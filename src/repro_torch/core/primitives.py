"""Fundamental parallel primitives on encoded data (paper §4, Table 1).

PyTorch port of ``repro.core.primitives``. All primitives are loop-free,
branch-free tensor programs, static-shape under the capacity model
(DESIGN.md §3):

  * inputs are fixed-capacity buffers + 0-d device counts, sentinel-padded,
  * each primitive takes/derives a static output capacity and returns
    (buffers, count) with the sentinel invariant restored.

No primitive reads a device value on the host, so none synchronises.
``torch.bucketize(x, b, right=False)`` == ``searchsorted(b, x, "left")``;
every searchsorted goes through ``dispatch.bucketize`` (the CUDA kernels on
the card). Output dtypes are the reference's: int32 positions and counts.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.encodings import (
    POS_DTYPE,
    RLEMask,
    cumsum,
    fill_scalar,
    is_integer,
    pad_positions,
    scatter_drop,
    take_clamped,
    unpack_values,
    valid_slots,
)
from repro_torch.device import torch_dtype
from repro_torch.kernels import dispatch

# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _arange(n: int, like: torch.Tensor, dtype=POS_DTYPE) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def _full(n: int, fill, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), fill, dtype=dtype, device=like.device)


def compact(flags: torch.Tensor, arrays, caps: int, fills
            ) -> Tuple[tuple, torch.Tensor]:
    """Stable compaction: keep slots where ``flags``; scatter into cap buffers.

    Returns (tuple of compacted arrays of length ``caps``, int32 count)."""
    idx = cumsum(flags) - 1  # target slot for kept entries
    tgt = torch.where(flags, idx, torch.full_like(idx, caps))
    outs = []
    for a, fill in zip(arrays, fills):
        out = _full(caps, fill, a.dtype, a)
        outs.append(scatter_drop(out, tgt, a, "set"))
    count = flags.sum(dtype=torch.int32)
    return tuple(outs), count


def repeat_interleave_capped(repeats: torch.Tensor, cap: int):
    """torch.repeat_interleave(arange(len(repeats)), repeats) with static cap.

    Returns (src_index[cap], valid[cap], total): output slot i's source entry
    is ``searchsorted(cumsum(repeats), i, 'right')``."""
    offsets = cumsum(repeats)  # inclusive prefix sums
    total = (offsets[-1] if repeats.shape[0] > 0
             else torch.zeros((), dtype=repeats.dtype, device=repeats.device))
    i = _arange(cap, offsets, offsets.dtype)
    src = dispatch.bucketize(offsets, i, right=True).to(POS_DTYPE)
    valid = i < total
    src = torch.where(valid, src, torch.zeros_like(src))
    return src, valid, _i32(total)


def range_arange_capped(starts: torch.Tensor, lengths: torch.Tensor, cap: int):
    """Algorithm 2 (range_arange) with static output capacity.

    Returns (result[cap], src[cap], valid[cap], total)."""
    src, valid, total = repeat_interleave_capped(lengths, cap)
    offsets = cumsum(lengths)
    prev = torch.cat([torch.zeros((1,), dtype=offsets.dtype,
                                  device=offsets.device), offsets[:-1]])
    i = _arange(cap, offsets, offsets.dtype)
    result = (take_clamped(starts, src).to(offsets.dtype)
              + (i - take_clamped(prev, src)))
    result = torch.where(valid, result, torch.zeros_like(result))
    return result.to(POS_DTYPE), src, valid, total


def unique_with_inverse(values: torch.Tensor, valid: torch.Tensor,
                        cap_groups: int):
    """torch.unique(return_inverse=True) under the capacity model.

    Returns (uniques[cap_groups], inverse[len(values)], num_groups)."""
    # sentinel = own-dtype max (int8-centered group keys exist: paper §3.2)
    big = (torch.iinfo(values.dtype).max if is_integer(values.dtype)
           else float("inf"))
    key = torch.where(valid, values, fill_scalar(big, values.dtype))
    order = torch.argsort(key, stable=True)
    sv = key[order]
    valid_sorted = valid[order]
    first = _arange(sv.shape[0], sv) == 0
    newgrp = valid_sorted & (first | (sv != torch.roll(sv, 1)))
    gid_sorted = cumsum(newgrp) - 1
    inverse = torch.zeros_like(gid_sorted).scatter_(0, order, gid_sorted)
    (uniques,), num_groups = compact(newgrp, (sv,), cap_groups, (0,))
    return uniques, inverse.to(POS_DTYPE), num_groups


def unique_bounded(values: torch.Tensor, valid: torch.Tensor, domain_size: int,
                   cap_groups: int | None = None):
    """Sort-free unique+inverse for values in the dense domain [0, domain_size):
    a presence scatter + cumsum renumbering, O(n + domain), no sort.

    Returns (uniques[cap_groups or domain_size], inverse[len(values)],
    num_groups); group ids ascend with the value, as in
    ``unique_with_inverse``."""
    cap_groups = domain_size if cap_groups is None else cap_groups
    v = torch.where(valid, _i32(values), domain_size)
    counts = scatter_drop(_full(domain_size, 0, torch.int32, v), v, 1, "add")
    present = counts > 0
    rank = (cumsum(present) - 1).to(POS_DTYPE)
    num_groups = present.sum(dtype=torch.int32)
    inverse = rank[torch.clamp(v, 0, domain_size - 1)]
    inverse = torch.where(valid, inverse, torch.zeros_like(inverse))
    (uniques,), _ = compact(present, (_arange(domain_size, v, torch.int32),),
                            cap_groups, (0,))
    return uniques, inverse.to(POS_DTYPE), num_groups


def rank_select_bounded(codes: torch.Tensor, lengths: torch.Tensor,
                        valid: torch.Tensor, domain_size: int, limit: int):
    """Sort-free top-``limit`` ROW selection over entries with bounded rank
    codes in ``[0, domain_size)`` (smaller = better). Returns ``(take,
    total)``: ``take[i]`` rows of entry ``i`` belong to the top-``limit``,
    ``total = min(limit, live rows)``."""
    lens = _i32(torch.where(valid, lengths, torch.zeros_like(lengths)))
    v = torch.where(valid & (lens > 0), _i32(codes), domain_size)
    hist = scatter_drop(_full(domain_size, 0, torch.int32, v), v, lens, "add")
    csum = cumsum(hist)  # inclusive: rows with code <= c
    total = torch.clamp(csum[domain_size - 1], max=limit)
    cstar = torch.searchsorted(csum, total.reshape(1), right=False,
                               out_int32=True)[0]
    excl = csum - hist  # rows with code < c
    rows_before_code = excl[torch.clamp(v, 0, domain_size - 1)]
    at_boundary = v == cstar
    b_lens = torch.where(at_boundary, lens, torch.zeros_like(lens))
    within = cumsum(b_lens) - b_lens  # boundary rows before this entry
    quota = total - rows_before_code - within
    take = torch.where(v < cstar, lens,
                       torch.where(at_boundary,
                                   torch.minimum(torch.clamp(quota, min=0),
                                                 lens),
                                   torch.zeros_like(lens)))
    return take, total


# ---------------------------------------------------------------------------
# range_intersect (Algorithm 1) — the workhorse
# ---------------------------------------------------------------------------


def range_intersect(s1, e1, n1, s2, e2, n2, nrows: int, cap_out: int):
    """Intersect two sorted non-overlapping run lists (paper Alg. 1).

    Returns (s[cap_out], e[cap_out], idx1[cap_out], idx2[cap_out], n_out);
    idx1/idx2 are per-output-run source indices into each input."""
    cap1 = s1.shape[0]
    bin_s = dispatch.bucketize(e2, s1, right=False)
    bin_e = dispatch.bucketize(s2, e1, right=True)
    zero = torch.zeros_like(bin_s)
    cnt = torch.where(valid_slots(n1, cap1), bin_e - bin_s, zero)
    cnt = torch.clamp(cnt, min=0)
    cnt = torch.minimum(cnt, torch.clamp(n2 - bin_s, min=0))
    idx2, idx1, valid, n_out = range_arange_capped(bin_s.to(POS_DTYPE), cnt,
                                                   cap_out)
    s = torch.maximum(take_clamped(s1, idx1), take_clamped(s2, idx2))
    e = torch.minimum(take_clamped(e1, idx1), take_clamped(e2, idx2))
    s = torch.where(valid, s, nrows)
    e = torch.where(valid, e, nrows)
    idx1 = torch.where(valid, idx1, torch.zeros_like(idx1))
    idx2 = torch.where(valid, idx2, torch.zeros_like(idx2))
    return s, e, idx1, idx2, n_out


def range_intersect_masks(m1: RLEMask, m2: RLEMask,
                          cap_out: int | None = None) -> RLEMask:
    """AND of two RLE masks (paper §5.1); smaller capacity first."""
    if m2.capacity < m1.capacity:
        m1, m2 = m2, m1
    cap_out = cap_out or (m1.capacity + m2.capacity)
    s, e, _, _, n = range_intersect(
        m1.starts, m1.ends, m1.n, m2.starts, m2.ends, m2.n, m1.nrows, cap_out)
    return RLEMask(starts=s, ends=e, n=n, nrows=m1.nrows)


def range_intersect_multi(lists: Sequence[tuple], nrows: int, cap_out: int):
    """Intersect k sorted non-overlapping run lists in ONE fused sweep.

    End events sort BEFORE start events at equal positions, so two adjacent
    runs of one list always produce a segment boundary (alignment, §6,
    depends on this). Returns (s[cap_out], e[cap_out], idxs, n_out) where
    idxs[j][i] is the source run of list j covering output run i."""
    k = len(lists)
    caps = [s.shape[0] for s, _, _ in lists]
    valids = [valid_slots(n, cap) for (_, _, n), cap in zip(lists, caps)]
    like = lists[0][0]
    pos = torch.cat([e + 1 for _, e, _ in lists]
                    + [s for s, _, _ in lists]).to(POS_DTYPE)
    delta = torch.cat([-_i32(v) for v in valids] + [_i32(v) for v in valids])
    pos = torch.where(delta == 0, nrows + 1, pos)
    order = torch.argsort(pos, stable=True)
    pos_s, delta_s = pos[order], delta[order]
    cov = cumsum(delta_s)
    prev_cov = torch.cat([torch.zeros((1,), dtype=cov.dtype,
                                      device=cov.device), cov[:-1]])
    start_flag = (cov == k) & (prev_cov < k) & (delta_s != 0)
    end_flag = (cov < k) & (prev_cov == k) & (delta_s != 0)
    (starts_out,), n_out = compact(start_flag, (pos_s,), cap_out, (nrows,))
    (ends_out,), _ = compact(end_flag, (pos_s - 1,), cap_out, (nrows,))
    valid = valid_slots(n_out, cap_out)
    s_out = torch.where(valid, starts_out, nrows).to(POS_DTYPE)
    e_out = torch.where(valid, ends_out, nrows).to(POS_DTYPE)
    idxs = []
    for (s_j, _, n_j), cap_j in zip(lists, caps):
        sp = pad_positions(s_j, n_j, nrows)
        b = dispatch.bucketize(sp, s_out, right=True) - 1
        b = torch.clamp(b, 0, cap_j - 1)
        idxs.append(torch.where(valid, b, torch.zeros_like(b)).to(POS_DTYPE))
    return s_out, e_out, idxs, n_out


# ---------------------------------------------------------------------------
# range_union (paper §5.2, RLE OR RLE) — vectorized sweep line
# ---------------------------------------------------------------------------


def range_union(s1, e1, n1, s2, e2, n2, nrows: int, cap_out: int):
    """Union of two sorted run lists. Returns (s, e, n_out).

    Sweep line over +1/-1 coverage deltas; start events land before end
    events at equal positions (concat layout + stable sort on the position
    alone), so adjacent runs merge maximally and positions never overflow."""
    cap1, cap2 = s1.shape[0], s2.shape[0]
    v1, v2 = valid_slots(n1, cap1), valid_slots(n2, cap2)
    pos = torch.cat([s1, s2, e1 + 1, e2 + 1]).to(torch.int32)
    delta = torch.cat([_i32(v1), _i32(v2), -_i32(v1), -_i32(v2)])
    pos = torch.where(delta == 0, nrows + 1, pos)
    order = torch.argsort(pos, stable=True)
    pos_s, delta_s = pos[order], delta[order]
    cov = cumsum(delta_s)
    prev_cov = torch.cat([torch.zeros((1,), dtype=cov.dtype,
                                      device=cov.device), cov[:-1]])
    start_flag = (cov > 0) & (prev_cov == 0) & (delta_s != 0)
    end_flag = (cov == 0) & (prev_cov > 0) & (delta_s != 0)
    (starts_out,), n_a = compact(start_flag, (pos_s,), cap_out, (nrows,))
    (ends_out,), _ = compact(end_flag, (pos_s - 1,), cap_out, (nrows,))
    n_out = n_a
    valid = valid_slots(n_out, cap_out)
    starts_out = torch.where(valid, starts_out, nrows).to(POS_DTYPE)
    ends_out = torch.where(valid, ends_out, nrows).to(POS_DTYPE)
    return starts_out, ends_out, n_out


# ---------------------------------------------------------------------------
# Index/RLE intersections (Algorithms 3-5)
# ---------------------------------------------------------------------------


def idx_in_rle_mask(pos, n_idx, rs, re, n_rle):
    """Algorithm 3 core: boolean mask over index slots + covering run id.

    Returns (mask[cap_idx], run_id[cap_idx])."""
    cap_idx = pos.shape[0]
    bin_ = dispatch.bucketize(rs, pos, right=True) - 1
    ok = (bin_ >= 0) & (bin_ < n_rle)
    bin_c = torch.clamp(bin_, 0, max(rs.shape[0] - 1, 0))
    mask = ok & (pos <= take_clamped(re, bin_c)) & valid_slots(n_idx, cap_idx)
    return mask, torch.where(mask, bin_c, torch.zeros_like(bin_c)).to(POS_DTYPE)


def idx_in_rle(c_idx_pos, n_idx, rs, re, n_rle, nrows: int, cap_out: int):
    """Algorithm 3: positions of an Index list falling inside RLE runs."""
    mask, run_id = idx_in_rle_mask(c_idx_pos, n_idx, rs, re, n_rle)
    (pos_out, run_out, src_out), n_out = compact(
        mask, (c_idx_pos, run_id, _arange(c_idx_pos.shape[0], c_idx_pos)),
        cap_out, (nrows, 0, 0))
    return pos_out, run_out, src_out, n_out


def rle_contain_idx(c_idx_pos, n_idx, rs, re, n_rle, nrows: int, cap_out: int):
    """Algorithm 5: same result as Alg. 3, bucketizing the other way
    (preferred when |idx| >> |rle|)."""
    cap_rle = rs.shape[0]
    bin_s = dispatch.bucketize(c_idx_pos, rs, right=False)
    bin_e = dispatch.bucketize(c_idx_pos, re, right=True) - 1
    ok = (bin_s <= bin_e) & valid_slots(n_rle, cap_rle)
    bin_e = torch.minimum(bin_e, n_idx - 1)
    lengths = torch.where(ok, bin_e - bin_s + 1, torch.zeros_like(bin_s))
    flat, run_src, valid, n_out = range_arange_capped(bin_s.to(POS_DTYPE),
                                                      lengths, cap_out)
    pos_out = torch.where(valid, take_clamped(c_idx_pos, flat), nrows)
    run_out = torch.where(valid, run_src, torch.zeros_like(run_src))
    src_out = torch.where(valid, flat, torch.zeros_like(flat))
    return pos_out, run_out.to(POS_DTYPE), src_out.to(POS_DTYPE), n_out


def idx_in_idx(p1, n1, p2, n2, nrows: int, cap_out: int):
    """Algorithm 4: intersection of two sorted Index position lists.
    Returns (pos_out, src1_out, src2_out, n_out)."""
    cap1 = p1.shape[0]
    bin_ = dispatch.bucketize(p2, p1, right=True) - 1
    ok = (bin_ >= 0) & (bin_ < n2) & valid_slots(n1, cap1)
    bin_c = torch.clamp(bin_, 0, max(p2.shape[0] - 1, 0))
    mask = ok & (p1 == take_clamped(p2, bin_c))
    (pos_out, s1, s2), n_out = compact(
        mask, (p1, _arange(cap1, p1), bin_c.to(POS_DTYPE)),
        cap_out, (nrows, 0, 0))
    return pos_out, s1, s2, n_out


def merge_sorted_idx(p1, n1, p2, n2, nrows: int, cap_out: int):
    """Union-merge two sorted unique position lists (paper §5.2 Index OR
    Index): concat + sort + dedup. Returns (pos_out, n_out)."""
    q1 = pad_positions(p1, n1, nrows)
    q2 = pad_positions(p2, n2, nrows)
    allp = torch.sort(torch.cat([q1, q2])).values
    first = _arange(allp.shape[0], allp) == 0
    keep = (allp < nrows) & (first | (allp != torch.roll(allp, 1)))
    (pos_out,), n_out = compact(keep, (allp,), cap_out, (nrows,))
    return pos_out, n_out


# ---------------------------------------------------------------------------
# Complements (Algorithms 6-7)
# ---------------------------------------------------------------------------


def complement_rle(rs, re, n, nrows: int):
    """Algorithm 6 (not_rle). Output capacity = cap + 1; the sentinel
    invariant (starts[n] == nrows) yields the final gap's end for free."""
    cap = rs.shape[0]
    s = torch.cat([_full(1, -1, POS_DTYPE, rs), re]) + 1
    e = torch.cat([rs, _full(1, nrows, POS_DTYPE, rs)]) - 1
    keep = (s <= e) & (_arange(cap + 1, rs) <= n)
    (s_out, e_out), n_out = compact(keep, (s, e), cap + 1, (nrows, nrows))
    return s_out, e_out, n_out


def complement_index(pos, n, nrows: int):
    """Algorithm 7 (not_index): gaps between index points, RLE output."""
    cap = pos.shape[0]
    s = torch.cat([_full(1, -1, POS_DTYPE, pos), pos]) + 1
    e = torch.cat([pos, _full(1, nrows, POS_DTYPE, pos)]) - 1
    keep = (s <= e) & (s < nrows) & (e >= 0) & (_arange(cap + 1, pos) <= n)
    (s_out, e_out), n_out = compact(keep, (s, e), cap + 1, (nrows, nrows))
    return s_out, e_out, n_out


# ---------------------------------------------------------------------------
# Compaction of gapped encodings (Table 1: compact_rle, compact_rle+index)
# ---------------------------------------------------------------------------


def compact_rle(rs, re, n, nrows: int):
    """Renumber rows to remove gaps between runs (Table 1 compact_rle).
    Returns (s', e', n, new_nrows_count)."""
    cap = rs.shape[0]
    valid = valid_slots(n, cap)
    lengths = torch.where(valid, re - rs + 1, torch.zeros_like(rs))
    ends_new = cumsum(lengths) - 1
    starts_new = ends_new - lengths + 1
    s_out = torch.where(valid, starts_new.to(POS_DTYPE), nrows)
    e_out = torch.where(valid, ends_new.to(POS_DTYPE), nrows)
    total = lengths.sum(dtype=torch.int32)
    return s_out, e_out, n, total


# ---------------------------------------------------------------------------
# Conversions (Table 1)
# ---------------------------------------------------------------------------


def rle_to_index(values, rs, re, n, nrows: int, cap_out: int):
    """Expand runs to individual (value, position) pairs."""
    rs, re = unpack_values(rs), unpack_values(re)
    cap = rs.shape[0]
    lengths = torch.where(valid_slots(n, cap), re - rs + 1,
                          torch.zeros_like(rs))
    pos, src, valid, n_out = range_arange_capped(rs, lengths, cap_out)
    pos = torch.where(valid, pos, nrows)
    vals = None
    if values is not None:
        v = take_clamped(unpack_values(values), src)
        vals = torch.where(valid, v, torch.zeros_like(v))
    return vals, pos, n_out


def rle_to_plain(values, rs, re, n, nrows: int, fill=0):
    """Expand RLE to a dense [nrows] tensor (coverage when ``values`` is
    None). Dispatch-routed: the CUDA ``rle_decode`` kernel when the policy
    picks it, otherwise the O(n) scatter+cumsum sweep."""
    from repro_torch.core.encodings import (_run_id_per_row,
                                            decode_rle_coverage)
    rs, re = unpack_values(rs), unpack_values(re)
    if values is None:
        return decode_rle_coverage(rs, re, n, nrows)
    routed = dispatch.maybe_rle_decode(values, rs, re, n, nrows, fill)
    if routed is not None:
        return routed
    covered = decode_rle_coverage(rs, re, n, nrows)
    run = torch.clamp(_run_id_per_row(rs, n, nrows), 0, rs.shape[0] - 1)
    values = unpack_values(values)
    return torch.where(covered, values[run], fill_scalar(fill, values.dtype))


def plain_to_rle(values, cap_out: int, nrows: int | None = None):
    """Detect runs of equal consecutive values (Table 1 plain_to_rle)."""
    nrows = nrows or values.shape[0]
    i = _arange(values.shape[0], values)
    newrun = (i == 0) | (values != torch.roll(values, 1))
    (v_out, s_out), n_out = compact(newrun, (values, i), cap_out, (0, nrows))
    e_out = torch.cat([s_out[1:], _full(1, nrows, POS_DTYPE, s_out)]) - 1
    e_out = torch.where(valid_slots(n_out, cap_out), e_out, nrows)
    return v_out, s_out, e_out, n_out


def plain_mask_to_rle(mask_values: torch.Tensor, cap_out: int):
    """Runs of True in a plain boolean mask."""
    nrows = mask_values.shape[0]
    i = _arange(nrows, mask_values)
    prev = torch.roll(mask_values, 1).clone()
    prev[:1] = False
    nxt = torch.roll(mask_values, -1).clone()
    nxt[-1:] = False
    start_flag = mask_values & ~prev
    end_flag = mask_values & ~nxt
    (s_out,), n_s = compact(start_flag, (i,), cap_out, (nrows,))
    (e_out,), _ = compact(end_flag, (i,), cap_out, (nrows,))
    return s_out, e_out, n_s


def plain_mask_to_index(mask_values: torch.Tensor, cap_out: int):
    """Positions of True values."""
    nrows = mask_values.shape[0]
    i = _arange(nrows, mask_values)
    (pos_out,), n_out = compact(mask_values, (i,), cap_out, (nrows,))
    return pos_out, n_out


def plain_to_plain_index(values, lo, hi, narrow_dtype, cap_outliers: int):
    """Bit-width reduction with outlier separation + centering (paper §3.2).
    Returns (base_narrow, offset, out_positions, out_values, n_outliers)."""
    nrows = values.shape[0]
    inlier = (values >= lo) & (values <= hi)
    center = (lo + hi) // 2 if is_integer(values.dtype) else (lo + hi) / 2
    base = torch.where(inlier, values - center, torch.zeros_like(values))
    base = base.to(torch_dtype(narrow_dtype))
    i = _arange(nrows, values)
    (pos_out, val_out), n_out = compact(~inlier, (i, values), cap_outliers,
                                        (nrows, 0))
    return base, center, pos_out, val_out, n_out


def plain_to_rle_index(values, min_run: int, cap_runs: int, cap_idx: int,
                       nrows: int | None = None):
    """Composite RLE+Index split (paper §3.2): runs >= min_run stay RLE,
    shorter 'impure' segments go to Index. Returns
    (rv, rs, re, rn, iv, ip, in_)."""
    nrows = nrows or values.shape[0]
    v, s, e, n = plain_to_rle(values, cap_out=values.shape[0], nrows=nrows)
    lengths = torch.where(valid_slots(n, v.shape[0]), e - s + 1,
                          torch.zeros_like(s))
    long_run = lengths >= min_run
    (rv, rs, re), rn = compact(long_run, (v, s, e), cap_runs, (0, nrows, nrows))
    short = (~long_run) & (lengths > 0)
    short_lengths = torch.where(short, lengths, torch.zeros_like(lengths))
    pos, src, validx, in_ = range_arange_capped(s, short_lengths, cap_idx)
    pos = torch.where(validx, pos, nrows)
    iv = take_clamped(v, src)
    iv = torch.where(validx, iv, torch.zeros_like(iv))
    return rv, rs, re, rn, iv, pos, in_
