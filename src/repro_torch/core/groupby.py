"""Group-by aggregation on encoded columns (paper §7 + Appendix A.2).

PyTorch port of ``repro.core.groupby`` (resident grouping and
aggregation; the host-side partial fold/merge of partitioned execution
arrives with the partition slice). Two phases: *Grouping* (inverse index
over unique group-key tuples) and *Aggregating* (segment reductions).
Heterogeneous encodings are brought onto a common segmentation first
(Alignment, §6).

Run-aware aggregation rewrites (paper §7.2):
  COUNT = Σ run_lengths           (never expands runs)
  SUM   = Σ value · run_length
  MIN/MAX = over value tensor only
  AVG/STD/VAR = post-processing over SUM / COUNT / SUM-of-squares

Every float SUM goes through ``dispatch.segment_sum`` — the deterministic
CUDA kernel on the card — so a query gives the same bits on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core.encodings import (
    POS_DTYPE,
    IndexColumn,
    IndexMask,
    PlainColumn,
    PlainIndexColumn,
    RLEColumn,
    RLEMask,
    coverage,
    decode_column,
    decode_mask,
    is_integer,
    scatter_drop,
    unpack_values,
    valid_slots,
)
from repro_torch.device import to_numpy
from repro_torch.kernels import dispatch

_I32 = torch.iinfo(torch.int32)


@dataclasses.dataclass(frozen=True)
class SegmentView:
    """Aligned view: per-segment values for every column + segment lengths.

    ``starts``/``ends`` are the row ranges of the segments (run-level path)
    or per-row unit ranges (row-level fallback)."""

    values: Dict[str, torch.Tensor]
    lengths: torch.Tensor  # rows per segment
    valid: torch.Tensor  # bool per segment
    n: torch.Tensor  # number of valid segments
    starts: torch.Tensor
    ends: torch.Tensor


def _is_position_explicit(c) -> bool:
    return isinstance(c, (RLEColumn, IndexColumn))


def _as_runs(c):
    """(values, starts, ends, n) — Index columns become unit-length runs."""
    if isinstance(c, RLEColumn):
        return (unpack_values(c.values), unpack_values(c.starts),
                unpack_values(c.ends), c.n)
    if isinstance(c, IndexColumn):
        pos = unpack_values(c.positions)
        return unpack_values(c.values), pos, pos, c.n
    raise TypeError(type(c))


def _mask_as_runs(m, nrows):
    if isinstance(m, RLEMask):
        return m.starts, m.ends, m.n
    if isinstance(m, IndexMask):
        return m.positions, m.positions, m.n
    raise TypeError(type(m))


def _zero_invalid(valid, x):
    return torch.where(valid, x, torch.zeros_like(x))


def align_columns(cols: Dict[str, object], mask=None) -> SegmentView:
    """Bring heterogeneously encoded columns onto one segmentation (§6).

    All columns position-explicit (RLE / Index) -> the fused k-way sweep
    keeps the result run-level; any Plain participant forces row-level
    segmentation (lengths == 1)."""
    items = list(cols.items())
    run_ok = all(_is_position_explicit(c) for _, c in items) and (
        mask is None or isinstance(mask, (RLEMask, IndexMask)))
    nrows = items[0][1].nrows

    if run_ok:
        src_vals = {name: _as_runs(c)[0] for name, c in items}
        run_lists = [_as_runs(c)[1:] for _, c in items]
        if mask is not None:
            run_lists.append(_mask_as_runs(mask, nrows))
        if len(run_lists) == 1:
            # single position-explicit column, no mask: its runs ARE the
            # segmentation (identity indices, no sweep needed).
            name0, c0 = items[0]
            _, s, e, n = _as_runs(c0)
            valid = valid_slots(n, c0.capacity)
            lengths = _zero_invalid(valid, e - s + 1)
            values = {name0: _zero_invalid(valid, src_vals[name0])}
            return SegmentView(values=values, lengths=lengths, valid=valid,
                               n=n, starts=s, ends=e)
        cap_total = sum(c.capacity for _, c in items)
        if mask is not None:
            cap_total += mask.capacity
        s, e, idxs, n = prim.range_intersect_multi(run_lists, nrows, cap_total)
        valid = valid_slots(n, cap_total)
        lengths = _zero_invalid(valid, e - s + 1)
        values = {name: _zero_invalid(valid, src_vals[name][idxs[j]])
                  for j, (name, _) in enumerate(items)}
        return SegmentView(values=values, lengths=lengths, valid=valid,
                           n=n, starts=s, ends=e)

    # Row-level fallback: any Plain participant (or Plain mask).
    values = {}
    live = None
    for name, c in items:
        values[name] = decode_column(c)
        if live is None:
            live = torch.ones((nrows,), dtype=torch.bool,
                              device=values[name].device)
        if not isinstance(c, (PlainColumn, PlainIndexColumn)):
            live = live & coverage(c)
    if mask is not None:
        live = live & decode_mask(mask)
    lengths = live.to(torch.int32)
    rows = torch.arange(nrows, dtype=POS_DTYPE, device=live.device)
    return SegmentView(values=values, lengths=lengths, valid=live,
                       n=lengths.sum(dtype=torch.int32), starts=rows, ends=rows)


# ---------------------------------------------------------------------------
# Grouping phase (paper §7.1)
# ---------------------------------------------------------------------------


def _bounded_key_domain(view: SegmentView, group_names: Sequence[str],
                        key_domains) -> Optional[int]:
    """Mixed-radix product domain size when the sort-free path may fire,
    else None (argsort path)."""
    pol = dispatch.policy()
    if not pol.enable_sort_free or not key_domains:
        return None
    total = 1
    for name in group_names:
        dom = key_domains.get(name)
        if dom is None or not is_integer(view.values[name].dtype):
            return None
        lo, size = int(dom[0]), int(dom[1])
        if lo < _I32.min or lo + size - 1 > _I32.max:
            return None
        total *= size
        if total > pol.sort_free_max_domain:
            return None
    return total if total > 0 else None


def grouping(view: SegmentView, group_names: Sequence[str],
             num_groups_cap: int,
             key_domains: Optional[Dict[str, Tuple[int, int]]] = None):
    """Inverse index per segment over unique group-key tuples.

    Sort-free fast path when every group key has a bounded dense domain
    (mixed-radix code + one ``unique_bounded`` scatter); argsort fallback
    otherwise. Group ids come out in lexicographic key order on both paths.

    Returns (gid[segments], num_groups, rep_index[num_groups_cap])."""
    bounded = _bounded_key_domain(view, group_names, key_domains)
    if bounded is not None:
        combined = None
        for name in group_names:
            lo, size = key_domains[name]
            code = view.values[name].to(torch.int32) - int(lo)
            combined = code if combined is None else combined * int(size) + code
        _, gid, num_groups = prim.unique_bounded(
            combined, view.valid, bounded, cap_groups=num_groups_cap)
    else:
        combined = None
        for name in group_names:
            vals = view.values[name]
            if is_integer(vals.dtype) and vals.dtype != torch.int32:
                vals = vals.to(torch.int32)
            _, inv, _ = prim.unique_with_inverse(vals, view.valid,
                                                 num_groups_cap)
            inv32 = inv.to(torch.int32)
            combined = (inv32 if combined is None
                        else combined * num_groups_cap + inv32)
        _, gid, num_groups = prim.unique_with_inverse(
            combined, view.valid, num_groups_cap)
    # representative segment per group (first occurrence) for key recovery
    seg_ids = torch.arange(gid.shape[0], dtype=POS_DTYPE, device=gid.device)
    gid_safe = torch.where(view.valid, gid, torch.full_like(gid, num_groups_cap))
    rep = scatter_drop(
        torch.full((num_groups_cap,), _I32.max, dtype=POS_DTYPE,
                   device=gid.device), gid_safe, seg_ids, "amin")
    return gid_safe, num_groups, rep


# ---------------------------------------------------------------------------
# Aggregating phase (paper §7.2 + A.2)
# ---------------------------------------------------------------------------


def _segsum(values, gid, cap):
    # dispatch-routed: the deterministic CUDA kernel for float32 sums with
    # cap <= 4096, exact integer scatter-add otherwise
    return dispatch.segment_sum(values, gid, cap)


def _seg_extreme(values, gid, cap, how: str):
    init = float("inf") if how == "amin" else float("-inf")
    out = torch.full((cap,), init, dtype=torch.float32, device=values.device)
    return scatter_drop(out, gid, values, how)


def aggregate(view: SegmentView, gid: torch.Tensor, specs, num_groups_cap: int):
    """specs: list of (out_name, agg, col_name). agg in
    sum|count|min|max|avg|var|std. Returns dict out_name -> tensor[cap]."""
    out = {}
    lengths = view.lengths
    f32 = torch.float32
    inf = torch.tensor(float("inf"), dtype=f32, device=lengths.device)
    for out_name, agg, col_name in specs:
        if agg == "count":
            out[out_name] = _segsum(lengths.to(torch.int32), gid, num_groups_cap)
            continue
        v = view.values[col_name]
        if agg == "sum":
            out[out_name] = _segsum(v.to(f32) * lengths.to(f32), gid,
                                    num_groups_cap)
        elif agg == "min":
            out[out_name] = _seg_extreme(torch.where(view.valid, v.to(f32), inf),
                                         gid, num_groups_cap, "amin")
        elif agg == "max":
            out[out_name] = _seg_extreme(torch.where(view.valid, v.to(f32), -inf),
                                         gid, num_groups_cap, "amax")
        elif agg in ("avg", "var", "std"):
            s = _segsum(v.to(f32) * lengths.to(f32), gid, num_groups_cap)
            c = _segsum(lengths.to(f32), gid, num_groups_cap)
            mean = s / torch.clamp(c, min=1)
            if agg == "avg":
                out[out_name] = mean
            else:
                sq = _segsum((v.to(f32) ** 2) * lengths.to(f32), gid,
                             num_groups_cap)
                var = sq / torch.clamp(c, min=1) - mean ** 2
                out[out_name] = (var if agg == "var"
                                 else torch.sqrt(torch.clamp(var, min=0)))
        else:
            raise ValueError(f"unknown agg {agg}")
    return out


@dataclasses.dataclass(frozen=True)
class GroupByResult:
    keys: Dict[str, torch.Tensor]  # group key values per group slot
    aggs: Dict[str, torch.Tensor]
    num_groups: torch.Tensor
    valid: torch.Tensor  # [num_groups_cap]


def groupby_aggregate(
    cols: Dict[str, object],
    group_names: Sequence[str],
    specs: Sequence[Tuple[str, str, Optional[str]]],
    num_groups_cap: int,
    mask=None,
    key_domains: Optional[Dict[str, Tuple[int, int]]] = None,
) -> GroupByResult:
    """End-to-end §7: align -> group -> aggregate.

    **Hybrid path** (the paper's §7/A.2 flow): when every GROUP column is
    position-explicit but some AGGREGATE columns are Plain, grouping runs
    at run level and Plain aggregate rows are scattered onto group ids
    through the O(n) row->segment sweep."""
    pe = {k: c for k, c in cols.items() if _is_position_explicit(c)}
    plain = {k: c for k, c in cols.items() if not _is_position_explicit(c)}
    mask_pe = mask is None or isinstance(mask, (RLEMask, IndexMask))
    hybrid = plain and mask_pe and all(g in pe for g in group_names)

    if not hybrid:
        view = align_columns(dict(cols), mask=mask)
        gid, num_groups, rep = grouping(view, group_names, num_groups_cap,
                                        key_domains=key_domains)
        out = aggregate(view, gid, list(specs), num_groups_cap)
    else:
        from repro_torch.core.encodings import (_run_id_per_row,
                                                decode_rle_coverage)
        nrows = next(iter(cols.values())).nrows
        view = align_columns(pe, mask=mask)  # run-level segments
        gid, num_groups, rep = grouping(view, group_names, num_groups_cap,
                                        key_domains=key_domains)
        run_specs = [(o, a, c) for o, a, c in specs
                     if c is None or c in view.values]
        out = aggregate(view, gid, run_specs, num_groups_cap)
        # row -> segment -> group scatter for Plain aggregate columns
        seg_of_row = _run_id_per_row(view.starts, view.n, nrows)
        cov = decode_rle_coverage(view.starts, view.ends, view.n, nrows)
        seg_c = torch.clamp(seg_of_row, 0, gid.shape[0] - 1)
        gid_row = torch.where(cov, gid[seg_c],
                              torch.full_like(seg_c, num_groups_cap))
        f32 = torch.float32
        zero = torch.zeros((), dtype=f32, device=cov.device)
        inf = torch.tensor(float("inf"), dtype=f32, device=cov.device)
        counts = None
        for o, a, c in specs:
            if c is None or c in view.values:
                continue
            v = decode_column(plain[c]).to(f32)
            if a in ("sum", "avg", "var", "std"):
                ssum = _segsum(torch.where(cov, v, zero), gid_row,
                               num_groups_cap)
            if a == "sum":
                out[o] = ssum
            elif a == "min":
                out[o] = _seg_extreme(torch.where(cov, v, inf), gid_row,
                                      num_groups_cap, "amin")
            elif a == "max":
                out[o] = _seg_extreme(torch.where(cov, v, -inf), gid_row,
                                      num_groups_cap, "amax")
            elif a in ("avg", "var", "std"):
                if counts is None:
                    counts = _segsum(view.lengths.to(f32), gid, num_groups_cap)
                mean = ssum / torch.clamp(counts, min=1)
                if a == "avg":
                    out[o] = mean
                else:
                    sq = _segsum(torch.where(cov, v * v, zero), gid_row,
                                 num_groups_cap)
                    var = sq / torch.clamp(counts, min=1) - mean ** 2
                    out[o] = (var if a == "var"
                              else torch.sqrt(torch.clamp(var, min=0)))
            else:
                raise ValueError(a)

    rep_safe = torch.clamp(rep, 0, gid.shape[0] - 1)
    gvalid = valid_slots(num_groups, num_groups_cap)
    keys = {name: _zero_invalid(gvalid, view.values[name][rep_safe])
            for name in group_names}
    return GroupByResult(keys=keys, aggs=out, num_groups=num_groups,
                         valid=gvalid)


# ---------------------------------------------------------------------------
# Cross-partition merge (partitioned execution, DESIGN.md §4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MergedGroupBy:
    """Host-side merged group-by result: exact-size numpy arrays, groups in
    lexicographic key order (np.unique)."""

    keys: Dict[str, np.ndarray]
    aggs: Dict[str, np.ndarray]
    num_groups: int


def _reduce_into_groups(vals: np.ndarray, inv: np.ndarray, ng: int,
                        agg: str) -> np.ndarray:
    """Reduce concatenated per-group values under one combine rule."""
    if agg in ("sum", "count"):
        acc = np.zeros((ng,), vals.dtype)
        np.add.at(acc, inv, vals)
        return acc
    if agg == "min":
        acc = np.full((ng,), np.inf, np.float64)
        np.minimum.at(acc, inv, vals)
        return acc.astype(vals.dtype)
    acc = np.full((ng,), -np.inf, np.float64)  # max
    np.maximum.at(acc, inv, vals)
    return acc.astype(vals.dtype)


def fold_groupby_partial(acc, r: GroupByResult, group_names: Sequence[str],
                         partial_specs):
    """Fold ONE partition's GroupByResult partial into the running merged
    state (host side): the incremental half of ``merge_groupby_partials``
    for the streamed executor (``core/stream.py``).

    ``acc`` is ``None`` or ``{"keys": uniq2d, "aggs": {out: vals},
    "key_dtypes": [...]}`` with groups in lexicographic key order. The
    host copies here are where the host waits for the partition's device
    values. Folding in partition order is bit-identical to the batch
    merge: each group's contributions accumulate left to right in both.
    """
    ng = int(r.num_groups)
    if ng == 0:
        return acc
    cols = [to_numpy(r.keys[g])[:ng] for g in group_names]
    block_keys = np.stack(cols, axis=1)
    block_aggs = {o: to_numpy(r.aggs[o])[:ng] for o, _, _ in partial_specs}
    if acc is None:
        return {"keys": block_keys, "aggs": block_aggs,
                "key_dtypes": [c.dtype for c in cols]}
    all_keys = np.concatenate([acc["keys"], block_keys], axis=0)
    if all_keys.shape[1] == 1:
        # the 1-D np.unique is far faster than the axis=0 (void view +
        # lexsort) path for the common single-key group-by
        u1, inv = np.unique(all_keys[:, 0], return_inverse=True)
        uniq = u1[:, None]
    else:
        uniq, inv = np.unique(all_keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ng2 = uniq.shape[0]
    merged = {o: _reduce_into_groups(
        np.concatenate([acc["aggs"][o], block_aggs[o]]), inv, ng2, agg)
        for o, agg, _ in partial_specs}
    return {"keys": uniq, "aggs": merged, "key_dtypes": acc["key_dtypes"]}


def finalize_groupby_partials(acc, group_names: Sequence[str],
                              specs: Sequence[Tuple[str, str, Optional[str]]]
                              ) -> MergedGroupBy:
    """Finalize a folded group-by state (avg = sum / count, key dtype
    restoration); ``acc=None`` (every partition skipped or empty) yields
    the empty result."""
    from repro_torch.core import plan as plan_mod

    _, finalize = plan_mod.decompose_specs(specs)
    if acc is None:
        keys = {g: np.zeros((0,), np.int32) for g in group_names}
        aggs = {name: np.zeros((0,), np.float32) for name, _, _ in finalize}
        return MergedGroupBy(keys=keys, aggs=aggs, num_groups=0)
    aggs = plan_mod._apply_finalize(acc["aggs"], finalize)
    keys = {g: acc["keys"][:, i].astype(acc["key_dtypes"][i])
            for i, g in enumerate(group_names)}
    return MergedGroupBy(keys=keys, aggs=aggs,
                         num_groups=acc["keys"].shape[0])


def merge_groupby_partials(results: Sequence[GroupByResult],
                           group_names: Sequence[str],
                           specs: Sequence[Tuple[str, str, Optional[str]]]):
    """Re-aggregate per-partition GroupByResult partials on the host: each
    partial output merges under its combine rule (sum/count add, min/max
    extremes) and avg finalizes as merged-sum / merged-count. Batch
    wrapper over ``fold_groupby_partial`` + ``finalize_groupby_partials``.
    """
    from repro_torch.core import plan as plan_mod

    partial_specs, _ = plan_mod.decompose_specs(specs)
    acc = None
    for r in results:
        acc = fold_groupby_partial(acc, r, group_names, partial_specs)
    return finalize_groupby_partials(acc, group_names, specs)
