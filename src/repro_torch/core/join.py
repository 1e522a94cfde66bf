"""Join operations on encoded columns (paper §8 + Appendix A.3).

PyTorch port of ``repro.core.join``. As in the reference, the paper's GPU
hash join is a *sort-merge* join: the build side is sorted by key (once),
probes are two ``searchsorted`` calls giving per-probe match ranges (the
CUDA bucketize kernels on the card), and expansion reuses the
``range_arange`` machinery (Alg. 2). Join entries operate at the encoding
granularity (runs for RLE, points for Index, rows for Plain).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import primitives as prim
from repro_torch.core.encodings import (
    POS_DTYPE,
    IndexColumn,
    IndexMask,
    PlainColumn,
    PlainIndexColumn,
    PlainMask,
    RLEColumn,
    RLEIndexColumn,
    RLEMask,
    decode_column,
    fill_scalar,
    is_integer,
    take_clamped,
    unpack_values,
    valid_slots,
)
from repro_torch.kernels import dispatch


def _zero_invalid(valid, x):
    return torch.where(valid, x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class JoinEntries:
    """Encoding-granular view of a join column."""

    keys: torch.Tensor  # key value per entry
    row_start: torch.Tensor  # first row covered by the entry
    length: torch.Tensor  # rows covered (1 for Plain/Index)
    n: torch.Tensor  # valid entries


def join_entries(col) -> JoinEntries:
    if isinstance(col, PlainColumn):
        nr = col.capacity
        dev = col.values.device
        return JoinEntries(
            keys=col.decode(),
            row_start=torch.arange(nr, dtype=POS_DTYPE, device=dev),
            length=torch.ones((nr,), dtype=POS_DTYPE, device=dev),
            n=torch.tensor(nr, dtype=torch.int32, device=dev),
        )
    if isinstance(col, RLEColumn):
        return JoinEntries(keys=unpack_values(col.values),
                           row_start=unpack_values(col.starts),
                           length=col.lengths.to(POS_DTYPE), n=col.n)
    if isinstance(col, IndexColumn):
        valid = valid_slots(col.n, col.capacity)
        return JoinEntries(keys=unpack_values(col.values),
                           row_start=unpack_values(col.positions),
                           length=valid.to(POS_DTYPE), n=col.n)
    raise TypeError(type(col))


@dataclasses.dataclass(frozen=True)
class JoinIndex:
    """Compressed (entry-level) join index: one slot per matching entry
    pair; ``len_l × len_r`` row pairs per slot expand only on demand."""

    left_entry: torch.Tensor
    right_entry: torch.Tensor
    left_start: torch.Tensor
    left_len: torch.Tensor
    right_start: torch.Tensor
    right_len: torch.Tensor
    n: torch.Tensor  # valid pair count
    total_rows: torch.Tensor  # Σ multiplicity


def join_index(left, right, cap_pairs: int) -> JoinIndex:
    """Get Join Index (paper §8.1) via sort-merge probe.
    ``right`` is the build side (sorted by key inside); ``left`` probes."""
    le = join_entries(left)
    re_ = join_entries(right)
    capL, capR = le.keys.shape[0], re_.keys.shape[0]
    big = _big_for(re_.keys.dtype, re_.keys.device)
    rkey = torch.where(valid_slots(re_.n, capR), re_.keys, big)
    order = torch.argsort(rkey, stable=True)
    rk = rkey[order]
    # jnp.where promotes the probe keys to the build side's sentinel dtype
    dt = torch.promote_types(le.keys.dtype, big.dtype)
    big = big.to(dt)
    lkey = torch.where(valid_slots(le.n, capL), le.keys.to(dt), big)
    lo = dispatch.bucketize(rk, lkey, right=False)
    hi = dispatch.bucketize(rk, lkey, right=True)
    cnt = _zero_invalid(valid_slots(le.n, capL) & (lkey != big), hi - lo)
    slot, l_ent, valid, n_pairs = prim.range_arange_capped(
        lo.to(POS_DTYPE), cnt, cap_pairs)
    r_ent = order[slot].to(POS_DTYPE)
    l_ent = _zero_invalid(valid, l_ent).to(POS_DTYPE)
    r_ent = _zero_invalid(valid, r_ent)
    l_len = _zero_invalid(valid, le.length[l_ent])
    r_len = _zero_invalid(valid, re_.length[r_ent])
    mult = l_len.to(torch.int32) * r_len.to(torch.int32)
    return JoinIndex(
        left_entry=l_ent, right_entry=r_ent,
        left_start=le.row_start[l_ent], left_len=l_len,
        right_start=re_.row_start[r_ent], right_len=r_len,
        n=n_pairs, total_rows=mult.sum(dtype=torch.int32),
    )


def expand_pairs_to_rows(ji: JoinIndex, cap_rows: int):
    """Apply Join Index at row granularity (paper §8.2, A.3 steps 2-3):
    left varies slowest. Returns (left_rows, right_rows, valid, total)."""
    mult = (ji.left_len * ji.right_len).to(torch.int32)
    pair, valid, total = prim.repeat_interleave_capped(mult, cap_rows)
    offsets = torch.cumsum(mult, 0, dtype=torch.int32)
    prev = torch.cat([torch.zeros((1,), dtype=offsets.dtype,
                                  device=offsets.device), offsets[:-1]])
    t = (torch.arange(cap_rows, dtype=offsets.dtype, device=offsets.device)
         - take_clamped(prev, pair))
    rl = torch.clamp(take_clamped(ji.right_len, pair), min=1).to(t.dtype)
    l_rows = take_clamped(ji.left_start, pair) + (t // rl).to(POS_DTYPE)
    r_rows = take_clamped(ji.right_start, pair) + (t % rl).to(POS_DTYPE)
    return (_zero_invalid(valid, l_rows), _zero_invalid(valid, r_rows),
            valid, total)


def gather_rows(col, rows: torch.Tensor, valid: torch.Tensor):
    """Apply Join Index to a payload column: fetch values at (unsorted,
    possibly duplicated) row ids. For RLE payloads the fetch is a binary
    search per row (run id -> value); the column is never decompressed."""
    if isinstance(col, PlainColumn):
        vals = take_clamped(col.decode(), rows)
    elif isinstance(col, RLEColumn):
        starts, ends = unpack_values(col.starts), unpack_values(col.ends)
        run = dispatch.bucketize(ends, rows, right=False).to(POS_DTYPE)
        run = torch.clamp(run, max=col.capacity - 1)
        inside = (rows >= starts[run]) & (rows <= ends[run]) & (run < col.n)
        vals = _zero_invalid(inside, unpack_values(col.values)[run])
    elif isinstance(col, IndexColumn):
        positions = unpack_values(col.positions)
        slot = dispatch.bucketize(positions, rows, right=False).to(POS_DTYPE)
        slot = torch.clamp(slot, max=col.capacity - 1)
        hit = (positions[slot] == rows) & (slot < col.n)
        vals = _zero_invalid(hit, unpack_values(col.values)[slot])
    else:
        raise TypeError(type(col))
    return _zero_invalid(valid, vals)


# ---------------------------------------------------------------------------
# PK-FK star-schema join (paper §8.1 + Table 6)
# ---------------------------------------------------------------------------


def pk_fk_join(fact_key_col, dim_keys: torch.Tensor, n_dim: torch.Tensor,
               payloads: dict, fill=0):
    """Sort-merge PK-FK probe: returns ``(mask, gathered)``.

    ``dim_keys`` is the build side — surviving dimension PK values in the
    fact key's value space, sorted, sentinel-padded past ``n_dim``.
    ``mask`` is the inner-join membership mask in the fact column's own
    encoding; ``gathered`` maps each payload name to a column in the fact
    key's encoding carrying the matched dimension attribute."""
    if isinstance(fact_key_col, (PlainIndexColumn, RLEIndexColumn)):
        fact_key_col = PlainColumn(values=decode_column(fact_key_col),
                                   nrows=fact_key_col.nrows)

    def probe(keys, kvalid):
        slot = dispatch.bucketize(dim_keys, keys, right=False)
        slot_c = torch.clamp(slot, max=dim_keys.shape[0] - 1)
        hit = (slot < n_dim) & (dim_keys[slot_c] == unpack_values(keys))
        if kvalid is not None:
            hit = kvalid & hit
        return slot_c, hit

    def gathered_values(p, slot, hit):
        return torch.where(hit, p[slot], fill_scalar(fill, p.dtype, p.device))

    if isinstance(fact_key_col, PlainColumn):
        slot, hit = probe(fact_key_col.decode(), None)
        mask = PlainMask(values=hit, nrows=fact_key_col.nrows)
        gathered = {
            name: PlainColumn(values=gathered_values(p, slot, hit),
                              nrows=fact_key_col.nrows)
            for name, p in payloads.items()}
        return mask, gathered

    if isinstance(fact_key_col, RLEColumn):
        c = fact_key_col
        slot, hit = probe(c.values, valid_slots(c.n, c.capacity))
        (s, e), n = prim.compact(
            hit, (unpack_values(c.starts), unpack_values(c.ends)), c.capacity,
            (c.nrows, c.nrows))
        mask = RLEMask(starts=s, ends=e, n=n, nrows=c.nrows)
        # gathered columns keep the fact key's FULL run structure (misses
        # hold ``fill`` and are excluded by the mask)
        gathered = {
            name: RLEColumn(values=gathered_values(p, slot, hit),
                            starts=c.starts, ends=c.ends, n=c.n, nrows=c.nrows)
            for name, p in payloads.items()}
        return mask, gathered

    if isinstance(fact_key_col, IndexColumn):
        c = fact_key_col
        slot, hit = probe(c.values, valid_slots(c.n, c.capacity))
        (pos,), n = prim.compact(hit, (unpack_values(c.positions),),
                                 c.capacity, (c.nrows,))
        mask = IndexMask(positions=pos, n=n, nrows=c.nrows)
        gathered = {
            name: IndexColumn(values=gathered_values(p, slot, hit),
                              positions=c.positions, n=c.n, nrows=c.nrows)
            for name, p in payloads.items()}
        return mask, gathered

    raise TypeError(type(fact_key_col))


# ---------------------------------------------------------------------------
# Semi-join (the production-workload workhorse)
# ---------------------------------------------------------------------------


def semi_join_mask(left, right_keys: torch.Tensor, n_right: torch.Tensor):
    """LEFT SEMI JOIN membership mask, in the left column's own encoding.

    ``right_keys`` must be sorted with invalid slots at the top (sentinel).
    For an RLE left column membership is decided once per *run*."""
    def member(keys, kvalid):
        lo = dispatch.bucketize(right_keys, keys, right=False)
        lo_c = torch.clamp(lo, max=right_keys.shape[0] - 1)
        hit = (lo < n_right) & (right_keys[lo_c] == unpack_values(keys))
        return hit if kvalid is None else kvalid & hit

    if isinstance(left, PlainColumn):
        return PlainMask(values=member(left.decode(), None), nrows=left.nrows)
    if isinstance(left, RLEColumn):
        keep = member(left.values, valid_slots(left.n, left.capacity))
        (s, e), n = prim.compact(
            keep, (unpack_values(left.starts), unpack_values(left.ends)),
            left.capacity, (left.nrows, left.nrows))
        return RLEMask(starts=s, ends=e, n=n, nrows=left.nrows)
    if isinstance(left, IndexColumn):
        keep = member(left.values, valid_slots(left.n, left.capacity))
        (p,), n = prim.compact(keep, (unpack_values(left.positions),),
                               left.capacity, (left.nrows,))
        return IndexMask(positions=p, n=n, nrows=left.nrows)
    raise TypeError(type(left))


def sorted_unique_keys(values: torch.Tensor, valid: torch.Tensor, cap: int):
    """Helper to build the right-side key set for semi_join_mask."""
    uniq, _, n = prim.unique_with_inverse(values, valid, cap)
    big = _big_for(uniq.dtype, uniq.device)
    uniq = torch.where(valid_slots(n, cap), uniq, big)
    return uniq, n


def _big_for(dtype, device):
    if is_integer(dtype):
        return torch.tensor(torch.iinfo(dtype).max, dtype=dtype, device=device)
    return torch.tensor(float("inf"), dtype=dtype, device=device)
