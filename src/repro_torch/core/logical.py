"""Logical operators AND / OR / NOT on MaskColumns (paper §5, Tables 2-5).

PyTorch port of ``repro.core.logical``. Encoding dispatch follows the
paper's tables, including output-encoding selection (Tables 3 & 5). As in
the reference, the paper's dynamic selectivity-threshold choice between
RLE->Index and RLE->Plain routes on static capacities (callers may pass an
expansion-capacity hint).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import primitives as prim
from repro_torch.core.encodings import (
    POS_DTYPE,
    IndexMask,
    PlainMask,
    RLEIndexMask,
    RLEMask,
    decode_mask,
    scatter_drop,
    take_fill,
    valid_slots,
)

# Paper §5.1: default selectivity threshold for RLE->Index vs RLE->Plain.
SELECTIVITY_THRESHOLD = 20


# ---------------------------------------------------------------------------
# AND (paper §5.1, Tables 2-3)
# ---------------------------------------------------------------------------


def and_masks(m1, m2, index_cap_hint: Optional[int] = None):
    """AND dispatch. Returns a MaskColumn whose encoding follows Table 3."""
    if isinstance(m1, RLEIndexMask) or isinstance(m2, RLEIndexMask):
        return _and_composite(m1, m2, index_cap_hint)
    if isinstance(m2, (RLEMask, IndexMask)) and isinstance(m1, PlainMask):
        m1, m2 = m2, m1  # symmetric; normalize order RLE/Index first
    if isinstance(m1, IndexMask) and isinstance(m2, RLEMask):
        m1, m2 = m2, m1

    if isinstance(m1, PlainMask) and isinstance(m2, PlainMask):
        return PlainMask(values=m1.values & m2.values, nrows=m1.nrows)

    if isinstance(m1, RLEMask) and isinstance(m2, RLEMask):
        return prim.range_intersect_masks(m1, m2)

    if isinstance(m1, RLEMask) and isinstance(m2, PlainMask):
        if index_cap_hint is not None:
            pos, n = _rle_mask_to_index(m1, index_cap_hint)
            return _and_index_plain(IndexMask(positions=pos, n=n,
                                              nrows=m1.nrows), m2)
        cov = prim.rle_to_plain(None, m1.starts, m1.ends, m1.n, m1.nrows)
        return PlainMask(values=cov & m2.values, nrows=m1.nrows)

    if isinstance(m1, RLEMask) and isinstance(m2, IndexMask):
        # idx_in_rle vs rle_contain_idx chosen by relative (static) sizes.
        cap_out = m2.capacity
        if m2.capacity <= m1.capacity:
            pos, _, _, n = prim.idx_in_rle(
                m2.positions, m2.n, m1.starts, m1.ends, m1.n, m1.nrows, cap_out)
        else:
            pos, _, _, n = prim.rle_contain_idx(
                m2.positions, m2.n, m1.starts, m1.ends, m1.n, m1.nrows, cap_out)
        return IndexMask(positions=pos, n=n, nrows=m1.nrows)

    if isinstance(m1, IndexMask) and isinstance(m2, PlainMask):
        return _and_index_plain(m1, m2)

    if isinstance(m1, IndexMask) and isinstance(m2, IndexMask):
        if m1.capacity > m2.capacity:
            m1, m2 = m2, m1
        pos, _, _, n = prim.idx_in_idx(
            m1.positions, m1.n, m2.positions, m2.n, m1.nrows, m1.capacity)
        return IndexMask(positions=pos, n=n, nrows=m1.nrows)

    raise TypeError(f"AND not defined for {type(m1)}, {type(m2)}")


def _and_index_plain(mi: IndexMask, mp: PlainMask) -> IndexMask:
    """Plain AND Index: subscript the plain mask at index positions (§5.1)."""
    sel = take_fill(mp.values, mi.positions, False)
    keep = sel & valid_slots(mi.n, mi.capacity)
    (pos,), n = prim.compact(keep, (mi.positions,), mi.capacity, (mi.nrows,))
    return IndexMask(positions=pos, n=n, nrows=mi.nrows)


def _rle_mask_to_index(m: RLEMask, cap: int):
    _, pos, n = prim.rle_to_index(None, m.starts, m.ends, m.n, m.nrows, cap)
    return pos, n


def _and_composite(m1, m2, hint):
    """§5.4: (r1∨i1) ∧ (r2∨i2) expanded distributively, recombined.

    A Plain operand has no run/point parts to distribute over, so the AND
    is taken row-level (as ``_or_composite`` does for OR). The reference
    splits a PlainMask into (None, None) here and returns an empty mask;
    the port deliberately departs from it (ROADMAP queue C)."""
    if isinstance(m1, PlainMask) or isinstance(m2, PlainMask):
        return PlainMask(values=decode_mask(m1) & decode_mask(m2),
                         nrows=m1.nrows)
    r1, i1 = _split(m1)
    r2, i2 = _split(m2)
    rr = and_masks(r1, r2) if (r1 is not None and r2 is not None) else None
    ri = and_masks(r1, i2) if (r1 is not None and i2 is not None) else None
    ir = and_masks(i1, r2) if (i1 is not None and r2 is not None) else None
    ii = and_masks(i1, i2) if (i1 is not None and i2 is not None) else None
    idx = None
    for m in (ri, ir, ii):
        if m is not None:
            idx = m if idx is None else or_masks(idx, m)
    device = _mask_device(m1)
    return _combine(rr, idx, m1.nrows, device)


def _mask_device(m) -> torch.device:
    if isinstance(m, RLEIndexMask):
        return m.rle.starts.device
    if isinstance(m, RLEMask):
        return m.starts.device
    if isinstance(m, IndexMask):
        return m.positions.device
    return m.values.device


def _split(m):
    if isinstance(m, RLEIndexMask):
        return m.rle, m.idx
    if isinstance(m, RLEMask):
        return m, None
    if isinstance(m, IndexMask):
        return None, m
    if isinstance(m, PlainMask):
        return None, None  # handled before reaching here
    raise TypeError(type(m))


def _combine(rle_part, idx_part, nrows, device):
    if rle_part is None and idx_part is None:
        return IndexMask(positions=torch.full((1,), nrows, dtype=POS_DTYPE,
                                              device=device),
                         n=torch.zeros((), dtype=torch.int32, device=device),
                         nrows=nrows)
    if rle_part is None:
        return idx_part
    if idx_part is None:
        return rle_part
    if isinstance(idx_part, RLEMask):  # e.g. result of a NOT
        return or_masks(rle_part, idx_part)
    return RLEIndexMask(rle=rle_part, idx=idx_part, nrows=nrows)


# ---------------------------------------------------------------------------
# OR (paper §5.2, Tables 4-5)
# ---------------------------------------------------------------------------


def or_masks(m1, m2):
    """OR dispatch. Output encodings follow Table 5."""
    if isinstance(m1, RLEIndexMask) or isinstance(m2, RLEIndexMask):
        return _or_composite(m1, m2)
    if isinstance(m2, RLEMask) and not isinstance(m1, RLEMask):
        m1, m2 = m2, m1
    if isinstance(m2, PlainMask) and isinstance(m1, IndexMask):
        m1, m2 = m2, m1

    if isinstance(m1, PlainMask) and isinstance(m2, PlainMask):
        return PlainMask(values=m1.values | m2.values, nrows=m1.nrows)

    if isinstance(m1, RLEMask) and isinstance(m2, RLEMask):
        s, e, n = prim.range_union(
            m1.starts, m1.ends, m1.n, m2.starts, m2.ends, m2.n,
            m1.nrows, m1.capacity + m2.capacity)
        return RLEMask(starts=s, ends=e, n=n, nrows=m1.nrows)

    if isinstance(m1, RLEMask) and isinstance(m2, PlainMask):
        cov = prim.rle_to_plain(None, m1.starts, m1.ends, m1.n, m1.nrows)
        return PlainMask(values=cov | m2.values, nrows=m1.nrows)

    if isinstance(m1, RLEMask) and isinstance(m2, IndexMask):
        # Table 5: output RLE + Index. Index points already inside runs are
        # absorbed; the remainder stays Index.
        inside, _ = prim.idx_in_rle_mask(
            m2.positions, m2.n, m1.starts, m1.ends, m1.n)
        outside = valid_slots(m2.n, m2.capacity) & ~inside
        (pos,), n = prim.compact(outside, (m2.positions,), m2.capacity,
                                 (m2.nrows,))
        idx = IndexMask(positions=pos, n=n, nrows=m2.nrows)
        return RLEIndexMask(rle=m1, idx=idx, nrows=m1.nrows)

    if isinstance(m1, PlainMask) and isinstance(m2, IndexMask):
        vals = scatter_drop(m1.values, m2.positions, True, "set")
        return PlainMask(values=vals, nrows=m1.nrows)

    if isinstance(m1, IndexMask) and isinstance(m2, IndexMask):
        pos, n = prim.merge_sorted_idx(
            m1.positions, m1.n, m2.positions, m2.n, m1.nrows,
            m1.capacity + m2.capacity)
        return IndexMask(positions=pos, n=n, nrows=m1.nrows)

    raise TypeError(f"OR not defined for {type(m1)}, {type(m2)}")


def _or_composite(m1, m2):
    """§5.4: (r1∨i1) ∨ (r2∨i2) = (r1∨r2) ∨ (i1∨i2)."""
    r1, i1 = _split_or_plain(m1)
    r2, i2 = _split_or_plain(m2)
    if isinstance(m1, PlainMask) or isinstance(m2, PlainMask):
        return PlainMask(values=decode_mask(m1) | decode_mask(m2),
                         nrows=m1.nrows)
    rle = r1 if r2 is None else (r2 if r1 is None else or_masks(r1, r2))
    idx = i1 if i2 is None else (i2 if i1 is None else or_masks(i1, i2))
    return _combine(rle, idx, m1.nrows, _mask_device(m1))


def _split_or_plain(m):
    if isinstance(m, PlainMask):
        return None, None
    return _split(m)


# ---------------------------------------------------------------------------
# NOT (paper §5.3, Algorithms 6-7)
# ---------------------------------------------------------------------------


def not_mask(m):
    if isinstance(m, PlainMask):
        return PlainMask(values=~m.values, nrows=m.nrows)
    if isinstance(m, RLEMask):
        s, e, n = prim.complement_rle(m.starts, m.ends, m.n, m.nrows)
        return RLEMask(starts=s, ends=e, n=n, nrows=m.nrows)
    if isinstance(m, IndexMask):
        s, e, n = prim.complement_index(m.positions, m.n, m.nrows)
        return RLEMask(starts=s, ends=e, n=n, nrows=m.nrows)
    if isinstance(m, RLEIndexMask):
        # §5.4 De Morgan: ¬(rle ∨ idx) = ¬rle ∧ ¬idx (both RLE -> intersect).
        return and_masks(not_mask(m.rle), not_mask(m.idx))
    raise TypeError(type(m))
