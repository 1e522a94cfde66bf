"""Arithmetic, comparison and selection on encoded DataColumns (paper §6).

PyTorch port of ``repro.core.arithmetic``. Point-wise binary operations
require *Alignment*: positional representations of both operands are
aligned (runs split, values duplicated), then the op is applied to the
aligned value tensors. Scalar operands need no alignment — the op applies
to value tensors directly, preserving the encoding (``c * 2`` on an RLE
column touches only #runs elements).
"""
from __future__ import annotations

import operator
from typing import Callable

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.core.encodings import (
    IndexColumn,
    IndexMask,
    PackedColumn,
    PlainColumn,
    PlainIndexColumn,
    PlainMask,
    RLEColumn,
    RLEIndexColumn,
    RLEIndexMask,
    RLEMask,
    coverage,
    decode_column,
    decode_mask,
    is_integer,
    offset_is_zero,
    scatter_drop,
    take_clamped,
    take_fill,
    unpack_values,
    valid_slots,
)

OPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
}
_CMP = {"lt", "le", "gt", "ge", "eq", "ne"}


def _fn(op) -> Callable:
    return OPS[op] if isinstance(op, str) else op


def _widen_for(v: torch.Tensor, literal) -> torch.Tensor:
    """Widen a narrow integer tensor to int32 when an integer literal lies
    outside its range: torch casts the literal to the tensor's dtype and
    wraps it (``int8 < 300`` is all False), where JAX refuses the
    literal."""
    if (isinstance(literal, (int, np.integer)) and not isinstance(literal, bool)
            and v.dtype in (torch.int8, torch.int16, torch.uint8)):
        info = torch.iinfo(v.dtype)
        if not info.min <= int(literal) <= info.max:
            return v.to(torch.int32)
    return v


def _zero_where_not(valid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``jnp.where(valid, vals, 0)``: a weak int 0 promotes bool to int32."""
    if vals.dtype == torch.bool:
        vals = vals.to(torch.int32)
    return torch.where(valid, vals, torch.zeros_like(vals))


# ---------------------------------------------------------------------------
# Scalar operand: operate on value tensors, encoding preserved (paper §6)
# ---------------------------------------------------------------------------


def scalar_op(col, op, scalar):
    """col <op> scalar with no alignment; preserves the encoding."""
    f = _fn(op)
    if isinstance(col, PlainColumn):
        return PlainColumn(values=f(_widen_for(col.decode(), scalar), scalar),
                           nrows=col.nrows)
    if isinstance(col, RLEColumn):
        return RLEColumn(values=f(_widen_for(unpack_values(col.values),
                                             scalar), scalar),
                         starts=col.starts, ends=col.ends, n=col.n,
                         nrows=col.nrows)
    if isinstance(col, IndexColumn):
        return IndexColumn(values=f(_widen_for(unpack_values(col.values),
                                               scalar), scalar),
                           positions=col.positions, n=col.n, nrows=col.nrows)
    if isinstance(col, PlainIndexColumn):
        return PlainColumn(values=f(decode_column(col), scalar),
                           nrows=col.nrows)
    if isinstance(col, RLEIndexColumn):
        return RLEIndexColumn(rle=scalar_op(col.rle, op, scalar),
                              idx=scalar_op(col.idx, op, scalar),
                              nrows=col.nrows)
    raise TypeError(type(col))


# ---------------------------------------------------------------------------
# Comparison against a literal -> MaskColumn in the column's encoding
# ---------------------------------------------------------------------------


def compare(col, op, literal):
    """Predicate evaluation (paper §6 + App. D composite-predicate rule).

    For RLE the comparison runs on the *run values* only — whole runs are
    selected/deselected at once."""
    f = _fn(op)
    if isinstance(col, PlainColumn):
        return PlainMask(values=f(_widen_for(col.decode(), literal), literal),
                         nrows=col.nrows)
    if isinstance(col, RLEColumn):
        keep = (f(_widen_for(unpack_values(col.values), literal), literal)
                & valid_slots(col.n, col.capacity))
        (s, e), n = prim.compact(
            keep, (unpack_values(col.starts), unpack_values(col.ends)),
            col.capacity, (col.nrows, col.nrows))
        return RLEMask(starts=s, ends=e, n=n, nrows=col.nrows)
    if isinstance(col, IndexColumn):
        keep = (f(_widen_for(unpack_values(col.values), literal), literal)
                & valid_slots(col.n, col.capacity))
        (p,), n = prim.compact(keep, (unpack_values(col.positions),),
                               col.capacity, (col.nrows,))
        return IndexMask(positions=p, n=n, nrows=col.nrows)
    if isinstance(col, PlainIndexColumn):
        # evaluate on the centered narrow base, then patch outlier positions
        if isinstance(col.base.values, PackedColumn):
            base_mask = f(col.base.decode(), literal)
        elif (is_integer(col.base.values.dtype)
                and not offset_is_zero(col.base.offset)):
            # the reference widens with astype(int64), which is int32 with
            # 64-bit mode off
            base_mask = f(col.base.values.to(torch.int32) + col.base.offset,
                          literal)
        else:
            base_mask = f(_widen_for(col.base.values, literal), literal)
        out_mask = f(_widen_for(unpack_values(col.outliers.values), literal),
                     literal)
        vals = scatter_drop(base_mask, unpack_values(col.outliers.positions),
                            out_mask, "set")
        return PlainMask(values=vals, nrows=col.nrows)
    if isinstance(col, RLEIndexColumn):
        mr = compare(col.rle, op, literal)
        mi = compare(col.idx, op, literal)
        return RLEIndexMask(rle=mr, idx=mi, nrows=col.nrows)
    raise TypeError(type(col))


def compare_range(col, lo, hi, lo_incl=True, hi_incl=True):
    """Fused range predicate lo <?< col <?< hi (App. D: evaluate all
    predicates on the RLE value tensor once, apply to positions once)."""
    f_lo = operator.ge if lo_incl else operator.gt
    f_hi = operator.le if hi_incl else operator.lt
    if isinstance(col, RLEColumn):
        v = _widen_for(_widen_for(unpack_values(col.values), lo), hi)
        keep = f_lo(v, lo) & f_hi(v, hi) & valid_slots(col.n, col.capacity)
        (s, e), n = prim.compact(
            keep, (unpack_values(col.starts), unpack_values(col.ends)),
            col.capacity, (col.nrows, col.nrows))
        return RLEMask(starts=s, ends=e, n=n, nrows=col.nrows)
    if isinstance(col, IndexColumn):
        v = _widen_for(_widen_for(unpack_values(col.values), lo), hi)
        keep = f_lo(v, lo) & f_hi(v, hi) & valid_slots(col.n, col.capacity)
        (p,), n = prim.compact(keep, (unpack_values(col.positions),),
                               col.capacity, (col.nrows,))
        return IndexMask(positions=p, n=n, nrows=col.nrows)
    from repro_torch.core.logical import and_masks
    return and_masks(compare(col, f_lo, lo), compare(col, f_hi, hi))


# ---------------------------------------------------------------------------
# Alignment + binary op between two columns (paper §6, Example 5)
# ---------------------------------------------------------------------------


def binary_op(c1, c2, op):
    """c1 <op> c2 aligned point-wise over positions common to both columns.

    Output encodings: RLE×RLE -> RLE (runs split at misalignment points);
    anything×Index -> Index; anything involving Plain -> Plain. Rows outside
    the common coverage hold 0 — liveness is tracked by the plan-level mask.
    """
    f = _fn(op)
    if isinstance(c1, PlainIndexColumn):
        c1 = PlainColumn(values=decode_column(c1), nrows=c1.nrows)
    if isinstance(c2, PlainIndexColumn):
        c2 = PlainColumn(values=decode_column(c2), nrows=c2.nrows)
    if isinstance(c1, RLEIndexColumn) or isinstance(c2, RLEIndexColumn):
        c1 = PlainColumn(values=decode_column(c1), nrows=c1.nrows)
        c2 = PlainColumn(values=decode_column(c2), nrows=c2.nrows)

    if isinstance(c1, PlainColumn) and isinstance(c2, PlainColumn):
        return PlainColumn(values=f(c1.decode(), c2.decode()), nrows=c1.nrows)

    if isinstance(c1, RLEColumn) and isinstance(c2, RLEColumn):
        cap_out = c1.capacity + c2.capacity
        s, e, i1, i2, n = prim.range_intersect(
            unpack_values(c1.starts), unpack_values(c1.ends), c1.n,
            unpack_values(c2.starts), unpack_values(c2.ends), c2.n,
            c1.nrows, cap_out)
        vals = f(unpack_values(c1.values)[i1], unpack_values(c2.values)[i2])
        vals = _zero_where_not(valid_slots(n, cap_out), vals)
        return RLEColumn(values=vals, starts=s, ends=e, n=n, nrows=c1.nrows)

    if isinstance(c1, RLEColumn) and isinstance(c2, IndexColumn):
        return _rle_op_index(c1, c2, f, swap=False)
    if isinstance(c1, IndexColumn) and isinstance(c2, RLEColumn):
        return _rle_op_index(c2, c1, f, swap=True)

    if isinstance(c1, IndexColumn) and isinstance(c2, IndexColumn):
        cap_out = min(c1.capacity, c2.capacity)
        pos, s1, s2, n = prim.idx_in_idx(
            unpack_values(c1.positions), c1.n, unpack_values(c2.positions),
            c2.n, c1.nrows, cap_out)
        vals = f(unpack_values(c1.values)[s1], unpack_values(c2.values)[s2])
        vals = _zero_where_not(valid_slots(n, cap_out), vals)
        return IndexColumn(values=vals, positions=pos, n=n, nrows=c1.nrows)

    # Plain × RLE / Plain × Index -> per-row result
    if isinstance(c1, PlainColumn) and isinstance(c2, RLEColumn):
        return PlainColumn(values=f(c1.decode(), decode_column(c2)),
                           nrows=c1.nrows)
    if isinstance(c1, RLEColumn) and isinstance(c2, PlainColumn):
        return PlainColumn(values=f(decode_column(c1), c2.decode()),
                           nrows=c1.nrows)
    if isinstance(c1, PlainColumn) and isinstance(c2, IndexColumn):
        pos2 = unpack_values(c2.positions)
        vals = f(take_clamped(c1.decode(), pos2), unpack_values(c2.values))
        vals = _zero_where_not(valid_slots(c2.n, c2.capacity), vals)
        return IndexColumn(values=vals, positions=pos2, n=c2.n, nrows=c1.nrows)
    if isinstance(c1, IndexColumn) and isinstance(c2, PlainColumn):
        pos1 = unpack_values(c1.positions)
        vals = f(unpack_values(c1.values), take_clamped(c2.decode(), pos1))
        vals = _zero_where_not(valid_slots(c1.n, c1.capacity), vals)
        return IndexColumn(values=vals, positions=pos1, n=c1.n, nrows=c1.nrows)

    raise TypeError(f"binary_op not defined for {type(c1)}, {type(c2)}")


def _rle_op_index(cr: RLEColumn, ci: IndexColumn, f, swap: bool) -> IndexColumn:
    """RLE <op> Index: common positions are the index points inside runs."""
    ci_pos = unpack_values(ci.positions)
    mask, run_id = prim.idx_in_rle_mask(
        ci_pos, ci.n, unpack_values(cr.starts), unpack_values(cr.ends), cr.n)
    rv = unpack_values(cr.values)[run_id]
    iv = unpack_values(ci.values)
    vals = f(iv, rv) if swap else f(rv, iv)
    (pos, v), n = prim.compact(mask, (ci_pos, vals), ci.capacity, (ci.nrows, 0))
    return IndexColumn(values=v, positions=pos, n=n, nrows=cr.nrows)


# ---------------------------------------------------------------------------
# Selection: apply a MaskColumn to a DataColumn (paper §6 last paragraph)
# ---------------------------------------------------------------------------


def apply_mask(col, mask):
    """Restrict a column to masked positions. For RLE/Index columns the
    alignment *is* the selection (gaps appear; no data movement for rows)."""
    if isinstance(mask, RLEIndexMask):
        a = apply_mask(col, mask.rle)
        b = apply_mask(col, mask.idx)
        return _merge_disjoint(a, b)
    if isinstance(col, (PlainIndexColumn, RLEIndexColumn)):
        col = PlainColumn(values=decode_column(col), nrows=col.nrows)

    if isinstance(col, PlainColumn):
        if isinstance(mask, PlainMask):
            return PlainColumn(values=_zero_where_not(mask.values, col.decode()),
                               nrows=col.nrows)
        if isinstance(mask, IndexMask):
            vals = take_fill(col.decode(), mask.positions, 0)
            vals = _zero_where_not(valid_slots(mask.n, mask.capacity), vals)
            return IndexColumn(values=vals, positions=mask.positions, n=mask.n,
                               nrows=col.nrows)
        if isinstance(mask, RLEMask):
            cov = decode_mask(mask)
            return PlainColumn(values=_zero_where_not(cov, col.decode()),
                               nrows=col.nrows)

    if isinstance(col, RLEColumn):
        if isinstance(mask, RLEMask):
            cap_out = col.capacity + mask.capacity
            s, e, i1, _, n = prim.range_intersect(
                unpack_values(col.starts), unpack_values(col.ends), col.n,
                mask.starts, mask.ends, mask.n, col.nrows, cap_out)
            vals = _zero_where_not(valid_slots(n, cap_out),
                                   unpack_values(col.values)[i1])
            return RLEColumn(values=vals, starts=s, ends=e, n=n,
                             nrows=col.nrows)
        if isinstance(mask, IndexMask):
            m, run_id = prim.idx_in_rle_mask(
                mask.positions, mask.n, unpack_values(col.starts),
                unpack_values(col.ends), col.n)
            vals = unpack_values(col.values)[run_id]
            (pos, v), n = prim.compact(m, (mask.positions, vals),
                                       mask.capacity, (mask.nrows, 0))
            return IndexColumn(values=v, positions=pos, n=n, nrows=col.nrows)
        if isinstance(mask, PlainMask):
            cov = decode_mask(mask) & coverage(col)
            return PlainColumn(values=_zero_where_not(cov, decode_column(col)),
                               nrows=col.nrows)

    if isinstance(col, IndexColumn):
        cpos = unpack_values(col.positions)
        cvals = unpack_values(col.values)
        if isinstance(mask, RLEMask):
            m, _ = prim.idx_in_rle_mask(cpos, col.n, mask.starts, mask.ends,
                                        mask.n)
            (pos, v), n = prim.compact(m, (cpos, cvals), col.capacity,
                                       (col.nrows, 0))
            return IndexColumn(values=v, positions=pos, n=n, nrows=col.nrows)
        if isinstance(mask, IndexMask):
            pos, s1, _, n = prim.idx_in_idx(
                cpos, col.n, mask.positions, mask.n, col.nrows, col.capacity)
            vals = _zero_where_not(valid_slots(n, col.capacity), cvals[s1])
            return IndexColumn(values=vals, positions=pos, n=n, nrows=col.nrows)
        if isinstance(mask, PlainMask):
            sel = take_fill(mask.values, cpos, False)
            keep = sel & valid_slots(col.n, col.capacity)
            (pos, v), n = prim.compact(keep, (cpos, cvals), col.capacity,
                                       (col.nrows, 0))
            return IndexColumn(values=v, positions=pos, n=n, nrows=col.nrows)

    raise TypeError(f"apply_mask not defined for {type(col)}, {type(mask)}")


def _merge_disjoint(a, b):
    """Merge two disjoint-position encoded columns (RLE+Index composite)."""
    if isinstance(a, RLEColumn) and isinstance(b, IndexColumn):
        return RLEIndexColumn(rle=a, idx=b, nrows=a.nrows)
    if isinstance(a, IndexColumn) and isinstance(b, RLEColumn):
        return RLEIndexColumn(rle=b, idx=a, nrows=a.nrows)
    if isinstance(a, PlainColumn) and isinstance(b, PlainColumn):
        return PlainColumn(values=a.decode() + b.decode(), nrows=a.nrows)
    if isinstance(a, IndexColumn) and isinstance(b, IndexColumn):
        pos = torch.cat([a.positions, b.positions])
        vals = torch.cat([a.values, b.values])
        order = torch.argsort(pos, stable=True)
        return IndexColumn(values=vals[order], positions=pos[order],
                           n=a.n + b.n, nrows=a.nrows)
    va = decode_column(a)
    vb = decode_column(b)
    ca = coverage(a)
    return PlainColumn(values=torch.where(ca, va, vb.to(va.dtype)),
                       nrows=a.nrows)
