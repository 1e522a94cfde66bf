"""Compressed-domain ordering: ORDER BY / TOP-K / LIMIT (DESIGN.md §10),
PyTorch port of ``repro.core.order``.

An RLE column of R runs sorts by sorting its R run entries — O(R log R),
not O(N log N) — and a bounded-domain key needs no comparison sort at
all: a presence histogram over the dense code domain plus one cumulative
sum yields exact row ranks (``primitives.rank_select_bounded``). Row-level
permutations are materialized only for the rows the output demands.

Three ranking paths, chosen per call from encodings + ingest metadata:

  * **bounded-domain**: every key integer-valued with ingest-recorded
    ``(lo, size)`` domains and a small mixed-radix product — histogram +
    cumsum ranks, one tiny ``O(limit)`` survivor sort, zero row sorts;
  * **entry sort**: position-explicit keys without usable domains — one
    stable argsort per key over ENTRIES (runs/points), then a cumulative
    row-count cutoff expands only the winning prefix;
  * **row-level**: Plain keys (or entry ordering disabled) — the dense
    int32 rank-key tensor goes through ``dispatch.topk`` (the CUDA
    ``topk_kernel`` on the card, the plain stable sort otherwise).

Tie semantics everywhere match pandas ``sort_values(kind="stable")``:
equal keys keep ascending row order, NaN keys rank last in both
directions. Float keys of the stable argsorts add 0.0 first, which maps
-0.0 to +0.0: the two then tie on every device's sort, as they do in
JAX's.

Partitioned execution merges per-partition top-k partials on the host
(``merge_ranked_partials``); partitions whose ORDER-BY-key zone map cannot
beat the current k-th best row are never transferred (partition.py).
Counts stay device tensors inside the program; ``host_block`` is where a
ranked partial's ``n`` is read on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import groupby as groupby_mod
from repro_torch.core import join as join_mod
from repro_torch.core import primitives as prim
from repro_torch.core.compress import next_pow2
from repro_torch.core.encodings import (
    IndexColumn,
    IndexMask,
    PlainColumn,
    PlainIndexColumn,
    RLEColumn,
    RLEIndexColumn,
    RLEMask,
    coverage,
    cumsum,
    decode_column,
    decode_mask,
    is_integer,
    valid_slots,
)
from repro_torch.device import to_numpy
from repro_torch.kernels import dispatch

_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)
# float32 rank keys (bit trick below) span [key(-inf), key(+inf)]; the band
# beneath key(-inf) is free for out-of-band classes:
_F32_INF_KEY = 0x7F800000
_NAN_RANK = -_F32_INF_KEY - 2  # strictly below every real float's key
_INVALID_RANK = _I32_MIN  # strictly below the NaN class


@dataclasses.dataclass(frozen=True)
class OrderedRows:
    """Device-side ranked-query result: the top-``n`` rows in rank order.

    ``positions[cap]`` are int32 row ids (partition-local under
    partitioned execution) with the sentinel ``nrows`` past ``n``;
    ``columns`` carries the gathered output values (stored/code space) at
    those rows. ``n`` is a 0-d int32 device tensor."""

    positions: torch.Tensor
    n: torch.Tensor
    columns: Dict[str, torch.Tensor]


@dataclasses.dataclass
class RankedTable:
    """Host-side finalized ranked result: exact-size arrays in rank order,
    dictionary codes decoded back to values."""

    positions: np.ndarray
    columns: Dict[str, np.ndarray]
    n: int


def _i32(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Rank-key transforms
# ---------------------------------------------------------------------------


def _f32_order_key(v: torch.Tensor) -> torch.Tensor:
    """Total-order-preserving float32 -> int32 bijection (radix-sort trick):
    ``key(a) < key(b)  <=>  a < b`` for all non-NaN floats, including
    infinities and signed zeros (-0.0 ranks just below +0.0). Every step
    stays in int32."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    flipped = torch.bitwise_xor(torch.bitwise_not(bits), _i32(_I32_MIN, bits))
    return torch.where(bits >= 0, bits, flipped)


def dense_rank_key(vals: torch.Tensor, live: torch.Tensor,
                   descending: bool) -> torch.Tensor:
    """int32 rank keys with LARGER = better (``dispatch.topk`` convention).

    Three totally ordered classes: live non-NaN values (direction applied),
    then NaN keys (pandas ``na_position='last'``), then dead rows — the
    float bit trick leaves the NaN band free, so no live row can collide
    with either sentinel class. Integer keys use the raw value (flipped by
    bitwise-not for ascending); a live value at the very edge of int32
    would tie the dead-row sentinel — the ingest value domain keeps real
    columns away from those edges (DESIGN.md §3)."""
    if vals.dtype.is_floating_point:
        nan = torch.isnan(vals)
        key = _f32_order_key(vals)
        if not descending:
            key = torch.bitwise_not(key)
        key = torch.where(nan, _i32(_NAN_RANK, key), key)
    else:
        key = vals.to(torch.int32)
        if not descending:
            key = torch.bitwise_not(key)
    return torch.where(live, key, _i32(_INVALID_RANK, key))


def _argsort_key_nan_last(perm: torch.Tensor, vals: torch.Tensor,
                          descending: bool) -> torch.Tensor:
    """Refine ``perm`` by one key: stable directional order with NaN keys
    strictly last (pandas ``na_position='last'``). Two stacked stable
    passes — value first, then the NaN flag — so NaNs cannot tie with
    genuine infinities."""
    v = vals[perm]
    if v.dtype.is_floating_point:
        v = v + 0.0  # -0.0 -> +0.0: the zeros tie, as in JAX's sort
    order = torch.argsort(v, stable=True, descending=descending)
    perm = perm[order]
    if vals.dtype.is_floating_point:
        nan_last = torch.argsort(torch.isnan(vals[perm]).to(torch.int32),
                                 stable=True)
        perm = perm[nan_last]
    return perm


# ---------------------------------------------------------------------------
# Top-k row selection
# ---------------------------------------------------------------------------


def _bounded_composite(view, by, descending, key_domains, pol):
    """Mixed-radix int32 rank code per entry (smaller = better), or None
    when any key lacks a usable ingest domain (mirrors the sort-free
    grouping gate, groupby._bounded_key_domain)."""
    if not key_domains:
        return None
    total = 1
    composite = None
    for name, desc in zip(by, descending):
        dom = key_domains.get(name)
        vals = view.values[name]
        if dom is None or not is_integer(vals.dtype):
            return None
        lo, size = int(dom[0]), int(dom[1])
        if lo < _I32_MIN or lo + size - 1 > _I32_MAX or size <= 0:
            return None
        total *= size
        if total > pol.sort_free_max_domain:
            return None
        code = vals.to(torch.int32) - _i32(lo, vals)
        if desc:
            code = _i32(size - 1, code) - code
        composite = code if composite is None else composite * size + code
    return composite, total


def _entry_perm(view, by, descending) -> torch.Tensor:
    """Entry permutation in rank order: one stable argsort per key, least
    significant first (iterated stable sorts == lexicographic order); the
    entry buffers are position-sorted, so ties keep ascending row order."""
    perm = torch.arange(view.starts.shape[0], device=view.starts.device)
    for name, desc in reversed(list(zip(by, descending))):
        perm = _argsort_key_nan_last(perm, view.values[name], desc)
    return perm


def _expand_prefix(starts, takes, cap_k: int, nrows: int):
    """Expand per-entry row quotas (entries already in rank order) into the
    output position list."""
    pos, _, pvalid, total = prim.range_arange_capped(starts, takes, cap_k)
    positions = torch.where(pvalid, pos, _i32(nrows, pos).to(pos.dtype))
    return positions, total.to(torch.int32)


def top_k_rows(cols: Dict[str, object], by: Sequence[str],
               descending: Sequence[bool], limit: int, mask=None,
               key_domains: Optional[Dict[str, Tuple[int, int]]] = None):
    """Positions of the top-``limit`` live rows under the multi-key order.

    Returns ``(positions[cap_k], n)`` with ``cap_k = next_pow2(limit, 8)``:
    int32 positions in rank order (sentinel ``nrows`` past ``n``),
    ``n = min(limit, live rows)`` as a 0-d int32 tensor. ``mask`` carries
    pipeline liveness; ``key_domains`` (ingest ``(lo, size)`` metadata)
    unlocks the histogram-rank path.
    """
    by = list(by)
    descending = list(descending)
    nrows = cols[by[0]].nrows
    limit_n = max(1, min(int(limit), nrows)) if nrows else 1
    cap_k = next_pow2(limit_n, 8)
    pol = dispatch.policy()

    entry_ok = (pol.enable_entry_order
                and all(isinstance(cols[b], (RLEColumn, IndexColumn))
                        for b in by)
                and (mask is None or isinstance(mask, (RLEMask, IndexMask))))

    if not entry_ok:
        # row-level: decode keys (the paper's baseline granularity)
        if len(by) == 1:
            col = cols[by[0]]
            live = coverage(col)
            if mask is not None:
                live = live & decode_mask(mask)
            key = dense_rank_key(decode_column(col), live, descending[0])
            kk = min(cap_k, nrows) if nrows else 1
            _, ridx = dispatch.topk(key, kk)
            n = torch.minimum(_i32(limit_n, live),
                              live.sum(dtype=torch.int32))
            slot = torch.arange(kk, dtype=torch.int32, device=live.device)
            positions = torch.where(slot < n, ridx.to(torch.int32),
                                    _i32(nrows, live))
            if kk < cap_k:
                positions = torch.cat([positions, torch.full(
                    (cap_k - kk,), nrows, dtype=torch.int32,
                    device=live.device)])
            return positions, n
        plain = {b: PlainColumn(values=decode_column(cols[b]),
                                nrows=cols[b].nrows) for b in by}
        view = groupby_mod.align_columns(plain, mask=mask)
    else:
        view = groupby_mod.align_columns({b: cols[b] for b in by}, mask=mask)

    bounded = None if not entry_ok else _bounded_composite(
        view, by, descending, key_domains, pol)
    if bounded is not None:
        composite, domain = bounded
        take, total = prim.rank_select_bounded(
            composite, view.lengths, view.valid, domain, limit_n)
        # <= limit_n entries carry a nonzero take (rank_select_bounded's
        # contract), so the survivor compaction can never overflow
        cap_s = next_pow2(limit_n, 8)
        (code_s, start_s, take_s), _ = prim.compact(
            take > 0, (composite, view.starts, take), cap_s,
            (domain, nrows, 0))
        order = torch.argsort(code_s, stable=True)  # tiny: O(limit) entries
        positions, _ = _expand_prefix(start_s[order], take_s[order],
                                      cap_k, nrows)
        return positions, total

    perm = _entry_perm(view, by, descending)
    lens = view.lengths[perm].to(torch.int32)
    rows_before = cumsum(lens) - lens
    take = torch.minimum(torch.clamp(_i32(limit_n, lens) - rows_before,
                                     min=0), lens)
    return _expand_prefix(view.starts[perm], take, cap_k, nrows)


def gather_at(col, positions: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Fetch a column's values at ranked row positions (k-sized output;
    composite encodings decode first — the output is row-granular anyway)."""
    if isinstance(col, (PlainIndexColumn, RLEIndexColumn)):
        col = PlainColumn(values=decode_column(col), nrows=col.nrows)
    valid = valid_slots(n, positions.shape[0])
    return join_mod.gather_rows(col, positions, valid)


# ---------------------------------------------------------------------------
# Ordering a group-by result (ORDER BY over aggregate outputs / group keys)
# ---------------------------------------------------------------------------


def rank_groupby(res, by: Sequence[str], descending: Sequence[bool],
                 limit: Optional[int]):
    """Reorder a ``GroupByResult``'s slots by group keys and/or aggregate
    outputs, keeping the first ``limit`` groups. Group slots are already in
    lexicographic key order, so ties fall back to key order — matching a
    pandas ``groupby().agg().sort_values(kind="stable")`` oracle."""
    cap = res.valid.shape[0]
    arrays = {**res.keys, **res.aggs}
    missing = [b for b in by if b not in arrays]
    if missing:
        raise KeyError(f"order_by after groupby: {missing!r} name neither a "
                       "group key nor an aggregate output")
    dev = res.valid.device
    perm = torch.arange(cap, device=dev)
    for name, desc in reversed(list(zip(by, descending))):
        perm = _argsort_key_nan_last(perm, arrays[name], desc)
    # most-significant pass: valid groups first (stable)
    order = torch.argsort((~res.valid[perm]).to(torch.int32), stable=True)
    perm = perm[order]
    ng = res.num_groups if limit is None else torch.minimum(
        res.num_groups, _i32(int(limit), res.num_groups))
    gvalid = torch.arange(cap, dtype=torch.int32, device=dev) < ng

    def reorder(v):
        return torch.where(gvalid, v[perm], torch.zeros((), dtype=v.dtype,
                                                        device=dev))

    return groupby_mod.GroupByResult(
        keys={k: reorder(v) for k, v in res.keys.items()},
        aggs={k: reorder(v) for k, v in res.aggs.items()},
        num_groups=ng, valid=gvalid)


# ---------------------------------------------------------------------------
# Host-side distributed merge (partitioned execution, DESIGN.md §4/§10)
# ---------------------------------------------------------------------------


def _np_sort_key(v: np.ndarray, descending: bool) -> np.ndarray:
    """np.lexsort key with direction applied; NaN sorts last either way
    (negating a float keeps NaN in place under numpy's NaN-last sorts)."""
    v = np.asarray(v)
    if not descending:
        return v
    if v.dtype.kind == "f":
        return -v
    return -v.astype(np.int64)


def host_block(res: OrderedRows, row_offset: int = 0):
    """Bring one partition's ranked partial to the host: exact-size arrays,
    positions globalized by the partition's row offset. Reading ``n`` here
    waits for the partial's device work (the streamed executor calls this
    in its fold, after the partial's event)."""
    n = int(res.n)
    return {
        "positions": to_numpy(res.positions)[:n].astype(np.int64)
        + row_offset,
        "columns": {k: to_numpy(v)[:n] for k, v in res.columns.items()},
    }


def ranked_kth_bound(state, key: str, descending: bool,
                     limit: Optional[int]):
    """The current k-th-best primary-key bound of a merged ranked state, in
    "larger = better" orientation, or ``None`` while fewer than ``limit``
    candidates are held (no pruning power yet).

    The bound tightens monotonically as partials merge — the invariant the
    pipelined ranked executor's speculative prefetch relies on
    (``stream.pipelined_ranked_fold``): a partition prunable under an older
    bound stays prunable under every later one.
    """
    if (limit is None or state is None
            or len(state["positions"]) < int(limit)):
        return None
    kth = state["columns"][key][-1]
    return kth if descending else -kth


def merge_ranked_partials(state, block, by: Sequence[str],
                          descending: Sequence[bool], limit: Optional[int]):
    """Classic distributed top-k merge: fold one partition's top-k partial
    into the running candidate set and re-truncate to ``limit``.

    The global top-k is contained in the union of per-partition top-k's,
    so merging partials in ANY partition order yields the exact result;
    ties across partitions resolve by global row id (the single-table
    stable order).
    """
    if state is None:
        merged = block
    else:
        merged = {
            "positions": np.concatenate([state["positions"],
                                         block["positions"]]),
            "columns": {k: np.concatenate([state["columns"][k],
                                           block["columns"][k]])
                        for k in state["columns"]},
        }
    keys = tuple(_np_sort_key(merged["columns"][b], d)
                 for b, d in zip(by, descending))
    order = np.lexsort((merged["positions"],) + tuple(reversed(keys)))
    if limit is not None:
        order = order[:int(limit)]
    return {
        "positions": merged["positions"][order],
        "columns": {k: v[order] for k, v in merged["columns"].items()},
    }


def ranked_table_from_state(state, dictionaries: Dict[str, np.ndarray]):
    """Finalize a merged candidate state: decode dictionary codes (clipped
    to the dictionary)."""
    cols = {}
    for name, vals in state["columns"].items():
        d = dictionaries.get(name)
        if d is not None and len(d):
            codes = np.clip(np.asarray(vals, np.int64), 0, len(d) - 1)
            cols[name] = d[codes]
        else:
            cols[name] = vals
    return RankedTable(positions=state["positions"], columns=cols,
                       n=len(state["positions"]))


def rank_merged_groupby(merged, by: Sequence[str],
                        descending: Sequence[bool], limit: Optional[int]):
    """Order a host-merged ``MergedGroupBy`` (partitioned group-by) by
    group keys / aggregate outputs; ties keep lexicographic key order
    (np.lexsort is stable)."""
    arrays = {**merged.keys, **merged.aggs}
    missing = [b for b in by if b not in arrays]
    if missing:
        raise KeyError(f"order_by after groupby: {missing!r} name neither a "
                       "group key nor an aggregate output")
    keys = tuple(_np_sort_key(arrays[b], d) for b, d in zip(by, descending))
    order = np.lexsort(tuple(reversed(keys))) if keys else np.arange(
        merged.num_groups)
    if limit is not None:
        order = order[:int(limit)]
    return groupby_mod.MergedGroupBy(
        keys={g: np.asarray(v)[order] for g, v in merged.keys.items()},
        aggs={a: np.asarray(v)[order] for a, v in merged.aggs.items()},
        num_groups=len(order))
