"""Partitioned out-of-core query execution (DESIGN.md §4, paper §2.1/§9),
PyTorch port of ``repro.core.partition``.

The paper's headline scenario is querying compressed data whose
UNCOMPRESSED form would not fit device memory:

  * ``PartitionedTable`` — row-range partitions, each a host-resident
    ``Table`` (pinned host tensors when the query device is CUDA) with
    per-partition heterogeneous encodings chosen by the §9 heuristics,
    plus host-side per-partition min/max *zone maps*,
  * predicate pushdown / partition skipping — a partition whose zone maps
    prove a query's filters, semi-joins and PK-FK join key sets select
    nothing is never transferred to the device,
  * ``PartitionedQuery`` — streams the query program partition by
    partition through the depth-``k`` pipeline in ``core/stream.py`` and
    folds decomposable aggregate partials incrementally (DESIGN.md §12).

Transfers: each partition's tensors are copied with ``non_blocking=True``
from pinned host memory on one dedicated CUDA copy stream per run, and an
event is recorded after the copies. The compute stream waits on that
event before the partition's program runs, and every transferred tensor
is marked ``record_stream(compute stream)``, so the caching allocator
never hands a retired partition's block to a later copy while a kernel
still reads it. On ``device="cpu"`` nothing is pinned and the copy
stream is absent (the transfer is a host copy).

What the reference's jit and donation become here, eagerly:
  * ``trace_count`` counts *programs built*: one per ``PartitionedQuery``
    (the reference counts jit retraces, which have no eager meaning).
  * Donation: a retired partition's device tensors lose their last
    reference once its partial is dispatched, so the allocator recycles
    their memory for the next copies instead of holding every streamed
    partition until the run ends.
  * The base mask excluding pow2 padding rows is built on the device from
    the partition's real row count.

Ranked terminals (ORDER BY / TOP-K, DESIGN.md §10): a row-terminal
``order_by`` runs the distributed top-k merge (``_run_ranked``) over
``stream.pipelined_ranked_fold``, visiting partitions best zone first and
never transferring one whose ORDER-BY-key zone map cannot beat the
current k-th best row (ranked zone-map pruning); ``groupby`` +
``order_by`` ranks the host-merged groups (``order.rank_merged_groupby``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import compress, groupby
from repro_torch.core import order as order_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import stream
from repro_torch.core import telemetry
from repro_torch.core.encodings import RLEMask, map_tensors, tensor_leaves
from repro_torch.core.plan import (
    And,
    Not,
    Or,
    Pred,
    Query,
    RangePred,
    _AggOp,
    _FilterOp,
    _JoinOp,
    _MapOp,
    _OrderByOp,
    _SemiJoinOp,
)
from repro_torch.core import table as table_mod
from repro_torch.core.stream import Pending
from repro_torch.core.table import Table, dictionary_pass
from repro_torch.device import resolve_device

MIN_PARTITION_BUCKET = 8  # floor for padded per-partition row counts


def device_put(tree, device: torch.device):
    """Copy every tensor of ``tree`` to ``device``: ``non_blocking`` on a
    CUDA device (the sources are pinned), a real copy on the CPU. The
    host->device transfer entry point; module-level so tests can stub it
    to count and observe transfers."""
    if device.type == "cuda":
        return map_tensors(lambda t: t.to(device, non_blocking=True), tree)
    return map_tensors(lambda t: t.to(device, copy=True), tree)


def _put_columns(columns, device: torch.device,
                 copy_stream: Optional["torch.cuda.Stream"] = None
                 ) -> Pending:
    """Transfer one partition's column tree in ONE ``device_put`` call and
    return it with the CUDA event recorded after its copies.

    The copies are issued on ``copy_stream`` (entered here, on the calling
    thread: the current stream is thread-local, and the prefetch ring
    calls this from its worker thread). Every call books one transfer
    with the telemetry registry (``record_h2d``: the always-on
    ``h2d_calls``/``h2d_bytes`` counters plus any scoped listeners), the
    single source of truth for H2D accounting. Its bytes are the bulk
    buffers' (0-d counts ride along uncounted, as in the reference)."""
    bulk = [t for t in tensor_leaves(columns) if t.dim() != 0]
    telemetry.record_h2d(sum(t.numel() * t.element_size() for t in bulk),
                         bulk)
    if device.type != "cuda":
        return Pending(device_put(columns, device))
    with torch.cuda.device(device), torch.cuda.stream(copy_stream):
        cols = device_put(columns, device)
        done = torch.cuda.Event()
        done.record()
    return Pending(cols, done)


@dataclasses.dataclass
class Partition:
    """One row range of a PartitionedTable, encoded and host-resident."""

    table: Table  # encoded columns with host (CPU, pinned for CUDA) tensors
    rows: int  # valid rows (before padding)
    padded_rows: int  # pow2-bucketed row count of the encoded buffers
    row_offset: int  # first global row covered
    zone_lo: Dict[str, float]  # per-column min over valid rows
    zone_hi: Dict[str, float]  # per-column max over valid rows

    def nbytes(self) -> int:
        return self.table.nbytes()


def _pad_to_bucket(arrays: Dict[str, np.ndarray], rows: int, padded: int):
    """Pad each column to ``padded`` rows by replicating the last row.

    Replication extends the final run of every column instead of introducing
    new runs/values, so it is free under RLE and inside the zone maps.
    """
    if padded == rows:
        return arrays
    out = {}
    for name, arr in arrays.items():
        tail = np.repeat(arr[-1:], padded - rows, axis=0)
        out[name] = np.concatenate([arr, tail])
    return out


class PartitionedTable:
    """Row-partitioned table: host-side partitions + global dictionaries.

    Duck-types the slice of the ``Table`` interface the plan layer touches
    (``encoding_of`` / ``code_for`` / ``nrows`` / ``device``), so
    ``Query``'s predicate reordering and dictionary-literal resolution
    work unchanged. ``device`` is where queries over it run.
    """

    def __init__(self, partitions: List[Partition],
                 dictionaries: Dict[str, np.ndarray], nrows: int,
                 domains: Optional[Dict[str, tuple]] = None,
                 col_dtypes: Optional[Dict[str, np.dtype]] = None,
                 budget_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.partitions = partitions
        self.dictionaries = dictionaries
        self.nrows = nrows
        # GLOBAL (cross-partition) value domains: the program is shared by
        # every partition, so any (lo, size) it relies on must hold for all
        self.domains = domains or {}
        # ingest dtypes (post-dictionary, post-float64-narrowing): the
        # partial-merge identity elements derive from these (plan.py)
        self.col_dtypes = col_dtypes or {}
        # device-memory budget the partitions were sized for (None =
        # undeclared): the streamed executor clamps its prefetch ring's
        # in-flight bytes against it (stream.clamp_depth)
        self.budget_bytes = budget_bytes
        self.device = torch.device("cpu") if device is None else device

    @classmethod
    def from_arrays(
        cls,
        data: Dict[str, np.ndarray],
        cfg: compress.CompressionConfig = compress.CompressionConfig(),
        num_partitions: Optional[int] = None,
        partition_rows: Optional[int] = None,
        boundaries: Optional[Sequence[int]] = None,
        encodings: Optional[Dict[str, str]] = None,
        pack: Optional[bool] = None,
        budget_bytes: Optional[int] = None,
        device=None,
    ) -> "PartitionedTable":
        """Ingest host arrays into row-range partitions for queries on
        ``device`` (None: the CUDA device, raising when there is none).

        Exactly one of ``num_partitions`` / ``partition_rows`` /
        ``boundaries`` / ``budget_bytes`` selects the split; ``boundaries``
        is a sorted list of cut offsets strictly inside (0, nrows), and
        ``budget_bytes`` derives ``partition_rows`` via ``rows_for_budget``
        (accounting for the dispatch policy's ``prefetch_depth`` in-flight
        copies). ``budget_bytes`` may ALSO accompany an explicit split: it
        is then only recorded so the streamed executor can clamp its
        prefetch ring against it. Encodings are chosen (or forced via
        ``encodings``) independently PER PARTITION.

        ``pack=True`` (or ``cfg.pack``) bit-packs integer buffers
        (DESIGN.md §11) at the width of the GLOBAL value domains, so every
        partition shares one bit width per column and the transfers move
        the packed words. The partitions stay in host memory, pinned when
        ``device`` is CUDA so their copies can run asynchronously.
        """
        dev = resolve_device(device)
        data, dicts = dictionary_pass(data)
        # narrow to the device value domain BEFORE zone maps: pruning must
        # agree with the float32 values the device compares
        data = {k: v.astype(np.float32) if v.dtype == np.float64 else v
                for k, v in data.items()}
        n = len(next(iter(data.values()))) if data else 0
        domains = {}
        for name, arr in data.items():
            dom = compress.column_domain(arr, dicts.get(name))
            if dom is not None:
                domains[name] = dom
        col_dtypes = {name: np.asarray(arr).dtype for name, arr in data.items()}
        if cfg.capacity_bucket is None:
            cfg = dataclasses.replace(cfg, capacity_bucket="pow2")
        if pack is not None:
            cfg = dataclasses.replace(cfg, pack=pack)
        if (budget_bytes is not None and num_partitions is None
                and partition_rows is None and boundaries is None):
            from repro_torch.kernels import dispatch
            partition_rows = rows_for_budget(
                data, budget_bytes, pack=cfg.pack,
                prefetch_depth=dispatch.policy().prefetch_depth)
        offsets = _partition_offsets(n, num_partitions, partition_rows,
                                     boundaries)
        parts = []
        for start, end in zip(offsets[:-1], offsets[1:]):
            rows = end - start
            sliced = {k: v[start:end] for k, v in data.items()}
            zones = {k: compress.column_minmax(v) for k, v in sliced.items()}
            zone_lo = {k: z[0] for k, z in zones.items()}
            zone_hi = {k: z[1] for k, z in zones.items()}
            padded = compress.next_pow2(rows, MIN_PARTITION_BUCKET) if rows else 0
            sliced = _pad_to_bucket(sliced, rows, padded)
            # encode on the host: out-of-core data never round-trips
            # through the device at ingest; the query's transfer is the
            # first copy to the card
            t = Table.from_arrays(sliced, cfg=cfg, encodings=encodings,
                                  dictionaries=dicts, pack_domains=domains,
                                  device="cpu")
            if dev.type == "cuda":
                t.columns = map_tensors(lambda x: x.pin_memory(), t.columns)
            parts.append(Partition(table=t, rows=rows, padded_rows=padded,
                                   row_offset=start, zone_lo=zone_lo,
                                   zone_hi=zone_hi))
        return cls(partitions=parts, dictionaries=dicts, nrows=n,
                   domains=domains, col_dtypes=col_dtypes,
                   budget_bytes=budget_bytes, device=dev)

    # -- Table duck-typing for the plan layer -------------------------------

    def encoding_of(self, name: str) -> str:
        for p in self.partitions:
            if p.rows:
                return p.table.encoding_of(name)
        return "PlainColumn"

    def code_for(self, name: str, value, op: str = "eq"):
        return table_mod.dictionary_code_for(self.dictionaries, name, value,
                                             op)

    # -- inspection ----------------------------------------------------------

    def validate(self) -> "PartitionedTable":
        """Integrity-check every partition (DESIGN.md §15): the ``Table``
        invariants per column (restricted to the real-row prefix — padding
        replicates the last real row), PLUS the partition-only invariants
        the skip decisions depend on: zone maps equal the actual min/max of
        the real rows, and ``row_offset`` coverage tiles [0, nrows).
        Raises ``faults.ValidationError``."""
        from repro_torch.core.faults import ValidationError

        offset = 0
        for i, p in enumerate(self.partitions):
            if p.row_offset != offset:
                raise ValidationError(
                    f"partition {i}: row_offset {p.row_offset} != expected "
                    f"{offset} (partitions must tile [0, nrows))")
            offset += p.rows
            for name, col in p.table.columns.items():
                decoded = compress.validate_encoded(
                    col, f"partition {i}:{name}", p.padded_rows,
                    dictionary=self.dictionaries.get(name),
                    domain=p.table.domains.get(name),
                    rows=p.rows)
                if not p.rows:
                    continue
                zlo = p.zone_lo.get(name)
                zhi = p.zone_hi.get(name)
                if (zlo is None or not np.isfinite(zlo)
                        or not np.isfinite(zhi)):
                    continue  # unbounded (NaN-poisoned) zones prune nothing
                body = decoded[:p.rows]
                lo, hi = float(body.min()), float(body.max())
                if lo != float(zlo) or hi != float(zhi):
                    raise ValidationError(
                        f"partition {i} column {name!r}: zone map "
                        f"[{zlo}, {zhi}] != actual [{lo}, {hi}]")
        if offset != self.nrows:
            raise ValidationError(
                f"partitions cover {offset} rows, table declares "
                f"{self.nrows}")
        return self

    def decode(self, name: str) -> np.ndarray:
        """Materialize a column across partitions (tests / inspection)."""
        chunks = [np.asarray(p.table.decode(name))[:p.rows]
                  for p in self.partitions if p.rows]
        return (np.concatenate(chunks) if chunks
                else np.zeros((0,), np.int32))

    def nbytes(self) -> int:
        """Host footprint (bit-packed buffers at packed size): also the
        H2D bytes of a no-skip streamed execution, since the transfer
        moves the packed words as they are."""
        return sum(p.nbytes() for p in self.partitions)

    def nbytes_unpacked(self) -> int:
        """Footprint with packed buffers at the whole-dtype width the §9
        narrowing would pick for the same domain (DESIGN.md §11)."""
        return sum(p.table.nbytes_unpacked() for p in self.partitions)

    def max_partition_nbytes(self, unpacked: bool = False) -> int:
        """Peak per-partition device footprint of the streamed execution."""
        if unpacked:
            return max((p.table.nbytes_unpacked()
                        for p in self.partitions if p.rows), default=0)
        return max((p.nbytes() for p in self.partitions if p.rows), default=0)


def _partition_offsets(n, num_partitions, partition_rows, boundaries):
    picked = sum(x is not None
                 for x in (num_partitions, partition_rows, boundaries))
    if picked != 1:
        raise ValueError("pass exactly one of num_partitions / "
                         "partition_rows / boundaries")
    if boundaries is not None:
        cuts = sorted(int(b) for b in boundaries)
        if any(b < 0 or b > n for b in cuts):
            raise ValueError(f"boundary outside [0, {n}]")
        return [0] + cuts + [n]
    if partition_rows is not None:
        if partition_rows <= 0:
            raise ValueError("partition_rows must be positive")
        return list(range(0, n, partition_rows)) + [n] if n else [0, 0]
    k = max(int(num_partitions), 1)
    step = -(-n // k) if n else 0
    return [min(i * step, n) for i in range(k)] + [n]


def rows_for_budget(data: Dict[str, np.ndarray], budget_bytes: int,
                    pack: bool = False, prefetch_depth: int = 0) -> int:
    """Partition row count so each partition's UNCOMPRESSED working set fits
    ``budget_bytes`` (the out-of-core sizing rule, DESIGN.md §4).

    With ``pack=True`` integer/dictionary columns are sized at their
    packed bit width (DESIGN.md §11) instead of a whole dtype, so strictly
    more rows fit the same budget on dict-heavy schemas. The policy's
    ``enable_pack`` kill switch (REPRO_PACK=0) is honored here exactly as
    ingest honors it — sizing by packed bits while ingest ships unpacked
    buffers would silently overrun the device budget.

    ``prefetch_depth`` accounts for the streamed executor's in-flight
    copies (DESIGN.md §12): each of the ``depth`` prefetched partitions
    holds one more copy of the row's transfer bytes on the device, so the
    per-row cost is ``(1 + depth)`` copies and strictly fewer rows fit.
    The default 0 preserves the single-resident-partition sizing; the
    executor additionally clamps its depth at run time when the table
    records a budget, so an unaccounted depth degrades to a shallower
    ring rather than a silent budget overshoot.
    """
    from repro_torch.kernels import dispatch
    pack = pack and dispatch.policy().enable_pack
    max_bits = dispatch.policy().pack_max_bits
    copies = 1 + max(int(prefetch_depth), 0)
    row_bits = 0
    for arr in data.values():
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            # strings dictionary-encode to int32 codes on device; packed,
            # the code space is the distinct-value count
            bits = 32
            if pack and arr.size:
                b = compress.pack_bit_width(0, len(np.unique(arr)) - 1)
                bits = b if b <= max_bits else 32
        elif pack and arr.dtype.kind in "iu" and arr.size:
            b = compress.pack_bit_width(int(arr.min()), int(arr.max()))
            bits = b if b <= max_bits else arr.dtype.itemsize * 8
        else:
            bits = arr.dtype.itemsize * 8
        row_bits += bits
    return max(int(budget_bytes * 8 // max(row_bits * copies, 1)), 1)


# ---------------------------------------------------------------------------
# Zone-map predicate pushdown
# ---------------------------------------------------------------------------
#
# Tri-state interval evaluation: ``_maybe_any`` over-approximates "some row
# in [lo, hi] could satisfy the predicate" (True also when unsure), so a
# False is a PROOF the partition contributes nothing and can be skipped
# without a device transfer. ``_definitely_all`` under-approximates "every
# row satisfies" — it exists for the NOT case (¬a may match only if a is not
# a tautology on the partition's range).


def _lit(table, name, op, value):
    if isinstance(value, str):
        # equality AND range literals translate to the dictionary's code
        # space (range ops via the searchsorted boundary code, preserving
        # operator semantics — Table.code_for), so zone maps recorded on
        # codes prune string predicates of every comparison shape
        if op in ("eq", "ne", "isin", "lt", "le", "gt", "ge"):
            return table.code_for(name, value, op)
        return None
    return value


def _range_bounds(table, expr: RangePred):
    """RangePred bounds in the column's stored (code) space."""
    lo, hi = expr.lo, expr.hi
    if isinstance(lo, str):
        lo = table.code_for(expr.col, lo, "ge" if expr.lo_incl else "gt")
    if isinstance(hi, str):
        hi = table.code_for(expr.col, hi, "le" if expr.hi_incl else "lt")
    return lo, hi


def _maybe_any(expr, zl: Dict[str, float], zh: Dict[str, float],
               table: PartitionedTable) -> bool:
    if isinstance(expr, Pred):
        if expr.col not in zl:
            return True  # computed/unknown column: cannot prune
        lo, hi = zl[expr.col], zh[expr.col]
        if lo > hi:
            return False  # empty partition interval
        if expr.op == "isin":
            lits = [_lit(table, expr.col, "isin", v) for v in expr.literal]
            return any(v is not None and lo <= v <= hi for v in lits)
        v = _lit(table, expr.col, expr.op, expr.literal)
        if v is None:
            return True
        return {"eq": lo <= v <= hi, "ne": not (lo == hi == v),
                "gt": hi > v, "ge": hi >= v,
                "lt": lo < v, "le": lo <= v}[expr.op]
    if isinstance(expr, RangePred):
        if expr.col not in zl:
            return True
        lo, hi = zl[expr.col], zh[expr.col]
        if lo > hi:
            return False
        rlo, rhi = _range_bounds(table, expr)
        above = hi > rlo if not expr.lo_incl else hi >= rlo
        below = lo < rhi if not expr.hi_incl else lo <= rhi
        return above and below
    if isinstance(expr, And):
        return _maybe_any(expr.a, zl, zh, table) and _maybe_any(expr.b, zl, zh, table)
    if isinstance(expr, Or):
        return _maybe_any(expr.a, zl, zh, table) or _maybe_any(expr.b, zl, zh, table)
    if isinstance(expr, Not):
        return not _definitely_all(expr.a, zl, zh, table)
    return True


def _definitely_all(expr, zl: Dict[str, float], zh: Dict[str, float],
                    table: PartitionedTable) -> bool:
    if isinstance(expr, Pred):
        if expr.col not in zl:
            return False
        lo, hi = zl[expr.col], zh[expr.col]
        if lo > hi:
            return True  # vacuously: no rows
        if expr.op == "isin":
            lits = [_lit(table, expr.col, "isin", v) for v in expr.literal]
            return any(v is not None and lo == hi == v for v in lits)
        v = _lit(table, expr.col, expr.op, expr.literal)
        if v is None:
            return False
        return {"eq": lo == hi == v, "ne": v < lo or v > hi,
                "gt": lo > v, "ge": lo >= v,
                "lt": hi < v, "le": hi <= v}[expr.op]
    if isinstance(expr, RangePred):
        if expr.col not in zl:
            return False
        lo, hi = zl[expr.col], zh[expr.col]
        if lo > hi:
            return True
        rlo, rhi = _range_bounds(table, expr)
        above = lo > rlo if not expr.lo_incl else lo >= rlo
        below = hi < rhi if not expr.hi_incl else hi <= rhi
        return above and below
    if isinstance(expr, And):
        return (_definitely_all(expr.a, zl, zh, table)
                and _definitely_all(expr.b, zl, zh, table))
    if isinstance(expr, Or):
        return (_definitely_all(expr.a, zl, zh, table)
                or _definitely_all(expr.b, zl, zh, table))
    if isinstance(expr, Not):
        return not _maybe_any(expr.a, zl, zh, table)
    return False


def _zone_str(lo, hi) -> str:
    return f"zone [{lo:g}, {hi:g}]"


def _expr_cause(expr, zl, zh, table) -> str:
    """The predicate bound responsible for a refuted expression — called
    only after ``_maybe_any(expr, ...)`` returned False, so every branch
    may assume its subtree is (or contains) a proof. The rendering feeds
    zone-map telemetry instants, ``last_stats['pruned_by']`` and
    ``explain_analyze`` (DESIGN.md §14)."""
    if isinstance(expr, Pred):
        if expr.col in zl and zl[expr.col] > zh[expr.col]:
            return f"{expr.col}: empty zone"
        return (f"{expr.col} {expr.op} {expr.literal!r} outside "
                f"{_zone_str(zl[expr.col], zh[expr.col])}")
    if isinstance(expr, RangePred):
        if expr.col in zl and zl[expr.col] > zh[expr.col]:
            return f"{expr.col}: empty zone"
        lo_b = "[" if expr.lo_incl else "("
        hi_b = "]" if expr.hi_incl else ")"
        return (f"{expr.col} in {lo_b}{expr.lo!r}, {expr.hi!r}{hi_b} "
                f"outside {_zone_str(zl[expr.col], zh[expr.col])}")
    if isinstance(expr, And):
        # one refuted conjunct suffices; name the first
        if not _maybe_any(expr.a, zl, zh, table):
            return _expr_cause(expr.a, zl, zh, table)
        return _expr_cause(expr.b, zl, zh, table)
    if isinstance(expr, Or):
        return (f"({_expr_cause(expr.a, zl, zh, table)}) and "
                f"({_expr_cause(expr.b, zl, zh, table)})")
    if isinstance(expr, Not):
        return "negated predicate holds on the whole zone"
    return "refuted predicate"


def partition_match_verdict(part: Partition, ops,
                            table: PartitionedTable):
    """``(can_match, cause)``: the partition-skipping decision PLUS the
    zone-map proof that justified a skip (L3-style pushdown, DESIGN.md §4).

    ``can_match`` is False iff zone maps PROVE no row of ``part`` survives
    all filters and semi-joins; ``cause`` is then the responsible
    predicate bound rendered as text (None on a visit verdict). Ops are
    walked in pipeline order: a ``map`` rebinding a column name
    invalidates that column's zone maps for every LATER filter/semi-join
    (the ingest-time min/max describe the original values, not the mapped
    ones), so those predicates fall back to "cannot prune"."""
    if part.rows == 0:
        return False, "empty partition"
    zl, zh = dict(part.zone_lo), dict(part.zone_hi)
    for op in ops:
        if isinstance(op, _MapOp):
            zl.pop(op.out, None)
            zh.pop(op.out, None)
        elif isinstance(op, _FilterOp):
            if not _maybe_any(op.expr, zl, zh, table):
                return False, _expr_cause(op.expr, zl, zh, table)
        elif isinstance(op, _SemiJoinOp):
            if op.on not in zl:
                continue
            lo, hi = zl[op.on], zh[op.on]
            keys = np.asarray(op.keys)
            if not np.any((keys >= lo) & (keys <= hi)):
                return False, (f"semi_join: no {op.on} key in "
                               f"{_zone_str(lo, hi)}")
        elif isinstance(op, _JoinOp):
            # FK zone-map pushdown (DESIGN.md §6): the surviving dimension
            # key set (prepared eagerly, once) prunes fact partitions whose
            # FK interval misses every key — inner-join semantics mean such
            # a partition contributes nothing.
            keys = op.host_keys
            if keys is not None and op.fk in zl:
                lo, hi = zl[op.fk], zh[op.fk]
                if not np.any((keys >= lo) & (keys <= hi)):
                    return False, (f"join: no dimension key for {op.fk} in "
                                   f"{_zone_str(lo, hi)}")
            # gathered columns rebind names: ingest zone maps for any
            # shadowed fact column no longer describe the pipeline values
            for out in op.out:
                zl.pop(out, None)
                zh.pop(out, None)
    return True, None


def partition_can_match(part: Partition, ops, table: PartitionedTable) -> bool:
    """The bare skip/visit verdict (see ``partition_match_verdict``)."""
    return partition_match_verdict(part, ops, table)[0]


# ---------------------------------------------------------------------------
# Streaming executor
# ---------------------------------------------------------------------------


def base_masked_program(inner):
    """Wrap a partial-mode ``Query.build`` program into the partitioned
    calling convention ``(columns, key_sets, rows)``.

    The base mask excluding padding rows (one run ``[0, rows - 1]``) is
    built on the columns' device with fill kernels, never a host copy, so
    building it does not wait for the stream; its ``nrows`` comes from
    the columns' metadata (every encoding carries it)."""

    def wrapped(columns, key_sets, rows):
        first = next(iter(columns.values()))
        dev = tensor_leaves(first)[0].device
        pos = torch.int32
        base = RLEMask(starts=torch.zeros((1,), dtype=pos, device=dev),
                       ends=torch.full((1,), rows - 1, dtype=pos, device=dev),
                       n=torch.ones((), dtype=pos, device=dev),
                       nrows=first.nrows)
        return inner(columns, key_sets, base)

    return wrapped


def ready_on_compute(put, device: torch.device):
    """The tree of a transfer, safe to read on the current (compute)
    stream. A ``Pending`` from ``_put_columns`` was copied on a copy
    stream: the compute stream waits on its event, and every tensor is
    marked used by the compute stream, so the caching allocator never
    hands its blocks to a later copy while a kernel still reads them
    (whoever drops the last reference: a retired partition, or the
    serving layer's residency LRU evicting a tree a program reads)."""
    if not isinstance(put, Pending):
        return put
    if put.event is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(put.event)
        for t in tensor_leaves(put.value):
            t.record_stream(cur)
    return put.value


def _to_host_after(value, device: torch.device) -> Pending:
    """A partial's tensors copied to host memory without a wait: on a CUDA
    device, ``non_blocking`` copies into pinned memory on the compute
    stream, then an event. Waiting on that event alone lets the host fold
    partial ``i`` while program ``i+1`` runs (a blocking copy would wait
    for the whole stream, program ``i+1`` included)."""
    if device.type != "cuda":
        return Pending(value)
    host = map_tensors(lambda t: t.to("cpu", non_blocking=True), value)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return Pending(host, done)


class PartitionedQuery(Query):
    """A ``Query`` over a ``PartitionedTable``: same staging API (including
    ``join`` against resident dimension tables — the dimension side is
    prepared once per run and shared by every partition's program),
    streaming partial-aggregate execution.

    The pipeline must terminate in ``aggregate``, ``groupby`` or
    ``order_by`` (partials of a bare filter are per-partition masks, which
    have no merge story — count them instead). One program serves every
    partition; ``trace_count`` is the number of programs built (one per
    query). Ranked terminals run the distributed top-k merge with ranked
    zone-map pruning (DESIGN.md §10).
    """

    def __init__(self, table: PartitionedTable):
        super().__init__(table)
        self.trace_count = 0
        self.last_stats: Dict[str, int] = {}
        # (index, visit?, prune cause) per partition, from the last run's
        # zone-map pass (partition_match_verdict, DESIGN.md §14)
        self.last_verdicts: List[tuple] = []
        # ranked zone-map pruning (DESIGN.md §10): once `limit` candidate
        # rows are held, partitions whose ORDER-BY-key zone map cannot beat
        # the current k-th best are never transferred. The off switch
        # measures the transfer-count win.
        self.ranked_pruning = True
        # serving hooks (core/serve.py, a later port slice): the server
        # swaps in a residency-LRU transfer and a cached program
        self._transfer_fn = None
        self._program_override = None
        self._program = None
        self._copy_stream = None

    def _built_program(self):
        if self._program is None:
            self._program = base_masked_program(self.build(partial=True))
            self.trace_count += 1
        return self._program

    def _transfer(self, part: Partition):
        # resolves the module-global ``device_put`` at call time inside
        # ``_put_columns``: tests stub it to count; the serving layer
        # injects its residency LRU here instead
        if self._transfer_fn is not None:
            return self._transfer_fn(part)
        return _put_columns(part.table.columns, self.table.device,
                            self._copy_stream)

    @contextlib.contextmanager
    def _copy_stream_on(self, dev: torch.device):
        """Scope of one run's CUDA copy stream (``_transfer`` issues the
        partition copies on it); no stream on the CPU."""
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            self._copy_stream = (torch.cuda.Stream(dev)
                                 if dev.type == "cuda" else None)
            try:
                yield
            finally:
                self._copy_stream = None

    def _make_executor(self, jit: bool):
        """The partition program (``jit`` is kept for signature parity:
        the port runs eagerly either way)."""
        if self._program_override is not None:
            return self._program_override
        return self._built_program()

    def _depth_and_stats(self, ptable: PartitionedTable):
        from repro_torch.kernels import dispatch

        depth = stream.clamp_depth(dispatch.policy().prefetch_depth,
                                   ptable.max_partition_nbytes(),
                                   ptable.budget_bytes)
        return depth, stream.StreamStats(prefetch_depth=depth,
                                         qid=getattr(self, "qid", None))

    # -- observability: EXPLAIN / EXPLAIN ANALYZE (DESIGN.md §14) -----------

    def explain(self) -> str:
        """Static plan tree plus the zone-map partition estimate: how many
        partitions the CURRENT ops would visit/skip. Join FK pruning needs
        the prepared dimension key set, which only exists at run time, so
        the estimate is conservative until a run has recorded
        ``host_keys``."""
        lines = self._explain_lines()
        ptable: PartitionedTable = self.table
        est = sum(1 for p in ptable.partitions
                  if partition_can_match(p, self.ops, ptable))
        total = len(ptable.partitions)
        note = ""
        if any(isinstance(op, _JoinOp) and op.host_keys is None
               for op in self.ops):
            note = "; join FK pruning resolves at run time"
        lines.append(f"estimated partitions: visit {est} / skip "
                     f"{total - est} of {total} (zone maps{note})")
        return "\n".join(lines)

    def explain_analyze(self, jit: bool = True) -> str:
        """EXPLAIN annotated with one measured streamed execution.

        Runs the query with tracing force-enabled and an H2D listener
        capturing exact transfer bytes, then renders the plan with the
        actuals: partitions visited/pruned (and the responsible predicate
        bounds), transfers + bytes moved vs the table's total ingested
        bytes, and the pipeline's per-stage ms. The machine-readable copy
        lands in ``self.last_analysis``.
        """
        from repro_torch.kernels import dispatch

        moved: List[int] = []
        with dispatch.overrides(enable_trace=True), \
                telemetry.h2d_listener(lambda nbytes, tree:
                                       moved.append(nbytes)):
            t0 = time.perf_counter()
            self.run(jit=jit)
            wall = (time.perf_counter() - t0) * 1e3
        st = self.last_stats
        ptable: PartitionedTable = self.table
        analysis = {
            "wall_ms": round(wall, 3),
            "partitions": st.get("partitions", 0),
            "executed": st.get("executed", 0),
            "pruned": st.get("skipped", 0),
            "ranked_skipped": st.get("ranked_skipped", 0),
            "pruned_by": dict(st.get("pruned_by", {})),
            "transferred": st.get("transferred", 0),
            "transfers_seen": len(moved),
            "bytes_moved": int(sum(moved)),
            "bytes_total": int(ptable.nbytes()),
            "h2d_ms": st.get("h2d_ms", 0.0),
            "compute_ms": st.get("compute_ms", 0.0),
            "merge_ms": st.get("merge_ms", 0.0),
            "prefetch_depth": st.get("prefetch_depth", 0),
            "retries": st.get("retries", 0),
            "degradations": st.get("degradations", 0),
            "trace_count": self.trace_count,
            "qid": self.qid,
        }
        self.last_analysis = analysis
        a = analysis
        lines = self._explain_lines()
        lines.append(
            f"actual: wall {a['wall_ms']:.3f} ms "
            f"(depth-{a['prefetch_depth']} pipeline, "
            f"{a['trace_count']} program"
            f"{'s' if a['trace_count'] != 1 else ''} built, qid={a['qid']})")
        ranked = (f" + {a['ranked_skipped']} ranked-pruned"
                  if a["ranked_skipped"] else "")
        lines.append(
            f"  partitions: {a['executed']} executed / {a['pruned']} "
            f"zone-pruned{ranked} of {a['partitions']}; "
            f"{a['transferred']} transfers, {a['bytes_moved']} of "
            f"{a['bytes_total']} ingested bytes moved")
        for cause, n in sorted(a["pruned_by"].items()):
            lines.append(f"  pruned x{n}: {cause}")
        lines.append(
            f"  stage ms: h2d {a['h2d_ms']:.3f} | compute "
            f"{a['compute_ms']:.3f} | merge {a['merge_ms']:.3f}")
        if a["retries"] or a["degradations"]:
            lines.append(
                f"  resilience: {a['retries']} transfer "
                f"retr{'ies' if a['retries'] != 1 else 'y'}, "
                f"{a['degradations']} depth degradation"
                f"{'s' if a['degradations'] != 1 else ''} "
                f"(final depth {a['prefetch_depth']})")
        return "\n".join(lines)

    def run(self, jit: bool = True):
        terminal = self.terminal_op()
        oop = self.order_op()
        if terminal is None and oop is None:
            raise NotImplementedError(
                "partitioned execution requires a terminal aggregate() / "
                "groupby() / order_by() (add e.g. a count aggregate to "
                "materialize a filter result)")
        # preparation FIRST: join prep records host_keys on each _JoinOp,
        # which partition_can_match's FK zone-map pushdown reads below
        key_sets = tuple(self._prepare_inputs())
        execute = self._make_executor(jit)

        ptable: PartitionedTable = self.table
        dev = ptable.device
        todo = []
        pruned_by: Dict[str, int] = {}
        self.last_verdicts = []
        for i, p in enumerate(ptable.partitions):
            ok, cause = partition_match_verdict(p, self.ops, ptable)
            self.last_verdicts.append((i, ok, cause))
            telemetry.instant("zone_map", "main", qid=self.qid, part=i,
                              verdict="visit" if ok else "skip", cause=cause)
            if ok:
                todo.append(p)
            else:
                pruned_by[cause] = pruned_by.get(cause, 0) + 1
        self.last_stats = {
            "partitions": len(ptable.partitions),
            "executed": len(todo),
            "skipped": len(ptable.partitions) - len(todo),
            "pruned_by": pruned_by,
        }
        depth, stats = self._depth_and_stats(ptable)
        # trace spans name partitions by their ingest index, matching the
        # zone_map verdict instants above
        pidx = {id(p): i for i, p in enumerate(ptable.partitions)}

        def label_of(p):
            return pidx.get(id(p))

        def compute(part, put):
            cols = ready_on_compute(put, dev)
            return _to_host_after(execute(cols, key_sets, part.rows), dev)

        if terminal is None:
            # row-terminal ranked query: distributed top-k merge with
            # ranked zone-map pruning and speculative prefetch
            return self._run_ranked(oop, compute, todo, depth, stats,
                                    label_of)

        partial_specs, _ = plan_mod.decompose_specs(terminal.specs)
        if isinstance(terminal, _AggOp):
            def fold(acc, part, partial):
                return plan_mod.fold_scalar_partial(acc, partial.value,
                                                    partial_specs)
        else:
            group_names = list(terminal.group)

            def fold(acc, part, partial):
                return groupby.fold_groupby_partial(
                    acc, partial.value, group_names, partial_specs)

        with self._copy_stream_on(dev):
            try:
                acc = stream.pipelined_fold(todo, self._transfer, compute,
                                            fold, None, depth, stats,
                                            nbytes_of=Partition.nbytes,
                                            label_of=label_of)
            finally:
                # terminal errors still report the partial pipeline stats
                # (stage ms, retries, degradations — DESIGN.md §15)
                self.last_stats.update(stats.as_dict())
        if isinstance(terminal, _AggOp):
            return plan_mod.finalize_scalar_partials(
                acc, terminal.specs, col_dtypes=ptable.col_dtypes)
        merged = groupby.finalize_groupby_partials(acc, group_names,
                                                   terminal.specs)
        if oop is not None:
            # groupby + order_by: partials carry PARTIAL aggregates, so
            # ranking can only happen after the host merge finalizes them
            merged = order_mod.rank_merged_groupby(merged, oop.by,
                                                   oop.descending, oop.limit)
        return merged

    # -- ranked (ORDER BY / TOP-K) execution --------------------------------

    def _rebound(self, name: str) -> bool:
        """Was ``name`` rebound by a map/join before the order op? (Its
        ingest zone maps then no longer describe the pipeline values.)"""
        for op in self.ops:
            if isinstance(op, _MapOp) and op.out == name:
                return True
            if isinstance(op, _JoinOp) and name in op.out:
                return True
            if isinstance(op, _OrderByOp):
                return False
        return False

    def _run_ranked(self, oop: _OrderByOp, compute, todo, depth: int,
                    stats: stream.StreamStats, label_of=None):
        ptable: PartitionedTable = self.table
        key0, desc0 = oop.by[0], oop.descending[0]
        prunable = (self.ranked_pruning and oop.limit is not None
                    and not self._rebound(key0))

        def zone_best(part):
            """Best rank the partition could possibly hold on the primary
            key (None = unknown: process early, never prune)."""
            z = part.zone_hi if desc0 else part.zone_lo
            if key0 not in z:
                return None
            return z[key0] if desc0 else -z[key0]

        # visit best-first: a good bound forms after the first partition,
        # maximizing later skips (unknown-zone partitions go first — they
        # can never be skipped, so they might as well seed the bound)
        items = sorted(todo, key=lambda p: (
            0 if zone_best(p) is None else 1,
            0 if zone_best(p) is None else -zone_best(p)))

        def prune(state, part):
            """True iff the CURRENT merged bound proves ``part`` cannot
            contribute. Strictly-worse partitions only — a tie could still
            win the ascending-row-id tiebreak. The bound tightens
            monotonically, so a speculatively transferred partition is
            re-checked (and its program gated) at the ring head: the
            executed set is EXACTLY the depth-0 sequential path's."""
            if not prunable:
                return False
            bound = order_mod.ranked_kth_bound(state, key0, desc0,
                                               oop.limit)
            if bound is None:
                return False
            zb = zone_best(part)
            return zb is not None and zb < bound

        def fold(state, part, partial):
            # the host copy of the partial is complete (the ring waited on
            # its event), so reading its count here does not stall the
            # device
            block = order_mod.host_block(partial.value,
                                         row_offset=part.row_offset)
            return order_mod.merge_ranked_partials(
                state, block, oop.by, oop.descending, oop.limit)

        with self._copy_stream_on(ptable.device):
            try:
                state, ranked_skipped, wasted = stream.pipelined_ranked_fold(
                    items, self._transfer, compute, fold, prune, depth, stats,
                    nbytes_of=Partition.nbytes, label_of=label_of)
            finally:
                # failed ranked runs still report partial pipeline stats
                self.last_stats.update(stats.as_dict())
        # coherent stats: partitions == executed + skipped + ranked_skipped;
        # ``prefetch_wasted`` counts speculative transfers whose partition
        # the tightened bound then pruned (bytes, never a result change)
        self.last_stats["skipped"] = (self.last_stats["partitions"]
                                      - stats.executed - ranked_skipped)
        self.last_stats["ranked_skipped"] = ranked_skipped
        self.last_stats["prefetch_wasted"] = wasted
        if state is None:  # every partition pruned: empty ranked result
            names = plan_mod._order_output_cols(self.ops, ptable) or ()
            state = {"positions": np.zeros((0,), np.int64),
                     "columns": {n: np.zeros(
                         (0,), ptable.col_dtypes.get(n, np.float32))
                         for n in names}}
        return order_mod.ranked_table_from_state(
            state, self._ranked_dictionaries())
