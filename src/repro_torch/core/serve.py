"""Concurrent query-serving layer over one resident compressed dataset
(DESIGN.md §13), PyTorch port of ``repro.core.serve``.

Everything below ``PartitionedQuery`` executes one query at a time: each
``run()`` re-transfers every surviving partition and each fresh ``Query``
object builds its program again, even when a serving workload asks the
same handful of query shapes against the same table all day. This module
is the serving loop of many concurrent queries amortizing one resident
dataset, built from four pieces that reuse the machinery of §4/§10/§12:

  * ``DeviceResidencyLRU`` — hot packed partitions stay on the device
    across queries under a byte budget (``serve_budget_bytes``, defaulting
    to the table's declared ingest budget, less the CUDA graphs' input
    slot on a card; admission and the ring's depth clamp use the same
    figure). It stores what
    ``partition._put_columns`` returns: the device tree plus the CUDA
    event recorded after its copies, which ran on the server's one copy
    stream. A hit issues no copy; every use of a resident tree, hit or
    miss, orders the compute stream after that event and marks the
    tensors ``record_stream(compute stream)``, so an eviction that drops
    the last reference while a program still reads the tree cannot hand
    its blocks to a later copy.

  * ``PlanCache`` — prepared partitioned programs keyed by
    ``plan_signature`` (query shape + baked literals). One program serves
    every partition (§4); the cache makes it serve every *submission* of
    that shape. ``PlanEntry.trace_count`` counts programs built, and the
    server checks after every batch that a hit on a warm entry built none
    (the reference's zero-retrace contract, restated eagerly). Resident
    trees outlive the program: nothing is released after a run.

  * shared scans — compatible queued queries (same table; terminal
    aggregate/group-by) batch into ONE streamed pass over the zone-map
    union of their partition sets (``stream.pipelined_fold``), each
    partition's device tree feeding every subscribed query's program
    back-to-back. The pass's ``compute`` returns ONE ``stream.Pending``
    whose value is every subscriber's host partial and whose event is
    recorded after the last of their device-to-host copies, so the ring
    folds no partial before its copy has landed. Per-query
    ``StreamStats`` attribution splits each query's partitions into LRU
    hits, co-batched shared hits, and the transfers it itself triggered.
    Row-terminal ranked queries run solo (their speculative prune order is
    per-query, §10) but still ride the LRU and plan cache. On a CUDA
    device the pass replays each (query, partition) program as a CUDA
    graph (``core/graphs.py``): a key's first sighting runs eagerly, its
    second captures, later ones replay; the graphs' static input slot
    comes out of the device budget the LRU and the ring share.

  * an admission/queue loop — ``submit()`` enqueues and returns a
    ``Ticket``; a single drain thread (inside ``torch.cuda.device`` of the
    table's device) forms FIFO batches bounded by ``serve_max_batch`` and
    by the device budget (a query whose zone-map partition union would
    push the batch past the budget waits for the next pass). Per-query
    folds happen in partition order on the host, so served results are
    bit-identical to a solo ``run()`` (tests/test_torch_serving.py holds
    this under concurrent submitter threads).

Serving observability: ``QueryServer.stats()`` reports QPS over the
serving window, p50/p99/mean latency over the last ``LATENCY_HISTORY``
completions, plan-cache and residency hit rates, the scan-sharing split,
and the programs replayed, captured and run eagerly (``graphs``). A
ticket's ``stats`` add ``queue_ms`` (submission to admission) and
``prep_ms`` (its preparation on the drain thread), the times of its
``serve.queue`` and ``serve.prep`` spans. Knobs:
``DispatchPolicy.serve_budget_bytes`` /
``plan_cache_size`` / ``serve_max_batch`` (env ``REPRO_SERVE_BUDGET_BYTES``
/ ``REPRO_PLAN_CACHE_SIZE`` / ``REPRO_SERVE_MAX_BATCH``).

Fault tolerance (DESIGN.md §15): ``submit(deadline_s=)`` bounds a query's
end-to-end latency, ``cancel(ticket)`` requests cooperative cancellation
— both take effect at partition boundaries (the query stops between
partitions, never mid-program), and a still-queued ticket is reaped at
the next batch formation. ``result(timeout=)`` removes a still-queued
ticket on expiry. Failure is isolated per subscriber: a query whose
program or fold raises mid-shared-scan fails only its own ticket. A
``DeviceOOMError`` that survives the streamed executor's own depth
degradation evicts the residency LRU and re-runs each subscriber in its
own pass before failing anything. ``close(drain=False)`` cancels the
queue instead of executing it, and ``recover()`` clears a ``_fatal``
invariant violation (fresh plan cache, restarted drain thread).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults, groupby
from repro_torch.core import graphs as graphs_mod
from repro_torch.core import order as order_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import stream
from repro_torch.core import telemetry
from repro_torch.core.faults import (
    DeviceOOMError,
    QueryCancelled,
    QueryDeadlineExceeded,
)
from repro_torch.core.partition import (
    Partition,
    PartitionedQuery,
    PartitionedTable,
    _put_columns,
    _to_host_after,
    base_masked_program,
    partition_can_match,
    partition_match_verdict,
    ready_on_compute,
)
from repro_torch.core.plan import _AggOp, _GroupByOp
from repro_torch.core.stream import Pending
from repro_torch.device import resolve_device

LATENCY_HISTORY = 1 << 16  # completions whose latencies stats() ranks


def _on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` on a CUDA device, else nothing."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


# ---------------------------------------------------------------------------
# Device-residency LRU
# ---------------------------------------------------------------------------


class DeviceResidencyLRU:
    """Partition-id -> transferred column tree, LRU-evicted under a byte
    budget.

    ``fetch`` returns ``(Pending, was_hit)``: the tree and the event
    recorded after its copies (None on the CPU). A hit issues NO copy.
    The transfer runs outside the lock — the prefetch ring's worker thread
    and the drain thread may fetch concurrently — on ``copy_stream`` (the
    server's), entered on the calling thread. Byte accounting uses
    ``Partition.nbytes()``, the packed host bytes ``rows_for_budget``
    sizes partitions by. Eviction only drops this cache's reference; a
    user marks the tensors with ``record_stream`` first
    (``partition.ready_on_compute``), so eviction is always safe.
    """

    def __init__(self, budget_bytes: Optional[int], device=None,
                 copy_stream: Optional["torch.cuda.Stream"] = None):
        self.budget_bytes = budget_bytes
        self.device = resolve_device(device)
        self.copy_stream = copy_stream
        self._entries: "OrderedDict[int, Tuple[Pending, int]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.resident_bytes = 0

    def fetch(self, pid: int, part: Partition) -> Tuple[Pending, bool]:
        with self._lock:
            got = self._entries.get(pid)
            if got is not None:
                self._entries.move_to_end(pid)
                self.hits += 1
                return got[0], True
        # slow path, outside the lock
        put = _put_columns(part.table.columns, self.device, self.copy_stream)
        nbytes = part.nbytes()
        with self._lock:
            got = self._entries.get(pid)
            if got is not None:  # another thread won the race
                self._entries.move_to_end(pid)
                self.hits += 1
                return got[0], True
            self.misses += 1
            self._entries[pid] = (put, nbytes)
            self.resident_bytes += nbytes
            # keep at least the newest entry: a single partition larger
            # than the budget must still be executable (it just never
            # stays resident past the next insertion)
            while (self.budget_bytes is not None
                   and self.resident_bytes > self.budget_bytes
                   and len(self._entries) > 1):
                _, (_, old_nbytes) = self._entries.popitem(last=False)
                self.resident_bytes -= old_nbytes
                self.evictions += 1
        return put, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.resident_bytes = 0


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanEntry:
    """One cached partitioned program and how often it was built."""

    program: Callable = None  # base_masked_program of the partial build
    trace_count: int = 0  # programs built for this entry (one per miss)
    hits: int = 0
    warm: bool = False  # served at least one completed batch
    # (layout, key-set capacities) -> the key's CUDA graph or sighting
    # state (core/graphs.py); a capture is not a build
    graphs: dict = dataclasses.field(default_factory=dict)


class PlanCache:
    """``plan_signature`` -> ``PlanEntry``, LRU-evicted at ``capacity``.

    A hit on a *warm* entry (one that has already served a completed
    batch) builds no program: the signature pins the baked literals and
    key-set contents, so the first submission's program answers every
    later one. ``QueryServer`` checks this after every batch (a violation
    raises, it is never silent).
    """

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._entries: "OrderedDict[tuple, PlanEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, sig: tuple,
                     build: Callable[[PlanEntry], None]
                     ) -> Tuple[PlanEntry, bool]:
        with self._lock:
            entry = self._entries.get(sig)
            if entry is not None:
                self._entries.move_to_end(sig)
                self.hits += 1
                entry.hits += 1
                return entry, True
            self.misses += 1
            entry = PlanEntry()
            build(entry)
            self._entries[sig] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return entry, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def drop_graphs(self) -> None:
        """Release every entry's CUDA graphs (their pool memory)."""
        with self._lock:
            for entry in self._entries.values():
                entry.graphs.clear()


# ---------------------------------------------------------------------------
# Tickets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted query (``QueryServer.submit``)."""

    qid: int
    query: PartitionedQuery
    submitted: float
    part_ids: frozenset  # zone-map partition superset (admission estimate)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None
    stats: Optional[Dict[str, object]] = None  # per-query attribution
    plan_hit: bool = False
    shared_with: int = 0  # co-batched queries in this ticket's scan pass
    latency_ms: float = 0.0
    deadline: Optional[float] = None  # absolute perf_counter budget
    cancel_requested: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    queue_ms: float = 0.0  # submission to admission into a batch
    prep_ms: float = 0.0  # preparation on the drain thread (_prep)


class _Prepped:
    """One batch member, prepared for execution."""

    def __init__(self, ticket, key_sets, entry, entry_hit, todo, terminal,
                 oop):
        self.ticket = ticket
        self.key_sets = key_sets
        self.entry = entry
        self.entry_hit = entry_hit
        self.todo = todo  # [(pid, Partition)] after full zone-map pruning
        self.terminal = terminal
        self.oop = oop
        self.stats = stream.StreamStats()
        self.fold = None
        self.finalize = None


def _agg_folder(item: _Prepped, col_dtypes):
    specs = item.terminal.specs
    partial_specs, _ = plan_mod.decompose_specs(specs)
    item.fold = lambda acc, partial: plan_mod.fold_scalar_partial(
        acc, partial, partial_specs)
    item.finalize = lambda acc: plan_mod.finalize_scalar_partials(
        acc, specs, col_dtypes=col_dtypes)


def _groupby_folder(item: _Prepped):
    terminal, oop = item.terminal, item.oop
    group_names = list(terminal.group)
    partial_specs, _ = plan_mod.decompose_specs(terminal.specs)
    item.fold = lambda acc, partial: groupby.fold_groupby_partial(
        acc, partial, group_names, partial_specs)

    def finalize(acc):
        merged = groupby.finalize_groupby_partials(acc, group_names,
                                                   terminal.specs)
        if oop is not None:
            # groupby + order_by ranks only after the host merge finalizes
            # the partial aggregates (same rule as PartitionedQuery.run)
            merged = order_mod.rank_merged_groupby(merged, oop.by,
                                                   oop.descending, oop.limit)
        return merged

    item.finalize = finalize


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class QueryServer:
    """Serve ``PartitionedQuery`` submissions against ONE resident table.

    ``submit()`` is thread-safe and non-blocking (returns a ``Ticket``);
    ``result(ticket)`` blocks until that query finishes. A single drain
    thread executes FIFO batches, so all device work is issued from one
    thread in a deterministic order — concurrency buys transfer and
    program amortization (LRU, plan cache, shared scans), not racing
    device programs.

    ``start=False`` skips the drain thread; ``step()`` then executes the
    next batch synchronously on the caller (tests drive batching
    deterministically this way, and it composes with ``with`` either way).
    """

    def __init__(self, table: PartitionedTable,
                 budget_bytes: Optional[int] = None,
                 plan_cache_size: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 start: bool = True):
        from repro_torch.kernels import dispatch
        pol = dispatch.policy()
        if budget_bytes is None:
            budget_bytes = (pol.serve_budget_bytes
                            if pol.serve_budget_bytes is not None
                            else table.budget_bytes)
        self.table = table
        self.device = table.device
        self.budget_bytes = budget_bytes
        # the shared scan's CUDA graphs: their static input slot is device
        # memory the server holds, so it comes out of the budget that the
        # residency LRU, the prefetch ring and admission share (none off
        # CUDA)
        self.graphs = graphs_mod.ProgramGraphs(table, self.device)
        part_budget = (None if budget_bytes is None
                       else max(budget_bytes - self.graphs.slot_nbytes, 0))
        # the server's one copy stream: every LRU miss copies on it, from
        # whichever thread fetches (the prefetch ring's worker, mostly)
        copy_stream = None
        if self.device.type == "cuda":
            with _on_device(self.device):
                copy_stream = torch.cuda.Stream(self.device)
        self.lru = DeviceResidencyLRU(part_budget, self.device, copy_stream)
        self.plans = PlanCache(plan_cache_size if plan_cache_size is not None
                               else pol.plan_cache_size)
        self.max_batch = max(int(max_batch if max_batch is not None
                                 else pol.serve_max_batch), 1)
        self._pid_of = {id(p): i for i, p in enumerate(table.partitions)}
        self._queue: "deque[Ticket]" = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._next_qid = 0
        # serving-window accounting (guarded by _stats_lock)
        self._stats_lock = threading.Lock()
        self._latencies_ms: "deque[float]" = deque(maxlen=LATENCY_HISTORY)
        self._completed = 0
        self._errors = 0
        self._first_submit: Optional[float] = None
        self._last_done: Optional[float] = None
        self._scan_passes = 0
        self._shared_queries = 0
        self._solo_queries = 0
        self._timeouts = 0  # result(timeout=) expiries
        self._cancelled = 0  # tickets failed with QueryCancelled
        self._expired = 0  # tickets failed with QueryDeadlineExceeded
        self._oom_fallbacks = 0  # LRU-evicting OOM fallbacks (§15)
        self._fatal: Optional[BaseException] = None  # invariant violation
        self._started = start
        self._worker: Optional[threading.Thread] = None
        if start:
            self._worker = self._spawn_worker()

    def _spawn_worker(self) -> threading.Thread:
        worker = threading.Thread(target=self._drain,
                                  name="repro-serve-drain", daemon=True)
        worker.start()
        return worker

    # -- submission ---------------------------------------------------------

    def query(self) -> PartitionedQuery:
        """A fresh ``PartitionedQuery`` staged against the served table."""
        return PartitionedQuery(self.table)

    def submit(self, query: PartitionedQuery,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue ``query``; returns immediately with a ``Ticket``.

        ``deadline_s`` bounds the query's END-TO-END latency (queue wait
        included): past it the ticket fails with
        ``QueryDeadlineExceeded`` at the next partition boundary or batch
        formation, whichever comes first."""
        if query.table is not self.table:
            raise ValueError("query was staged against a different table "
                             "than this server holds resident")
        if query.terminal_op() is None and query.order_op() is None:
            raise NotImplementedError(
                "served queries need a terminal aggregate() / groupby() / "
                "order_by(), exactly like PartitionedQuery.run")
        # zone-map-only admission estimate (join key sets are prepared at
        # execution, so FK pruning is not yet available: a superset)
        pids = frozenset(
            i for i, p in enumerate(self.table.partitions)
            if partition_can_match(p, query.ops, self.table))
        now = time.perf_counter()
        deadline = now + float(deadline_s) if deadline_s is not None else None
        with self._cv:
            if self._fatal is not None:
                raise self._fatal
            if self._closed:
                raise RuntimeError("QueryServer is closed")
            ticket = Ticket(qid=self._next_qid, query=query, submitted=now,
                            part_ids=pids, deadline=deadline)
            self._next_qid += 1
            self._queue.append(ticket)
            self._cv.notify()
        with self._stats_lock:
            if self._first_submit is None:
                self._first_submit = now
        return ticket

    def cancel(self, ticket: Ticket) -> bool:
        """Request cooperative cancellation of ``ticket``.

        A still-queued ticket is dequeued and failed with
        ``QueryCancelled`` immediately; a running one stops at its next
        partition boundary. Returns False when the ticket had already
        finished (its result/error stands)."""
        if ticket.done.is_set():
            return False
        ticket.cancel_requested.set()
        if self._dequeue(ticket):
            self._finish(ticket, error=QueryCancelled(
                f"query {ticket.qid} cancelled while queued"))
        return True

    def _dequeue(self, ticket: Ticket) -> bool:
        """Remove a still-queued ``ticket``; False when it already left
        the queue (running or finished)."""
        with self._cv:
            try:
                self._queue.remove(ticket)
                return True
            except ValueError:
                return False

    def result(self, ticket: Ticket, timeout: Optional[float] = None):
        if not ticket.done.wait(timeout):
            with self._stats_lock:
                self._timeouts += 1
            telemetry.record_fault("serve_timeout", ticket=ticket.qid,
                                   timeout_s=timeout)
            # a still-QUEUED ticket is reaped here: its caller gave up, so
            # leaving it to run only burns device time and wedges close();
            # a RUNNING one finishes
            if self._dequeue(ticket):
                self._finish(ticket, error=QueryCancelled(
                    f"query {ticket.qid} dequeued: result(timeout="
                    f"{timeout}) expired before it was admitted"))
            if self._fatal is not None:  # the drain thread died on it
                raise self._fatal
            raise TimeoutError(f"query {ticket.qid} still queued/running "
                               f"after {timeout}s")
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    def _cancel_error(self, ticket: Ticket,
                      now: Optional[float] = None) -> Optional[BaseException]:
        """The error ``ticket`` should fail with right now, or None.

        Probed at every cooperative cancellation point: batch formation,
        each shared-scan partition boundary, and the solo path's transfer
        boundary."""
        if ticket.cancel_requested.is_set():
            return QueryCancelled(f"query {ticket.qid} cancelled")
        if ticket.deadline is not None:
            if (time.perf_counter() if now is None else now) >= ticket.deadline:
                return QueryDeadlineExceeded(
                    f"query {ticket.qid} exceeded its "
                    f"{(ticket.deadline - ticket.submitted):.3f}s deadline")
        return None

    # -- admission / drain loop --------------------------------------------

    def _part_nbytes(self, pids) -> int:
        parts = self.table.partitions
        return sum(parts[i].nbytes() for i in pids)

    def _next_batch(self, block: bool) -> Optional[List[Ticket]]:
        while True:
            reaped: List[Tuple[Ticket, BaseException]] = []
            batch: Optional[List[Ticket]] = None
            with self._cv:
                if block:
                    while not self._queue and not self._closed:
                        self._cv.wait()
                # reap cancelled / deadline-expired tickets BEFORE they
                # cost a batch slot — a dead ticket never reaches a scan
                now = time.perf_counter()
                keep: "deque[Ticket]" = deque()
                for t in self._queue:
                    err = self._cancel_error(t, now)
                    if err is not None:
                        reaped.append((t, err))
                    else:
                        keep.append(t)
                self._queue = keep
                if self._queue:
                    batch = [self._queue.popleft()]
                    union = set(batch[0].part_ids)
                    union_bytes = self._part_nbytes(union)
                    # FIFO budget admission: the head always runs;
                    # followers join while the batch stays within
                    # max_batch and the union of zone-map partition sets
                    # stays within the device budget
                    while self._queue and len(batch) < self.max_batch:
                        nxt = self._queue[0]
                        fresh = nxt.part_ids - union
                        fresh_bytes = self._part_nbytes(fresh)
                        if (self.lru.budget_bytes is not None
                                and union_bytes + fresh_bytes
                                > self.lru.budget_bytes):
                            break
                        union |= fresh
                        union_bytes += fresh_bytes
                        batch.append(self._queue.popleft())
                closed = self._closed
            for t, err in reaped:  # outside the lock: _finish takes others
                self._finish(t, error=err)
            if batch is not None:
                admitted = time.perf_counter()
                for t in batch:
                    t.queue_ms = (admitted - t.submitted) * 1e3
                    # from the client's thread to this one: ring only
                    telemetry.interval("serve.queue", t.submitted, admitted,
                                       qid=t.query.qid, ticket=t.qid)
                return batch
            if not block or closed:
                return None
            # reaping emptied the queue: go back to waiting

    def _drain(self) -> None:
        with _on_device(self.device):
            while True:
                batch = self._next_batch(block=True)
                if batch is None:  # closed and fully drained
                    return
                try:
                    self._execute_batch(batch)
                except Exception as exc:  # noqa: BLE001 - invariant
                    # only the plan-cache contract violation raises out of
                    # _execute_batch; park it in _fatal (submit/result
                    # raise it, recover() clears it) instead of dying
                    # silently
                    with self._cv:
                        if self._fatal is None:
                            self._fatal = exc
                    return

    def step(self) -> int:
        """Synchronously execute the next admitted batch (``start=False``
        mode); returns how many queries it served (0 = queue empty)."""
        batch = self._next_batch(block=False)
        if not batch:
            return 0
        with _on_device(self.device):
            self._execute_batch(batch)
        return len(batch)

    # -- execution ----------------------------------------------------------

    def _build_entry(self, query: PartitionedQuery):
        def build(entry: PlanEntry) -> None:
            entry.program = base_masked_program(query.build(partial=True))
            entry.trace_count += 1

        return build

    def _prep(self, ticket: Ticket) -> _Prepped:
        q = ticket.query
        with telemetry.timed("serve.prep", "main", ticket, "prep_ms",
                             qid=q.qid, ticket=ticket.qid):
            # join/semi-join prep FIRST: it records host_keys, which the
            # full zone-map pruning below (unlike the admission superset)
            # consumes
            key_sets = tuple(q._prepare_inputs())
            sig = plan_mod.plan_signature(q.ops)
            entry, hit = self.plans.get_or_build(sig, self._build_entry(q))
            ticket.plan_hit = hit
            telemetry.instant("serve.plan", qid=q.qid, ticket=ticket.qid,
                              hit=hit)
            todo = []
            for i, p in enumerate(self.table.partitions):
                ok, cause = partition_match_verdict(p, q.ops, self.table)
                telemetry.instant("zone_map", qid=q.qid, part=i,
                                  verdict="visit" if ok else "skip",
                                  cause=cause)
                if ok:
                    todo.append((i, p))
            item = _Prepped(ticket, key_sets, entry, hit, todo,
                            q.terminal_op(), q.order_op())
            # served spans are tagged with the QUERY's process-unique qid
            # (the same id a solo run() would use), so one trace separates
            # co-batched queries; the ticket id stays a server-local
            # counter
            item.stats.qid = q.qid
            if isinstance(item.terminal, _AggOp):
                _agg_folder(item, self.table.col_dtypes)
            elif isinstance(item.terminal, _GroupByOp):
                _groupby_folder(item)
            return item

    def _execute_batch(self, batch: List[Ticket]) -> None:
        items: List[_Prepped] = []
        for ticket in batch:
            try:
                items.append(self._prep(ticket))
            except Exception as exc:  # noqa: BLE001 - per-ticket
                self._finish(ticket, error=exc)
        # snapshot BEFORE execution: entries created by this batch are not
        # warm yet, and their first submission legitimately built one
        built0 = {id(it.entry): it.entry.trace_count for it in items}
        warm0 = {id(it.entry): it.entry.warm for it in items}
        try:
            shared = [it for it in items if it.terminal is not None]
            solo = [it for it in items if it.terminal is None]
            if shared:
                self._shared_scan(shared)
            for it in solo:
                self._run_solo(it)
        except Exception as exc:  # noqa: BLE001 - keep the drain alive
            for ticket in batch:
                if not ticket.done.is_set():
                    self._finish(ticket, error=exc)
            return
        # the plan-cache contract: a hit on a WARM entry (one that served
        # a completed batch) must not have built a program during this
        # batch. A violation raises out of step()/the drain — never routed
        # into ticket errors, never silent.
        for it in items:
            key = id(it.entry)
            if warm0[key] and it.entry.trace_count != built0[key]:
                exc = RuntimeError(
                    "plan-cache hit built a program: plan_signature no "
                    "longer pins the cached program (bug in core/serve.py)")
                self._fatal = exc
                raise exc
        for it in items:
            it.entry.warm = True

    def _shared_scan(self, items: List[_Prepped],
                     _oom_retry: bool = False) -> None:
        from repro_torch.kernels import dispatch

        dev = self.device
        # failure isolation: a subscriber whose program/fold raises (or
        # whose deadline expires / cancel lands) drops into `dead` and is
        # finished with ITS error; the shared pass carries on for the rest
        dead: set = set()

        def reap(i: int, exc: BaseException) -> None:
            dead.add(i)
            self._finish(items[i].ticket, error=exc)

        for idx, it in enumerate(items):
            err = self._cancel_error(it.ticket)
            if err is not None:
                reap(idx, err)

        # one streamed pass over the zone-map union, partition order =
        # table order, so each query's partials fold exactly as its solo
        # run would (bit-identical results)
        union: "OrderedDict[int, Partition]" = OrderedDict()
        need: Dict[int, List[int]] = {}
        for idx, it in enumerate(items):
            if idx in dead:
                continue
            for pid, part in it.todo:
                need.setdefault(pid, []).append(idx)
                union[pid] = part
        scan = sorted(union.items())
        max_nbytes = max((p.nbytes() for _, p in scan), default=0)
        depth = stream.clamp_depth(dispatch.policy().prefetch_depth,
                                   max_nbytes, self.lru.budget_bytes)
        pass_stats = stream.StreamStats(prefetch_depth=depth)
        for it in items:
            it.stats.prefetch_depth = depth

        def transfer(part_item):
            pid, part = part_item
            return self.lru.fetch(pid, part)

        def compute(part_item, fetched):
            pid, part = part_item
            put, was_hit = fetched
            cols = ready_on_compute(put, dev)
            partials = {}
            takers = [i for i in need[pid] if i not in dead]
            # partition boundary = cooperative cancellation point
            for i in list(takers):
                err = self._cancel_error(items[i].ticket)
                if err is not None:
                    reap(i, err)
                    takers.remove(i)
            payer = takers[0] if takers else None  # miss -> first taker
            for i in takers:
                st = items[i].stats
                src = ("lru" if was_hit else "miss" if i == payer
                       else "shared")
                try:
                    # one span per (query, partition) pair: the shared
                    # pass fans a single scan out to every subscriber, and
                    # each span carries that query's qid plus how the
                    # bytes were sourced — so per-query trace sums
                    # reconcile with stats(). It times the host's launch
                    # of the program, or of its CUDA graph (and any wait
                    # for the device in it); ``graph`` says which.
                    with stream.stage(st, "compute_ms", "serve.program",
                                      "main", {"part": pid, "src": src}) as sp:
                        faults.maybe_inject("program", pid)
                        partials[i], sp.attrs["graph"] = self.graphs.run(
                            items[i].entry, pid, cols, items[i].key_sets,
                            part.rows)
                except DeviceOOMError:
                    raise  # allocator pressure is pass-level, not per-query
                except Exception as exc:  # noqa: BLE001 - isolate
                    telemetry.record_fault("serve_isolated",
                                           qid=st.qid, part=pid,
                                           error=type(exc).__name__)
                    reap(i, exc)
                    continue
                st.executed += 1
                if src == "lru":
                    st.lru_hits += 1
                elif src == "miss":
                    st.transferred += 1
                else:
                    st.shared_hits += 1
            # every subscriber's partial copied to the host, then ONE
            # event after the last copy: the ring waits on it before the
            # fold reads any of them
            return _to_host_after(partials, dev)

        def fold(accs, part_item, partials):
            pid = part_item[0]
            for i, partial in partials.value.items():
                if i in dead:
                    continue
                try:
                    with stream.stage(items[i].stats, "merge_ms",
                                      "serve.fold", "main", {"part": pid}):
                        accs[i] = items[i].fold(accs[i], partial)
                except Exception as exc:  # noqa: BLE001 - isolate
                    reap(i, exc)
                    continue
            return accs

        try:
            with telemetry.span("serve.batch", "main",
                                queries=len(items), partitions=len(scan),
                                qids=[it.stats.qid for it in items]):
                accs = stream.pipelined_fold(
                    scan, transfer, compute, fold,
                    {i: None for i in range(len(items))},
                    depth, pass_stats, nbytes_of=lambda pi: pi[1].nbytes(),
                    label_of=lambda pi: pi[0])
        except DeviceOOMError as exc:
            # the streamed executor already degraded its depth to 0 and
            # STILL hit allocator exhaustion: shed the server's own
            # pressure (evict every resident partition) and split the
            # batch — each surviving subscriber re-runs in its own pass
            telemetry.record_fault("serve_oom", queries=len(items),
                                   resident_bytes=self.lru.resident_bytes)
            with self._stats_lock:
                self._oom_fallbacks += 1
            self.lru.clear()
            alive = [it for idx, it in enumerate(items)
                     if idx not in dead and not it.ticket.done.is_set()]
            if _oom_retry or len(alive) <= 1:
                for it in alive:
                    self._finish(it.ticket, error=exc)
                return
            for it in alive:
                self._shared_scan([it], _oom_retry=True)
            return
        with self._stats_lock:
            self._scan_passes += 1
            if len(items) > 1:
                self._shared_queries += len(items)
            else:
                self._solo_queries += 1
        for idx, it in enumerate(items):
            if idx in dead or it.ticket.done.is_set():
                continue
            try:
                result = it.finalize(accs[idx])
            except Exception as exc:  # noqa: BLE001
                self._finish(it.ticket, error=exc)
                continue
            it.ticket.shared_with = len(items) - 1
            st = it.stats.as_dict()
            st["skipped"] = max(
                len(self.table.partitions) - it.stats.executed, 0)
            st["h2d_ms"] = round(pass_stats.h2d_ms, 3)  # pass-level wait
            # resilience is a property of the PASS (retries and depth
            # degradations happen in the shared ring), surfaced to every
            # subscriber so any one ticket's stats tell the whole story
            st["retries"] = pass_stats.retries
            st["degradations"] = pass_stats.degradations
            st["prefetch_depth"] = pass_stats.prefetch_depth
            self._finish(it.ticket, result=result, stats=st)

    def _run_solo(self, item: _Prepped) -> None:
        """Row-terminal ranked query: per-query speculative prune order
        (§10) — runs alone, but through the residency LRU (whose stored
        transfer ``PartitionedQuery.run`` waits on) and its cached
        program."""
        q = item.ticket.query
        err = self._cancel_error(item.ticket)
        if err is not None:
            self._finish(item.ticket, error=err)
            return
        hits0 = self.lru.hits

        def fetch(part):
            # the streamed executor calls this once per surviving
            # partition: a cooperative cancellation point for solo runs
            cerr = self._cancel_error(item.ticket)
            if cerr is not None:
                raise cerr
            return self.lru.fetch(self._pid_of[id(part)], part)[0]

        q._transfer_fn = fetch
        q._program_override = item.entry.program
        try:
            try:
                result = q.run()
            except DeviceOOMError:
                # mirror the shared pass: shed residency pressure once,
                # then retry with a cold LRU before failing the ticket
                telemetry.record_fault(
                    "serve_oom", qid=q.qid,
                    resident_bytes=self.lru.resident_bytes)
                with self._stats_lock:
                    self._oom_fallbacks += 1
                self.lru.clear()
                result = q.run()
        except Exception as exc:  # noqa: BLE001
            self._finish(item.ticket, error=exc)
            return
        finally:
            q._transfer_fn = None
            q._program_override = None
        with self._stats_lock:
            self._scan_passes += 1
            self._solo_queries += 1
        st = dict(q.last_stats)
        # the drain thread serializes execution, so the hit delta is ours
        st["lru_hits"] = self.lru.hits - hits0
        st["transferred"] = max(st.get("transferred", 0) - st["lru_hits"], 0)
        self._finish(item.ticket, result=result, stats=st)

    def _finish(self, ticket: Ticket, result=None, error=None,
                stats=None) -> None:
        if ticket.done.is_set():
            return  # cancel()/result(timeout) raced the drain: first wins
        now = time.perf_counter()
        if stats is not None:
            stats["queue_ms"] = round(ticket.queue_ms, 3)
            stats["prep_ms"] = round(ticket.prep_ms, 3)
        ticket.result = result
        ticket.error = error
        ticket.stats = stats
        ticket.latency_ms = (now - ticket.submitted) * 1e3
        with self._stats_lock:
            self._last_done = now
            if error is None:
                self._completed += 1
                self._latencies_ms.append(ticket.latency_ms)
            elif isinstance(error, QueryDeadlineExceeded):
                self._expired += 1
            elif isinstance(error, QueryCancelled):
                self._cancelled += 1
            else:
                self._errors += 1
        if isinstance(error, QueryDeadlineExceeded):
            telemetry.record_fault("serve_deadline", ticket=ticket.qid)
        elif isinstance(error, QueryCancelled):
            telemetry.record_fault("serve_cancel", ticket=ticket.qid)
        ticket.done.set()

    # -- observability / lifecycle -----------------------------------------

    def stats(self) -> Dict[str, object]:
        """Counters since the server started; ``p50_ms`` / ``p99_ms`` /
        ``mean_ms`` over the last ``LATENCY_HISTORY`` completions."""
        with self._stats_lock:
            lats = np.asarray(self._latencies_ms, dtype=np.float64)
            completed = self._completed
            window = 0.0
            if self._first_submit is not None and self._last_done is not None:
                window = max(self._last_done - self._first_submit, 0.0)
            out = {
                "completed": completed,
                "errors": self._errors,
                "timeouts": self._timeouts,
                "cancelled": self._cancelled,
                "expired": self._expired,
                "oom_fallbacks": self._oom_fallbacks,
            }
            scans = {
                "passes": self._scan_passes,
                "shared_queries": self._shared_queries,
                "solo_queries": self._solo_queries,
            }
        plan_total = self.plans.hits + self.plans.misses
        res_total = self.lru.hits + self.lru.misses
        out.update({
            "qps": round(completed / window, 3) if window > 0 else 0.0,
            "p50_ms": round(float(np.percentile(lats, 50)), 3) if lats.size else 0.0,
            "p99_ms": round(float(np.percentile(lats, 99)), 3) if lats.size else 0.0,
            "mean_ms": round(float(lats.mean()), 3) if lats.size else 0.0,
            "plan_cache": {
                "hits": self.plans.hits,
                "misses": self.plans.misses,
                "size": len(self.plans),
                "capacity": self.plans.capacity,
                "hit_rate": round(self.plans.hits / plan_total, 3)
                            if plan_total else 0.0,
            },
            "residency": {
                "hits": self.lru.hits,
                "misses": self.lru.misses,
                "evictions": self.lru.evictions,
                "resident_bytes": self.lru.resident_bytes,
                "resident_partitions": len(self.lru),
                "budget_bytes": self.budget_bytes,
                "hit_rate": round(self.lru.hits / res_total, 3)
                            if res_total else 0.0,
            },
            "scans": scans,
            "graphs": self.graphs.stats(),
        })
        return out

    def close(self, drain: bool = True) -> None:
        """Stop the server and release resident buffers.

        ``drain=True`` (default) EXECUTES everything already queued
        before stopping — submitted work is never silently discarded.
        ``drain=False`` cancels the queue instead (each queued ticket
        fails with ``QueryCancelled``; waiters unblock immediately).
        Either way the in-flight batch, if any, finishes."""
        dropped: List[Ticket] = []
        with self._cv:
            self._closed = True
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            self._cv.notify_all()
        for t in dropped:
            self._finish(t, error=QueryCancelled(
                f"query {t.qid} cancelled: server closed with drain=False"))
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        else:
            while self.step():  # start=False: drain synchronously
                pass
        # a drain thread killed by _fatal leaves its queue behind: fail
        # those tickets so their waiters unblock instead of hanging
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
        for t in leftovers:
            self._finish(t, error=self._fatal if self._fatal is not None
                         else QueryCancelled(
                             f"query {t.qid} cancelled: server closed"))
        self.lru.clear()
        self.plans.drop_graphs()
        self.graphs.release()

    def recover(self) -> "QueryServer":
        """Clear a ``_fatal`` invariant violation and resume serving.

        The plan-cache contract violation parks its exception in
        ``_fatal`` and stops the drain thread — every later ``submit``
        re-raises it. Recovery drops the poisoned plan cache entirely
        (every signature builds again — correct, just cold), evicts the
        residency LRU, and restarts the drain thread. A no-op on a healthy
        server; raises on a closed one."""
        with self._cv:
            if self._closed:
                raise RuntimeError("cannot recover a closed QueryServer")
            was_fatal = self._fatal is not None
            self._fatal = None
        if was_fatal:
            self.plans = PlanCache(self.plans.capacity)
            self.lru.clear()
            telemetry.record_fault("serve_recover")
        if self._started and (self._worker is None
                              or not self._worker.is_alive()):
            self._worker = self._spawn_worker()
        return self

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
