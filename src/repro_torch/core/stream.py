"""Async pipelined streaming executor (DESIGN.md §12), PyTorch port.

The out-of-core path's cost is three overlappable stages per partition —
host->device transfer, the device program, and the host-side partial
merge. This module runs the per-partition loop as a depth-``k`` software
pipeline:

  * ``pipelined_fold`` — a prefetch ring of up to ``depth`` partitions
    transferred ahead (issued from a dedicated transfer thread; on the
    card the copies run on their own CUDA copy stream, so they overlap
    the compute stream's kernels) of the one whose partial is being
    folded on the host, with exactly ONE device program dispatched beyond
    the partial being drained: the next program is dispatched between
    waiting for partial ``i`` and folding it, so the device runs ``i+1``
    while the host merges ``i`` and partitions ``i+2..i+k`` stream in.
    ``depth=0`` is the fully synchronous reference mode (transfer,
    compute, wait, merge);

  * ``pipelined_ranked_fold`` — the ranked (ORDER BY / TOP-K) variant:
    transfers are issued speculatively up to ``depth`` ahead under the
    pruning bound known at issue time, but execution is gated by a
    re-check at the head of the ring once earlier merges have tightened
    the bound, so the executed set is EXACTLY the sequential path's (the
    ranked partitioned terminal that drives it arrives with ROADMAP A10);

  * ``clamp_depth`` — budget awareness: the ring's in-flight encoded
    copies are clamped against the device-memory budget the table was
    sized for (``rows_for_budget``).

Waiting: a callback may return a ``Pending`` (a value plus the CUDA event
recorded after the work that produces it); ``_block`` waits on that event
alone. It never calls ``torch.cuda.synchronize()``, which would also wait
for the copy stream and remove the overlap the ring exists for. Plain
values (CPU runs, synthetic tests) are ready as they are.

Merges fold in deterministic partition order regardless of depth, so
results are bit-identical at every depth. Stage wall times are recorded
per run (``StreamStats``): ``h2d_ms`` / ``compute_ms`` / ``merge_ms`` are
MAIN-thread wall time spent waiting on transfers, dispatching + waiting
on device programs, and folding partials respectively — a fully hidden
transfer shows up as ``h2d_ms ~ 0``. Each stage is a ``stage`` block:
while telemetry records (``REPRO_TRACE`` or a running profiler, DESIGN.md
§14) it is ALSO a span from the same timestamp pair, open in the
profiler's trace while the stage runs.

Fault tolerance (DESIGN.md §15): both drivers probe the fault-injection
harness (``faults.maybe_inject``) at their three per-partition stages,
retry ``TransientTransferError`` with exponential backoff
(``transfer_retries`` / ``transfer_backoff_ms``), and respond to
``DeviceOOMError`` by retiring the prefetch ring, halving the depth
(floor: the synchronous depth-0 mode) and resuming from the failed
partition — folds are strictly in order, so the carried accumulator is
exact and recovered results stay bit-identical to a fault-free run. Any
terminal error leaves the ring CLEAN: queued transfer futures are
cancelled before the pool shuts down, and ``StreamStats`` is final
whether the driver returned or raised.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import faults, telemetry
from repro_torch.core.faults import DeviceOOMError, TransientTransferError


@dataclasses.dataclass
class StreamStats:
    """Per-run pipeline observability (surfaced via ``last_stats``)."""

    prefetch_depth: int = 0  # effective (post-clamp) depth this run used
    h2d_ms: float = 0.0  # main-thread wait on transfers (hidden -> ~0)
    compute_ms: float = 0.0  # dispatching programs + blocking on partials
    merge_ms: float = 0.0  # folding partials on the host
    inflight_bytes_max: int = 0  # peak bytes transferred-but-not-yet-folded
    transferred: int = 0  # partition transfers issued
    executed: int = 0  # device programs dispatched
    # serving attribution (core/serve.py, DESIGN.md §13, a later port
    # slice): ``lru_hits`` were already device-resident, ``shared_hits``
    # were transferred by a co-batched query in the same shared pass.
    # Standalone PartitionedQuery runs leave both at 0.
    lru_hits: int = 0
    shared_hits: int = 0
    # fault tolerance (DESIGN.md §15): transfer retries performed after
    # TransientTransferErrors, and depth halvings performed after
    # DeviceOOMErrors (``prefetch_depth`` reflects the FINAL depth)
    retries: int = 0
    degradations: int = 0
    # query id the run's trace spans are tagged with (telemetry.next_qid
    # via plan.Query; None on runs driven outside the query layer)
    qid: Optional[int] = None

    def as_dict(self) -> dict:
        # generic over the dataclass fields, so no field is ever
        # populated but dropped
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = round(v, 3) if f.name.endswith("_ms") else v
        return out


_EMPTY: dict = {}


def stage(stats: StreamStats, field: Optional[str], name: str,
          track: str = "main", attrs: dict = _EMPTY):
    """A block timed into ``stats.<field>`` that is also the span ``name``
    while telemetry records (``telemetry.timed``, tagged ``stats.qid``).

    The ``StreamStats`` a run reports and the spans in its trace come from
    the SAME timestamp pairs, so ``explain_analyze`` / bench JSONs and the
    Chrome trace reconcile by construction. ``field=None`` times a span
    with no stats counterpart (the worker thread's ``transfer``). A stage
    that raises adds nothing to ``stats`` and is recorded with its
    ``error``.
    """
    return telemetry.timed(name, track, stats, field, qid=stats.qid,
                           **attrs)


def clamp_depth(depth: int, max_part_nbytes: int,
                budget_bytes: Optional[int]) -> int:
    """Clamp the prefetch depth against the declared device-memory budget.

    ``rows_for_budget`` sizes ONE partition's working set to the budget;
    the prefetch ring adds up to ``depth`` encoded in-flight copies on
    top. Those extra copies are allowed one further budget's worth of
    memory (the seed's double-buffer already implied one undeclared copy)
    — beyond that the depth is clamped with a warning rather than
    silently overshooting the budget the caller asked for. Tables ingested
    without a budget (``budget_bytes=None``) are never clamped.
    """
    depth = max(int(depth), 0)
    if budget_bytes is None or max_part_nbytes <= 0 or depth <= 1:
        return depth
    fit = max(int(budget_bytes) // int(max_part_nbytes), 1)
    if depth > fit:
        warnings.warn(
            f"prefetch_depth={depth} would keep "
            f"{depth} x {max_part_nbytes} = {depth * max_part_nbytes} "
            f"in-flight bytes against a {budget_bytes}-byte device budget; "
            f"clamping to depth {fit} (REPRO_PREFETCH_DEPTH / "
            "DispatchPolicy.prefetch_depth)", stacklevel=3)
        return fit
    return depth


@dataclasses.dataclass
class Pending:
    """A callback's result whose device work is ordered before ``event``
    (a CUDA event recorded right after it; None when nothing is pending,
    as on the CPU)."""

    value: object
    event: Optional["torch.cuda.Event"] = None


def _block(x) -> None:
    """Wait until ``x`` is ready: on its own event, never device-wide."""
    if isinstance(x, Pending) and x.event is not None:
        x.event.synchronize()


# ---------------------------------------------------------------------------
# Fault handling (DESIGN.md §15)
# ---------------------------------------------------------------------------


class _Restart(Exception):
    """Internal carrier for OOM depth-degradation (never escapes this
    module): holds the cause, the accumulator folded so far, and the
    position of the partition whose transfer/compute/fold cycle failed.
    Folds are strictly in order, so ``acc`` covers exactly
    ``items[start:pos]`` and the outer driver can retire the ring, halve
    the depth, and resume from ``pos`` without re-folding anything."""

    def __init__(self, cause: BaseException, acc, pos: int):
        super().__init__(str(cause))
        self.cause = cause
        self.acc = acc
        self.pos = pos


def _degrade(depth: int, cause: BaseException, stats: StreamStats) -> int:
    """Halve the prefetch depth after a DeviceOOMError (floor 0 = the
    synchronous reference mode); at the floor the OOM is terminal."""
    if depth <= 0:
        raise cause
    new_depth = depth // 2
    stats.degradations += 1
    stats.prefetch_depth = new_depth
    telemetry.record_fault("degrade", qid=stats.qid, depth_from=depth,
                           depth_to=new_depth, cause=type(cause).__name__)
    return new_depth


def _transfer_with_retry(transfer: Callable, item, part,
                         stats: StreamStats):
    """One transfer through the injection probe + bounded exponential
    backoff on ``TransientTransferError`` (the only retryable class —
    ``DeviceOOMError`` degrades instead, anything else is terminal)."""
    from repro_torch.kernels import dispatch
    pol = dispatch.policy()
    retries = max(int(pol.transfer_retries), 0)
    backoff_s = max(float(pol.transfer_backoff_ms), 0.0) * 1e-3
    attempt = 0
    while True:
        try:
            faults.maybe_inject("transfer", part)
            return transfer(item)
        except TransientTransferError as exc:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            attempt += 1
            stats.retries += 1
            telemetry.record_fault("retry", qid=stats.qid, part=part,
                                   attempt=attempt,
                                   backoff_ms=round(delay * 1e3, 3),
                                   error=str(exc))
            if delay > 0:
                time.sleep(delay)


def pipelined_fold(items: Sequence, transfer: Callable, compute: Callable,
                   fold: Callable, init, depth: int, stats: StreamStats,
                   nbytes_of: Optional[Callable] = None,
                   label_of: Optional[Callable] = None):
    """Run ``fold(acc, item, compute(item, transfer(item)))`` over ``items``
    as a depth-``depth`` software pipeline; returns the final ``acc``.

    ``transfer(item)`` issues the (async) host->device copy;
    ``compute(item, cols)`` dispatches the fused device program and
    returns its (async) result; ``fold(acc, item, partial)`` consumes the
    partial on the host — it may block on device values. Items are folded
    strictly in sequence order at every depth, so any associative-in-order
    merge yields bit-identical results regardless of overlap.

    ``depth=0`` serializes every stage (and blocks on each partial before
    folding) — the reference point for the overlap benchmark. With
    ``depth >= 1``, up to ``depth`` transfers beyond the fold head are
    in flight on a dedicated transfer thread, and exactly one device
    program runs ahead of the partial being folded: it is dispatched
    after blocking on partial ``i`` and before folding it, so the fold
    and the next program overlap without ever enqueueing two programs
    against each other (drain included — no global barrier).

    ``label_of(item)`` (optional) names the partition in trace spans'
    ``part`` attr and in fault-injection coordinates (falling back to the
    item's position). All spans carry ``stats.qid``.

    Fault behavior (DESIGN.md §15): transient transfer failures retry
    with backoff; a ``DeviceOOMError`` at any stage retires the ring,
    halves ``depth`` and resumes from the failed partition (terminal at
    depth 0); any terminal error cancels the queued ring futures before
    propagating, so no transfer outlives the call.
    """
    pos, acc = 0, init
    while True:
        try:
            return _fold_pipeline(items, pos, acc, transfer, compute, fold,
                                  depth, stats, nbytes_of, label_of)
        except _Restart as r:
            depth = _degrade(depth, r.cause, stats)
            pos, acc = r.pos, r.acc


def _fold_pipeline(items, start, acc, transfer, compute, fold, depth,
                   stats, nbytes_of, label_of):
    """One pass of ``pipelined_fold`` from position ``start``; raises
    ``_Restart`` on a recoverable DeviceOOMError."""

    def part_of(i):
        return label_of(items[i]) if label_of is not None else i

    def attr(item):
        if label_of is None or not telemetry.enabled():
            return _EMPTY
        return {"part": label_of(item)}

    def xfer(i):
        return _transfer_with_retry(transfer, items[i], part_of(i), stats)

    if depth <= 0:
        i = start
        try:
            while i < len(items):
                item = items[i]
                a = attr(item)
                with stage(stats, "h2d_ms", "transfer", "transfer", a):
                    cols = xfer(i)
                    _block(cols)
                with stage(stats, "compute_ms", "program", "device", a):
                    faults.maybe_inject("compute", part_of(i))
                    partial = compute(item, cols)
                    del cols  # the program holds what it still reads
                    _block(partial)
                with stage(stats, "merge_ms", "fold", "main", a):
                    faults.maybe_inject("fold", part_of(i))
                    acc = fold(acc, item, partial)
                stats.transferred += 1
                stats.executed += 1
                if nbytes_of is not None:
                    stats.inflight_bytes_max = max(stats.inflight_bytes_max,
                                                   nbytes_of(item))
                i += 1
        except DeviceOOMError as exc:
            # at depth 0 _degrade re-raises; the carrier keeps one shape
            raise _Restart(exc, acc, i) from None
        return acc

    ring: deque = deque()  # (pos, item, future cols): transfers in flight
    pending = None  # (pos, item, async partial, t_disp): ONE dispatched
    idx = start
    head = start  # position of the next unfolded item (restart point)
    inflight = 0

    def do_transfer(i):
        # runs on the worker thread; the span is the copy-issue window
        # there, rendered on the transfer track
        with stage(stats, None, "transfer", "transfer", attr(items[i])):
            return xfer(i)

    with ThreadPoolExecutor(max_workers=1) as pool:
        try:

            def top_up():
                # the dispatched-but-unfolded program occupies a ring slot
                # too: at most depth+1 partitions live beyond the fold
                # head, exactly the budget clamp_depth accounts for
                nonlocal idx, inflight
                while (len(ring) + (pending is not None) < depth + 1
                       and idx < len(items)):
                    item = items[idx]
                    ring.append((idx, item, pool.submit(do_transfer, idx)))
                    idx += 1
                    stats.transferred += 1
                    if nbytes_of is not None:
                        inflight += nbytes_of(item)
                        stats.inflight_bytes_max = max(
                            stats.inflight_bytes_max, inflight)

            def dispatch_head():
                i, item, fut = ring.popleft()
                a = attr(item)
                with stage(stats, "h2d_ms", "h2d_wait", "main", a):
                    cols = fut.result()  # ~0 when the copy hid behind compute
                with stage(stats, "compute_ms", "dispatch", "main", a) as d:
                    faults.maybe_inject("compute", part_of(i))
                    partial = compute(item, cols)
                stats.executed += 1
                return i, item, partial, d.t1

            top_up()
            if ring:
                pending = dispatch_head()
            while pending is not None:
                i, item, partial, t_disp = pending
                head = i  # acc covers items[start:i]
                a = attr(item)
                with stage(stats, "compute_ms", "block", "main", a) as b:
                    _block(partial)  # the device is the gate
                # the program's dispatch->retire window on the device
                # track; its halves already fed compute_ms, no stats field
                telemetry.interval("program", t_disp, b.t1, "device",
                                   qid=stats.qid, **a)
                # program ``i`` retired: launch ``i+1`` BEFORE folding
                # ``i`` so the fold runs under the next program
                pending = dispatch_head() if ring else None
                with stage(stats, "merge_ms", "fold", "main", a):
                    faults.maybe_inject("fold", part_of(i))
                    acc = fold(acc, item, partial)
                head = i + 1
                if nbytes_of is not None:
                    inflight -= nbytes_of(item)
                # the fold head advanced: replenish the transfer ring
                # (copies run on the worker while the next program runs)
                top_up()
        except DeviceOOMError as exc:
            raise _Restart(exc, acc, head) from None
        finally:
            # terminal or restarting: cancel queued copies so nothing the
            # caller will never fold still runs under the pool shutdown.
            # (The one possibly-running transfer finishes and is
            # dropped; a restart re-transfers into fresh buffers.)
            for _, _, fut in ring:
                fut.cancel()
            ring.clear()
    return acc


def pipelined_ranked_fold(items: Sequence, transfer: Callable,
                          compute: Callable, fold: Callable,
                          prune: Callable, depth: int,
                          stats: StreamStats,
                          nbytes_of: Optional[Callable] = None,
                          label_of: Optional[Callable] = None
                          ) -> Tuple[object, int, int]:
    """Ranked (TOP-K) pipeline: speculative prefetch, bound-gated execution.

    ``items`` must arrive best-zone-first; ``prune(state, item)`` is True
    when the CURRENT merged state's k-th-best bound proves ``item`` cannot
    contribute. Transfers are issued up to ``depth`` ahead under the bound
    known at issue time — the next best-zone partitions stream in while
    the current merge tightens the bound — but each item is re-checked
    when it reaches the head of the ring, and only then is its device
    program dispatched. The bound tightens monotonically, so:

      * an item prunable at issue time stays prunable (never transferred),
      * an item that the strictly sequential executor would have pruned
        is pruned at the head re-check here — speculation wastes at most
        ``depth`` transfers' worth of BYTES, never an execution and never
        a result (tests/test_stream.py asserts the executed set matches
        depth 0 exactly). A head-pruned item's copy runs on and is
        waited for when the pass ends, never cancelled, so the transfers
        a run makes do not depend on when the worker thread picked them
        up.

    Returns ``(state, ranked_skipped, prefetch_wasted)`` where
    ``prefetch_wasted`` counts transferred-then-pruned items (a subset of
    ``ranked_skipped``).

    Fault behavior matches ``pipelined_fold`` (DESIGN.md §15): transient
    transfer retries, OOM depth-degradation resuming from the failed
    partition (per-item decisions re-checked — the bound only tightens,
    so nothing skipped un-skips), and ring cleanup on terminal errors.
    """
    # per-position outcome ("issue"/"head" prune, "exec"), overwritten on
    # a degraded re-run so skip/waste counts never double-count an item
    decisions: Dict[int, str] = {}
    pos, state = 0, None
    while True:
        try:
            state = _ranked_pipeline(items, pos, state, transfer, compute,
                                     fold, prune, depth, stats, nbytes_of,
                                     label_of, decisions)
            break
        except _Restart as r:
            depth = _degrade(depth, r.cause, stats)
            pos, state = r.pos, r.acc
    skipped = sum(1 for d in decisions.values() if d != "exec")
    wasted = sum(1 for d in decisions.values() if d == "head")
    return state, skipped, wasted


def _ranked_pipeline(items, start, state, transfer, compute, fold, prune,
                     depth, stats, nbytes_of, label_of, decisions):
    """One pass of ``pipelined_ranked_fold`` from position ``start``;
    raises ``_Restart`` on a recoverable DeviceOOMError."""

    def part_of(i):
        return label_of(items[i]) if label_of is not None else i

    def attr(item):
        if label_of is None or not telemetry.enabled():
            return _EMPTY
        return {"part": label_of(item)}

    def do_transfer(i):
        with stage(stats, None, "transfer", "transfer", attr(items[i])):
            return _transfer_with_retry(transfer, items[i], part_of(i),
                                        stats)

    ring: deque = deque()  # (pos, item, future cols): not yet bound-gated
    dropped = []  # futures of head-pruned items, waited for at the end
    idx = start
    head = start
    inflight = 0
    with ThreadPoolExecutor(max_workers=1) as pool:
        try:
            while idx < len(items) or ring:
                while len(ring) < depth + 1 and idx < len(items):
                    i, item = idx, items[idx]
                    idx += 1
                    if prune(state, item):
                        decisions[i] = "issue"
                        if telemetry.enabled():
                            telemetry.instant("ranked_prune", "main",
                                              qid=stats.qid, stage="issue",
                                              **attr(item))
                        continue
                    # speculative, off-thread: bytes at risk, not results
                    ring.append((i, item, pool.submit(do_transfer, i)))
                    stats.transferred += 1
                    if nbytes_of is not None:
                        inflight += nbytes_of(item)
                        stats.inflight_bytes_max = max(
                            stats.inflight_bytes_max, inflight)
                if not ring:
                    break
                i, item, fut = ring.popleft()
                head = i  # state covers every fold up to (not incl.) i
                if nbytes_of is not None:
                    inflight -= nbytes_of(item)
                if prune(state, item):  # merges since issue tightened it
                    decisions[i] = "head"
                    if telemetry.enabled():
                        telemetry.instant("ranked_prune", "main",
                                          qid=stats.qid, stage="head",
                                          wasted_transfer=True, **attr(item))
                    # the speculative copy is left to run and waited for
                    # when the pass ends, never cancelled: whether an
                    # un-started one could still be cancelled depends on
                    # the worker thread's timing, and what a run moves
                    # (and rides from the residency LRU) must not
                    # (ROADMAP.md C7)
                    dropped.append(fut)
                    continue
                a = attr(item)
                with stage(stats, "h2d_ms", "h2d_wait", "main", a):
                    cols = fut.result()
                with stage(stats, "compute_ms", "program", "device", a):
                    faults.maybe_inject("compute", part_of(i))
                    partial = compute(item, cols)  # gated: pruned never run
                    _block(partial)
                with stage(stats, "merge_ms", "fold", "main", a):
                    faults.maybe_inject("fold", part_of(i))
                    state = fold(state, item, partial)
                stats.executed += 1
                decisions[i] = "exec"
        except DeviceOOMError as exc:
            raise _Restart(exc, state, head) from None
        finally:
            for _, _, fut in ring:
                fut.cancel()
            ring.clear()
            for fut in dropped:
                fut.exception()  # its error, if any, is dropped with it
    return state
