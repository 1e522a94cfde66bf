"""Fault taxonomy + deterministic fault injection (DESIGN.md §15).

PyTorch port: a copy of ``repro.core.faults`` (pure Python), kept
separate so the port never imports the JAX package. The reference never
maps a real allocator failure to ``DeviceOOMError`` (only its fault
plans raise it), and neither does the port.

The streamed executor and the serving layer promise more than speed: a
transient H2D failure must retry, a device OOM must degrade the prefetch
ring instead of killing the query, a wedged query must be cancellable,
and NONE of those paths can be trusted without a way to trigger them on
demand. This module provides both halves:

  * the **error taxonomy** every resilience decision keys on.
    ``TransientTransferError`` is the only retryable class (the transfer
    loop backs off and re-issues); ``DeviceOOMError`` triggers
    ring-retirement + depth degradation in ``stream`` and batch
    shrinking / LRU eviction in ``serve``; ``QueryCancelled`` /
    ``QueryDeadlineExceeded`` are the serving layer's cooperative
    cancellation signals; ``ValidationError`` marks corrupted compressed
    inputs (``Table.validate``). Anything else is terminal and propagates
    with the ring cleaned up behind it.

  * a **deterministic injection harness**: a ``FaultPlan`` schedules
    faults at exact ``(site, partition, attempt)`` coordinates — where
    ``site`` is one of the executor's three probe points (``"transfer"``
    = the single host-to-device transfer boundary, ``"compute"`` = device
    program execution, ``"fold"`` = the host merge; the serving layer adds
    ``"program"`` for per-subscriber shared-scan programs) and
    ``attempt`` counts how many times that (site, partition) pair has
    been probed *within the plan's scope* (so a retry or a
    degraded-depth re-run naturally advances past an attempt-0 fault).
    Entering the plan (``with plan: ...``) activates it process-wide —
    the prefetch ring's transfer worker thread must see it too — and
    flips ``DispatchPolicy.enable_fault_injection`` on for the scope.

Production cost: every probe site calls ``maybe_inject``, which returns
after ONE policy-field read when injection is disabled (the same
contract as telemetry spans — ``REPRO_FAULTS`` / bench_stream's <2%
overhead gate covers it). Plans are deterministic by construction:
coordinates are exact, and the seeded constructor derives them from a
``numpy`` Generator, never from wall clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import telemetry


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of the engine's resilience taxonomy (DESIGN.md §15)."""


class TransientTransferError(FaultError):
    """A host->device copy failed in a retryable way. The ONLY class the
    transfer loop retries (exponential backoff, ``transfer_retries`` /
    ``transfer_backoff_ms``); exhausting the budget re-raises it."""


class DeviceOOMError(FaultError):
    """Device allocator exhaustion. The streamed executor responds by
    retiring the prefetch ring, halving the depth and retrying the failed
    partition; the serving layer responds by evicting LRU residents and
    splitting the shared batch before failing the query."""


class QueryCancelled(FaultError):
    """Cooperative cancellation: the ticket was cancelled (explicitly,
    by a ``result(timeout=)`` expiry on a still-queued ticket, or by
    ``close(drain=False)``) and its query stopped at a partition
    boundary."""


class QueryDeadlineExceeded(QueryCancelled):
    """The ticket's ``submit(deadline_s=)`` budget elapsed before the
    query finished; treated as a cancellation at the next boundary."""


class ValidationError(ValueError):
    """A compressed column/table failed an integrity invariant
    (``Table.validate`` / ``PartitionedTable.validate``): corrupted
    inputs fail loudly at ingest instead of producing wrong masks."""


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

KINDS = ("transient", "oom", "latency")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault at exact (site, partition, attempt) coords."""

    site: str  # "transfer" | "compute" | "fold" | "program"
    part: int  # partition label (ingest index)
    attempt: int  # nth probe of (site, part) within the plan's scope
    kind: str  # "transient" | "oom" | "latency"
    latency_ms: float = 0.0


class FaultPlan:
    """Deterministic, scoped fault schedule.

    Build one explicitly (``plan.transient(part=3)``, ``plan.oom(part=7,
    site="compute")``, ``plan.latency(part=1, ms=5)`` — chainable) or
    seed it (``FaultPlan.seeded(seed, parts=16)``), then activate it for
    a scope::

        with FaultPlan().transient(3).oom(7, site="compute"):
            query.run()

    Activation is process-global (the transfer worker thread probes the
    same plan) and force-enables ``DispatchPolicy.enable_fault_injection``
    for the scope, restoring the previous policy on exit. ``fired``
    records every injected fault in probe order; attempt counters live in
    the plan, so one plan spanning retries, degraded re-runs, and a
    shared-pass-then-solo serving fallback keeps advancing instead of
    re-firing attempt 0 forever.
    """

    def __init__(self, faults: Tuple[Fault, ...] = ()):
        self._faults: Dict[Tuple[str, int, int], Fault] = {
            (f.site, f.part, f.attempt): f for f in faults}
        self._counts: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()
        self.fired: List[Fault] = []
        self._saved_policy = None

    # -- construction -------------------------------------------------------

    def add(self, fault: Fault) -> "FaultPlan":
        if fault.kind not in KINDS:
            raise ValueError(f"unknown fault kind {fault.kind!r}")
        self._faults[(fault.site, fault.part, fault.attempt)] = fault
        return self

    def transient(self, part: int, attempt: int = 0,
                  site: str = "transfer") -> "FaultPlan":
        return self.add(Fault(site, part, attempt, "transient"))

    def oom(self, part: int, attempt: int = 0,
            site: str = "transfer") -> "FaultPlan":
        return self.add(Fault(site, part, attempt, "oom"))

    def latency(self, part: int, ms: float, attempt: int = 0,
                site: str = "transfer") -> "FaultPlan":
        return self.add(Fault(site, part, attempt, "latency",
                              latency_ms=float(ms)))

    @classmethod
    def seeded(cls, seed: int, parts: int, transients: int = 3,
               ooms: int = 1, oom_site: str = "compute") -> "FaultPlan":
        """Derive a plan from ``seed``: ``transients`` retryable transfer
        faults and ``ooms`` device OOMs, each at attempt 0 of a distinct
        partition (so the default retry budget and one depth halving
        recover every one — the chaos bench's recovery contract)."""
        if transients + ooms > parts:
            raise ValueError(
                f"cannot place {transients}+{ooms} faults on {parts} "
                "distinct partitions")
        rng = np.random.default_rng(seed)
        chosen = rng.choice(parts, size=transients + ooms, replace=False)
        plan = cls()
        for p in chosen[:transients]:
            plan.transient(int(p))
        for p in chosen[transients:]:
            plan.oom(int(p), site=oom_site)
        return plan

    def scheduled(self) -> List[Fault]:
        return list(self._faults.values())

    # -- activation ---------------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        from repro_torch.kernels import dispatch
        with _ACTIVATION_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a FaultPlan is already active; plans "
                                   "do not nest")
            self._saved_policy = dispatch.policy()
            dispatch.set_policy(dataclasses.replace(
                self._saved_policy, enable_fault_injection=True))
            _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        from repro_torch.kernels import dispatch
        with _ACTIVATION_LOCK:
            _ACTIVE = None
            dispatch.set_policy(self._saved_policy)
            self._saved_policy = None

    # -- probing ------------------------------------------------------------

    def fire(self, site: str, part) -> None:
        """Advance the (site, part) attempt counter; raise/sleep if a
        fault is scheduled at the coordinate it just passed."""
        key = (site, part)
        with self._lock:
            attempt = self._counts.get(key, 0)
            self._counts[key] = attempt + 1
            fault = self._faults.get((site, part, attempt))
            if fault is not None:
                self.fired.append(fault)
        if fault is None:
            return
        telemetry.record_fault("injected", site=site, part=part,
                               attempt=attempt, kind=fault.kind)
        if fault.kind == "latency":
            time.sleep(fault.latency_ms * 1e-3)
            return
        msg = (f"injected {fault.kind} fault at site={site} part={part} "
               f"attempt={attempt}")
        if fault.kind == "oom":
            raise DeviceOOMError(msg)
        raise TransientTransferError(msg)

    def attempts(self, site: str, part) -> int:
        """How many times (site, part) has been probed (tests)."""
        with self._lock:
            return self._counts.get((site, part), 0)


_ACTIVE: Optional[FaultPlan] = None
_ACTIVATION_LOCK = threading.Lock()


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def maybe_inject(site: str, part) -> None:
    """Probe one injection site. Production fast path: one policy-field
    read, then return — the same disabled-cost contract as telemetry."""
    from repro_torch.kernels import dispatch
    if not dispatch.policy().enable_fault_injection:
        return
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site, part)
