"""Engine-wide telemetry: spans, counters, per-query traces (DESIGN.md §14).

PyTorch port of ``repro.core.telemetry``, kept separate so ``repro_torch``
never imports the JAX package. The callers are the planner
(``plan.Query``: query ids, ``plan.join_side``, ``plan.program``), the
partitioned and streamed executors (``core/partition.py``,
``core/stream.py``), the server (``core/serve.py``), the kernel router
(``kernels.dispatch._route``) and the kernel wrappers
(``kernels._build.count_launch``).

The engine grew three disconnected observability islands — ``StreamStats``
on the pipelined executor, ``QueryServer.stats()`` on the serving layer,
and ad-hoc ``trace_count`` / transfer counters in tests and benches. This
module is the one registry they all fold into, so a single trace answers
"where did this query's time and bytes go, and why did the planner choose
that path?" end to end:

  * ``span(name, track=, **attrs)`` — a context manager recording one
    complete event (wall-clock begin + duration) into a bounded ring
    buffer. ``track`` is the LOGICAL pipeline stage ("main" / "transfer" /
    "device"), not the OS thread: the depth-``k`` executor's copy runs on
    a worker thread but renders on the transfer track, and the
    dispatch->retire window of each device program renders on the device
    track (DESIGN.md §12's three overlappable stages, one track each).
    ``timed(...)`` is the same span, always timed, that also adds its
    milliseconds to a field (the executor's ``StreamStats``, a ticket's
    ``prep_ms``), so the stats and the trace come from one timestamp
    pair. ``interval(...)`` records a window measured elsewhere (one that
    crosses threads, such as a ticket's ``serve.queue``): ring only.

  * the profiler's trace — while recording, every span also opens a
    range named ``repro.<name>`` on the thread doing the work, for the
    span's whole extent, so a running ``torch.profiler`` places it on its
    own clock among the device's kernels and copies. Recording is on
    while such a profiler runs, whatever the policy says.

  * monotonic counters — ``add_counter`` / ``counter``. The H2D transfer
    counters (``h2d_calls`` / ``h2d_bytes``) are ALWAYS on, enabled or
    not: ``h2d_listener`` observes the same calls, so the transfer counts
    a bench and the tests read cannot diverge.

  * per-query traces — every span/instant carries the ``qid`` of the
    query that caused it (``telemetry.next_qid`` hands out process-unique
    ids; ``plan.Query`` takes one at staging time), and
    ``query_trace(qid)`` filters the buffer to one query's events. The
    serving layer tags shared-scan spans per subscriber, so co-batched
    queries separate cleanly in one trace.

Enablement & cost: recording is on while ``DispatchPolicy.enable_trace``
(env ``REPRO_TRACE``, default off) is set or a ``torch.profiler``
runs. Off, ``span()`` returns a shared no-op context manager after two
flag reads — no allocation, no lock, no timestamps — and the always-on
work is the two integer adds of ``record_h2d`` per PARTITION transfer
(micro- to milliseconds of device work each) and the clock reads of the
``timed`` stages. The ring buffer holds
``DispatchPolicy.trace_buffer_events`` events (env
``REPRO_TRACE_BUFFER``); beyond that the OLDEST events drop (the
``dropped_events`` counter says how many), so tracing a long-running
server is bounded-memory by construction.

Export: ``export_chrome_trace(path)`` writes the buffer in the Chrome
trace-event JSON format (load in ``chrome://tracing`` / Perfetto): one
process, one row per track, spans as complete ("X") events with their
attrs inspectable per event, timestamps in Unix-epoch microseconds (the
profiler's clock), so it overlays a ``torch.profiler`` trace of the run.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from torch.autograd import profiler as _torch_profiler

try:
    # a FUNCTION-scope range: a CPU op in the profiler's trace. A
    # ``record_function`` range is a user annotation, which the profiler
    # also copies onto the device's timeline over the kernels it launched,
    # where it would read as device time.
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # spans then stay out of the profiler's trace
    _Range = None

# Logical stage tracks (chrome-trace rows), in render order. Spans may
# name other tracks; they get rows after these. ``fault`` carries the
# resilience events (injections, retries, degradations, cancellations —
# DESIGN.md §15), kept on their own row so a chaos trace reads at a
# glance.
TRACKS = ("main", "transfer", "device", "fault")

_DEFAULT_BUFFER = 1 << 16


def _policy():
    # lazy: kernels.dispatch imports this module's recorders; importing it
    # back at module level would cycle the layering
    from repro_torch.kernels import dispatch
    return dispatch.policy()


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process.

    Read from the module flag torch keeps for such fast checks; every
    profiler sets it, one that profiles all threads included (where
    ``torch.autograd._profiler_enabled()`` reads False on other threads).
    False where this torch has no such flag."""
    return getattr(_torch_profiler, "_is_profiler_enabled", False)


def enabled() -> bool:
    """Live read: recording is on while the policy's ``enable_trace`` is
    set (``dispatch.overrides(enable_trace=True)`` turns it on for exactly
    the extent of the ``with`` block) or a profiler runs."""
    return _policy().enable_trace or profiling()


def buffer_limit() -> int:
    lim = _policy().trace_buffer_events
    return lim if lim and lim > 0 else _DEFAULT_BUFFER


def _epoch_ns() -> int:
    """Unix-epoch ns at ``perf_counter``'s zero: what puts the ring's
    ``perf_counter`` times on the clock of the profiler's events."""
    return time.time_ns() - time.perf_counter_ns()


class Telemetry:
    """Thread-safe span/counter registry with a bounded event ring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._counters: Dict[str, float] = {}
        self.dropped = 0
        self.epoch_ns = _epoch_ns()

    # -- events -------------------------------------------------------------

    def record(self, name: str, t0: float, dur: float, track: str = "main",
               **attrs) -> None:
        """Append one complete span (``t0``/``dur`` in perf_counter secs)."""
        ev = {"name": name, "track": track, "ts": t0, "dur": dur,
              "attrs": attrs}
        limit = buffer_limit()
        with self._lock:
            self._events.append(ev)
            if len(self._events) > limit:
                drop = len(self._events) - limit
                for _ in range(drop):
                    self._events.popleft()
                self.dropped += drop
                self._counters["dropped_events"] = self.dropped

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        """A zero-duration marker event (routing decisions, verdicts)."""
        self.record(name, time.perf_counter(), 0.0, track, **attrs)

    def events(self, qid: Optional[int] = None,
               name: Optional[str] = None) -> List[dict]:
        """Snapshot of the buffer, optionally filtered by query id / name."""
        with self._lock:
            evs = list(self._events)
        if qid is not None:
            evs = [e for e in evs if e["attrs"].get("qid") == qid]
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    def query_trace(self, qid: int) -> List[dict]:
        """Every recorded event attributed to query ``qid``."""
        return self.events(qid=qid)

    # -- counters -----------------------------------------------------------

    def add_counter(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    # -- lifecycle ----------------------------------------------------------

    def reset(self) -> None:
        """Clear events and counters; re-read the clocks' offset."""
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self.dropped = 0
            self.epoch_ns = _epoch_ns()

    # -- export -------------------------------------------------------------

    def export_chrome_trace(self, path: str) -> str:
        """Write the buffer as Chrome trace-event JSON; returns ``path``.

        One process ("repro-engine"), one named thread row per track
        (DESIGN.md §12's main / transfer / device stages), spans as
        complete ("X") events and zero-duration events as instants ("i"),
        timestamps in Unix-epoch µs, the clock of ``torch.profiler``'s
        events, so the two traces of one run overlay. Loadable in
        chrome://tracing or https://ui.perfetto.dev.
        """
        with self._lock:
            evs = list(self._events)
            epoch_us = self.epoch_ns / 1e3
        tracks = list(TRACKS)
        for ev in evs:
            if ev["track"] not in tracks:
                tracks.append(ev["track"])
        tid_of = {t: i for i, t in enumerate(tracks)}
        out = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": "repro-engine"}}]
        for t, i in tid_of.items():
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": i, "args": {"name": t}})
            out.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                        "tid": i, "args": {"sort_index": i}})
        for ev in evs:
            rec = {"name": ev["name"], "pid": 0,
                   "tid": tid_of[ev["track"]],
                   "ts": epoch_us + ev["ts"] * 1e6,
                   "args": {k: v for k, v in ev["attrs"].items()
                            if v is not None}}
            if ev["dur"] > 0:
                rec["ph"] = "X"
                rec["dur"] = ev["dur"] * 1e6
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            out.append(rec)
        with open(path, "w") as f:
            json.dump({"traceEvents": out,
                       "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped}}, f)
        return path


# ---------------------------------------------------------------------------
# Module-level registry + convenience API (what the engine calls)
# ---------------------------------------------------------------------------

_REGISTRY = Telemetry()
_QIDS = itertools.count()


def registry() -> Telemetry:
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


def next_qid() -> int:
    """Process-unique query id (``plan.Query`` takes one at staging)."""
    return next(_QIDS)


def export_chrome_trace(path: str) -> str:
    return _REGISTRY.export_chrome_trace(path)


def query_trace(qid: int) -> List[dict]:
    return _REGISTRY.query_trace(qid)


class _Span:
    """A timed block on the thread doing the work. While recording it
    holds a profiler range ``repro.<name>`` open for its whole extent and
    lands in the ring at its end; with ``into`` it adds its milliseconds
    to ``into.<field>`` whether or not it records. A block that raises
    adds nothing to the field and is recorded with ``error=<exception
    type>``."""

    __slots__ = ("name", "track", "attrs", "into", "field", "rec", "t0",
                 "t1", "_range")

    def __init__(self, name, track, attrs, into=None, field=None, rec=True):
        self.name = name
        self.track = track
        self.attrs = attrs
        self.into = into
        self.field = field
        self.rec = rec
        self._range = None

    def __enter__(self):
        if self.rec and _Range is not None:
            self._range = _Range("repro." + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        self.t1 = t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        dur = t1 - self.t0
        if exc_type is None and self.field is not None:
            setattr(self.into, self.field,
                    getattr(self.into, self.field) + dur * 1e3)
        if self.rec:
            attrs = self.attrs
            if exc_type is not None:
                attrs = dict(attrs, error=exc_type.__name__)
            _REGISTRY.record(self.name, self.t0, dur, self.track, **attrs)
        return False


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, track: str = "main", **attrs):
    """Span context manager; the shared no-op when tracing is disabled."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name, track, attrs)


def timed(name: str, track: str, into, field: Optional[str], **attrs):
    """A span that is timed whether or not it records: it adds its ms to
    ``into.<field>`` (``field=None``: to nothing) and, while recording,
    is the span ``name``. Its ``t1`` is the clock read at its end."""
    return _Span(name, track, attrs, into, field, enabled())


def interval(name: str, t0: float, t1: float, track: str = "main",
             **attrs) -> None:
    """Record the window ``[t0, t1]`` (``perf_counter`` seconds) measured
    elsewhere, such as one that starts on another thread: ring only."""
    if enabled():
        _REGISTRY.record(name, t0, t1 - t0, track, **attrs)


def instant(name: str, track: str = "main", **attrs) -> None:
    if enabled():
        _REGISTRY.instant(name, track, **attrs)


def add_counter(name: str, value: float = 1) -> None:
    _REGISTRY.add_counter(name, value)


# ---------------------------------------------------------------------------
# H2D transfer accounting — the single source of truth
# ---------------------------------------------------------------------------
#
# ``partition._put_columns`` (the ONE device_put boundary of the streamed
# out-of-core path, residency LRU included) reports every transfer here.
# The counters are always on; listeners let benches/tests observe per-call
# granularity (bytes, and the host tree that shipped) without stubbing the
# copy: the benchmark's served deployment and the tests count transfers
# through ``h2d_listener``.

_h2d_listeners: List[Callable] = []


def record_h2d(nbytes: int, tree=None, qid: Optional[int] = None) -> None:
    """Book one host->device partition transfer of ``nbytes`` bytes."""
    _REGISTRY.add_counter("h2d_calls", 1)
    _REGISTRY.add_counter("h2d_bytes", nbytes)
    for fn in list(_h2d_listeners):
        fn(nbytes, tree)
    if enabled():
        _REGISTRY.instant("h2d", track="transfer", bytes=nbytes, qid=qid)


# ---------------------------------------------------------------------------
# Fault-path accounting (DESIGN.md §15)
# ---------------------------------------------------------------------------


def record_fault(event: str, **attrs) -> None:
    """Book one fault-path event: an injected fault, a transfer retry, a
    depth degradation, an OOM-triggered serving fallback, a cancellation
    or deadline expiry. The ``fault.<event>`` counter is ALWAYS on (like
    the H2D counters — fault handling is rare and load-bearing, so
    operators must see it without enabling tracing); with tracing on the
    event also lands in the ring as an instant on the ``fault`` track."""
    _REGISTRY.add_counter(f"fault.{event}")
    if enabled():
        _REGISTRY.instant(f"fault.{event}", track="fault", **attrs)


@contextlib.contextmanager
def h2d_listener(fn: Callable):
    """Subscribe ``fn(nbytes, tree)`` to every H2D transfer for the scope."""
    _h2d_listeners.append(fn)
    try:
        yield fn
    finally:
        _h2d_listeners.remove(fn)


# ---------------------------------------------------------------------------
# Kernel-dispatch routing records and kernel launches
# ---------------------------------------------------------------------------


def record_route(primitive: str, path: str, reason: str) -> None:
    """Record one dispatch routing decision (kernels/dispatch.py).

    The port runs eagerly, so the router decides on every call: one
    record marks one routed call (per partition, per program run), not a
    compilation. ``reason`` names the threshold that decided (e.g.
    ``n=65536>=unpack_min_vals=4096``)."""
    if not enabled():
        return
    _REGISTRY.add_counter(f"route.{primitive}.{path}", 1)
    _REGISTRY.instant(f"route.{primitive}", track="main", path=path,
                      reason=reason)


def record_kernel(name: str, nbytes: int) -> None:
    """While recording, a ``kernel`` instant on the device track for one
    launch of the port's kernel ``name`` (``kernels._build.count_launch``):
    ``nbytes`` is the least the launch must move, each input read once
    and each output written once."""
    if enabled():
        _REGISTRY.instant("kernel", track="device", kernel=name,
                          nbytes=nbytes)
