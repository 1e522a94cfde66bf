"""The reduction of a profiled slice to device busy time, time by kind of
device operation, runtime calls and named idle gaps.

Device intervals (kernels, copies, memsets, on every stream) are merged
before they are summed, so overlapping streams count once. The functions
below take plain ``Event`` tuples, so the arithmetic is tested without a
card; ``events_of`` turns a ``torch.profiler`` session into them.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, List, Optional, Sequence, Tuple

SLICE = "perfbench.slice"
REQUEST = "perfbench.request."
COPY = re.compile(r"^(Memcpy|Memset)")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
LAUNCH_OR_COPY = re.compile(r"^cu(da)?\w*(Launch|Memcpy|Memset)")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start_us: float
    end_us: float
    device: bool  # ran on the card (kernel, copy, memset)


def events_of(prof) -> List[Event]:
    """Every event of a ``torch.profiler`` session, device ones marked,
    read from the profiler's raw results (building its event tree takes
    minutes for a slice of seconds). Times are microseconds from the
    session's first event. The device-side copies of the benchmark's own
    ranges (``perfbench.*`` user annotations, which span a request's
    device work and the gaps in it) are left out: they are no operation."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in raw), default=0)
    out = []
    for e in raw:
        name = e.name()
        device = e.device_type() == DeviceType.CUDA
        if device and name.startswith("perfbench."):
            continue
        start = (e.start_ns() - t0) / 1e3
        out.append(Event(name, start, start + e.duration_ns() / 1e3, device))
    return out


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kind_of(name: str, symbols: Sequence[str]) -> str:
    """``copy``, ``port`` (a kernel of the port, by symbol) or ``library``."""
    if COPY.match(name):
        return "copy"
    if any(re.search(rf"\b{re.escape(s)}\b", name) for s in symbols):
        return "port"
    return "library"


def short(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:120] or name[:120]


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    seconds_by_kind: dict  # copy / port / library: summed device seconds
    runtime_calls: int  # CUDA launch, copy and memset calls on the host
    device_ops: list  # [[name, seconds]], the 10 largest by total
    idle_gaps: list  # [[name, seconds]], the 10 longest gaps


def _gap_name(start: float, end: float, cpu: Sequence[Event]) -> str:
    """What the host was doing in a gap: the innermost op running at its
    middle, else Python after the last op that ended before it; prefixed
    by the request's shape where one request alone was open."""
    mid = (start + end) / 2
    covering = [e for e in cpu if e.start_us <= mid <= e.end_us]
    labels = {e.name[len(REQUEST):] for e in covering
              if e.name.startswith(REQUEST)}
    ops = [e for e in cpu if not e.name.startswith("perfbench.")
           and not RUNTIME.match(e.name)]
    inner = [e for e in ops if e.start_us <= mid <= e.end_us]
    if inner:
        what = max(inner, key=lambda e: e.start_us).name
    else:
        before = [e for e in ops if e.end_us <= start]
        what = ("python after " + max(before, key=lambda e: e.end_us).name
                if before else "python")
    return f"{labels.pop()}: {what}" if len(labels) == 1 else what


def reduce(events: Sequence[Event], symbols: Sequence[str],
           window: Optional[Tuple[float, float]] = None) -> Optional[Slice]:
    """The slice between the ``perfbench.slice`` marker's ends (or
    ``window``), or None when no device operation ran in it."""
    if window is None:
        marks = [e for e in events if e.name == SLICE and not e.device]
        if not marks:
            return None
        # the host's range, not a device-side annotation of the same name
        mark = max(marks, key=lambda e: e.end_us - e.start_us)
        window = (mark.start_us, mark.end_us)
    t0, t1 = window
    dev = [(e.name, max(e.start_us, t0), min(e.end_us, t1))
           for e in events if e.device and e.end_us > t0 and e.start_us < t1]
    busy = union((s, e) for _, s, e in dev)
    if not busy:
        return None
    by_kind = {"copy": 0.0, "port": 0.0, "library": 0.0}
    by_name: dict = {}
    for name, s, e in dev:
        by_kind[kind_of(name, symbols)] += (e - s) / 1e6
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    cpu = [e for e in events if not e.device and e.end_us > t0
           and e.start_us < t1 and e.name != SLICE]
    calls = sum(1 for e in cpu if LAUNCH_OR_COPY.match(e.name))
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return Slice(
        window_s=(t1 - t0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        seconds_by_kind=by_kind, runtime_calls=calls,
        device_ops=sorted(([k, v] for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:10],
        idle_gaps=[[_gap_name(s, e, cpu), (e - s) / 1e6]
                   for s, e in longest])
