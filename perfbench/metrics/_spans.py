"""What the readers of the program's own records share: telemetry's ring
(``repro_torch.core.telemetry``), which the program fills while a
profiler records, read over the profiled slice. The ring's times are
``perf_counter`` seconds, the clock of ``run.slice_window``."""
from perfbench.metrics import _slice


def _records(run):
    """Every event of the ring that ends inside the profiled slice, or
    None: no slice, a program that recorded nothing there (one that keeps
    no such records), or a ring that dropped events which may have ended
    there."""
    if run.slice_window is None:
        return None
    from repro_torch.core import telemetry
    reg = telemetry.registry()
    events = reg.events()
    t0, t1 = run.slice_window
    inside = [e for e in events if t0 <= e["ts"] + e["dur"] <= t1]
    if not inside:
        return None
    # the ring drops its oldest events: none of the slice's is gone while
    # the oldest it kept ended before the slice began
    if reg.dropped and events[0]["ts"] + events[0]["dur"] >= t0:
        return None
    return inside


def _queries(run, inside):
    """How many queries the slice's spans are divided over: those
    answered in the slice (``_slice.answered``, as the device metrics
    count them). That needs the device's slice, which a run with no
    device operation lacks (the CPU); there it is the query ids the
    slice's records carry, since a tiny slice may answer none."""
    if run.slice is not None:
        done = _slice.answered(run)
        return len(done) if done else None
    qids = {e["attrs"]["qid"] for e in inside
            if e["attrs"].get("qid") is not None}
    return len(qids) or None


def ms_per_query(run, names):
    """Milliseconds of the spans named in ``names`` in the slice, over the
    queries of ``_queries``. Host spans, so they read on any device."""
    inside = _records(run)
    if inside is None:
        return None
    n = _queries(run, inside)
    if n is None:
        return None
    return sum(e["dur"] for e in inside if e["name"] in names) * 1e3 / n
