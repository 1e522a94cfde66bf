"""MB (10^6 bytes) moved host to device in the window
(``telemetry.h2d_listener``), over the queries answered in it."""


def read(run):
    done = run.done()
    if not done or "h2d_bytes" not in run.counters.get("end", {}):
        return None
    return run.counter_delta("h2d_bytes") / 1e6 / len(done)
