"""The mean over the queries answered in the window of their ticket's
``h2d_ms``: the serving thread's wait on copies in the query's pass."""


def read(run):
    waits = [r.stats["h2d_ms"] for r in run.done()
             if r.stats and "h2d_ms" in r.stats]
    return sum(waits) / len(waits) if waits else None
