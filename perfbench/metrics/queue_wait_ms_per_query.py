"""The mean over the queries answered in the window of their ticket's
``queue_ms``: the server's time from submission to admission into a
batch (its ``serve.queue`` span)."""


def read(run):
    waits = [r.stats["queue_ms"] for r in run.done()
             if r.stats and "queue_ms" in r.stats]
    return sum(waits) / len(waits) if waits else None
