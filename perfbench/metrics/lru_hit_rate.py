"""Residency hits over hits and misses of the server's device LRU, as
deltas of ``QueryServer.stats()`` over the window."""


def read(run):
    if "lru_hits" not in run.counters.get("end", {}):
        return None
    hits, misses = run.counter_delta("lru_hits"), run.counter_delta("lru_misses")
    return hits / (hits + misses) if hits + misses else None
