"""Queries (shared and solo) over scan passes of the server, as deltas of
``QueryServer.stats()`` over the window."""


def read(run):
    if "passes" not in run.counters.get("end", {}):
        return None
    passes = run.counter_delta("passes")
    queries = (run.counter_delta("shared_queries")
               + run.counter_delta("solo_queries"))
    return queries / passes if passes else None
