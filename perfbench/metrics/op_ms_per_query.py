"""Device ms of the library's operations (neither a kernel of the port nor
a copy) in the profiled slice, over the queries answered in it."""
from perfbench.metrics import _slice


def read(run):
    return _slice.per_query(run, lambda s: s.seconds_by_kind["library"])
