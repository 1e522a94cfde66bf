"""Device ms of the port's own kernels (the names frozen in
``perfbench/kernels.json``) in the profiled slice, over the queries
answered in it."""
from perfbench.metrics import _slice


def read(run):
    return _slice.per_query(run, lambda s: s.seconds_by_kind["port"])
