"""CUDA launch, copy and memset runtime calls in the profiled slice, over
the queries answered in it."""
from perfbench.metrics import _slice


def read(run):
    done = _slice.answered(run)
    return run.slice.runtime_calls / len(done) if done else None
