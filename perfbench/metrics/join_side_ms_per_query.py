"""Host ms of the program's ``plan.join_side`` spans (a join's dimension
side, built in ``Query._prepare_join_side``) in the profiled slice, over
the queries the program worked on there (``_spans.ms_per_query``)."""
from perfbench.metrics import _spans


def read(run):
    return _spans.ms_per_query(run, ("plan.join_side",))
