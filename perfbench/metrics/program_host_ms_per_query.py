"""Host ms of the program's query programs in the profiled slice, over
the queries the program worked on there (``_spans.ms_per_query``):
``plan.program`` spans (a resident ``Query.run`` issuing its operators)
and ``serve.program`` spans (the server issuing one query's program on
one partition), each with any wait for the device inside."""
from perfbench.metrics import _spans


def read(run):
    return _spans.ms_per_query(run, ("plan.program", "serve.program"))
