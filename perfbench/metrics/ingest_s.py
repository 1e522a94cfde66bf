"""Seconds to ingest the generated arrays into the deployment's tables
(``Table.from_arrays`` / ``PartitionedTable.from_arrays``, the server's
start)."""


def read(run):
    return run.timings["ingest_s"]
