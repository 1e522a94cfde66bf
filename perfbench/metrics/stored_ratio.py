"""Encoded bytes of the cell's tables as ingested (``Table.nbytes`` /
``PartitionedTable.nbytes``) over the plain bytes of the same columns."""


def read(run):
    return run.stored_bytes / run.plain_bytes
