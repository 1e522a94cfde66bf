"""What the deployments and shapes share: a program's result as host
numpy (the form the reference's answers take), and the bytes an encoded
column or table holds, counted by the benchmark itself."""
from __future__ import annotations

import dataclasses


def host_answer(res) -> dict:
    """Group-by results trimmed to their live groups, scalar aggregates
    as 0-d arrays, ranked rows as positions and gathered columns."""
    from repro_torch.core.order import RankedTable
    from repro_torch.device import to_numpy
    if isinstance(res, RankedTable):
        return {"positions": res.positions, "n": res.n,
                "columns": dict(res.columns)}
    if isinstance(res, dict):
        return {k: to_numpy(v) for k, v in res.items()}
    ng = int(res.num_groups)
    return {"num_groups": ng,
            "keys": {k: to_numpy(v)[:ng] for k, v in res.keys.items()},
            "aggs": {k: to_numpy(v)[:ng] for k, v in res.aggs.items()}}


def tensor_bytes(obj, seen=None) -> int:
    """Bytes of every tensor of one or more dimensions reachable through
    the dataclass fields, dicts and sequences of ``obj`` (an encoded
    column, a table, a list of them), each tensor counted once. The 0-d
    counts that ride along with run and index buffers are left out."""
    import torch
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.data_ptr(), obj.numel())
        if obj.dim() == 0 or key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v, seen) for v in obj)
    return 0


def column_bytes(table, name: str) -> int:
    """Encoded bytes of column ``name`` over every row of ``table`` (each
    partition's of a ``PartitionedTable``)."""
    parts = getattr(table, "partitions", None)
    tables = [p.table for p in parts] if parts is not None else [table]
    return sum(tensor_bytes(t.columns[name]) for t in tables)


def table_bytes(table) -> int:
    """Encoded bytes of every column of ``table``."""
    return sum(column_bytes(table, n) for n in _names(table))


def _names(table):
    parts = getattr(table, "partitions", None)
    return list((parts[0].table if parts else table).columns)
