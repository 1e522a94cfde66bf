"""Carry a table's encoded state across packages as plain host data.

A *description* of a table uses no framework types, so the JAX package's
tables and the port's can be written and read by code that imports only
numpy:

    {"nrows": int,
     "dictionaries": {name: np.ndarray},
     "domains": {name: (lo, size)},
     "columns": {name: <column>}}

    <column> = {"type": "<encoding class name>",
                "fields": {field: np.ndarray | int | float | <column>}}

Buffers are numpy arrays (0-d for counts ``n`` and for ``offset``);
static fields (``nrows``, ``bit_width``) are Python ints. A test builds
the description of a ``repro`` table with ``np.asarray`` on each leaf;
``table_from_numpy`` then gives a port ``Table`` holding the same encoded
buffers, so both packages run the same encoded data.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import encodings as E
from repro_torch.core.table import Table
from repro_torch.device import resolve_device, to_numpy

_TYPES = {cls.__name__: cls for cls in (
    E.PlainColumn, E.RLEColumn, E.IndexColumn, E.PlainIndexColumn,
    E.RLEIndexColumn, E.PlainMask, E.RLEMask, E.IndexMask, E.RLEIndexMask,
    E.PackedColumn)}
_STATIC = ("nrows", "bit_width")


def column_from_numpy(desc: dict, device):
    """One encoded column (or mask) from its description."""
    cls = _TYPES[desc["type"]]
    kw = {}
    for name, value in desc["fields"].items():
        if isinstance(value, dict):
            kw[name] = column_from_numpy(value, device)
        elif name in _STATIC:
            kw[name] = int(value)
        elif name == "offset":
            kw[name] = np.asarray(value).item()  # host scalar
        else:
            a = np.array(value, copy=True, order="C")  # writable host copy
            t = torch.from_numpy(a).to(device)
            kw[name] = t.reshape(()) if name == "n" else t
    return cls(**kw)


def table_from_numpy(state: Dict, device=None) -> Table:
    """A port ``Table`` on ``device`` (None: the CUDA device) from a
    description (see the module docstring)."""
    dev = resolve_device(device)
    cols = {name: column_from_numpy(desc, dev)
            for name, desc in state["columns"].items()}
    return Table(columns=cols, nrows=int(state["nrows"]),
                 dictionaries=dict(state.get("dictionaries", {})),
                 domains={k: (int(v[0]), int(v[1]))
                          for k, v in state.get("domains", {}).items()},
                 device=dev)


def column_to_numpy(col) -> dict:
    """Description of one port column or mask."""
    fields = {}
    for f in dataclasses.fields(col):
        value = getattr(col, f.name)
        if dataclasses.is_dataclass(value):
            fields[f.name] = column_to_numpy(value)
        elif f.name in _STATIC:
            fields[f.name] = int(value)
        else:
            fields[f.name] = np.asarray(to_numpy(value))
    return {"type": type(col).__name__, "fields": fields}


def table_to_numpy(table: Table) -> Dict:
    """Description of a port ``Table`` (the inverse of ``table_from_numpy``)."""
    return {"nrows": table.nrows,
            "dictionaries": dict(table.dictionaries),
            "domains": dict(table.domains),
            "columns": {name: column_to_numpy(c)
                        for name, c in table.columns.items()}}
