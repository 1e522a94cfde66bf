"""Table abstraction: a set of heterogeneously encoded columns (paper §3.3).

PyTorch port of ``repro.core.table``. Tables are host-side containers;
their columns' buffers live on ``device``. String columns are
dictionary-encoded at ingest (codes on the device, dictionary on the host),
as in TQP (§2.1). ``validate()`` waits for the ``faults`` port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compress
from repro_torch.core.encodings import decode_column
from repro_torch.device import resolve_device, to_numpy


def dictionary_pass(data: Dict[str, np.ndarray]):
    """Value+dictionary encode string / out-of-int32-domain columns (TQP §2.1).

    Returns (data', dictionaries): data' has those columns replaced by int32
    codes."""
    out, dicts = {}, {}
    nrows = None
    for name, arr in data.items():
        arr = np.asarray(arr)
        nrows = len(arr) if nrows is None else nrows
        if len(arr) != nrows:
            raise ValueError(f"column {name}: length mismatch")
        wide_int = arr.dtype.kind == "i" and arr.size and (
            arr.min() < np.iinfo(np.int32).min
            or arr.max() > np.iinfo(np.int32).max)
        if arr.dtype.kind in ("U", "S", "O") or wide_int:
            codes, dictionary = compress.dictionary_encode(arr)
            dicts[name] = dictionary
            arr = codes
        out[name] = arr
    return out, dicts


def dictionary_code_for(dictionaries: Dict[str, np.ndarray], name: str,
                        value, op: str = "eq"):
    """Shared literal -> code translation (see ``Table.code_for``)."""
    if name not in dictionaries:
        return value
    d = dictionaries[name]
    idx = int(np.searchsorted(d, value))
    exact = idx < len(d) and d[idx] == value
    if op in ("eq", "ne", "isin"):
        return idx if exact else -1
    if op in ("lt", "ge"):
        return idx
    if op in ("le", "gt"):
        return idx if exact else idx - 1
    raise ValueError(f"code_for: unsupported op {op!r}")


@dataclasses.dataclass
class Table:
    columns: Dict[str, object]
    nrows: int
    dictionaries: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # per-column dense value domain (lo, size) recorded at ingest for
    # integer/dictionary columns — the sort-free grouping contract
    domains: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    # per-column sorted-order metadata, filled lazily by ``sorted_order``
    _sort_orders: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_arrays(
        cls,
        data: Dict[str, np.ndarray],
        cfg: compress.CompressionConfig = compress.CompressionConfig(),
        encodings: Optional[Dict[str, str]] = None,
        dictionaries: Optional[Dict[str, np.ndarray]] = None,
        pack: Optional[bool] = None,
        pack_domains: Optional[Dict[str, Tuple[int, int]]] = None,
        device=None,
    ) -> "Table":
        """Ingest host arrays onto ``device`` (None: the CUDA device, raising
        when there is none); choose encodings per the §9 heuristics unless
        overridden per-column via ``encodings``.

        ``dictionaries``: pre-computed global dictionaries — ``data`` must
        already hold codes for those columns. ``pack=True`` raises until
        bit packing is ported; ``pack_domains`` is accepted for signature
        parity.
        """
        dev = resolve_device(device)
        if dictionaries is None:
            data, dicts = dictionary_pass(data)
        else:
            dicts = dictionaries
        if pack is not None:
            cfg = dataclasses.replace(cfg, pack=pack)
        cols = {}
        domains = {}
        nrows = None
        for name, arr in data.items():
            arr = np.asarray(arr)
            nrows = len(arr) if nrows is None else nrows
            enc = (encodings or {}).get(name)
            dom = compress.column_domain(arr, dicts.get(name))
            pdom = (pack_domains or {}).get(name, dom)
            cols[name] = compress.encode(arr, cfg, encoding=enc,
                                         pack_domain=pdom, device=dev)
            if dom is not None:
                domains[name] = dom
        return cls(columns=cols, nrows=nrows or 0, dictionaries=dicts,
                   domains=domains, device=dev)

    def column(self, name: str):
        return self.columns[name]

    def validate(self) -> "Table":
        raise NotImplementedError(
            "Table.validate waits for the faults port (ROADMAP queue A9)")

    def decode(self, name: str) -> np.ndarray:
        """Materialize a column to host values (tests / inspection)."""
        vals = to_numpy(decode_column(self.columns[name]))
        if name in self.dictionaries:
            return self.dictionaries[name][vals]
        return vals

    def code_for(self, name: str, value, op: str = "eq"):
        """Dictionary code of a string literal for predicate pushdown
        (equality: exact code or -1; ranges: searchsorted boundary code)."""
        return dictionary_code_for(self.dictionaries, name, value, op)

    def sorted_order(self, name: str):
        """Permutation sorting column ``name``'s stored values, or ``None``
        when already stored non-decreasing. Memoized on the table."""
        if name not in self._sort_orders:
            vals = to_numpy(decode_column(self.columns[name]))
            self._sort_orders[name] = (
                None if compress.column_is_sorted(vals)
                else np.argsort(vals, kind="stable"))
        return self._sort_orders[name]

    def nbytes(self) -> int:
        """Device footprint of the encoded buffers."""
        return sum(compress.encoded_nbytes(c) for c in self.columns.values())

    def nbytes_unpacked(self) -> int:
        """Equal to ``nbytes()`` until bit packing is ported."""
        return self.nbytes()

    def encoding_of(self, name: str) -> str:
        return type(self.columns[name]).__name__

    def encodings(self) -> Dict[str, str]:
        """Chosen encoding per column, in schema order."""
        return {name: self.encoding_of(name) for name in self.columns}
