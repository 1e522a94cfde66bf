"""Helpers shared by the shapes' references (``grouped`` a frozen copy of
``chip_smoke.py``'s ``_grouped``), and the lower precision the control
computes in.

``lower=True`` is the control: the same reference computed in bfloat16,
the precision below the float32 that the configuration states for its
float columns and sums. Float inputs are rounded to bfloat16 before they
are used, sums accumulate in float64 (kinder than bfloat16 hardware,
which accumulates in float32), and every float output is rounded to
bfloat16. Integers (keys, counts, positions) are exact either way.
"""
from __future__ import annotations

import numpy as np


def bf16(x) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as float64."""
    a = np.asarray(x, dtype=np.float32)
    u = np.ascontiguousarray(a).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32).astype(np.float64)
    return out.reshape(a.shape)


def values(a, lower: bool) -> np.ndarray:
    """A column as float64, rounded to bfloat16 first under ``lower``."""
    return bf16(a) if lower else np.asarray(a, dtype=np.float64)


def output(x, lower: bool):
    """A float output, rounded to bfloat16 under ``lower``."""
    if lower:
        out = bf16(x)
        return float(out) if np.ndim(x) == 0 else out
    return float(x) if np.ndim(x) == 0 else np.asarray(x, np.float64)


def grouped(keys, sel, weights, domain):
    """Group ids in lexicographic key order, float64 sums per group (of
    float64 ``weights``) and row counts per group. Rows out of ``sel``
    go to one more bin, dropped after."""
    keys = np.where(sel, keys, domain)
    counts = np.bincount(keys, minlength=domain + 1)[:domain]
    present = counts > 0
    sums = {k: np.bincount(keys, weights=w, minlength=domain + 1)[:domain][present]
            for k, w in weights.items()}
    return np.flatnonzero(present), sums, counts[present]


_DERIVED: dict = {}


def derived(d, lower: bool) -> dict:
    """Per-row float64 columns that several queries read, computed once a
    LINEITEM (the last one's kept): ``price``, ``disc_price`` =
    ``l_extendedprice * (1 - l_discount)`` and ``charge`` = ``disc_price
    * (1 + l_tax)``."""
    key = (id(d), lower)
    if key not in _DERIVED:
        _DERIVED.clear()
        p = values(d["price"], lower)
        dp = p * (100 - d["discount"]) * 0.01
        _DERIVED[key] = {"price": p, "disc_price": dp,
                         "charge": dp * (100 + d["tax"]) * 0.01}
    return _DERIVED[key]


def grouped_answer(gk, names, aggs):
    """A group-by answer: ``gk`` split into the key columns by ``names``
    ((name, radix) pairs, most significant first)."""
    keys = {}
    rest = gk
    for name, radix in reversed(names):
        keys[name] = (rest % radix).astype(np.int64)
        rest = rest // radix
    return {"num_groups": int(len(gk)),
            "keys": {n: keys[n] for n, _ in names}, "aggs": aggs}
