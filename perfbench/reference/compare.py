"""The comparison that decides ``correct``: one answer of the program
against the reference's answer of the same shape on the same data.

Two numbers come of it:

- ``exact_mismatches``: the values that must be equal and are not. Group
  counts and keys, integer aggregates (row counts), ranked positions and
  every gathered column (they are stored values), element by element; a
  missing name or a length that differs counts once per value it lacks.
- ``float_rel_err``: the largest relative gap of a float aggregate (sums
  and means, which the program keeps in float32) from the reference's
  float64 value, ``|got - want| / |want|``.
"""
from __future__ import annotations

import numpy as np


def _exact(got, want) -> int:
    w = np.asarray(want)
    if got is None:
        return max(w.size, 1)
    g = np.asarray(got)
    if g.shape != w.shape:
        return max(w.size, g.size, 1)
    if np.issubdtype(w.dtype, np.floating):
        return int(np.count_nonzero(~((g == w) | (np.isnan(g) & np.isnan(w)))))
    return int(np.count_nonzero(g.astype(np.int64) != w.astype(np.int64)))


def _rel(got, want) -> float:
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    if g.shape != w.shape or not np.all(np.isfinite(g)):
        return float("inf")
    if w.size == 0:
        return 0.0
    gap = np.abs(g - w)
    den = np.abs(w)
    rel = np.where(den > 0, gap / np.where(den > 0, den, 1.0),
                   np.where(gap > 0, np.inf, 0.0))
    return float(rel.max())


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) or (
        isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.integer))


def _values(got: dict, want: dict):
    """(mismatches, rel err) over a dict of named values: integers exact,
    floats by their relative gap."""
    bad, rel = 0, 0.0
    for k, w in want.items():
        g = got.get(k) if isinstance(got, dict) else None
        if _is_int(w):
            bad += _exact(g, w)
        elif g is None:
            bad += max(np.size(w), 1)
        else:
            rel = max(rel, _rel(g, w))
    return bad, rel


def compare(got, want):
    """``(exact_mismatches, float_rel_err)`` of answer ``got`` against the
    reference's ``want``."""
    if not isinstance(got, dict):
        return 1, 0.0
    if "positions" in want:
        bad = _exact(got.get("n"), want["n"])
        bad += _exact(got.get("positions"), want["positions"])
        cols = got.get("columns") or {}
        bad += sum(_exact(cols.get(c), v) for c, v in want["columns"].items())
        bad += len(set(cols) - set(want["columns"]))
        return bad, 0.0
    if "keys" in want:
        bad = _exact(got.get("num_groups"), want["num_groups"])
        bad += sum(_exact((got.get("keys") or {}).get(k), v)
                   for k, v in want["keys"].items())
        abad, rel = _values(got.get("aggs") or {}, want["aggs"])
        return bad + abad, rel
    return _values(got, want)
