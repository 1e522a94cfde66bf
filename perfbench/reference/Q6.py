"""TPC-H Q6 (forecasting revenue change): the sum of extendedprice x
discount over rows shipped in 1994, with discount 0.05-0.07 and quantity
under 24."""
import numpy as np

from perfbench.reference import _common

EPOCH = np.datetime64("1992-01-01")


def answer(data, lower=False):
    d = data.lineitem
    lo = int((np.datetime64("1994-01-01") - EPOCH).astype(np.int64))
    hi = int((np.datetime64("1995-01-01") - EPOCH).astype(np.int64))
    sel = ((d["shipdate"] >= lo) & (d["shipdate"] < hi)
           & (d["discount"] >= 5) & (d["discount"] <= 7)
           & (d["quantity"] < 24))
    rev = _common.values(d["price"], lower) * d["discount"] * 0.01
    return {"revenue": _common.output(rev[sel].sum(), lower)}
