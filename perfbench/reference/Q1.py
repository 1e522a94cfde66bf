"""TPC-H Q1 (pricing summary report): rows shipped by 1998-12-01 less
DELTA days, grouped by (returnflag, linestatus): the sums of quantity,
extendedprice, the discounted price and the charge, the means of
quantity, extendedprice and discount, and the row count."""
import numpy as np

from perfbench.reference import _common

DELTA = 90
FLAGS, STATUSES = 3, 2  # A N R; F O


def answer(data, lower=False, delta=DELTA):
    d = data.lineitem
    cut = int((np.datetime64("1998-12-01") - np.datetime64("1992-01-01"))
              .astype(np.int64)) - delta
    sel = d["shipdate"] <= cut
    key = d["returnflag"].astype(np.int64) * STATUSES + d["linestatus"]
    x = _common.derived(d, lower)
    gk, sums, cnt = _common.grouped(key, sel, {
        "q": d["quantity"], "p": x["price"], "dp": x["disc_price"],
        "ch": x["charge"], "d": d["discount"]}, FLAGS * STATUSES)
    n = np.maximum(cnt, 1)
    out = _common.output
    return _common.grouped_answer(
        gk, (("returnflag", FLAGS), ("linestatus", STATUSES)), {
            "sum_qty": out(sums["q"], lower),
            "sum_base_price": out(sums["p"], lower),
            "sum_disc_price": out(sums["dp"], lower),
            "sum_charge": out(sums["ch"], lower),
            "avg_qty": out(sums["q"] / n, lower),
            "avg_price": out(sums["p"] / n, lower),
            "avg_disc": out(sums["d"] / n, lower),
            "count_order": cnt.astype(np.int64)})
