"""TPC-H Q19 (discounted revenue): the discounted price of LINEITEM rows
shipped by AIR, DELIVER IN PERSON, of one of three branches of PART
brand, containers, size and the row's quantity. The query's text asks
for ``l_shipmode in ('AIR', 'AIR REG')``; 'AIR REG' is no value of the
column (its value is 'REG AIR'), so AIR alone matches."""
import numpy as np

from perfbench.reference import _common

AIR, IN_PERSON = 0, 1
# (brand code of Brand#MN, container codes, size up to, quantity from):
# containers are SM / LG / MED x CASE BOX BAG JAR PKG PACK CAN DRUM
BRANCHES = (
    (0 * 5 + 1, (0 * 8 + 0, 0 * 8 + 1, 0 * 8 + 5, 0 * 8 + 4), 5, 1),
    (1 * 5 + 2, (2 * 8 + 2, 2 * 8 + 1, 2 * 8 + 4, 2 * 8 + 5), 10, 10),
    (2 * 5 + 3, (1 * 8 + 0, 1 * 8 + 1, 1 * 8 + 5, 1 * 8 + 4), 15, 20),
)


def answer(data, lower=False):
    d, p = data.lineitem, data.part
    rows = np.flatnonzero((d["shipmode"] == AIR) & (d["shipinstruct"] == IN_PERSON))
    pk = d["partkey"][rows].astype(np.int64) - 1
    brand, container, size = p["brand"][pk], p["container"][pk], p["size"][pk]
    q = d["quantity"][rows]
    sel = np.zeros(len(rows), bool)
    for b, containers, top, lo in BRANCHES:
        sel |= ((brand == b) & np.isin(container, containers)
                & (size >= 1) & (size <= top) & (q >= lo) & (q <= lo + 10))
    dp = _common.derived(d, lower)["disc_price"][rows[sel]]
    return {"revenue": _common.output(dp.sum(), lower)}
