"""TPC-H Q6 (forecasting revenue change) at its validation parameters:
DATE 1994-01-01, DISCOUNT 0.06, QUANTITY 24."""
from perfbench.shapes import _common

SCANNED = ("shipdate", "discount", "quantity", "price")


def build(tables, query_cls):
    from perfbench.generate import day
    from repro_torch.core.plan import col
    return (query_cls(tables["lineitem"])
            .filter(col("shipdate").between(day("1994-01-01"), day("1995-01-01"),
                                            hi_incl=False)
                    & col("discount").between(5, 7)
                    & (col("quantity") < 24))
            .map("revenue", _common.price_discount)
            .aggregate({"revenue": ("sum", "revenue")}))


def input_bytes(tables) -> int:
    return _common.scanned_bytes(tables["lineitem"], SCANNED)
