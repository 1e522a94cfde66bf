"""TPC-H Q1 (pricing summary report) at its validation parameter, DELTA
90 days, grouped at run level on the Q1 projection."""
from perfbench.shapes import _common

DELTA = 90
SCANNED = ("shipdate", "returnflag", "linestatus", "quantity", "price",
           "discount", "tax")


def build(tables, query_cls):
    return _common.q1(tables, query_cls, DELTA)


def input_bytes(tables) -> int:
    return _common.scanned_bytes(tables["lineitem"], SCANNED)
