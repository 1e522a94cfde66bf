"""TPC-H Q1 at DELTA 120 days, the other end of the parameter's range
[60, 120]: a second plan of the same query."""
from perfbench.shapes import Q1, _common

DELTA = 120


def build(tables, query_cls):
    return _common.q1(tables, query_cls, DELTA)


def input_bytes(tables) -> int:
    return Q1.input_bytes(tables)
