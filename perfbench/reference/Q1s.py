"""TPC-H Q1 at DELTA 120 days: a second plan of the same query."""
from perfbench.reference import Q1

DELTA = 120


def answer(data, lower=False):
    return Q1.answer(data, lower, delta=DELTA)
