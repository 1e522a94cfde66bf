"""What the shapes share: the ``map`` callables (one function each, so
that repeated submissions share a plan-cache signature: a ``map`` is keyed
by its callable) and the byte count of a query's inputs.

Discount and tax are integers in hundredths, so ``1 - l_discount`` is
``(100 - discount) / 100``."""
from __future__ import annotations


def disc_price(env):
    """``l_extendedprice * (1 - l_discount)``."""
    from repro_torch.core import arithmetic as a
    off = a.scalar_op(env["discount"], lambda d, s: s - d, 100)
    return a.scalar_op(a.binary_op(env["price"], off, "mul"), "mul", 0.01)


def charge(env):
    """``disc_price * (1 + l_tax)``, of the ``disc_price`` mapped before."""
    from repro_torch.core import arithmetic as a
    up = a.scalar_op(env["tax"], "add", 100)
    return a.scalar_op(a.binary_op(env["disc_price"], up, "mul"), "mul", 0.01)


def price_discount(env):
    """``l_extendedprice * l_discount`` (Q6)."""
    from repro_torch.core import arithmetic as a
    return a.scalar_op(a.binary_op(env["price"], env["discount"], "mul"),
                       "mul", 0.01)


def q1(tables, query_cls, delta):
    """TPC-H Q1 with its substitution parameter ``delta`` (days)."""
    from perfbench.generate import day
    from repro_torch.core.plan import col
    return (query_cls(tables["lineitem"])
            .filter(col("shipdate") <= day("1998-12-01") - delta)
            .map("disc_price", disc_price)
            .map("charge", charge)
            .groupby(["returnflag", "linestatus"],
                     {"sum_qty": ("sum", "quantity"),
                      "sum_base_price": ("sum", "price"),
                      "sum_disc_price": ("sum", "disc_price"),
                      "sum_charge": ("sum", "charge"),
                      "avg_qty": ("avg", "quantity"),
                      "avg_price": ("avg", "price"),
                      "avg_disc": ("avg", "discount"),
                      "count_order": ("count", None)}, num_groups_cap=8))


def scanned_bytes(table, names) -> int:
    """Encoded bytes of columns ``names``, each counted once over every
    row (every partition) of ``table``: what a scan of them must read.
    Zone maps prune no partition of these shapes on this projection: each
    partition spans the whole domain of every filtered column."""
    from perfbench.deployments._common import column_bytes
    return sum(column_bytes(table, n) for n in names)
