"""The benchmark's data: TPC-H's LINEITEM and PART drawn from a seed by
the rules of the specification's section 4.2.3 (the columns the queries
read), so that later changes to the program cannot move the yardstick.

- ORDERS, which no query reads, only for the dates of its lines:
  ``o_orderdate`` uniform over [STARTDATE, ENDDATE - 151 days].
- LINEITEM: 1 to 7 lines an order (each count for a seventh of the
  orders), in order-key order; ``l_partkey``,
  ``l_quantity`` 1-50, ``l_discount`` 0.00-0.10, ``l_tax`` 0.00-0.08,
  ``l_shipmode`` and ``l_shipinstruct`` uniform; ``l_shipdate`` the
  order's date + [1, 121], ``l_receiptdate`` + [1, 30] after that;
  ``l_returnflag`` R or A when received by CURRENTDATE, else N;
  ``l_linestatus`` O when shipped after CURRENTDATE, else F;
  ``l_extendedprice`` = ``l_quantity`` x ``p_retailprice(l_partkey)``.
- PART: ``p_brand`` Brand#MN, ``p_container`` of two syllables,
  ``p_size`` 1-50, ``p_retailprice`` by its formula.

Dates are day numbers from 1992-01-01. Decimals in hundredths (discount,
tax) are integers; ``extendedprice`` is the nearest float32 to its exact
decimal. Text columns are dictionary codes in the order of their words,
so that a code sorts as its text does (``CODES``). The columns are drawn,
and LINEITEM sorted into the configuration's projection order, on the
device given (the card in a run), in a few large calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

EPOCH = np.datetime64("1992-01-01")


def day(date: str) -> int:
    """The day number of an ISO date."""
    return int((np.datetime64(date) - EPOCH).astype(np.int64))


STARTDATE, ENDDATE, CURRENTDATE = day("1992-01-01"), day("1998-12-31"), day("1995-06-17")
# the words of each text column, a code being its index
CODES = {
    "returnflag": ("A", "N", "R"),
    "linestatus": ("F", "O"),
    "shipmode": ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"),
    "shipinstruct": ("COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"),
    "container_1": ("SM", "LG", "MED", "JUMBO", "WRAP"),
    "container_2": ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"),
}


def code(column: str, word: str) -> int:
    return CODES[column].index(word)


def brand(m: int, n: int) -> int:
    """The code of ``Brand#MN``."""
    return (m - 1) * 5 + (n - 1)


def container(words: str) -> int:
    """The code of a container such as ``MED BOX``."""
    a, b = words.split()
    return code("container_1", a) * 8 + code("container_2", b)


@dataclasses.dataclass
class Data:
    """One seed's inputs: host arrays, handed alike to the program and to
    the plain reference."""

    lineitem: Dict[str, np.ndarray]
    part: Dict[str, np.ndarray]

    def plain_bytes(self) -> int:
        """Bytes of the columns as plain arrays (the user's data)."""
        return sum(int(a.nbytes) for t in (self.lineitem, self.part)
                   for a in t.values())


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number, negative and above 64
    bits included) and an optional stream id."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def sizes(cfg: dict, scale: Optional[float] = None):
    """(ORDERS, PART) rows at the configuration's scale factor, or at
    ``scale`` (the CPU tests)."""
    sf = float(cfg["scale_factor"] if scale is None else scale)
    return max(int(round(1_500_000 * sf)), 8), max(int(round(200_000 * sf)), 10)


def retail_cents(partkey):
    """``p_retailprice`` in cents (4.2.3), of an int64 tensor."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


class _Draw:
    """Uniform whole numbers from one ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        import torch
        self.torch, self.device = torch, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 64))

    def ints(self, lo: int, hi: int, n: int):
        """``n`` int32 draws from ``[lo, hi)``."""
        return self.torch.randint(lo, hi, (n,), generator=self.gen,
                                  device=self.device, dtype=self.torch.int32)

    def perm(self, n: int):
        return self.torch.randperm(n, generator=self.gen, device=self.device)


def make_part(draw: _Draw, n_parts: int):
    import torch
    return {
        "partkey": torch.arange(1, n_parts + 1, dtype=torch.int32, device=draw.device),
        "brand": draw.ints(0, 5, n_parts) * 5 + draw.ints(0, 5, n_parts),
        "container": draw.ints(0, 5, n_parts) * 8 + draw.ints(0, 8, n_parts),
        "size": draw.ints(1, 51, n_parts),
    }


def make_lineitem(draw: _Draw, n_orders: int, n_parts: int):
    """LINEITEM's columns in order-key order, 1-7 lines an order: each
    count for a seventh of the orders, in an order drawn from the seed, so
    that every seed gives the same number of rows."""
    import torch
    i32 = torch.int32
    orderdate = draw.ints(STARTDATE, ENDDATE - 151 + 1, n_orders)
    lines = draw.perm(n_orders) % 7 + 1
    of = torch.repeat_interleave(
        torch.arange(n_orders, device=draw.device), lines)
    n = int(of.numel())
    quantity = draw.ints(1, 51, n)
    partkey = draw.ints(1, n_parts + 1, n)
    shipdate = orderdate[of] + draw.ints(1, 122, n)
    del of
    received = shipdate + draw.ints(1, 31, n) <= CURRENTDATE
    ra = torch.where(draw.ints(0, 2, n) == 0, code("returnflag", "R"),
                     code("returnflag", "A"))
    cents = quantity.to(torch.int64) * retail_cents(partkey.to(torch.int64))
    return {
        "returnflag": torch.where(received, ra, code("returnflag", "N")).to(i32),
        "linestatus": (shipdate > CURRENTDATE).to(i32),  # F 0, O 1
        "shipdate": shipdate,
        "quantity": quantity,
        "discount": draw.ints(0, 11, n),
        "tax": draw.ints(0, 9, n),
        "price": (cents.to(torch.float64) / 100).to(torch.float32),
        "partkey": partkey,
        "shipmode": draw.ints(0, 7, n),
        "shipinstruct": draw.ints(0, 4, n),
    }


def sort_perm(cols, order: Sequence[str]):
    """The stable sort of the ``order`` columns (first most significant),
    as one argsort of a mixed-radix int64 composite key."""
    import torch
    key = torch.zeros_like(cols[order[0]], dtype=torch.int64)
    span_total = 1
    for c in order:
        v = cols[c].to(torch.int64)
        lo, span = int(v.min()), int(v.max()) - int(v.min()) + 1
        span_total *= span
        if span_total >= 2**62:
            raise ValueError("sort key domain too large for one int64 key")
        key = key * span + (v - lo)
    return torch.argsort(key, stable=True)


def _host(cols, perm=None) -> Dict[str, np.ndarray]:
    return {k: (v if perm is None else v[perm]).cpu().numpy()
            for k, v in cols.items()}


def make(cfg: dict, seed: int, device=None, scale: Optional[float] = None) -> Data:
    """The inputs of configuration ``cfg`` for ``seed``, drawn on
    ``device`` (the CPU by default) by one generator: PART, the orders'
    dates and LINEITEM, in that order. Only the columns the configuration
    keeps are returned, as host arrays, LINEITEM sorted by its
    ``sort_order``. The same seed on the same kind of device gives the
    same data."""
    import torch
    device = torch.device("cpu" if device is None else device)
    n_orders, n_parts = sizes(cfg, scale)
    draw = _Draw(seed, device)
    part = make_part(draw, n_parts)
    lineitem = make_lineitem(draw, n_orders, n_parts)
    lineitem = {c: lineitem[c] for c in cfg["lineitem_columns"]}
    order = tuple(cfg["sort_order"])
    data = Data(lineitem=_host(lineitem, sort_perm(lineitem, order) if order else None),
                part=_host({c: part[c] for c in cfg["part_columns"]}))
    del lineitem, part
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return data
