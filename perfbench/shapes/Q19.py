"""TPC-H Q19 (discounted revenue) at its validation parameters: Brand#12,
#23 and #34 with QUANTITY 1, 10 and 20. LINEITEM is joined to PART, whose
three branches filter the dimension; each branch's quantity range then
applies by the brand that the join brings over. ``l_shipmode in ('AIR',
'AIR REG')``, as the query's text has it, matches AIR alone: 'AIR REG'
is no value of the column (its value is 'REG AIR'), so it has no code."""
from perfbench.shapes import _common

BRANCHES = (  # (brand, container size word, quantity from, size up to)
    ((1, 2), "SM", 1, 5),
    ((2, 3), "MED", 10, 10),
    ((3, 4), "LG", 20, 15),
)
CONTAINERS = {"SM": ("CASE", "BOX", "PACK", "PKG"),
              "MED": ("BAG", "BOX", "PKG", "PACK"),
              "LG": ("CASE", "BOX", "PACK", "PKG")}
SCANNED = ("shipmode", "shipinstruct", "partkey", "quantity", "price",
           "discount")
DIMENSION = ("partkey", "brand", "container", "size")


def _any(preds):
    out = preds[0]
    for p in preds[1:]:
        out = out | p
    return out


def build(tables, query_cls):
    from perfbench import generate as g
    from repro_torch.core.plan import col
    part_where = _any([
        (col("brand") == g.brand(*b))
        & col("container").isin([g.container(f"{w} {c}") for c in CONTAINERS[w]])
        & col("size").between(1, size)
        for b, w, _, size in BRANCHES])
    by_brand = _any([(col("brand") == g.brand(*b)) & col("quantity").between(q, q + 10)
                     for b, _, q, _ in BRANCHES])
    return (query_cls(tables["lineitem"])
            .filter(col("shipmode").isin([g.code("shipmode", "AIR")])
                    & (col("shipinstruct") == g.code("shipinstruct",
                                                     "DELIVER IN PERSON")))
            .join(tables["part"], fk="partkey", cols=["brand"], where=part_where)
            .filter(by_brand)
            .map("disc_price", _common.disc_price)
            .aggregate({"revenue": ("sum", "disc_price")}))


def input_bytes(tables) -> int:
    return (_common.scanned_bytes(tables["lineitem"], SCANNED)
            + _common.scanned_bytes(tables["part"], DIMENSION))
