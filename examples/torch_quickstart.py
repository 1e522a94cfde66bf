"""Quickstart of the PyTorch port: SQL analytics directly on compressed
columns, on the card.

    PYTHONPATH=src python examples/torch_quickstart.py              # 1M rows, CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --cpu --rows 20000

The same sales table, the same queries and the same numpy oracles as
``examples/quickstart.py``, run through ``repro_torch``: columns get RLE /
Plain+Index / Plain encodings per the paper's §9 heuristics, then filter +
semi-join + group-by pipelines, a PK-FK join, a partitioned out-of-core
run with zone-map pruning and a ranked top-10 run end to end without
decompressing the encoded columns.
"""
import argparse
import time

import numpy as np

from repro_torch.core import compress
from repro_torch.core.encodings import decode_column
from repro_torch.core.partition import PartitionedQuery, PartitionedTable
from repro_torch.core.plan import Query, col, pk_fk_gather
from repro_torch.core.table import Table
from repro_torch.device import as_tensor, resolve_device, to_numpy

ROWS = 1_000_000
CFG = compress.CompressionConfig(plain_threshold=10_000)


def make_data(n: int, seed: int = 0):
    """(columns, store whitelist, store -> tier payload), drawn in the
    reference's order from one generator."""
    rng = np.random.default_rng(seed)
    # sorted by (region, store): the locality V-order / clustering gives
    region = np.sort(rng.integers(0, 8, n)).astype(np.int32)
    store = np.sort(rng.integers(0, 500, n)).astype(np.int32)
    units = rng.integers(1, 20, n).astype(np.int32)
    # a few huge outlier transactions -> Plain+Index (paper §3.2)
    revenue = np.where(rng.random(n) < 0.001, 2_000_000_000,
                       rng.integers(1, 5000, n)).astype(np.int32)
    status = np.sort(rng.choice(["paid", "pending", "refund"], n,
                                p=[.9, .07, .03]))
    data = {"region": region, "store": store, "units": units,
            "revenue": revenue, "status": status}
    whitelist = rng.choice(500, 40, replace=False).astype(np.int32)
    dim_payload = rng.integers(0, 5, 500).astype(np.int32)  # store -> tier
    return data, whitelist, dim_payload


def _groupby_q1(t):
    return (Query(t)
            .filter((col("status") == "paid") & (col("units") > 2))
            .groupby(["region"], {"total_units": ("sum", "units"),
                                  "orders": ("count", None)},
                     num_groups_cap=16))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--rows", type=int, default=ROWS)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    t_start = time.perf_counter()
    N = args.rows
    data, whitelist, dim_payload = make_data(N)
    region, store, units = data["region"], data["store"], data["units"]
    revenue, status = data["revenue"], data["status"]
    out = {}

    table = Table.from_arrays(data, cfg=CFG, device=dev)
    print("column encodings (chosen by the paper's §9 heuristics):")
    for name in table.columns:
        print(f"  {name:8s} -> {table.encoding_of(name)}")
    plain_bytes = 5 * 4 * N
    print(f"in-memory: {table.nbytes()/2**20:.2f} MiB encoded "
          f"vs {plain_bytes/2**20:.2f} MiB plain "
          f"({plain_bytes/table.nbytes():.1f}x)")

    # Packed ingest: integer buffers bit-packed at their exact domain
    # width, unpacked lazily on the device; results are bit-identical.
    packed = Table.from_arrays(data, cfg=CFG, pack=True, device=dev)
    print(f"bit-packed: {packed.nbytes()/2**20:.2f} MiB "
          f"({plain_bytes/packed.nbytes():.1f}x vs plain, "
          f"{table.nbytes()/packed.nbytes():.1f}x vs whole-dtype "
          f"encodings)\n")

    # Query 1: filtered group-by at RUN granularity on the RLE columns
    res = _groupby_q1(table).run()
    ng = int(res.num_groups)
    keys = to_numpy(res.keys["region"])[:ng]
    total_units = to_numpy(res.aggs["total_units"])[:ng]
    orders = to_numpy(res.aggs["orders"])[:ng]
    print("paid orders with >2 units, by region:")
    for r, u, c in zip(keys, total_units, orders):
        print(f"  region {r}: units={int(u)} orders={int(c)}")
    sel = (status == "paid") & (units > 2)
    want = {int(r): int(units[sel & (region == r)].sum())
            for r in np.unique(region)}
    got = {int(r): int(u) for r, u in zip(keys, total_units)}
    assert got == want, "engine result mismatch!"
    print("  (matches numpy oracle)")
    out["q1"] = {"region": keys, "total_units": total_units,
                 "orders": orders}

    # the same query over the bit-packed table: bit-identical
    res_p = _groupby_q1(packed).run()
    assert np.array_equal(to_numpy(res.aggs["total_units"]),
                          to_numpy(res_p.aggs["total_units"]))
    print("  (bit-packed table gives the identical result)\n")

    # Query 2: semi-join against a store whitelist + revenue sum
    res2 = (Query(table)
            .semi_join("store", whitelist)
            .aggregate({"revenue": ("sum", "revenue"),
                        "n": ("count", None)})).run()
    sel2 = np.isin(store, whitelist)
    print(f"whitelisted stores: n={int(res2['n'])} "
          f"(oracle {int(sel2.sum())}), "
          f"revenue={float(res2['revenue']):.3e}")
    assert int(res2["n"]) == int(sel2.sum())
    out["q2"] = {"n": int(res2["n"]), "revenue": int(res2["revenue"])}

    # Query 3: PK-FK join, the dimension payload fetched per RUN
    dim_keys = np.arange(500, dtype=np.int32)
    tier_col = pk_fk_gather(table.columns["store"], as_tensor(dim_keys, dev),
                            as_tensor(dim_payload, dev))
    print(f"PK-FK join output encoding: {type(tier_col).__name__} "
          f"(stays compressed)")
    tier = to_numpy(decode_column(tier_col))
    assert (tier == dim_payload[store]).all()
    out["q3"] = tier

    # Query 4: partitioned OUT-OF-CORE execution over host partitions with
    # zone maps: a partition the predicate rules out never moves
    ptable = PartitionedTable.from_arrays(data, cfg=CFG, num_partitions=8,
                                          device=dev)
    q4 = (PartitionedQuery(ptable)
          .filter((col("region") == 2) & (col("status") == "paid"))
          .groupby(["store"], {"total_units": ("sum", "units"),
                               "orders": ("count", None)},
                   num_groups_cap=1024))
    res4 = q4.run()
    sel4 = (region == 2) & (status == "paid")
    print(f"\npartitioned (8 partitions, region==2 & paid): "
          f"{q4.last_stats['skipped']} partitions zone-map-skipped, "
          f"{q4.last_stats['executed']} executed, {q4.trace_count} programs "
          f"compiled")
    assert q4.last_stats["skipped"] > 0  # region-sorted data: real pruning
    ng4 = int(res4.num_groups)
    stores4 = to_numpy(res4.keys["store"])[:ng4]
    units4 = to_numpy(res4.aggs["total_units"])[:ng4]
    orders4 = to_numpy(res4.aggs["orders"])[:ng4]
    assert ng4 == len(np.unique(store[sel4]))
    assert int(orders4.sum()) == int(sel4.sum())
    want_units = {int(s): int(units[sel4 & (store == s)].sum())
                  for s in np.unique(store[sel4])}
    got_units = {int(s): int(u) for s, u in zip(stores4, units4)}
    assert got_units == want_units, "partitioned result mismatch!"
    print("  (partitioned result matches numpy oracle)")
    out["q4"] = {"store": stores4, "total_units": units4, "orders": orders4,
                 "skipped": q4.last_stats["skipped"],
                 "executed": q4.last_stats["executed"]}

    # EXPLAIN ANALYZE: the compressed-domain plan tree plus the measured
    # partition / transfer / stage accounting of one traced run
    q4b = (PartitionedQuery(ptable)
           .filter((col("region") == 2) & (col("status") == "paid"))
           .groupby(["store"], {"total_units": ("sum", "units")},
                    num_groups_cap=1024))
    print("\nEXPLAIN ANALYZE:")
    print(q4b.explain_analyze())

    # Query 5: RANKED query, top-10 paid rows by revenue; zone maps skip
    # partitions that cannot beat the current 10th-best row
    q5 = (PartitionedQuery(ptable)
          .filter(col("status") == "paid")
          .order_by("revenue", descending=True, limit=10,
                    cols=["region", "store"]))
    res5 = q5.run()
    sel5 = status == "paid"
    order5 = np.argsort(-revenue[sel5].astype(np.int64), kind="stable")
    want_rows = np.flatnonzero(sel5)[order5[:10]]
    assert np.array_equal(res5.positions, want_rows), \
        "ranked result mismatch!"
    print(f"\ntop-10 paid rows by revenue (ranked query): "
          f"revenue[0]={int(res5.columns['revenue'][0])}, "
          f"{q5.last_stats.get('ranked_skipped', 0)} partitions "
          f"ranked-pruned")
    out["q5"] = {"positions": np.asarray(res5.positions),
                 **{k: np.asarray(v) for k, v in res5.columns.items()}}
    out["wall_s"] = time.perf_counter() - t_start
    print("quickstart OK")
    return out


if __name__ == "__main__":
    main()
