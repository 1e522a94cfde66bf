"""Query serving demo of the PyTorch port: three concurrent clients against
one resident compressed dataset, on the card.

    PYTHONPATH=src python examples/torch_serving_demo.py            # 200k rows, CUDA
    PYTHONPATH=src python examples/torch_serving_demo.py --cpu --rows 20000

The twin of ``examples/serving_demo.py``: a ``QueryServer`` holds one
bit-packed ``PartitionedTable`` and serves concurrent
``PartitionedQuery`` submissions through a plan cache (repeat shapes build
no new program), a device-residency LRU (hot partitions never move again)
and shared scans. Three client threads each submit the same dashboard mix
twice; every served answer must be bit-identical to its solo run.
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.core import (PartitionedQuery, PartitionedTable,
                              QueryServer, col)
from repro_torch.device import resolve_device, to_numpy

ROWS = 200_000


def make_data(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "region": rng.choice(["east", "west", "north", "south"], n),
        "units": rng.integers(0, 10, n, dtype=np.int32),
        "price": (rng.random(n) * 100).astype(np.float32),
    }


def make_queries(pt):
    """One dashboard refresh: revenue rollup, per-region breakdown, top-5."""
    return [
        (PartitionedQuery(pt).filter(col("units") > 2)
         .aggregate({"revenue": ("sum", "price"),
                     "orders": ("count", None)})),
        (PartitionedQuery(pt).filter(col("units") > 2)
         .groupby(["region"], {"revenue": ("sum", "price")})),
        (PartitionedQuery(pt)
         .groupby(["region"], {"units": ("sum", "units")})
         .order_by("units", descending=True, limit=5)),
    ]


def host(results):
    """The three answers as host arrays: the rollup's scalars, the
    breakdown's revenue by group slot, the top-5's regions and units."""
    agg, by_region, top = results
    return {"rollup": {k: to_numpy(v) for k, v in agg.items()},
            "revenue": to_numpy(by_region.aggs["revenue"]),
            "top_region": np.asarray(to_numpy(top.keys["region"])),
            "top_units": to_numpy(top.aggs["units"])}


def same(a, b) -> bool:
    """Bit-identical host answers."""
    return (a["rollup"].keys() == b["rollup"].keys()
            and all(np.array_equal(a["rollup"][k], b["rollup"][k])
                    for k in a["rollup"])
            and all(np.array_equal(a[k], b[k])
                    for k in ("revenue", "top_region", "top_units")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--rows", type=int, default=ROWS)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    t_start = time.perf_counter()
    pt = PartitionedTable.from_arrays(make_data(args.rows), num_partitions=8,
                                      pack=True, device=dev)

    # solo reference results, for the bit-identity check below
    expected = host([q.run() for q in make_queries(pt)])

    with QueryServer(pt) as srv:
        results = {}

        def client(slot):
            tickets = [srv.submit(q) for q in make_queries(pt)]
            results[slot] = [srv.result(t, timeout=120) for t in tickets]

        served = []
        for _ in range(2):  # round 2 hits the plan cache + residency LRU
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                assert not t.is_alive(), "a client thread did not finish"
            served += [host(r) for r in results.values()]

        s = srv.stats()
        print(f"served {s['completed']} queries at {s['qps']} qps | "
              f"p50 {s['p50_ms']} ms, p99 {s['p99_ms']} ms")
        print(f"plan cache hit rate {s['plan_cache']['hits']}/"
              f"{s['plan_cache']['hits'] + s['plan_cache']['misses']} = "
              f"{s['plan_cache']['hit_rate']}")
        print(f"residency hit rate {s['residency']['hit_rate']} "
              f"({s['residency']['resident_partitions']} partitions, "
              f"{s['residency']['resident_bytes']} bytes resident)")
        print(f"scan sharing: {s['scans']['shared_queries']} queries rode "
              f"shared passes, {s['scans']['solo_queries']} ran solo")

        # served results are bit-identical to solo execution
        assert len(served) == 6
        for got in served:
            assert same(got, expected), "served answer differs from solo"
    print("serving_demo OK")
    return {"solo": expected, "served": served, "stats": s,
            "wall_s": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
