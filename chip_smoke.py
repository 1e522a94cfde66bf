#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # TPC-H scale factor 10, ~60M LINEITEM rows
    python3 chip_smoke.py --sf 0.01  # a quick rehearsal at a small scale

What it does, in order, failing (non-zero exit, no result line) on the
first error:

1. Prints the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the time to build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Kernel checks: each of the eight kernels against its plain PyTorch
   version on the card, on edge cases (empty inputs, ragged tails,
   duplicates, right=True/False, int32/float32, sentinel-padded
   boundaries, gaps with a non-zero fill, out-of-range ids; for the packed
   kernels every bit width of {1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32},
   values straddling lanes, N = 0 and 1, negative offsets, width-32 wrap,
   boundaries above the shared-memory route, a partially covered RLE with
   ``n < cap``; for topk int32 and float32, n in {0, 1, 7, 2047, 2048,
   2049, 1_000_003} by k in {1, 8, 37, 128, 256}, all-equal inputs,
   INT32_MIN rows, +-inf, signed zeros, an input of a survivor pass,
   3M-key ascending, descending, tied and nearly-all-INT32_MIN inputs,
   three grid caps that must give the same bits, and views at offsets 1-3;
   for bucketize_kernel also query views at storage offset 1 with
   nq % 4 != 0). Integer outputs, the decoders and topk must be equal (topk
   values and indices, and bit-identical across two launches);
   segment_sum must be within rtol=1e-4 of a float64 host sum and
   bit-identical across two launches.
3. Resident query phase: TPC-H-shaped LINEITEM (each query sorted by its
   Table 7 order) and ORDERS at the chosen scale, seed 2, ingested with
   ``CompressionConfig(plain_threshold=1_000)`` onto the card; Q1, Q3,
   Q6, Q17 and Q19 run through ``repro_torch`` ``Query``. Every answer is
   checked against a numpy oracle (integers exact, float sums rtol=1e-4)
   and every re-run is bit-identical. Launch counts are zeroed just
   before this phase and read just after it; the run fails if any of the
   four resident-path kernels was not launched.
4. Out-of-core phase: the same LINEITEM arrays of Q1, Q6, Q17 and Q3 and
   the same ORDERS, ingested as ``PartitionedTable.from_arrays(...,
   partition_rows=1 << 23, pack=True, budget_bytes=1 << 30)`` (host
   partitions, pinned, bit-packed) and streamed through
   ``PartitionedQuery.run()``. Each answer must match its oracle and the
   resident answer, be bit-identical at prefetch depth 0, 1 and 2, and
   match the same query over ``pack=False`` partitions; Q6 also runs
   under a seeded fault plan (3 transient transfers, 1 OOM) that must fire
   in full and recover bit-identically. Per query it prints partitions
   visited and pruned, bytes moved packed and unpacked, the stage ms, warm
   wall ms at depth 0 and 2, and the H2D bound (bytes over the pinned
   bandwidth measured here with one 1 GiB copy). Launch counts are zeroed
   just before the phase and read just after; the run fails if any of the
   three packed kernels was not launched.
5. Ordering phase (ORDER BY / TOP-K): R1, a row-level top-100 by the
   Plain float ``price`` after ``shipdate <= 2400`` on the Q1-ordered
   table (``topk_kernel`` over the dense rank keys); R2, a top-1000 by
   (``quantity`` desc, ``shipdate`` asc) on the Q6-ordered table (RLE
   keys: the bounded-histogram path, no kernel); Q3r, Q3 ranked by
   (``revenue`` desc, ``orderdate`` asc), top 10 (group slots ranked after
   the join and group-by). Each runs on the resident table and streamed
   over the out-of-core phase's packed partitions at prefetch depth 0, 1
   and 2. Answers must equal a numpy oracle (``np.lexsort``, stable, over
   the candidates of an ``np.partition`` threshold; positions and integer
   columns exactly, Q3r's float sums within rtol=1e-4), re-runs and
   depths must be bit-identical, streamed R1 and R2 bit-identical to
   resident, and R2 must prune partitions by rank. Launch counts are zeroed
   just before the phase and read just after; the run fails if
   ``topk_kernel`` was not launched.
6. Kernel timing at the largest inputs the main path gave each kernel:
   kernel, plain-version and (where one PyTorch call computes the same
   function) library times by CUDA events, beside the least time the card
   could take (bytes over 3.35 TB/s, or operations over 67 TFLOP/s,
   whichever is larger). Two times of the kernel and of the library
   call: per launch (``ms``: events around one call, so the host's
   dispatch of the call is inside the window; median of 10 after warm-up,
   of 30 each where a library call is timed in turns with the kernel) and
   back to back (``ms_back_to_back``: N calls between one pair of events,
   over N). ``topk_kernel`` is also timed at one streamed partition
   (2^23 keys), at R1's length in ascending order (its worst case), and
   back to back at grid caps of 1, 2 and 4 blocks an SM;
   ``bucketize_kernel`` and ``torch.searchsorted`` get their host time a
   call (host clock, no synchronisation inside a batch) and their device
   time a call (``torch.profiler``).
7. A ``{"kernels": [...]}`` summary line, then as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

The script imports neither JAX nor the JAX package; the TPC-H generators
below are copies of ``benchmarks/bench_tpch.py``'s.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
LINEITEM_ROWS = {1.0: 6_001_215, 10.0: 59_986_052}  # TPC-H's own counts
SF1_ORDERS = 1_500_000
KERNEL_INFO = {
    "bucketize_kernel": ("src/repro_torch/kernels/csrc/bucketize.cu",
                         "src/repro/kernels/bucketize.py:60"),
    "bucketize_count_kernel": ("src/repro_torch/kernels/csrc/bucketize.cu",
                               "src/repro/kernels/bucketize.py:96"),
    "rle_decode_kernel": ("src/repro_torch/kernels/csrc/rle_decode.cu",
                          "src/repro/kernels/rle_decode.py:40"),
    "segment_sum_kernel": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                           "src/repro/kernels/segment_reduce.py:43"),
    "unpack_kernel": ("src/repro_torch/kernels/csrc/unpack.cu",
                      "src/repro/kernels/unpack.py:88"),
    "bucketize_packed_kernel": ("src/repro_torch/kernels/csrc/unpack.cu",
                                "src/repro/kernels/unpack.py:122"),
    "rle_decode_packed_kernel": ("src/repro_torch/kernels/csrc/unpack.cu",
                                 "src/repro/kernels/unpack.py:169"),
    "topk_kernel": ("src/repro_torch/kernels/csrc/topk.cu",
                    "src/repro/kernels/topk.py:119"),
}
RESIDENT_KERNELS = ("bucketize_kernel", "bucketize_count_kernel",
                    "rle_decode_kernel", "segment_sum_kernel")
PACKED_KERNELS = ("unpack_kernel", "bucketize_packed_kernel",
                  "rle_decode_packed_kernel")
PACK_BITS = (1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32)
OOC_QUERIES = ("Q1", "Q6", "Q17", "Q3")  # the out-of-core phase's queries
# the ordering phase's queries and the LINEITEM sort order each reads
RANKED_SOURCE = {"R1": "Q1", "R2": "Q6", "Q3r": "Q3"}
ORDER_KERNELS = ("topk_kernel",)

# ---------------------------------------------------------------------------
# TPC-H-shaped data (copies of benchmarks/bench_tpch.py's generators)
# ---------------------------------------------------------------------------

# paper Table 7: query-specific multi-column sort orders
SORT_ORDERS = {
    "Q1": ("returnflag", "linestatus", "shipdate", "quantity"),
    "Q3": ("orderkey",),
    "Q6": ("quantity", "discount", "shipdate"),
    "Q17": ("partkey",),
    "Q19": ("partkey",),
}


def _sort_perm(cols, order, device=None):
    """``np.lexsort`` of the ``order`` columns (first most significant) as
    one stable argsort of a mixed-radix int64 composite key: the same
    permutation, sorted on ``device`` (a CUDA device: the card sorts 60M
    keys in milliseconds, where numpy takes tens of seconds)."""
    key = np.zeros(len(cols[order[0]]), np.int64)
    span_total = 1
    for c in order:
        v = cols[c].astype(np.int64)
        lo, span = int(v.min()), int(v.max()) - int(v.min()) + 1
        span_total *= span
        if span_total >= 2**62:
            raise ValueError("sort key domain too large for one int64 key")
        key = key * span + (v - lo)
    if device is None or getattr(device, "type", device) == "cpu":
        return np.argsort(key, kind="stable")
    import torch
    dev_key = torch.from_numpy(key).to(device)
    return torch.argsort(dev_key, stable=True).cpu().numpy()


def make_lineitem(rng, n, order=None, device=None):
    """LINEITEM-like columns, globally sorted by ``order`` (paper §9.1.1);
    ``device`` sorts on the card (the same permutation)."""
    cols = {
        "returnflag": rng.integers(0, 3, n).astype(np.int32),
        "linestatus": rng.integers(0, 2, n).astype(np.int32),
        "shipdate": rng.integers(0, 2557, n).astype(np.int32),
        "quantity": rng.integers(1, 51, n).astype(np.int32),
        "discount": rng.integers(0, 11, n).astype(np.int32),
        "price": (rng.random(n).astype(np.float32) * 1000),
        "tax": rng.integers(0, 9, n).astype(np.int32),
        "partkey": rng.integers(0, n // 30, n).astype(np.int32),
        "orderkey": rng.integers(0, n // 4, n).astype(np.int32),
    }
    if order:
        perm = _sort_perm(cols, order, device)
        cols = {k: v[perm] for k, v in cols.items()}
    return cols


def make_orders(rng, n_orders):
    """ORDERS-like dimension: surrogate PK (stored key-ordered) + filter /
    group attributes."""
    return {
        "orderkey": np.arange(n_orders, dtype=np.int32),
        "orderdate": rng.integers(0, 366, n_orders).astype(np.int32),
        "shippriority": rng.integers(0, 2, n_orders).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# The five query pipelines (bench_tpch.py's, staged on repro_torch) and
# their numpy oracles
# ---------------------------------------------------------------------------


def build_query(name, table, orders_table=None, part_keys=None,
                query_cls=None):
    """The query ``name`` staged on ``table`` with ``query_cls`` (``Query``
    by default; ``PartitionedQuery`` for a partitioned table)."""
    from repro_torch.core import arithmetic
    from repro_torch.core.plan import Query, col

    Query = query_cls or Query  # noqa: N806

    def rev(env):
        return arithmetic.binary_op(env["price"], env["discount"], "mul")

    if name == "Q1":
        return (Query(table)
                .filter(col("shipdate") <= 2400)
                .groupby(["returnflag", "linestatus"],
                         {"sum_qty": ("sum", "quantity"),
                          "sum_price": ("sum", "price"),
                          "avg_disc": ("avg", "discount"),
                          "cnt": ("count", None)}, num_groups_cap=16))
    if name == "Q3":
        return (Query(table)
                .filter(col("shipdate") > 1200)
                .join(orders_table, fk="orderkey",
                      cols=["orderdate", "shippriority"],
                      where=col("orderdate") < 180)
                .groupby(["orderdate", "shippriority"],
                         {"revenue": ("sum", "price"), "cnt": ("count", None)},
                         num_groups_cap=512))
    if name == "Q6":
        return (Query(table)
                .filter(col("shipdate").between(500, 864)
                        & col("discount").between(5, 7)
                        & (col("quantity") < 24))
                .map("rev", rev)
                .aggregate({"revenue": ("sum", "rev")}))
    if name == "Q17":
        return (Query(table)
                .semi_join("partkey", part_keys)
                .filter(col("quantity") < 10)
                .aggregate({"sum_price": ("sum", "price"), "c": ("count", None)}))
    if name == "Q19":
        return (Query(table)
                .semi_join("partkey", part_keys)
                .filter(col("quantity").between(5, 30) & (col("shipdate") > 100))
                .map("rev", rev)
                .aggregate({"revenue": ("sum", "rev")}))
    raise ValueError(name)


def build_ranked(name, table, orders_table=None, query_cls=None):
    """The ranked query ``name`` (R1, R2 or Q3r) staged on ``table``."""
    from repro_torch.core.plan import Query, col

    Query = query_cls or Query  # noqa: N806
    if name == "R1":
        return (Query(table).filter(col("shipdate") <= 2400)
                .order_by("price", descending=True, limit=100,
                          cols=["orderkey", "quantity"]))
    if name == "R2":
        return Query(table).order_by(["quantity", "shipdate"],
                                     descending=[True, False], limit=1000,
                                     cols=["price"])
    if name == "Q3r":
        return build_query("Q3", table, orders_table,
                           query_cls=query_cls).order_by(
            ["revenue", "orderdate"], descending=[True, False], limit=10)
    raise ValueError(name)


def _top_rows(keys, rows, limit):
    """Positions of the ``limit`` best rows by ``keys`` (primary first,
    smaller = better; ties to the lowest row): ``np.lexsort`` over the
    rows whose primary key is within the ``limit``-th best."""
    p = keys[0]
    if len(p) > limit:
        kth = np.partition(p, limit - 1)[limit - 1]
        cand = p <= kth
        keys, rows = tuple(k[cand] for k in keys), rows[cand]
    order = np.lexsort((rows,) + tuple(reversed(keys)))[:limit]
    return rows[order]


def ranked_oracle(name, d, q3_want=None):
    """The ranked query's answer with numpy: ``{"positions", "columns"}``
    for R1 and R2, Q3's oracle groups reordered for Q3r."""
    if name == "R1":
        rows = np.flatnonzero(d["shipdate"] <= 2400)
        pos = _top_rows((-d["price"][rows].astype(np.float64),), rows, 100)
        cols = ("orderkey", "quantity", "price")
    elif name == "R2":
        rows = np.arange(len(d["quantity"]))
        pos = _top_rows((-d["quantity"].astype(np.int64),
                         d["shipdate"].astype(np.int64)), rows, 1000)
        cols = ("price", "quantity", "shipdate")
    elif name == "Q3r":
        order = np.lexsort((q3_want["keys"]["orderdate"],
                            -q3_want["aggs"]["revenue"]))[:10]
        return {"num_groups": len(order),
                "keys": {k: v[order] for k, v in q3_want["keys"].items()},
                "aggs": {k: v[order] for k, v in q3_want["aggs"].items()}}
    else:
        raise ValueError(name)
    return {"positions": pos, "n": len(pos),
            "columns": {c: d[c][pos] for c in cols}}


def check_ranked(name, got, want):
    """A ranked answer against its oracle: positions and every gathered
    column exactly (they are stored values), group answers as
    ``check_answer``."""
    if "keys" in want:
        if got["num_groups"] != want["num_groups"]:
            raise AssertionError(f"{name}: {got['num_groups']} groups, "
                                 f"want {want['num_groups']}")
        check_answer(name, got, want)
        return
    if got["n"] != want["n"] or not np.array_equal(got["positions"],
                                                   want["positions"]):
        raise AssertionError(f"{name}: ranked positions differ")
    if set(got["columns"]) != set(want["columns"]):
        raise AssertionError(f"{name}: columns {sorted(got['columns'])}")
    for c, v in want["columns"].items():
        if not np.array_equal(got["columns"][c], v):
            raise AssertionError(f"{name}: column {c} differs")


def _grouped(keys, sel, weights, domain):
    """Group ids in lexicographic key order + float64 sums per group."""
    present = np.bincount(keys[sel], minlength=domain) > 0
    sums = {k: np.bincount(keys[sel], weights=w[sel].astype(np.float64),
                           minlength=domain)[present]
            for k, w in weights.items()}
    counts = np.bincount(keys[sel], minlength=domain)[present]
    return np.flatnonzero(present), sums, counts


def oracle(name, d, orders=None, part_keys=None):
    """The query's answer computed with numpy on the host (float64 sums).
    Group-by answers: {"keys": {name: int array}, "aggs": {...}} in
    lexicographic key order; scalar answers: {out: value}."""
    if name == "Q1":
        sel = d["shipdate"] <= 2400
        key = d["returnflag"] * 2 + d["linestatus"]
        gk, sums, cnt = _grouped(key, sel, {"q": d["quantity"], "p": d["price"],
                                            "d": d["discount"]}, 6)
        return {"keys": {"returnflag": gk // 2, "linestatus": gk % 2},
                "aggs": {"sum_qty": sums["q"], "sum_price": sums["p"],
                         "avg_disc": sums["d"] / np.maximum(cnt, 1),
                         "cnt": cnt}}
    if name == "Q3":
        od = orders["orderdate"][d["orderkey"]]
        sp = orders["shippriority"][d["orderkey"]]
        sel = (d["shipdate"] > 1200) & (od < 180)
        key = od * 2 + sp
        gk, sums, cnt = _grouped(key, sel, {"r": d["price"]}, 366 * 2)
        return {"keys": {"orderdate": gk // 2, "shippriority": gk % 2},
                "aggs": {"revenue": sums["r"], "cnt": cnt}}
    price = d["price"].astype(np.float64)
    if name == "Q6":
        sel = ((d["shipdate"] >= 500) & (d["shipdate"] <= 864)
               & (d["discount"] >= 5) & (d["discount"] <= 7)
               & (d["quantity"] < 24))
        return {"revenue": float((price * d["discount"])[sel].sum())}
    member = np.isin(d["partkey"], part_keys)
    if name == "Q17":
        sel = member & (d["quantity"] < 10)
        return {"sum_price": float(price[sel].sum()), "c": int(sel.sum())}
    if name == "Q19":
        sel = (member & (d["quantity"] >= 5) & (d["quantity"] <= 30)
               & (d["shipdate"] > 100))
        return {"revenue": float((price * d["discount"])[sel].sum())}
    raise ValueError(name)


def host_result(res):
    """A query result as host numpy arrays (trimmed to the live groups)."""
    from repro_torch.core.order import RankedTable
    from repro_torch.device import to_numpy
    if isinstance(res, RankedTable):
        return {"positions": res.positions, "n": res.n,
                "columns": dict(res.columns)}
    if isinstance(res, dict):
        return {k: to_numpy(v) for k, v in res.items()}
    ng = int(res.num_groups)
    return {"num_groups": ng,
            "keys": {k: to_numpy(v)[:ng] for k, v in res.keys.items()},
            "aggs": {k: to_numpy(v)[:ng] for k, v in res.aggs.items()}}


def check_same(name, got, want):
    """Two host results of one query (e.g. streamed and resident): group
    keys, integers and counts equal, float sums within rtol 1e-4."""
    if "keys" in want:
        if got["num_groups"] != want["num_groups"]:
            raise AssertionError(f"{name}: group counts differ")
        check_answer(name, got, {"keys": want["keys"], "aggs": {
            k: v if np.issubdtype(v.dtype, np.integer) else v.astype(np.float64)
            for k, v in want["aggs"].items()}})
        return
    for k, v in want.items():
        g = np.asarray(got[k])
        if np.issubdtype(g.dtype, np.integer) and int(g) != int(v):
            raise AssertionError(f"{name}: {k}={int(g)} != {int(v)}")
        np.testing.assert_allclose(float(g), float(v), rtol=1e-4,
                                   err_msg=f"{name}: {k}")


def _bits(tree):
    """Flatten a host result to (name, bytes) pairs for bit-identity."""
    if isinstance(tree, dict):
        return [(k + "/" + n, b) for k, v in sorted(tree.items())
                for n, b in _bits(v)]
    return [("", np.ascontiguousarray(np.asarray(tree)).tobytes())]


def check_answer(name, got, want):
    if "keys" in want:
        for k, v in want["keys"].items():
            if not np.array_equal(got["keys"][k], v):
                raise AssertionError(f"{name}: group keys {k} differ")
        for k, v in want["aggs"].items():
            g = got["aggs"][k]
            if np.issubdtype(g.dtype, np.integer):
                if not np.array_equal(g, v):
                    raise AssertionError(f"{name}: {k} differs")
            else:
                np.testing.assert_allclose(g, v, rtol=1e-4,
                                           err_msg=f"{name}: {k}")
        return
    for k, v in want.items():
        g = got[k]
        if isinstance(v, int):
            if int(g) != v:
                raise AssertionError(f"{name}: {k}={int(g)} != {v}")
        else:
            np.testing.assert_allclose(float(g), v, rtol=1e-4,
                                       err_msg=f"{name}: {k}")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_turns_ms(fn, other, iters=30, warmup=2):
    """``time_ms`` of ``fn`` and of ``other`` taken in turns (fn, other,
    other, fn, ...), so both meet the same clocks and host load: the
    medians of ``iters`` calls each."""
    import torch
    for _ in range(warmup):
        fn()
        other()
    times = ([], [])
    for i in range(iters):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            (fn, other)[j]()
            b.record()
            b.synchronize()
            times[j].append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


def time_b2b_ms(fn, per_launch_ms, budget_ms=25.0):
    """Milliseconds a launch of ``fn`` takes back to back: N launches
    between one pair of CUDA events, over N (N sized to about
    ``budget_ms`` of work, 10 to 200), after warm-up. Unlike ``time_ms``,
    the host's dispatch of a launch overlaps the device work of the one
    before it."""
    import torch
    n = int(min(200, max(10, budget_ms / max(per_launch_ms, 1e-3))))
    fn()
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_us(fn, batch=20, reps=30):
    """Host microseconds one call of ``fn`` takes: the median over ``reps``
    batches of ``batch`` calls, timed on the host's clock with no
    synchronisation inside a batch (the card drains between batches)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_us(fn, key, reps=50):
    """Device microseconds one call of ``fn`` takes: the CUDA time
    ``torch.profiler`` books to kernels whose name holds ``key``, over
    ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if key in e.key and not e.key.startswith("aten::"):
            total += getattr(e, "device_time_total", None) or e.cuda_time_total
    return total / reps if total else None


def topk_more_shapes(dev, k):
    """``topk_kernel`` beside ``torch.topk`` at one streamed partition
    (2^23 random int32 keys) and at R1's length in ascending order (every
    key beats the running threshold: the kernel's worst case), each held
    against ``ref.topk``: per-launch and back-to-back ms, and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk as kt
    rng = np.random.default_rng(11)
    out = []
    for what, n in (("streamed partition, random", 1 << 23),
                    ("R1 length, ascending", LINEITEM_ROWS[10.0])):
        if what.endswith("random"):
            x = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n,
                                              dtype=np.int32)).to(dev)
        else:
            x = torch.arange(n, dtype=torch.int32, device=dev)
        got, want = kt.topk_kernel(x, k), ref.topk(x, k)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"topk_kernel disagrees: {what}")
        kern = lambda: kt.topk_kernel(x, k)  # noqa: E731
        lib = lambda: torch.topk(x, k)  # noqa: E731
        k_ms, lib_ms = time_turns_ms(kern, lib)
        out.append({"case": what, "values": n, "k": k,
                    "passes": kt.passes(n, k), "ms": k_ms,
                    "ms_back_to_back": time_b2b_ms(kern, k_ms),
                    "library_ms": lib_ms,
                    "library_ms_back_to_back": time_b2b_ms(lib, lib_ms),
                    "bound_ms": bound_ms(4 * n + 8 * k, n)[0]})
        del x, got, want
    return out


def bound_ms(nbytes, nops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _steps(n):
    return max(1, int(n).bit_length())


# ---------------------------------------------------------------------------
# Phase 2: kernel edge cases against the plain versions
# ---------------------------------------------------------------------------


def kernel_edge_cases(dev):
    import torch
    from repro_torch.kernels import bucketize as kb, ref
    from repro_torch.kernels.rle_decode import rle_decode_kernel
    from repro_torch.kernels.segment_reduce import segment_sum_kernel

    rng = np.random.default_rng(0)
    i32max = np.iinfo(np.int32).max
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def same(a, b, what):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"kernel check failed: {what}")

    b_cases = [
        ("empty queries", np.arange(10), np.zeros(0)),
        ("empty boundaries", np.zeros(0), np.arange(5)),
        ("duplicates, ragged tail", np.sort(rng.integers(0, 10, 37)),
         rng.integers(-2, 12, 1025)),
        ("sentinel-padded boundaries",
         np.concatenate([np.sort(rng.integers(0, 100, 20)), np.full(12, i32max)]),
         rng.integers(-5, 200, 333)),
        ("one boundary", np.array([7]), rng.integers(0, 15, 77)),
        ("large", np.sort(rng.integers(0, 10**7, 50_000)),
         rng.integers(-5, 10**7 + 5, 300_001)),
        ("beyond shared memory", np.sort(rng.integers(0, 10**8, 300_000)),
         rng.integers(0, 10**8, 100_003)),
    ]
    for what, b, q in b_cases:
        for dtype in (np.int32, np.float32):
            bb, qq = t(b.astype(dtype)), t(q.astype(dtype))
            for right in (True, False):
                want = ref.ref_bucketize(bb, qq, right)
                if bb.shape[0] <= kb.MAX_SMEM_BOUNDARIES:
                    same(kb.bucketize_kernel(bb, qq, right), want,
                         f"bucketize_kernel {what} {dtype.__name__} {right}")
                same(kb.bucketize_count_kernel(bb, qq, right), want,
                     f"bucketize_count_kernel {what} {dtype.__name__} {right}")
                cases += 1
    # views at storage offset 1 (queries not 16-byte aligned: the scalar
    # loads), nq % 4 != 0, and the 16-byte route's ragged ends
    for nq in (1, 3, 5, 1023, 1025, 300_001):
        for dtype in (np.int32, np.float32):
            b = np.sort(rng.integers(-50, 50, 550)).astype(dtype)
            q = rng.integers(-60, 60, nq + 1).astype(dtype)
            for off in (0, 1):
                bb, qq = t(b), t(q)[off:off + nq]
                for right in (True, False):
                    same(kb.bucketize_kernel(bb, qq, right),
                         ref.ref_bucketize(bb, qq, right),
                         f"bucketize_kernel offset {off} nq={nq} "
                         f"{dtype.__name__} {right}")
                    cases += 1
    nanq = t(np.array([np.nan, 1.0, 5.0], np.float32))
    nanb = t(np.array([1.0, 2.0, 3.0], np.float32))
    for right in (True, False):
        want = ref.ref_bucketize(nanb, nanq, right)
        same(kb.bucketize_kernel(nanb, nanq, right), want, "NaN queries")
        same(kb.bucketize_count_kernel(nanb, nanq, right), want, "NaN queries")

    def rle_inputs(nrows, starts, ends, vals, cap):
        pad = cap - len(starts)
        return (np.concatenate([vals, np.zeros(pad, vals.dtype)]),
                np.concatenate([starts, np.full(pad, nrows)]).astype(np.int32),
                np.concatenate([ends, np.full(pad, nrows)]).astype(np.int32))

    starts = np.sort(rng.choice(5000, 300, replace=False)).astype(np.int32)
    ends = np.concatenate([starts[1:] - 1, [4999]]).astype(np.int32)
    r_cases = [
        ("zero runs at capacity", 500, np.zeros(0, np.int32),
         np.zeros(0, np.int32), np.zeros(0, np.int32), 8, 0, 7),
        ("zero rows", 0, np.array([0]), np.array([0]),
         np.array([3], np.int32), 1, 1, 0),
        ("gaps, non-zero fill, ragged", 3000, np.array([5, 2047, 2900]),
         np.array([90, 2500, 2999]), np.array([1.5, -2.0, 3.25], np.float32),
         3, 3, -1),
        ("sentinel padding", 3000, np.array([0, 500, 2900]),
         np.array([99, 999, 2999]), np.array([3, 5, 7], np.int32), 16, 3, 0),
        ("full cover", 5000, starts, ends,
         rng.integers(1, 100, 300).astype(np.int32), 300, 300, 0),
        ("n below the filled slots", 5000, starts, ends,
         rng.random(300).astype(np.float32), 300, 150, 2.5),
    ]
    for what, nrows, s, e, v, cap, n, fill in r_cases:
        vv, ss, ee = rle_inputs(nrows, s, e, v, cap)
        vv, ss, ee = t(vv), t(ss), t(ee)
        nn = torch.tensor(n, dtype=torch.int32, device=dev)
        same(rle_decode_kernel(vv, ss, ee, nn, nrows, fill),
             ref.ref_rle_decode(vv, ss, ee, nn, nrows, fill),
             f"rle_decode_kernel {what}")
        cases += 1

    s_cases = [
        ("empty values", 0, 4, None),
        ("one group, ragged tail", 1025, 1, None),
        ("all ids out of range", 512, 8, "all_out"),
        ("every fifth id dropped", 2048, 8, "fifth"),
        ("sorted ids", 300_000, 16, "sorted"),
        ("random ids, G=4096", 200_001, 4096, None),
        ("negative ids", 4096, 32, "negative"),
    ]
    for what, n, g, how in s_cases:
        v = rng.random(n).astype(np.float32)
        ids = rng.integers(0, g, n).astype(np.int32)
        if how == "all_out":
            ids[:] = g
        elif how == "fifth":
            ids[::5] = g
        elif how == "sorted":
            ids = np.sort(ids)
        elif how == "negative":
            ids[::3] = -1
        vt, it = t(v), t(ids)
        got = segment_sum_kernel(vt, it, g)
        again = segment_sum_kernel(vt, it, g)
        if not torch.equal(got, again):
            raise AssertionError(f"segment_sum_kernel not deterministic: {what}")
        keep = (ids >= 0) & (ids < g)
        want = np.zeros(g, np.float64)
        np.add.at(want, ids[keep], v[keep].astype(np.float64))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-5, err_msg=f"segment_sum {what}")
        plain = ref.ref_segment_reduce(vt, it, g)
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"segment_sum vs plain {what}")
        cases += 1
    torch.cuda.synchronize()
    return cases


def _packed_values(rng, b, n, lo):
    """``n`` values of a ``b``-bit domain from ``lo`` (the full int32 range
    at b = 32), their packed lanes as int32 (host), and the offset."""
    from repro_torch.core import compress
    if b == 32:
        lo, hi = -(2**31), 2**31 - 1
    else:
        hi = lo + (1 << b) - 1
    v = rng.integers(lo, hi, n, endpoint=True).astype(np.int64)
    return v, compress.pack_array(v, lo, b).view(np.int32), lo


def packed_edge_cases(dev):
    """The three packed kernels against their plain versions on the card."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import unpack as ku

    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def same(a, b, what):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"kernel check failed: {what}")

    for b in PACK_BITS:
        # N = 0, N = 1, a few lanes (values straddle lanes for most b), a
        # ragged tail; negative offsets, and the full range at b = 32
        for n in (0, 1, 33, 100_003):
            for lo in (-(1 << min(b, 31) - 1), 12345):
                v, w, off = _packed_values(rng, b, n, lo)
                ww = t(w)
                got = ku.unpack_kernel(ww, b, off, n)
                same(got, ref.ref_unpack(ww, b, off, n), f"unpack b={b} n={n}")
                if not np.array_equal(got.cpu().numpy(), v.astype(np.int32)):
                    raise AssertionError(f"unpack round trip b={b} n={n}")
                cases += 1
    for off in (0, 7, -(2**31), 2**31 - 1):  # width-32 wrap-add
        v = np.array([-(2**31), -1, 0, 1, 2**31 - 1], np.int64)
        from repro_torch.core import compress
        ww = t(compress.pack_array(v, off, 32).view(np.int32))
        got = ku.unpack_kernel(ww, 32, off, 5)
        if not np.array_equal(got.cpu().numpy(), v.astype(np.int32)):
            raise AssertionError(f"unpack width-32 wrap, offset {off}")
        cases += 1

    i32max = np.iinfo(np.int32).max
    for b, nb, how in ((3, 1, "one boundary"), (9, 32, "sentinel-padded"),
                       (21, 4096, "shared memory"),
                       (24, ku.MAX_SMEM_BOUNDARIES + 1000, "beyond shared"),
                       (32, 1000, "width 32"), (1, 2, "width 1")):
        for n in (0, 1, 77_777):
            v, w, off = _packed_values(rng, b, n, -3)
            lo_b = int(v.min()) - 2 if n else -5
            hi_b = int(v.max()) + 2 if n else 5
            bnd = np.sort(rng.integers(lo_b, hi_b, nb, endpoint=True))
            if how == "sentinel-padded":
                bnd[-12:] = i32max
            bb, ww = t(np.clip(bnd, -(2**31), i32max).astype(np.int32)), t(w)
            for right in (True, False):
                want = ref.ref_bucketize_packed(bb, ww, b, off, n, right)
                same(ku.bucketize_packed_kernel(bb, ww, b, off, n, right), want,
                     f"bucketize_packed {how} n={n} right={right}")
                if nb <= ku.MAX_SMEM_BOUNDARIES:
                    same(ku.bucketize_packed_kernel(bb, ww, b, off, n, right,
                                                    global_route=True),
                         want, f"bucketize_packed L2 route {how} n={n}")
                cases += 1

    def runs(nrows, k, cap, gap):
        starts = np.sort(rng.choice(nrows - gap, k, replace=False))
        ends = np.minimum(np.concatenate([starts[1:] - 1 - gap,
                                          [nrows - 1 - gap]]), nrows - 1)
        ends = np.maximum(ends, starts)
        pad = cap - k
        return (np.concatenate([starts, np.full(pad, nrows)]).astype(np.int32),
                np.concatenate([ends, np.full(pad, nrows)]).astype(np.int32))

    for what, nrows, k, cap, n_valid, gap, b, fill in (
            ("full cover", 50_000, 300, 300, 300, 0, 11, 0),
            ("gaps, n < cap, fill", 50_000, 300, 512, 150, 3, 13, -7),
            ("no valid runs", 5_000, 8, 16, 0, 1, 5, 9),
            ("one row", 1, 1, 1, 1, 0, 1, 0),
            ("width 32", 40_000, 64, 64, 64, 2, 32, 3)):
        starts, ends = runs(nrows, k, cap, gap)
        v, w, off = _packed_values(rng, b, cap, -50)
        ww, ss, ee = t(w), t(starts), t(ends)
        nn = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        same(ku.rle_decode_packed_kernel(ww, b, off, cap, ss, ee, nn, nrows,
                                         fill),
             ref.ref_rle_decode_packed(ww, b, off, cap, ss, ee, nn, nrows, fill),
             f"rle_decode_packed {what}")
        cases += 1
    torch.cuda.synchronize()
    return cases


def topk_edge_cases(dev):
    """``topk_kernel`` against ``ref.topk`` on the card: values and indices
    equal, and bit-identical across two launches."""
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import topk as kt

    rng = np.random.default_rng(3)
    i32min = np.iinfo(np.int32).min
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = 0

    def check(x, k, what):
        got, again = kt.topk_kernel(x, k), kt.topk_kernel(x, k)
        want = ref.topk(x, k)
        for a, b, part in ((got[0], want[0], "values"),
                           (got[1], want[1], "indices")):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"topk_kernel check failed: {what} "
                                     f"k={k} {part}")
        bits = [v.view(torch.int32) for v in (got[0], again[0])]
        if not (torch.equal(*bits) and torch.equal(got[1], again[1])):
            raise AssertionError(f"topk_kernel not bit-identical: {what}")

    for dtype in (np.int32, np.float32):
        for n in (0, 1, 7, 2047, 2048, 2049, 1_000_003):
            x = (rng.integers(-1000, 1000, n) if dtype == np.int32
                 else rng.standard_normal(n)).astype(dtype)
            for k in (1, 8, 37, 128, 256):
                check(t(x), k, f"{dtype.__name__} n={n}")
                cases += 1
    specials = {
        "all equal int32": np.full(100_000, 7, np.int32),
        "all equal float32": np.full(100_000, 0.5, np.float32),
        "INT32_MIN rows": np.where(rng.random(50_000) < 0.5, i32min,
                                   rng.integers(-5, 5, 50_000)).astype(np.int32),
        "only INT32_MIN, n < k": np.full(5, i32min, np.int32),
        "+-inf": np.where(rng.random(100_000) < 0.01, np.inf,
                          np.where(rng.random(100_000) < 0.01, -np.inf,
                                   rng.standard_normal(100_000))).astype(np.float32),
        "signed zeros": rng.choice([0.0, -0.0, 1.0, -1.0], 10_000).astype(np.float32),
    }
    for what, x in specials.items():
        for k in (1, 37, 256):
            check(t(x), k, what)
            cases += 1
    n = 3_000_000  # the range pass and one survivor pass at k = 256
    x = t(rng.integers(-(2**31), 2**31 - 1, n, endpoint=True).astype(np.int32))
    before = _build.LAUNCHES["topk_kernel"]
    check(x, 256, "a survivor pass")
    launched = (_build.LAUNCHES["topk_kernel"] - before) // 2
    if launched != kt.passes(n, 256) or launched < 2:
        raise AssertionError(f"topk_kernel: {launched} passes at n={n}")
    cases += 1
    # the inputs that stress the running threshold, at 3M keys
    ramp = np.arange(n, dtype=np.int64) - n // 2
    stress = {
        "ascending int32": ramp.astype(np.int32),
        "descending float32": (-ramp).astype(np.float32),
        # equal values in runs of 50,000 across the block ranges' edges
        "ties straddling ranges": (ramp // 50_000).astype(np.int32),
        "all INT32_MIN but a few": np.where(
            rng.random(n) < 0.99995, i32min, rng.integers(-3, 3, n)
        ).astype(np.int32),
    }
    for what, xs in stress.items():
        for k in (8, 100, 256):
            check(t(xs), k, what)
            cases += 1
    # the answer does not depend on the grid; misaligned starts are legal
    xs = t(stress["ties straddling ranges"])
    want = kt.topk_kernel(xs, 128)
    for cap in (2, 7, 100):
        got = kt.topk_kernel(xs, 128, max_blocks=cap)
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            raise AssertionError(f"topk_kernel: grid cap {cap} differs")
        cases += 1
    for dtype in (np.int32, np.float32):
        base = t(rng.integers(-1000, 1000, 1_000_003).astype(dtype))
        for off in (1, 2, 3):
            check(base[off:], 37, f"{dtype.__name__} view at offset {off}")
            cases += 1
    torch.cuda.synchronize()
    return cases


# ---------------------------------------------------------------------------
# Phase 6: every kernel at the main path's largest inputs
# ---------------------------------------------------------------------------


def kernel_timing(launches, largest):
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bucketize as kb
    from repro_torch.kernels.rle_decode import rle_decode_kernel
    from repro_torch.kernels.segment_reduce import segment_sum_kernel
    from repro_torch.kernels import topk as kt
    from repro_torch.kernels import unpack as ku

    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = largest[name]
        lib_what, lib_fn = None, None
        if name in ("bucketize_kernel", "bucketize_count_kernel"):
            b, q, right = rec["boundaries"], rec["queries"], rec["right"]
            kern = (kb.bucketize_kernel if name == "bucketize_kernel"
                    else kb.bucketize_count_kernel)
            got = kern(b, q, right)
            want = ref.ref_bucketize(b, q, right)
            err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            if not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees at the query shape")
            nb, nq = b.shape[0], q.shape[0]
            shape = {"boundaries": nb, "queries": nq, "dtype": str(q.dtype),
                     "right": right, "queries_offset": q.storage_offset()}
            nbytes, nops = 4 * (nb + 2 * nq), nq * _steps(nb)
            kern_fn = lambda: kern(b, q, right)  # noqa: E731
            plain_fn = lambda: ref.ref_bucketize(b, q, right)  # noqa: E731
            lib_fn = lambda: torch.searchsorted(  # noqa: E731
                b, q, right=right, out_int32=True)
            lib_what = "torch.searchsorted"
            if name == "bucketize_kernel":  # where a launch's time goes
                shape["host_us"] = {"kernel": host_us(kern_fn),
                                    lib_what: host_us(lib_fn)}
                shape["device_us"] = {
                    "kernel": device_us(kern_fn, "bucketize_smem_kernel"),
                    lib_what: device_us(lib_fn, "searchsorted")}
        elif name == "rle_decode_kernel":
            v, s, e, n = rec["values"], rec["starts"], rec["ends"], rec["n"]
            nrows, fill = rec["nrows"], rec["fill"]
            got = rle_decode_kernel(v, s, e, n, nrows, fill)
            want = ref.ref_rle_decode(v, s, e, n, nrows, fill)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            cap = v.shape[0]
            shape = {"capacity": cap, "nrows": nrows, "dtype": str(v.dtype)}
            nbytes, nops = 12 * cap + 4 + 4 * nrows, nrows * _steps(cap)
            kern_fn = lambda: rle_decode_kernel(  # noqa: E731
                v, s, e, n, nrows, fill)
            plain_fn = lambda: ref.ref_rle_decode(  # noqa: E731
                v, s, e, n, nrows, fill)
        elif name == "unpack_kernel":
            w, b, off, n = (rec["words"], rec["bit_width"], rec["offset"],
                            rec["nvals"])
            got = ku.unpack_kernel(w, b, off, n)
            if not torch.equal(got, ref.ref_unpack(w, b, off, n)):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            shape = {"values": n, "bit_width": b, "words": w.shape[0]}
            nbytes, nops = 4 * w.shape[0] + 4 * n, n
            kern_fn = lambda: ku.unpack_kernel(w, b, off, n)  # noqa: E731
            plain_fn = lambda: ref.ref_unpack(w, b, off, n)  # noqa: E731
        elif name == "bucketize_packed_kernel":
            bnd, w, b, off, n, right = (rec["boundaries"], rec["words"],
                                        rec["bit_width"], rec["offset"],
                                        rec["nvals"], rec["right"])
            got = ku.bucketize_packed_kernel(bnd, w, b, off, n, right)
            if not torch.equal(got, ref.ref_bucketize_packed(bnd, w, b, off, n,
                                                             right)):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            nb = bnd.shape[0]
            shape = {"boundaries": nb, "queries": n, "bit_width": b,
                     "right": right}
            nbytes = 4 * (nb + w.shape[0] + n)
            nops = n * _steps(nb)
            kern_fn = lambda: ku.bucketize_packed_kernel(  # noqa: E731
                bnd, w, b, off, n, right)
            plain_fn = lambda: ref.ref_bucketize_packed(  # noqa: E731
                bnd, w, b, off, n, right)
            # no PyTorch call computes this function: torch.searchsorted
            # needs the queries unpacked first. Timed beside it, it is not
            # the library time of the kernel line.
            q = ref.ref_unpack(w, b, off, n)
            searched = lambda: torch.searchsorted(  # noqa: E731
                bnd, q, right=right, out_int32=True)
            shape["searchsorted_on_unpacked_ms"] = time_ms(searched)
            shape["searchsorted_on_unpacked_ms_back_to_back"] = time_b2b_ms(
                searched, shape["searchsorted_on_unpacked_ms"])
        elif name == "rle_decode_packed_kernel":
            w, b, off, cap = (rec["words"], rec["bit_width"], rec["offset"],
                              rec["cap"])
            st, en, nn, nrows, fill = (rec["starts"], rec["ends"], rec["n"],
                                       rec["nrows"], rec["fill"])

            def kern():
                return ku.rle_decode_packed_kernel(w, b, off, cap, st, en, nn,
                                                   nrows, fill)

            def plain():
                return ref.ref_rle_decode_packed(w, b, off, cap, st, en, nn,
                                                 nrows, fill)

            if not torch.equal(kern(), plain()):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            shape = {"capacity": cap, "nrows": nrows, "bit_width": b}
            nbytes = 4 * w.shape[0] + 8 * cap + 4 + 4 * nrows
            nops = nrows * _steps(cap)
            kern_fn, plain_fn = kern, plain
        elif name == "topk_kernel":
            x, k = rec["values"], rec["k"]
            got, want = kt.topk_kernel(x, k), ref.topk(x, k)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} disagrees at the query shape")
            err = 0.0
            n = x.shape[0]
            shape = {"values": n, "dtype": str(x.dtype), "k": k,
                     "k_pow2": kt.k_pow2_of(k), "passes": kt.passes(n, k)}
            # keys read once, k (value, index) pairs written; at least one
            # comparison a key
            nbytes, nops = 4 * n + 8 * k, n
            kern_fn = lambda: kt.topk_kernel(x, k)  # noqa: E731
            plain_fn = lambda: ref.topk(x, k)  # noqa: E731
            # same values; its tie order is not documented
            lib_fn = lambda: torch.topk(x, k)  # noqa: E731
            lib_what = "torch.topk"
            shape["more_shapes"] = topk_more_shapes(x.device, k)
            # the whole call at other grid caps than the default
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            shape["grid_caps"] = []
            for per_sm in (1, kt.BLOCKS_PER_SM, 4):
                cap = sms * per_sm
                capped = lambda: kt.topk_kernel(  # noqa: E731
                    x, k, max_blocks=cap)
                if not all(torch.equal(g, w) for g, w in zip(capped(), want)):
                    raise AssertionError(f"{name} disagrees at cap {cap}")
                shape["grid_caps"].append({
                    "blocks_per_sm": per_sm,
                    "grid": kt.plan(n, k, cap)[0].grid,
                    "ms_back_to_back": time_b2b_ms(capped, 0.2)})
        else:
            v, ids, g = rec["values"], rec["segment_ids"], rec["num_segments"]
            got = segment_sum_kernel(v, ids, g)
            if not torch.equal(got, segment_sum_kernel(v, ids, g)):
                raise AssertionError(f"{name} not deterministic")
            plain = ref.ref_segment_reduce(v, ids, g)
            ids_h, v_h = ids.cpu().numpy(), v.cpu().numpy().astype(np.float64)
            keep = (ids_h >= 0) & (ids_h < g)
            want = np.zeros(g, np.float64)
            np.add.at(want, ids_h[keep], v_h[keep])
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                       atol=1e-3, err_msg=name)
            err = float((got - plain).abs().max())
            n = v.shape[0]
            shape = {"values": n, "num_segments": g}
            nbytes, nops = 8 * n + 4 * g, n
            kern_fn = lambda: segment_sum_kernel(v, ids, g)  # noqa: E731
            plain_fn = lambda: ref.ref_segment_reduce(v, ids, g)  # noqa: E731
            if bool(keep.all()):  # one index_add_ computes the same function
                lib_fn = lambda: torch.zeros(  # noqa: E731
                    g, device=v.device).index_add_(0, ids, v)
                lib_what = "index_add_"
        lib_ms = lib_b2b = None
        if lib_fn is not None:  # kernel and library call in turns
            k_ms, lib_ms = time_turns_ms(kern_fn, lib_fn)
            lib_b2b = time_b2b_ms(lib_fn, lib_ms)
        else:
            k_ms = time_ms(kern_fn)
        p_ms = time_ms(plain_fn)
        k_b2b = time_b2b_ms(kern_fn, k_ms)
        b_ms, b_by = bound_ms(nbytes, nops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "ms_back_to_back": k_b2b, "library_ms_back_to_back": lib_b2b}
        print(json.dumps({"kernel": name, "kernel_ms_per_launch": k_ms,
                          "kernel_ms_back_to_back": k_b2b, "plain_ms": p_ms,
                          "library_ms_per_launch": lib_ms,
                          "library_ms_back_to_back": lib_b2b,
                          "library": lib_what, "bound_ms": b_ms,
                          "bound_by": b_by, "shape": shape,
                          "launches": launches[name],
                          "max_abs_err": err}), flush=True)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the query path at TPC-H scale
# ---------------------------------------------------------------------------


def profile_run(name, q, out_dir):
    """One more warm run under ``torch.profiler``: writes the op table to
    ``out_dir/<name>.txt`` and returns the device busy time, its share of
    the wall time, and the ops that launched the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
            "top_ops_device_ms": ops[:6]}


def query_phase(sf, dev, runs, profile_dir=None):
    """The resident path. Returns its per-query records and what the
    later phases reuse: the LINEITEM arrays of ``OOC_QUERIES``, the oracles
    and resident answers, ORDERS and the semi-join keys, and the resident
    tables the ordering phase ranks."""
    import torch
    from repro_torch.core import compress
    from repro_torch.core.table import Table
    from repro_torch.kernels import _build

    n = LINEITEM_ROWS.get(sf, int(round(LINEITEM_ROWS[1.0] * sf)))
    # every LINEITEM orderkey (in [0, n // 4)) must name an ORDERS row
    n_orders = max(int(round(SF1_ORDERS * sf)), n // 4)
    rng = np.random.default_rng(2)
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    cfg = compress.CompressionConfig(plain_threshold=1_000)
    orders = make_orders(rng, n_orders)
    orders_table = Table.from_arrays(orders, cfg=cfg, device=dev)
    print(f"query phase: LINEITEM {n} rows, ORDERS {n_orders} rows "
          f"(scale factor {sf}), {len(part_keys)} semi-join part keys",
          flush=True)
    per_query = {}
    shared = {"orders": orders, "orders_table": orders_table,
              "part_keys": part_keys, "data": {}, "want": {}, "resident": {},
              "tables": {}, "packed": {}}
    for name in ("Q1", "Q3", "Q6", "Q17", "Q19"):
        t0 = time.perf_counter()
        data = make_lineitem(rng, n, order=SORT_ORDERS[name], device=dev)
        gen_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = Table.from_arrays(data, cfg=cfg, device=dev)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        want = oracle(name, data, orders=orders, part_keys=part_keys)
        plain_bytes = sum(v.shape[0] * 4 for v in data.values())
        if name in OOC_QUERIES:  # generated once, streamed again later
            shared["data"][name] = data
            shared["want"][name] = want
        del data
        q = build_query(name, table, orders_table, part_keys)
        before = dict(_build.LAUNCHES)
        results, times = [], []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = q.run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            results.append(host_result(res))
            del res
        caused = {k: (_build.LAUNCHES[k] - before[k]) // runs
                  for k in _build.LAUNCHES}
        check_answer(name, results[0], want)
        first = _bits(results[0])
        for other in results[1:]:
            if _bits(other) != first:
                raise AssertionError(f"{name}: re-run is not bit-identical")
        shared["resident"][name] = results[0]
        rec = {"query": name, "encodings": table.encodings(),
               "device_MiB_encoded": table.nbytes() / 2**20,
               "device_MiB_plain": plain_bytes / 2**20,
               "generate_s": gen_s, "ingest_s": ingest_s,
               "cold_ms": times[0], "warm_median_ms":
               statistics.median(times[1:]) if runs > 1 else None,
               "launches_per_run": caused, "oracle": "ok",
               "rerun_bit_identical": True}
        if profile_dir is not None:
            rec["profile"] = profile_run(name, q, profile_dir)
        print(json.dumps(rec), flush=True)
        per_query[name] = rec
        if name in RANKED_SOURCE.values():  # ranked again, resident
            shared["tables"][name] = table
        del q, table
        torch.cuda.empty_cache()
    return per_query, shared


# ---------------------------------------------------------------------------
# Phase 4: the out-of-core path (packed partitions streamed from the host)
# ---------------------------------------------------------------------------


def pinned_h2d_gbps(dev, nbytes=1 << 30, iters=5):
    """Host-to-device rate of one ``nbytes`` copy from pinned memory
    (median of ``iters`` CUDA-event timings), in GB/s."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), iters=iters,
                 warmup=1)
    del src, dst
    torch.cuda.empty_cache()
    return nbytes / (ms * 1e-3) / 1e9


def _timed_run(q):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = host_result(q.run())
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def chaos_plan(seed, visited):
    """``FaultPlan.seeded``'s schedule (transient transfer faults and one
    OOM in the program, each at attempt 0 of a distinct partition) drawn
    over the partitions the query visits: a fault placed on a partition
    that zone maps prune would never fire. Three transients and one OOM
    when at least four partitions are visited."""
    from repro_torch.core.faults import FaultPlan
    k = min(4, len(visited))
    chosen = np.random.default_rng(seed).choice(visited, size=k, replace=False)
    plan = FaultPlan()
    for p in chosen[:-1]:
        plan.transient(int(p))
    return plan.oom(int(chosen[-1]), site="compute")


def outofcore_phase(dev, shared, h2d_gbps, seed, profile_dir=None):
    """Stream ``OOC_QUERIES`` over packed (and, for comparison, unpacked)
    host partitions; returns the per-query records. With ``profile_dir``,
    one more depth-2 run of each query goes under ``torch.profiler``."""
    import torch
    from repro_torch.core import compress, telemetry
    from repro_torch.core.partition import PartitionedQuery, PartitionedTable
    from repro_torch.kernels import _build, dispatch

    cfg = compress.CompressionConfig(plain_threshold=1_000)
    orders_table, part_keys = shared["orders_table"], shared["part_keys"]
    per_query = {}
    for name in OOC_QUERIES:
        data = shared["data"][name]
        if name not in RANKED_SOURCE.values():
            del shared["data"][name]
        n = len(data["price"])
        # 8 partitions: 2**23 rows each at scale factor 10
        rows = 1 << max(8, (-(-n // 8) - 1).bit_length())
        tables, rec = {}, {"query": name, "partition_rows": rows}
        for pack in (True, False):
            t0 = time.perf_counter()
            tables[pack] = PartitionedTable.from_arrays(
                data, cfg=cfg, partition_rows=rows, pack=pack,
                budget_bytes=1 << 30, device=dev)
            rec[f"ingest_s_{'packed' if pack else 'unpacked'}"] = \
                time.perf_counter() - t0
        del data
        pt = tables[True]
        rec["partitions"] = len(pt.partitions)
        rec["padded_rows"] = sorted({p.padded_rows for p in pt.partitions})
        rec["host_MiB_packed"] = pt.nbytes() / 2**20
        rec["host_MiB_unpacked_partitions"] = tables[False].nbytes() / 2**20
        rec["MiB_unpacked_accounting"] = pt.nbytes_unpacked() / 2**20

        def query(table):
            return build_query(name, table, orders_table, part_keys,
                               query_cls=PartitionedQuery)

        results, times = {}, {0: [], 1: [], 2: []}
        moved = []
        for depth in (0, 1, 2, 0, 2, 0, 2):
            before = dict(_build.LAUNCHES)
            with dispatch.overrides(prefetch_depth=depth), \
                    telemetry.h2d_listener(lambda nb, tree: moved.append(nb)):
                q = query(pt)
                res, ms = _timed_run(q)
            if depth == 2 and "launches_per_run" not in rec:
                rec["launches_per_run"] = {
                    k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
            times[depth].append(ms)
            if depth in results and _bits(res) != _bits(results[depth]):
                raise AssertionError(f"{name}: depth-{depth} re-run differs")
            results.setdefault(depth, res)
            stats = dict(q.last_stats)
            if depth == 2:
                rec["stats_depth2"] = {k: stats[k] for k in (
                    "partitions", "executed", "skipped", "transferred",
                    "h2d_ms", "compute_ms", "merge_ms", "inflight_bytes_max",
                    "prefetch_depth")}
        bytes_moved = sum(moved) // len(times[0] + times[1] + times[2])
        check_answer(name, results[0], shared["want"][name])
        for depth in (1, 2):
            if _bits(results[depth]) != _bits(results[0]):
                raise AssertionError(f"{name}: depth {depth} is not "
                                     "bit-identical to depth 0")
        check_same(name, results[0], shared["resident"][name])
        moved_unpacked = []
        with telemetry.h2d_listener(lambda nb, tree: moved_unpacked.append(nb)):
            unpacked, ms_unpacked = _timed_run(query(tables[False]))
        check_same(name, results[0], unpacked)
        rec.update({
            "visited": stats["executed"], "pruned": stats["skipped"],
            "bytes_moved_packed": bytes_moved,
            "bytes_moved_unpacked": sum(moved_unpacked),
            "pinned_h2d_GBps": h2d_gbps,
            "h2d_bound_ms_packed": bytes_moved / (h2d_gbps * 1e9) * 1e3,
            "h2d_bound_ms_unpacked":
                sum(moved_unpacked) / (h2d_gbps * 1e9) * 1e3,
            "cold_ms_depth0": times[0][0],
            "warm_ms_depth0": statistics.median(times[0][1:]),
            "warm_ms_depth1": times[1][0],
            "warm_ms_depth2": statistics.median(times[2]),
            "ms_unpacked_depth2": ms_unpacked,
            "oracle": "ok", "matches_resident": True,
            "depths_bit_identical": True, "matches_unpacked": True,
            "unpacked_bit_identical": _bits(unpacked) == _bits(results[0]),
        })
        if profile_dir is not None:
            with dispatch.overrides(prefetch_depth=2):
                rec["profile_depth2"] = profile_run(f"streamed_{name}",
                                                    query(pt), profile_dir)
        if name == "Q6":
            plan = chaos_plan(seed, [i for i, ok, _ in q.last_verdicts if ok])
            with plan:
                q = query(pt)
                chaos, ms = _timed_run(q)
            if len(plan.fired) != len(plan.scheduled()):
                raise AssertionError(f"chaos: {len(plan.fired)} of "
                                     f"{len(plan.scheduled())} faults fired")
            if _bits(chaos) != _bits(results[2]):
                raise AssertionError("chaos: recovered Q6 differs from the "
                                     "clean run")
            rec["chaos"] = {"fired": len(plan.fired), "ms": ms,
                            "retries": q.last_stats["retries"],
                            "degradations": q.last_stats["degradations"],
                            "final_depth": q.last_stats["prefetch_depth"],
                            "bit_identical": True}
        print(json.dumps(rec), flush=True)
        per_query[name] = rec
        if name in RANKED_SOURCE.values():  # streamed again, ranked
            shared["packed"][name] = pt
        del tables, pt
        torch.cuda.empty_cache()
    return per_query


# ---------------------------------------------------------------------------
# Phase 5: ORDER BY / TOP-K, resident and streamed
# ---------------------------------------------------------------------------


def ordering_phase(dev, shared, runs, profile_dir=None):
    """R1, R2 and Q3r on the resident tables of the query phase and over
    the packed partitions of the out-of-core phase (depth 0, 1, 2);
    returns the per-query records."""
    import torch
    from repro_torch.core import telemetry
    from repro_torch.core.partition import PartitionedQuery
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import topk as kt

    orders_table = shared["orders_table"]
    per_query = {}
    for name, src in RANKED_SOURCE.items():
        data = shared["data"].pop(src)
        want = ranked_oracle(name, data, shared["want"].get(src))
        del data
        table = shared["tables"].pop(src)
        q = build_ranked(name, table, orders_table)
        rec = {"query": name, "table": f"LINEITEM sorted for {src}",
               "path": q._order_path(q.order_op())}
        results, times = [], []
        for i in range(runs):
            before = dict(_build.LAUNCHES)
            res, ms = _timed_run(q)
            if i == 0:
                rec["launches_per_run"] = {
                    k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
            results.append(res)
            times.append(ms)
        check_ranked(name, results[0], want)
        if name == "R1" and dev.type == "cuda":
            # every run launches topk.passes(rows, k) times
            n_keys = _build.LARGEST["topk_kernel"]["values"].shape[0]
            expect = kt.passes(n_keys, kt.k_pow2_of(100))
            got = rec["launches_per_run"]["topk_kernel"]
            if got != expect:
                raise AssertionError(f"R1: {got} topk launches a resident run, "
                                     f"want {expect}")
        for other in results[1:]:
            if _bits(other) != _bits(results[0]):
                raise AssertionError(f"{name}: re-run is not bit-identical")
        resident = results[0]
        rec.update({"cold_ms": times[0], "warm_median_ms":
                    statistics.median(times[1:]) if runs > 1 else None,
                    "oracle": "ok", "rerun_bit_identical": True})
        if profile_dir is not None:
            rec["profile"] = profile_run(name, q, profile_dir)
        del q, table

        pt = shared["packed"].pop(src)
        streamed, stimes, moved = {}, {0: [], 1: [], 2: []}, []
        for depth in (0, 1, 2, 0, 2):
            before = dict(_build.LAUNCHES)
            with dispatch.overrides(prefetch_depth=depth), \
                    telemetry.h2d_listener(lambda nb, tree: moved.append(nb)):
                sq = build_ranked(name, pt, orders_table,
                                  query_cls=PartitionedQuery)
                res, ms = _timed_run(sq)
            stimes[depth].append(ms)
            if depth in streamed and _bits(res) != _bits(streamed[depth]):
                raise AssertionError(f"{name}: streamed depth-{depth} re-run "
                                     "differs")
            streamed.setdefault(depth, res)
            if depth == 2 and "stats_depth2" not in rec:
                stats = dict(sq.last_stats)
                rec["stats_depth2"] = {k: stats.get(k, 0) for k in (
                    "partitions", "executed", "skipped", "ranked_skipped",
                    "prefetch_wasted", "transferred", "h2d_ms", "compute_ms",
                    "merge_ms", "prefetch_depth")}
                rec["streamed_launches_per_run"] = {
                    k: _build.LAUNCHES[k] - before[k] for k in _build.KERNELS}
        for depth in (1, 2):
            if _bits(streamed[depth]) != _bits(streamed[0]):
                raise AssertionError(f"{name}: depth {depth} is not "
                                     "bit-identical to depth 0")
        check_ranked(name, streamed[0], want)
        if name == "Q3r":  # float sums in another order than resident
            check_same(name, streamed[0], resident)
        elif _bits(streamed[0]) != _bits(resident):
            raise AssertionError(f"{name}: streamed differs from resident")
        st = rec["stats_depth2"]
        if name == "R2" and st["ranked_skipped"] == 0:
            raise AssertionError("R2: no partition was pruned by rank")
        if name == "R1" and dev.type == "cuda":
            # one call a visited partition, passes() launches a call
            kk = kt.k_pow2_of(100)
            visited = [p for p in pt.partitions if p.rows]
            expect = sum(kt.passes(p.padded_rows, kk) for p in visited)
            got = rec["streamed_launches_per_run"]["topk_kernel"]
            if st["executed"] == len(visited) and got != expect:
                raise AssertionError(f"R1: {got} topk launches, want {expect}")
            if got < st["executed"]:
                raise AssertionError("R1: a visited partition launched no "
                                     "topk_kernel")
        rec.update({
            "visited": st["executed"], "zone_pruned": st["skipped"],
            "ranked_pruned": st["ranked_skipped"],
            "bytes_moved": sum(moved) // 5,
            "cold_ms_depth0": stimes[0][0],
            "warm_ms_depth0": stimes[0][1],
            "warm_ms_depth1": stimes[1][0],
            "warm_ms_depth2": statistics.median(stimes[2]),
            "streamed_oracle": "ok", "depths_bit_identical": True,
            "streamed_equals_resident": "bit-identical" if name != "Q3r"
            else "keys and counts equal, sums within rtol 1e-4",
        })
        if profile_dir is not None:
            with dispatch.overrides(prefetch_depth=2):
                rec["profile_depth2"] = profile_run(
                    f"streamed_{name}", build_ranked(
                        name, pt, orders_table, query_cls=PartitionedQuery),
                    profile_dir)
        print(json.dumps(rec), flush=True)
        per_query[name] = rec
        del pt
        torch.cuda.empty_cache()
    return per_query


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sf", type=float, default=10.0,
                        help="TPC-H scale factor of the query phase")
    parser.add_argument("--runs", type=int, default=4,
                        help="runs of each resident query (first cold, rest "
                        "warm)")
    parser.add_argument("--seed", type=int, default=7,
                        help="seed of the out-of-core phase's fault plan")
    parser.add_argument("--profile", type=Path, default=None,
                        help="directory for a torch.profiler table of one "
                        "more warm run of each query, resident and streamed "
                        "(its launches are not counted in launches_per_run)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_INFO['dir']})", flush=True)
    for src, log in sorted(_build.BUILD_INFO.get("logs", {}).items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    cases = (kernel_edge_cases(dev) + packed_edge_cases(dev)
             + topk_edge_cases(dev))
    print(f"kernel checks: {cases} edge cases agree with the plain versions",
          flush=True)

    _build.capture(True)
    _build.reset_launches()
    per_query, shared = query_phase(args.sf, dev, args.runs, args.profile)
    resident = dict(_build.LAUNCHES)
    missing = [k for k in RESIDENT_KERNELS if resident[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the resident path: "
                             f"{missing}")
    h2d_gbps = pinned_h2d_gbps(dev)
    print(f"pinned H2D: {h2d_gbps:.2f} GB/s (one 1 GiB copy, median of 5)",
          flush=True)
    _build.reset_launches()
    ooc = outofcore_phase(dev, shared, h2d_gbps, args.seed, args.profile)
    streamed = dict(_build.LAUNCHES)
    missing = [k for k in PACKED_KERNELS if streamed[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the out-of-core "
                             f"path: {missing}")
    _build.reset_launches()
    ranked = ordering_phase(dev, shared, args.runs, args.profile)
    ordering = dict(_build.LAUNCHES)
    missing = [k for k in ORDER_KERNELS if ordering[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ordering path: "
                             f"{missing}")
    print(json.dumps({"launches": {"resident": resident,
                                   "out_of_core": streamed,
                                   "ordering": ordering}}), flush=True)
    launches = {k: resident[k] + streamed[k] + ordering[k]
                for k in _build.KERNELS}
    # the inputs the main path gave each kernel; no capture while timing
    largest = dict(_build.LARGEST)
    _build.capture(False)
    rows = kernel_timing(launches, largest)
    print(json.dumps({"card": card, "queries": {
        k: {"warm_median_ms": v["warm_median_ms"], "ingest_s": v["ingest_s"]}
        for k, v in per_query.items()}, "out_of_core": {
        k: {"warm_ms_depth0": v["warm_ms_depth0"],
            "warm_ms_depth2": v["warm_ms_depth2"],
            "h2d_bound_ms_packed": v["h2d_bound_ms_packed"],
            "bytes_moved_packed": v["bytes_moved_packed"],
            "bytes_moved_unpacked": v["bytes_moved_unpacked"]}
        for k, v in ooc.items()}, "ordering": {
        k: {"path": v["path"], "warm_median_ms": v["warm_median_ms"],
            "warm_ms_depth0": v["warm_ms_depth0"],
            "warm_ms_depth2": v["warm_ms_depth2"],
            "visited": v["visited"], "ranked_pruned": v["ranked_pruned"]}
        for k, v in ranked.items()}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
