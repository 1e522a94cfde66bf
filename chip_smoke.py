#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # TPC-H scale factor 10, ~60M LINEITEM rows
    python3 chip_smoke.py --sf 0.01  # a quick rehearsal at a small scale

What it does, in order, failing (non-zero exit, no result line) on the
first error:

1. Prints the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the time to build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (nvcc, at first use).
2. Kernel checks: each of the four kernels against its plain PyTorch
   version on the card, on edge cases (empty inputs, ragged tails,
   duplicates, right=True/False, int32/float32, sentinel-padded
   boundaries, gaps with a non-zero fill, out-of-range ids). Integer
   outputs and rle_decode must be equal; segment_sum must be within
   rtol=1e-4 of a float64 host sum and bit-identical across two launches.
3. Query phase: TPC-H-shaped LINEITEM (each query sorted by its Table 7
   order) and ORDERS at the chosen scale, seed 2, ingested with
   ``CompressionConfig(plain_threshold=1_000)`` onto the card; Q1, Q3, Q6,
   Q17 and Q19 run through ``repro_torch`` ``Query``. Every answer is
   checked against a numpy oracle (integers exact, float sums rtol=1e-4)
   and every query runs twice with bit-identical results. Kernel launch
   counts are zeroed just before this phase and read just after it; the
   run fails if any of the four kernels was not launched.
4. Kernel timing at the largest inputs the query phase gave each kernel:
   kernel, plain-version and (where one PyTorch call computes the same
   function) library times by CUDA events, median of 10 after warm-up,
   beside the least time the card could take (bytes over 3.35 TB/s, or
   operations over 67 TFLOP/s, whichever is larger).
5. A ``{"kernels": [...]}`` summary line, then as the last line
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
}

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


def make_lineitem(rng, n, order=None):
    """LINEITEM-like columns, globally sorted by ``order`` (paper §9.1.1)."""
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
        perm = np.lexsort(tuple(cols[c] for c in reversed(order)))
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


def build_query(name, table, orders_table=None, part_keys=None):
    from repro_torch.core import arithmetic
    from repro_torch.core.plan import Query, col

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
    from repro_torch.device import to_numpy
    if isinstance(res, dict):
        return {k: to_numpy(v) for k, v in res.items()}
    ng = int(res.num_groups)
    return {"num_groups": ng,
            "keys": {k: to_numpy(v)[:ng] for k, v in res.keys.items()},
            "aggs": {k: to_numpy(v)[:ng] for k, v in res.aggs.items()}}


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


# ---------------------------------------------------------------------------
# Phase 4: the four kernels at the query phase's largest inputs
# ---------------------------------------------------------------------------


def kernel_timing(launches):
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bucketize as kb
    from repro_torch.kernels.rle_decode import rle_decode_kernel
    from repro_torch.kernels.segment_reduce import segment_sum_kernel

    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = _build.LARGEST[name]
        if name.startswith("bucketize"):
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
                     "right": right}
            nbytes, nops = 4 * (nb + 2 * nq), nq * _steps(nb)
            k_ms = time_ms(lambda: kern(b, q, right))
            p_ms = time_ms(lambda: ref.ref_bucketize(b, q, right))
            lib_ms = time_ms(lambda: torch.searchsorted(b, q, right=right,
                                                        out_int32=True))
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
            k_ms = time_ms(lambda: rle_decode_kernel(v, s, e, n, nrows, fill))
            p_ms = time_ms(lambda: ref.ref_rle_decode(v, s, e, n, nrows, fill))
            lib_ms = None
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
            k_ms = time_ms(lambda: segment_sum_kernel(v, ids, g))
            p_ms = time_ms(lambda: ref.ref_segment_reduce(v, ids, g))
            lib_ms = None
            if bool(keep.all()):  # one index_add_ computes the same function
                lib_ms = time_ms(lambda: torch.zeros(g, device=v.device)
                                 .index_add_(0, ids, v))
        b_ms, b_by = bound_ms(nbytes, nops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(json.dumps({"kernel": name, "kernel_ms": k_ms, "plain_ms": p_ms,
                          "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "shape": shape,
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
    for name in ("Q1", "Q3", "Q6", "Q17", "Q19"):
        t0 = time.perf_counter()
        data = make_lineitem(rng, n, order=SORT_ORDERS[name])
        gen_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = Table.from_arrays(data, cfg=cfg, device=dev)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        want = oracle(name, data, orders=orders, part_keys=part_keys)
        plain_bytes = sum(v.shape[0] * 4 for v in data.values())
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
        del q, table
        torch.cuda.empty_cache()
    return per_query


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sf", type=float, default=10.0,
                        help="TPC-H scale factor of the query phase")
    parser.add_argument("--runs", type=int, default=4,
                        help="runs of each query (first cold, rest warm)")
    parser.add_argument("--profile", type=Path, default=None,
                        help="directory for a torch.profiler table of one "
                        "more warm run of each query (its launches are "
                        "not counted in launches_per_run)")
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

    cases = kernel_edge_cases(dev)
    print(f"kernel checks: {cases} edge cases agree with the plain versions",
          flush=True)

    _build.capture(True)
    _build.reset_launches()
    per_query = query_phase(args.sf, dev, args.runs, args.profile)
    launches = dict(_build.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    rows = kernel_timing(launches)
    _build.capture(False)
    print(json.dumps({"card": card, "queries": {
        k: {"warm_median_ms": v["warm_median_ms"], "ingest_s": v["ingest_s"]}
        for k, v in per_query.items()}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
