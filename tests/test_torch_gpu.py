"""The port's CUDA kernels and its query path on the card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips elsewhere (inside the ``cuda_device`` fixture, never at import).
The module imports no JAX, so the card's machine runs it alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (integer outputs and rle_decode exactly; segment_sum within the
reference tests' rtol 1e-4 of a float64 host sum and bit-identical
across launches; the three packed kernels exactly, on every bit width),
topk exactly, values and indices, bit-identical across launches and over
several survivor passes), the stable argsorts of the ordering layer on
CUDA against the CPU's and a numpy oracle (NaN last, ties in row order),
the TPC-H-shaped queries and the ranked queries of ``chip_smoke.py`` are
held against the same queries on CPU tensors and the numpy oracle, and
the streamed partitioned path (pinned partitions, copy stream, events)
against its CPU run.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import compress
from repro_torch.core.table import Table
from repro_torch.kernels import _build, ref
from repro_torch.kernels import bucketize as kb
from repro_torch.kernels.rle_decode import rle_decode_kernel
from repro_torch.kernels.segment_reduce import segment_sum_kernel
from repro_torch.kernels import unpack as ku

from torch_twins import (BUCKETIZE_CASES, RLE_CASES, TOPK_CASES,  # noqa: F401
                         bucketize_cases, cuda_device, rle_case, topk_case)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", BUCKETIZE_CASES + ["beyond_smem"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gpu_bucketize_kernels_match_plain(cuda_device, rng, case, dtype):
    if case == "beyond_smem":
        b = np.sort(rng.integers(0, 10**8, kb.MAX_SMEM_BOUNDARIES + 5))
        q = rng.integers(0, 10**8, 100_003)
    else:
        b, q = bucketize_cases(rng)[case]
    bb, qq = _t(b.astype(dtype), cuda_device), _t(q.astype(dtype), cuda_device)
    for right in (True, False):
        want = ref.ref_bucketize(bb, qq, right)
        if bb.shape[0] <= kb.MAX_SMEM_BOUNDARIES:
            assert torch.equal(kb.bucketize_kernel(bb, qq, right), want)
        assert torch.equal(kb.bucketize_count_kernel(bb, qq, right), want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RLE_CASES)
@pytest.mark.parametrize("as_float", [False, True])
def test_gpu_rle_decode_kernel_matches_plain(cuda_device, case, as_float):
    vals, starts, ends, n, nrows, fill = rle_case(case)
    if as_float:
        vals = vals.astype(np.float32)
    args = [_t(a, cuda_device) for a in (vals, starts, ends)]
    nt = torch.tensor(n, dtype=torch.int32, device=cuda_device)
    got = rle_decode_kernel(*args, nt, nrows, fill)
    assert torch.equal(got, ref.ref_rle_decode(*args, nt, nrows, fill))


@pytest.mark.gpu
@pytest.mark.parametrize("n,s", [(1025, 1), (2048, 8), (300_000, 16),
                                 (200_001, 4096)])
def test_gpu_segment_sum_kernel_deterministic_and_close(cuda_device, rng, n, s):
    v = rng.random(n).astype(np.float32)
    ids = rng.integers(-1, s + 1, n).astype(np.int32)  # ids -1 and s drop
    vt, it = _t(v, cuda_device), _t(ids, cuda_device)
    got = segment_sum_kernel(vt, it, s)
    assert torch.equal(got, segment_sum_kernel(vt, it, s))
    keep = (ids >= 0) & (ids < s)
    exact = np.zeros(s, np.float64)
    np.add.at(exact, ids[keep], v[keep].astype(np.float64))
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gpu_wrappers_reject_mixed_devices(cuda_device):
    b = torch.arange(10, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kb.bucketize_kernel(b, torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        segment_sum_kernel(torch.ones(4, device=cuda_device),
                           torch.zeros(4, dtype=torch.int32), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Q1", "Q3", "Q6", "Q17", "Q19"])
def test_gpu_query_matches_cpu_and_oracle(cuda_device, name):
    """The query on CUDA tensors (kernel route) gives the CPU route's
    answer and the oracle's, bit-identically across runs, and launches
    kernels."""
    n = 200_000
    rng = np.random.default_rng(2)
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    orders = chip_smoke.make_orders(rng, n // 4)
    data = chip_smoke.make_lineitem(rng, n, order=chip_smoke.SORT_ORDERS[name])
    cfg = compress.CompressionConfig(plain_threshold=1_000)
    results = {}
    for dev in ("cpu", cuda_device):
        t = Table.from_arrays(data, cfg=cfg, device=dev)
        ot = Table.from_arrays(orders, cfg=cfg, device=dev)
        q = chip_smoke.build_query(name, t, ot, part_keys)
        before = sum(_build.LAUNCHES.values())
        results[str(dev)] = [chip_smoke.host_result(q.run()) for _ in range(2)]
        launched = sum(_build.LAUNCHES.values()) - before
        assert (launched > 0) == (dev != "cpu")
    cpu, gpu = results["cpu"][0], results[str(cuda_device)][0]
    assert chip_smoke._bits(gpu) == chip_smoke._bits(results[str(cuda_device)][1])
    want = chip_smoke.oracle(name, data, orders=orders, part_keys=part_keys)
    chip_smoke.check_answer(name, gpu, want)
    chip_smoke.check_answer(name, cpu, want)
    if "keys" in gpu:
        assert gpu["num_groups"] == cpu["num_groups"]
        for k in gpu["keys"]:
            np.testing.assert_array_equal(gpu["keys"][k], cpu["keys"][k])
        pairs = [(gpu["aggs"][k], cpu["aggs"][k]) for k in gpu["aggs"]]
    else:
        pairs = [(gpu[k], cpu[k]) for k in gpu]
    for g, c in pairs:
        assert g.dtype == c.dtype
        if np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, c)
        else:
            np.testing.assert_allclose(g, c, rtol=1e-4)


def _packed(rng, b, n, lo):
    hi = lo + (1 << b) - 1 if b < 32 else 2**31 - 1
    lo = lo if b < 32 else -(2**31)
    v = rng.integers(lo, hi, n, endpoint=True).astype(np.int64)
    return v, compress.pack_array(v, lo, b).view(np.int32), lo


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32])
@pytest.mark.parametrize("n", [0, 1, 33, 100_003])
def test_gpu_unpack_kernel_matches_plain(cuda_device, rng, b, n):
    v, w, lo = _packed(rng, b, n, -(1 << (b - 1)) if b < 32 else 0)
    ww = _t(w, cuda_device)
    got = ku.unpack_kernel(ww, b, lo, n)
    assert torch.equal(got, ref.ref_unpack(ww, b, lo, n))
    np.testing.assert_array_equal(got.cpu().numpy(), v.astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 9, 21, 32])
@pytest.mark.parametrize("nb", [1, 32, ku.MAX_SMEM_BOUNDARIES + 7])
def test_gpu_bucketize_packed_kernel_matches_plain(cuda_device, rng, b, nb):
    v, w, lo = _packed(rng, b, 50_001, -5)
    bnd = np.sort(rng.integers(int(v.min()) - 2, int(v.max()) + 2, nb))
    if nb == 32:  # sentinel-padded boundaries
        bnd[-8:] = np.iinfo(np.int32).max
    bb, ww = _t(np.sort(bnd).astype(np.int32), cuda_device), _t(w, cuda_device)
    for right in (True, False):
        want = ref.ref_bucketize_packed(bb, ww, b, lo, v.size, right)
        got = ku.bucketize_packed_kernel(bb, ww, b, lo, v.size, right)
        assert torch.equal(got, want)
        if nb <= ku.MAX_SMEM_BOUNDARIES:
            assert torch.equal(ku.bucketize_packed_kernel(
                bb, ww, b, lo, v.size, right, global_route=True), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_valid,fill", [(300, 0), (150, -3), (0, 9)])
def test_gpu_rle_decode_packed_kernel_matches_plain(cuda_device, rng, n_valid,
                                                    fill):
    nrows, cap = 100_000, 512
    starts = np.sort(rng.choice(nrows - 5, 300, replace=False)).astype(np.int32)
    ends = np.concatenate([starts[1:] - 2, [nrows - 7]]).astype(np.int32)
    pad = cap - 300
    starts = np.concatenate([starts, np.full(pad, nrows)]).astype(np.int32)
    ends = np.concatenate([ends, np.full(pad, nrows)]).astype(np.int32)
    v, w, lo = _packed(rng, 13, cap, -100)
    ww, ss, ee = (_t(a, cuda_device) for a in (w, starts, ends))
    nn = torch.tensor(n_valid, dtype=torch.int32, device=cuda_device)
    got = ku.rle_decode_packed_kernel(ww, 13, lo, cap, ss, ee, nn, nrows, fill)
    want = ref.ref_rle_decode_packed(ww, 13, lo, cap, ss, ee, nn, nrows, fill)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Q1", "Q6", "Q17", "Q3"])
def test_gpu_streamed_partitions_match_cpu(cuda_device, name):
    """Packed partitions pinned in host memory, copied on the copy stream
    and folded after events: the card's answer equals the CPU run's, is
    bit-identical at depth 0/1/2, and launches the packed kernels."""
    from repro_torch.core.partition import PartitionedQuery, PartitionedTable
    from repro_torch.kernels import dispatch
    n = 300_000
    rng = np.random.default_rng(2)
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    orders = chip_smoke.make_orders(rng, n // 4)
    data = chip_smoke.make_lineitem(rng, n, order=chip_smoke.SORT_ORDERS[name])
    cfg = compress.CompressionConfig(plain_threshold=1_000)
    runs = {}
    for dev in ("cpu", cuda_device):
        pt = PartitionedTable.from_arrays(data, cfg=cfg, partition_rows=1 << 16,
                                          pack=True, device=dev)
        ot = Table.from_arrays(orders, cfg=cfg, device=dev)
        for depth in (0, 1, 2):
            with dispatch.overrides(prefetch_depth=depth):
                q = chip_smoke.build_query(name, pt, ot, part_keys,
                                           query_cls=PartitionedQuery)
                runs[(str(dev), depth)] = chip_smoke.host_result(q.run())
    gpu = runs[(str(cuda_device), 0)]
    for depth in (1, 2):
        assert chip_smoke._bits(runs[(str(cuda_device), depth)]) == \
            chip_smoke._bits(gpu)
    chip_smoke.check_answer(name, gpu, chip_smoke.oracle(
        name, data, orders=orders, part_keys=part_keys))
    chip_smoke.check_same(name, gpu, runs[("cpu", 0)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES)
def test_gpu_topk_kernel_matches_plain(cuda_device, case):
    """topk_kernel equals ref.topk on the card and on the CPU, values and
    indices, at every k of chip_smoke.py's list; two launches give the
    same bits."""
    from repro_torch.kernels import topk as kt
    x, _ = topk_case(case)
    xx = _t(x, cuda_device)
    for k in (1, 8, 37, 128, 256):
        got, again = kt.topk_kernel(xx, k), kt.topk_kernel(xx, k)
        want = ref.topk(xx, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].dtype == torch.int32 and got[0].shape == (k,)
        assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
        assert torch.equal(got[1], again[1])
        cv, ci = ref.topk(torch.from_numpy(np.ascontiguousarray(x)), k)
        assert torch.equal(got[0].cpu(), cv) and torch.equal(got[1].cpu(), ci)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1_000_003, 100), (3_000_000, 256)])
def test_gpu_topk_kernel_multi_pass(cuda_device, n, k):
    """Inputs of a range pass over many blocks and a survivor pass: one
    launch a pass, and the stable sort's answer."""
    from repro_torch.kernels import topk as kt
    rng = np.random.default_rng(n)
    x = rng.integers(-100, 100, n).astype(np.int32)
    x[rng.random(n) < 0.2] = np.iinfo(np.int32).min
    xx = _t(x, cuda_device)
    before = _build.LAUNCHES["topk_kernel"]
    v, i = kt.topk_kernel(xx, k)
    assert _build.LAUNCHES["topk_kernel"] - before == kt.passes(n, k) >= 2
    wv, wi = ref.topk(xx, k)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    order = np.lexsort((np.arange(n), -x.astype(np.int64)))[:k]
    np.testing.assert_array_equal(i.cpu().numpy(), order)


def _topk_stress(pattern, n):
    ramp = np.arange(n, dtype=np.int64) - n // 2
    if pattern == "ascending":
        return ramp.astype(np.int32)
    if pattern == "descending":
        return (-ramp).astype(np.float32)
    # equal values in runs of 50,000, so ties straddle the block ranges
    return (ramp // 50_000).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["ascending", "descending", "ties"])
def test_gpu_topk_kernel_threshold_stress(cuda_device, pattern):
    """3M keys in ascending order (every key beats the running threshold),
    descending (none does after the first step) and in tied runs across
    the block ranges: the stable sort's answer, bit-identical twice."""
    from repro_torch.kernels import topk as kt
    n = 3_000_000
    x = _topk_stress(pattern, n)
    xx = _t(x, cuda_device)
    for k in (8, 100, 256):
        got, again = kt.topk_kernel(xx, k), kt.topk_kernel(xx, k)
        want = ref.topk(xx, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
        assert torch.equal(got[1], again[1])
        order = np.lexsort((np.arange(n), -x.astype(np.float64)))[:k]
        np.testing.assert_array_equal(got[1].cpu().numpy(), order)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gpu_topk_kernel_grid_independent(cuda_device, dtype):
    """The answer does not depend on the range pass's grid (three caps
    against the card's own) nor on a misaligned start (views at offsets
    1-3, a scalar head before the 16-byte loads)."""
    from repro_torch.kernels import topk as kt
    rng = np.random.default_rng(5)
    x = rng.integers(-500, 500, 2_000_003).astype(dtype)
    xx = _t(x, cuda_device)
    want = ref.topk(xx, 128)
    for cap in (None, 2, 7, 61):
        got = kt.topk_kernel(xx, 128, max_blocks=cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for off in (1, 2, 3):
        view = xx[off:]
        got = kt.topk_kernel(view, 37)
        w = ref.topk(view, 37)
        assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 550, 58_112])
@pytest.mark.parametrize("nq", [1, 3, 5, 1_406_900])
def test_gpu_bucketize_kernel_views_and_sizes(cuda_device, nb, nq):
    """bucketize_kernel on the 16-byte route (aligned queries, ragged ends
    when nq % 4 != 0) and the scalar route (a query view at storage offset
    1), from one boundary to the shared-memory limit (the persistent grid
    and the opt-in above 48 KB), both dtypes, right and left."""
    rng = np.random.default_rng(nb + nq)
    for dtype in (np.int32, np.float32):
        b = np.sort(rng.integers(-10**6, 10**6, nb)).astype(dtype)
        q = rng.integers(-10**6 - 5, 10**6 + 5, nq + 1).astype(dtype)
        bb = _t(b, cuda_device)
        qall = _t(q, cuda_device)
        for off in (0, 1):
            qq = qall[off:off + nq]
            assert qq.is_contiguous() and qq.storage_offset() == off
            for right in (True, False):
                want = ref.ref_bucketize(bb, qq, right)
                assert torch.equal(kb.bucketize_kernel(bb, qq, right), want)
                np.testing.assert_array_equal(
                    want.cpu().numpy(),
                    np.searchsorted(b, q[off:off + nq],
                                    side="right" if right else "left"))


@pytest.mark.gpu
def test_gpu_bucketize_plan_and_launch_paths(cuda_device):
    """The shared-memory route under each of ``launch_plan``'s plans
    (16-byte or scalar loads, one tile a block or a persistent grid on
    either side of ``TILE`` boundaries) gives the plain counts, and every
    call of either route books one launch."""
    rng = np.random.default_rng(8)
    base = _t(rng.integers(-5, 1005, 100_008).astype(np.int32), cuda_device)
    for nb in (kb.TILE, kb.TILE + 1):
        b = _t(np.sort(rng.integers(0, 1000, nb)).astype(np.int32), cuda_device)
        for off in (0, 1, 2, 4):
            q = base[off:off + 100_003]
            out = torch.empty_like(q)
            plan = kb.launch_plan(nb, q.data_ptr(), out.data_ptr())
            assert bool(plan & kb.VECTORIZED) == (off % 4 == 0)
            assert bool(plan & kb.PERSISTENT) == (nb > kb.TILE)
            for right, name, fn in (
                    (True, "bucketize_kernel", kb.bucketize_kernel),
                    (False, "bucketize_count_kernel",
                     kb.bucketize_count_kernel)):
                before = _build.LAUNCHES[name]
                got = fn(b, q, right)
                assert _build.LAUNCHES[name] - before == 1
                assert torch.equal(got, ref.ref_bucketize(b, q, right))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [50, 100_000])
def test_gpu_stable_argsort_nan_last(cuda_device, n):
    """The ordering layer's stable argsorts on CUDA (small and large
    inputs take different sorts there) give the CPU's permutation and a
    numpy oracle's: NaN last in both directions, -0.0 tying +0.0, ties in
    ascending row order; the dense rank keys agree bit for bit."""
    from repro_torch.core import order
    rng = np.random.default_rng(n)
    f = rng.choice([1.5, -2.0, 0.0, -0.0, np.inf, -np.inf, np.nan, 3.0],
                   n).astype(np.float32)
    i = rng.integers(0, 5, n).astype(np.int32)
    live = rng.random(n) < 0.9
    rows = np.arange(n)
    for vals in (f, i):
        for desc in (False, True):
            perms = [order._argsort_key_nan_last(
                torch.arange(n, device=dev), _t(vals, dev), desc).cpu().numpy()
                for dev in ("cpu", cuda_device)]
            key = vals.astype(np.float64) + 0.0
            key = np.where(np.isnan(key), 0.0, -key if desc else key)
            want = np.lexsort((rows, key, np.isnan(vals.astype(np.float64))))
            np.testing.assert_array_equal(perms[0], want)
            np.testing.assert_array_equal(perms[1], want)
            keys = [order.dense_rank_key(_t(vals, dev), _t(live, dev),
                                         desc).cpu()
                    for dev in ("cpu", cuda_device)]
            assert torch.equal(keys[0], keys[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["R1", "R2", "Q3r"])
def test_gpu_ranked_queries_match_cpu_and_oracle(cuda_device, name):
    """chip_smoke.py's ranked queries on CUDA tensors give the CPU route's
    answer and the oracle's, resident and streamed over packed pinned
    partitions at depth 0/1/2; R1 launches topk_kernel."""
    from repro_torch.core.partition import PartitionedQuery, PartitionedTable
    from repro_torch.kernels import dispatch
    n = 200_000
    rng = np.random.default_rng(2)
    orders = chip_smoke.make_orders(rng, n // 4)
    src = chip_smoke.RANKED_SOURCE[name]
    data = chip_smoke.make_lineitem(rng, n, order=chip_smoke.SORT_ORDERS[src])
    cfg = compress.CompressionConfig(plain_threshold=1_000)
    want = chip_smoke.ranked_oracle(
        name, data, chip_smoke.oracle("Q3", data, orders=orders)
        if name == "Q3r" else None)
    runs = {}
    for dev in ("cpu", cuda_device):
        t = Table.from_arrays(data, cfg=cfg, device=dev)
        ot = Table.from_arrays(orders, cfg=cfg, device=dev)
        before = _build.LAUNCHES["topk_kernel"]
        runs[(str(dev), "resident")] = [chip_smoke.host_result(
            chip_smoke.build_ranked(name, t, ot).run()) for _ in range(2)]
        launched = _build.LAUNCHES["topk_kernel"] - before
        assert (launched > 0) == (dev != "cpu" and name == "R1")
        pt = PartitionedTable.from_arrays(data, cfg=cfg, partition_rows=1 << 16,
                                          pack=True, device=dev)
        for depth in (0, 1, 2):
            with dispatch.overrides(prefetch_depth=depth):
                q = chip_smoke.build_ranked(name, pt, ot,
                                            query_cls=PartitionedQuery)
                runs[(str(dev), depth)] = chip_smoke.host_result(q.run())
    gpu = runs[(str(cuda_device), "resident")]
    assert chip_smoke._bits(gpu[0]) == chip_smoke._bits(gpu[1])
    chip_smoke.check_ranked(name, gpu[0], want)
    chip_smoke.check_ranked(name, runs[("cpu", "resident")][0], want)
    streamed = runs[(str(cuda_device), 0)]
    chip_smoke.check_ranked(name, streamed, want)
    for depth in (1, 2):
        assert chip_smoke._bits(runs[(str(cuda_device), depth)]) == \
            chip_smoke._bits(streamed)
    if name != "Q3r":
        assert chip_smoke._bits(streamed) == chip_smoke._bits(gpu[0])
        assert chip_smoke._bits(runs[("cpu", 0)]) == chip_smoke._bits(gpu[0])
