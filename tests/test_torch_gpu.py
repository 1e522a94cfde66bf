"""The port's CUDA kernels and its query path on the card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips elsewhere (inside the ``cuda_device`` fixture, never at import).
The module imports no JAX, so the card's machine runs it alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (integer outputs and rle_decode exactly; segment_sum within the
reference tests' rtol 1e-4 of a float64 host sum and bit-identical
across launches; the three packed kernels exactly, on every bit width, at grid caps and
from words views at storage offsets 1-3),
topk exactly, values and indices, bit-identical across launches and over
several survivor passes), the stable argsorts of the ordering layer on
CUDA against the CPU's and a numpy oracle (NaN last, ties in row order),
the TPC-H-shaped queries and the ranked queries of ``chip_smoke.py`` are
held against the same queries on CPU tensors and the numpy oracle, and
the streamed partitioned path (pinned partitions, copy stream, events)
against its CPU run, each smoke model (float32) against its CPU run on
the same weights, one float32 train step of three smoke archs against the
CPU, the training phase's data path against the CPU, and a training
checkpoint's round trip on the card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import configs as model_configs
from repro_torch.core import compress
from repro_torch.core.table import Table
from repro_torch.kernels import _build, ref
from repro_torch.kernels import bucketize as kb
from repro_torch.kernels.rle_decode import rle_decode_kernel
from repro_torch.kernels.segment_reduce import segment_sum_kernel
from repro_torch.kernels import unpack as ku

from torch_twins import (BUCKETIZE_CASES, RLE_CASES, RLE_DRAWS,  # noqa: F401
                         TOPK_CASES, bucketize_cases, cuda_device,
                         packed_values, rle_case, rle_draw, topk_case)


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
@pytest.mark.parametrize("name", RLE_DRAWS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gpu_rle_decode_draws_match_plain(cuda_device, name, dtype):
    """The tile walk's draws (one-run, window and L2-route tiles) equal
    the plain version bit for bit, at the resident grid and two caps."""
    vals, starts, ends, n, nrows, fill = rle_draw(
        name, np.random.default_rng(RLE_DRAWS.index(name)))
    if dtype == np.float32:
        vals = (vals * np.float32(0.37)).astype(np.float32)
        vals[::5] = -0.0
    args = [_t(a, cuda_device) for a in (vals, starts, ends)]
    nt = torch.tensor(n, dtype=torch.int32, device=cuda_device)
    want = ref.ref_rle_decode(*args, nt, nrows, fill).view(torch.int32)
    for grid in (None, 1, 3):
        got = rle_decode_kernel(*args, nt, nrows, fill, max_blocks=grid)
        assert torch.equal(got.view(torch.int32), want), grid


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_rle_decoders_short_runs_at_scale(cuda_device, packed):
    """About 2^21 runs of 1-4 rows with gaps over 2^23 rows (a window in
    every tile), at the resident grid and a cap of 7 blocks."""
    rng = np.random.default_rng(21)
    rows = 1 << 23
    starts, ends = chip_smoke.short_runs(rng, rows)
    cap = len(starts)
    ss, ee = (_t(a.astype(np.int32), cuda_device) for a in (starts, ends))
    nt = torch.tensor(cap - 3, dtype=torch.int32, device=cuda_device)
    if packed:
        _, w, off = packed_values(rng, 13, cap, -7)
        ww = _t(w, cuda_device)
        want = ref.ref_rle_decode_packed(ww, 13, off, cap, ss, ee, nt, rows, 5)
        run = lambda g: ku.rle_decode_packed_kernel(  # noqa: E731
            ww, 13, off, cap, ss, ee, nt, rows, 5, max_blocks=g)
    else:
        vv = _t(rng.integers(-99, 99, cap).astype(np.int32), cuda_device)
        want = ref.ref_rle_decode(vv, ss, ee, nt, rows, 5)
        run = lambda g: rle_decode_kernel(  # noqa: E731
            vv, ss, ee, nt, rows, 5, max_blocks=g)
    for grid in (None, 7):
        assert torch.equal(run(grid), want), grid


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


def _view_at(w, off, dev):
    """The lanes ``w`` as a view at storage offset ``off`` (4 * off bytes
    past a 16-byte boundary for off in 1..3)."""
    buf = np.concatenate([np.full(off, -1, np.int32), w])
    return _t(buf, dev)[off:]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 3, 7, 8, 9, 16, 21, 24, 31, 32])
@pytest.mark.parametrize("n", [0, 1, 33, 127, 128, 129, 2047, 2048, 2049,
                               100_003])
def test_gpu_unpack_kernel_matches_plain(cuda_device, rng, b, n):
    """Whole 128-value groups, the ragged last group and the scalar path of
    words views at offsets 1-3 equal the plain version, at the resident
    grid and capped ones."""
    v, w, lo = _packed(rng, b, n, -(1 << (b - 1)) if b < 32 else 0)
    ww = _t(w, cuda_device)
    want = ref.ref_unpack(ww, b, lo, n)
    got = ku.unpack_kernel(ww, b, lo, n)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), v.astype(np.int32))
    for grid in (1, 3):
        assert torch.equal(ku.unpack_kernel(ww, b, lo, n, max_blocks=grid),
                           want)
    for off in (1, 2, 3):
        view = _view_at(w, off, cuda_device)
        assert view.storage_offset() == off
        assert torch.equal(ku.unpack_kernel(view, b, lo, n), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", chip_smoke.UNPACK_CLASSES)
def test_gpu_unpack_kernel_launch_classes(cuda_device, rng, n):
    """Each launch class of the main path, 8 to 2^23 values at 24 bits,
    at grid caps that must give the same bits."""
    v, w, lo = _packed(rng, 24, n, -(1 << 23))
    ww = _t(w, cuda_device)
    want = ref.ref_unpack(ww, 24, lo, n)
    np.testing.assert_array_equal(want.cpu().numpy(), v.astype(np.int32))
    for grid in (None, 1, 7, 1000):
        assert torch.equal(ku.unpack_kernel(ww, 24, lo, n, max_blocks=grid),
                           want)


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
                bb, ww, b, lo, v.size, right, tiled=True), want)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 9, 21, 24, 32])
@pytest.mark.parametrize("pattern", chip_smoke.PACKED_PATTERNS)
def test_gpu_bucketize_packed_kernel_tile_bound(cuda_device, b, pattern):
    """The tiled route on the streamed semi-join's sorted, code-0 padded
    queries (tiles of padding only, one across n_valid), random,
    all-equal and above-every-boundary ones: equal to the plain version at
    grid caps and splitter counts that change no count, from words views
    at offsets 1-3, and on the shared-memory route at 4,064 boundaries."""
    rng = np.random.default_rng(b + 100 * len(pattern))
    bnd, v, w, lo = chip_smoke.packed_queries(rng, b, pattern, 300_001,
                                              97_533, n_valid=140_000)
    bb, ww, n = _t(bnd, cuda_device), _t(w, cuda_device), len(v)
    small = bb[::24].contiguous()
    for right in (True, False):
        want = ref.ref_bucketize_packed(bb, ww, b, lo, n, right)
        np.testing.assert_array_equal(
            want.cpu().numpy(), np.searchsorted(
                bnd, v.astype(np.int32), side="right" if right else "left"))
        for kw in ({}, {"max_blocks": 1}, {"max_blocks": 5},
                   {"max_splitters": 64}, {"max_splitters": 1 << 14}):
            assert torch.equal(ku.bucketize_packed_kernel(
                bb, ww, b, lo, n, right, **kw), want), kw
        for off in (1, 2, 3):
            assert torch.equal(ku.bucketize_packed_kernel(
                bb, _view_at(w, off, cuda_device), b, lo, n, right), want)
        want = ref.ref_bucketize_packed(small, ww, b, lo, n, right)
        for tiled in (False, True):
            assert torch.equal(ku.bucketize_packed_kernel(
                small, ww, b, lo, n, right, tiled=tiled), want)


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
@pytest.mark.parametrize("name", RLE_DRAWS)
@pytest.mark.parametrize("bits", [1, 4, 13, 32])
def test_gpu_rle_decode_packed_draws_match_plain(cuda_device, name, bits):
    """The packed decoder on the tile walk's draws equals the plain
    version exactly, at the resident grid and two caps."""
    rng = np.random.default_rng(100 + RLE_DRAWS.index(name))
    _, starts, ends, n, nrows, fill = rle_draw(name, rng)
    cap = len(starts)
    _, w, lo = packed_values(rng, bits, cap, -50)
    ww, ss, ee = (_t(a, cuda_device) for a in (w, starts, ends))
    nn = torch.tensor(n, dtype=torch.int32, device=cuda_device)
    want = ref.ref_rle_decode_packed(ww, bits, lo, cap, ss, ee, nn, nrows,
                                     fill)
    for grid in (None, 1, 3):
        got = ku.rle_decode_packed_kernel(ww, bits, lo, cap, ss, ee, nn, nrows,
                                          fill, max_blocks=grid)
        assert torch.equal(got, want), grid


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


# ---------------------------------------------------------------------------
# The redesigned segment_sum (float32 and int32) and bucketize_count kernels
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("g", chip_smoke.SEGSUM_GROUPS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("pattern", chip_smoke.SEGSUM_PATTERNS)
def test_gpu_segment_sum_kernel_cases(cuda_device, g, dtype, pattern):
    """int32 sums equal the plain version (wrapping ``index_add_``), and
    ``index_add_`` itself on in-range ids; float32 within rtol 1e-4 of a
    float64 sum; the bits equal across launches, grid caps (1, 3, 64
    blocks) and an offset view (scalar loads)."""
    rng = np.random.default_rng(g * 7 + len(pattern))
    v, ids = chip_smoke.segsum_case(rng, g, dtype, pattern, n=100_003)
    vt, it = _t(v, cuda_device), _t(ids, cuda_device)
    got = segment_sum_kernel(vt, it, g)
    runs = [segment_sum_kernel(vt, it, g)] + [
        segment_sum_kernel(vt, it, g, max_blocks=cap) for cap in (1, 3, 64)]
    vo = torch.zeros(len(v) + 1, dtype=vt.dtype, device=cuda_device)
    io = torch.zeros(len(v) + 1, dtype=it.dtype, device=cuda_device)
    vo[1:], io[1:] = vt, it
    runs.append(segment_sum_kernel(vo[1:], io[1:], g))
    for r in runs:
        assert torch.equal(got.view(torch.int32), r.view(torch.int32))
    if dtype == np.int32:
        assert torch.equal(got, ref.ref_segment_reduce(vt, it, g))
        if pattern == "in_range":
            assert torch.equal(got, torch.zeros(
                g, dtype=torch.int32, device=cuda_device).index_add_(0, it, vt))
    else:
        keep = (ids >= 0) & (ids < g)
        exact = np.zeros(g, np.float64)
        np.add.at(exact, ids[keep], v[keep].astype(np.float64))
        np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-4,
                                   atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 2, 16, 33, 512])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gpu_segment_sum_kernel_equals_its_emulated_order(cuda_device, g,
                                                          dtype):
    """The kernel's bits are those of ``segment_sum_emulated``, the numpy
    repeat of its fixed order: the order depends on N and G only."""
    from torch_twins import segment_sum_emulated
    rng = np.random.default_rng(40 + g)
    v, ids = chip_smoke.segsum_case(rng, g, dtype, "ragged")
    got = segment_sum_kernel(_t(v, cuda_device), _t(ids, cuda_device), g)
    want = segment_sum_emulated(v, ids, g)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("nb", chip_smoke.COUNT_NB)
@pytest.mark.parametrize("pattern,dtype", [
    (p, d) for p in chip_smoke.COUNT_PATTERNS for d in (np.int32, np.float32)
    if not (p == "nan" and d == np.int32)])  # NaN queries are float32
def test_gpu_bucketize_count_kernel_cases(cuda_device, nb, pattern, dtype):
    """The tiled route equals ``ref_bucketize`` on every query pattern at
    each boundary count, aligned and from a view at offset 1."""
    rng = np.random.default_rng(nb % 1000 + len(pattern))
    b = np.sort(rng.integers(0, 4 * nb, nb)).astype(dtype)
    q = chip_smoke.count_kernel_queries(rng, b, pattern, 200_003)
    bb, qq = _t(b, cuda_device), _t(q, cuda_device)
    for off in (0, 1):
        for right in (True, False):
            assert torch.equal(kb.bucketize_count_kernel(bb, qq[off:], right),
                               ref.ref_bucketize(bb, qq[off:], right))


@pytest.mark.gpu
def test_gpu_bucketize_count_kernel_window_edge_and_grid(cuda_device):
    """Tiles whose counts span exactly the window, one more and one less;
    and a sorted and a random probe at 2^23 boundaries under grid caps and
    splitter counts (16 KiB, 64 entries, and 64 KiB, which opts in above
    48 KiB of shared memory) that change no count."""
    b, q = chip_smoke.count_window_edge(kb.WINDOW, kb.COUNT_TILE)
    for dtype in (np.int32, np.float32):
        bb, qq = _t(b.astype(dtype), cuda_device), _t(q.astype(dtype),
                                                       cuda_device)
        for right in (True, False):
            assert torch.equal(kb.bucketize_count_kernel(bb, qq, right),
                               ref.ref_bucketize(bb, qq, right))
    rng = np.random.default_rng(9)
    bb = _t(np.sort(rng.integers(0, 1 << 26, 1 << 23)).astype(np.int32),
            cuda_device)
    for pattern in ("sorted", "random"):
        q = chip_smoke.count_kernel_queries(rng, bb.cpu().numpy(), pattern,
                                            1_000_003)
        qq = _t(q, cuda_device)
        want = ref.ref_bucketize(bb, qq)
        for kw in ({}, {"max_blocks": 1}, {"max_blocks": 5},
                   {"max_splitters": 64}, {"max_splitters": 1 << 14}):
            assert torch.equal(kb.bucketize_count_kernel(bb, qq, **kw), want)


# ---------------------------------------------------------------------------
# The query server (core/serve.py) on the card
# ---------------------------------------------------------------------------


def _served_table(dev, n=300_000, parts_rows=1 << 16):
    """The serving mix's inputs at a small size: a Q1-ordered packed
    LINEITEM on ``dev`` (pinned host partitions), ORDERS, part keys."""
    from repro_torch.core.partition import PartitionedTable
    rng = np.random.default_rng(2)
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    orders = chip_smoke.make_orders(rng, n // 4)
    data = chip_smoke.make_lineitem(rng, n, order=chip_smoke.SORT_ORDERS["Q1"])
    cfg = compress.CompressionConfig(plain_threshold=1_000)
    pt = PartitionedTable.from_arrays(data, cfg=cfg, partition_rows=parts_rows,
                                      pack=True, device=dev)
    ot = Table.from_arrays(orders, cfg=cfg, device=dev)
    return pt, ot, part_keys


def _serve_threads(srv, make, plan):
    """Submit each list of ``plan`` from its own thread; the answers as
    (name, host result), in completion order."""
    import threading
    done, errors = [], []

    def client(names):
        try:
            tickets = [(n, srv.submit(make(n))) for n in names]
            for n, t in tickets:
                done.append((n, chip_smoke.host_result(
                    srv.result(t, timeout=300))))
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(p,)) for p in plan]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return done


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 2])
def test_gpu_server_threads_bit_identical_to_solo(cuda_device, depth):
    """32 submissions of the serving mix from 4 threads: every answer is
    bit-identical to the query's solo run, and kernels are launched."""
    from repro_torch.core.serve import QueryServer
    from repro_torch.kernels import dispatch
    pt, ot, keys = _served_table(cuda_device)

    def make(name):
        return chip_smoke.build_served(name, pt, ot, keys)

    mix = chip_smoke.SERVE_MIX
    with dispatch.overrides(prefetch_depth=depth):
        solo = {n: chip_smoke.host_result(make(n).run()) for n in mix}
        plan = [[mix[(t + i) % len(mix)] for i in range(8)] for t in range(4)]
        before = sum(_build.LAUNCHES.values())
        with QueryServer(pt, max_batch=8) as srv:
            done = _serve_threads(srv, make, plan)
            stats = srv.stats()
    assert sum(_build.LAUNCHES.values()) > before
    assert len(done) == 32 and stats["completed"] == 32
    assert stats["errors"] == 0
    for n, got in done:
        assert chip_smoke._bits(got) == chip_smoke._bits(solo[n]), n


@pytest.mark.gpu
def test_gpu_server_evicting_budget_stays_exact(cuda_device):
    """A budget of one partition (plus the CUDA graphs' input slot, which
    the budget includes): every fetch evicts the tree a program may still
    be reading (the ring runs ahead), and the answers stay bit-identical
    to solo runs."""
    from repro_torch.core.graphs import ProgramGraphs
    from repro_torch.core.serve import QueryServer
    from repro_torch.kernels import dispatch
    pt, ot, keys = _served_table(cuda_device)

    def make(name):
        return chip_smoke.build_served(name, pt, ot, keys)

    mix = chip_smoke.SERVE_MIX
    part = pt.max_partition_nbytes()
    slot = ProgramGraphs(pt, cuda_device).slot_nbytes
    with dispatch.overrides(prefetch_depth=2):
        solo = {n: chip_smoke.host_result(make(n).run()) for n in mix}
        with pytest.warns(UserWarning):  # the ring's depth clamp
            with QueryServer(pt, budget_bytes=part + slot,
                             max_batch=8) as srv:
                assert srv.lru.budget_bytes == part
                done = _serve_threads(srv, make, [list(mix), list(mix)])
                evictions = srv.lru.evictions
                resident = srv.lru.resident_bytes
    assert evictions > 0 and resident <= part
    for n, got in done:
        assert chip_smoke._bits(got) == chip_smoke._bits(solo[n]), n


@pytest.mark.gpu
def test_gpu_shared_scan_folds_after_each_d2h_event(cuda_device,
                                                    monkeypatch):
    """8 subscribers over 8 partitions in one shared pass, three passes
    (so the programs run eagerly, are captured and are replayed as CUDA
    graphs), each program held back on the device (a sleep kernel before
    it), so every partial's device-to-host copy lands late: the fold must
    still read each partial's final values (the pass waits on the event
    after the last copy), giving the solo runs' answers bit for bit."""
    from repro_torch.core import serve
    from repro_torch.core.partition import PartitionedQuery
    from repro_torch.core.plan import col
    from repro_torch.kernels import dispatch
    pt, _, _ = _served_table(cuda_device, n=8 << 16)
    assert len(pt.partitions) == 8
    cuts = [300 * (i + 1) for i in range(8)]

    def make(cut):
        return (PartitionedQuery(pt).filter(col("shipdate") <= cut)
                .aggregate({"s": ("sum", "price"), "q": ("sum", "quantity"),
                            "c": ("count", None)}))

    solo = {c: chip_smoke.host_result(make(c).run()) for c in cuts}
    real = serve.base_masked_program

    def slowed(inner):
        program = real(inner)

        def late(*args):
            torch.cuda._sleep(20_000_000)  # about 10 ms on the device
            return program(*args)

        return late

    monkeypatch.setattr(serve, "base_masked_program", slowed)
    for depth in (0, 2):
        with dispatch.overrides(prefetch_depth=depth):
            srv = serve.QueryServer(pt, start=False, max_batch=8)
            try:
                # eager, then captures, then replays: a replayed program's
                # partial leaves the graph's buffers just as late
                for rnd in range(3):
                    tickets = {c: srv.submit(make(c)) for c in cuts}
                    assert srv.step() == 8
                    assert srv.stats()["scans"]["passes"] == rnd + 1
                    for c, t in tickets.items():
                        got = chip_smoke.host_result(srv.result(t, timeout=0))
                        assert (chip_smoke._bits(got)
                                == chip_smoke._bits(solo[c])), (rnd, c)
                g = srv.stats()["graphs"]
                assert g["fallbacks"] == 0, srv.graphs.last_error
                assert g["replays"] >= g["captures"] > 0
            finally:
                srv.close()


# ---------------------------------------------------------------------------
# The served program as a CUDA graph (core/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_SHAPES = ("Q1", "Q1s", "Q6", "Q19")


def _graph_tables(dev, scale=0.01, part_rows=1 << 13):
    """The benchmark's served cell at a small size on ``dev``: LINEITEM
    as packed pinned partitions (eight, the last one shorter: two
    layouts), PART resident; and the cell's four query shapes."""
    import json
    from pathlib import Path
    from perfbench import generate, harness
    from repro_torch.core.partition import PartitionedTable
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "perfbench/configs/tpch_sf10_served_third.json")
                     .read_text())
    data = generate.make(cfg, 3_000_000_029, device=dev, scale=scale)
    comp = compress.CompressionConfig(**cfg["deployment"]["compression"])
    pt = PartitionedTable.from_arrays(data.lineitem, cfg=comp,
                                      partition_rows=part_rows, pack=True,
                                      device=dev)
    tables = {"lineitem": pt,
              "part": Table.from_arrays(data.part, cfg=comp, device=dev)}
    return tables, {n: harness.plugin("shapes", n) for n in GRAPH_SHAPES}


def _leaf_bits(tree):
    """Each leaf's bytes, once every copy in flight has landed (a graph's
    partial comes back on its way to pinned host memory)."""
    from repro_torch.core.encodings import tensor_leaves
    torch.cuda.synchronize()
    return [t.cpu().numpy().tobytes() for t in tensor_leaves(tree)]


@pytest.mark.gpu
def test_gpu_graph_replays_bit_identical_to_eager(cuda_device):
    """Every partition's program of the four shapes, three rounds, each
    with fresh transfers and a fresh join side: the runner's partial
    (eager, capture or replay) is bit-identical to the eager program's on
    the same inputs, over partitions of two layouts."""
    from repro_torch.core import graphs
    from repro_torch.core.partition import (PartitionedQuery, _put_columns,
                                            base_masked_program,
                                            ready_on_compute)
    from repro_torch.core.serve import PlanEntry
    tables, shapes = _graph_tables(cuda_device)
    pt = tables["lineitem"]
    runner = graphs.ProgramGraphs(pt, cuda_device)
    assert len(set(runner._layouts)) >= 2
    modes = {n: [] for n in GRAPH_SHAPES}
    for name in GRAPH_SHAPES:
        entry = PlanEntry(program=base_masked_program(
            shapes[name].build(tables, PartitionedQuery).build(partial=True)))
        for rnd in range(3):
            keys = tuple(shapes[name].build(tables, PartitionedQuery)
                         ._prepare_inputs())
            for pid, part in enumerate(pt.partitions):
                cols = ready_on_compute(
                    _put_columns(part.table.columns, cuda_device), cuda_device)
                want = _leaf_bits(entry.program(cols, keys, part.rows))
                got, mode = runner.run(entry, pid, cols, keys, part.rows)
                modes[name].append(mode)
                assert _leaf_bits(got) == want, (name, rnd, pid, mode)
    assert runner.fallbacks == 0, runner.last_error
    for name, seen in modes.items():
        assert seen.count("capture") == len(set(runner._layouts)), name
        assert seen.count("replay") > len(seen) // 2, name


def _booked_rounds(tables, shapes, graphs_on, rounds=3):
    """Per round of the four shapes through one server (no drain thread):
    the kernels' launches and shape classes, the ``kernel`` instants'
    (kernel, bytes) and the routing counters booked; and the server's
    graph counters. ``graphs_on=False`` runs every program eagerly."""
    from repro_torch.core import serve, telemetry
    from repro_torch.core.partition import PartitionedQuery
    from repro_torch.kernels import dispatch
    booked = []
    try:
        with dispatch.overrides(enable_trace=True):
            with serve.QueryServer(tables["lineitem"], start=False,
                                   max_batch=8) as srv:
                srv.graphs.enabled = graphs_on
                for _ in range(rounds):
                    _build.reset_launches()
                    telemetry.reset()
                    tickets = [srv.submit(shapes[n].build(tables,
                                                          PartitionedQuery))
                               for n in GRAPH_SHAPES]
                    while srv.step():
                        pass
                    for t in tickets:
                        srv.result(t, timeout=0)
                    reg = telemetry.registry()
                    booked.append((
                        dict(_build.LAUNCHES),
                        {k: dict(v) for k, v in _build.SHAPES.items()},
                        sorted((e["attrs"]["kernel"], e["attrs"]["nbytes"])
                               for e in reg.events(name="kernel")),
                        {k: v for k, v in reg.counters().items()
                         if k.startswith("route.")}))
                g = srv.stats()["graphs"]
    finally:
        telemetry.reset()
    return booked, g


@pytest.mark.gpu
def test_gpu_replays_book_what_eager_runs_book(cuda_device):
    """A capture launches nothing and a replay runs no wrapper, so the
    runner books each graph's launches, shape classes, ``kernel``
    instants (with their bytes) and routing records on every replay:
    three rounds of the four shapes through a server that captures and
    replays book, round by round, exactly what a server that runs every
    program eagerly books."""
    tables, shapes = _graph_tables(cuda_device)
    eager, g_eager = _booked_rounds(tables, shapes, graphs_on=False)
    graphed, g = _booked_rounds(tables, shapes, graphs_on=True)
    assert g_eager["captures"] == g_eager["replays"] == 0
    assert g["fallbacks"] == 0 and g["replays"] > g["captures"] > 0
    assert sum(eager[-1][0].values()) > 0
    for rnd, (want, got) in enumerate(zip(eager, graphed)):
        assert got == want, rnd


@pytest.mark.gpu
def test_gpu_served_graphs_bit_identical_to_solo(cuda_device):
    """The four shapes, three times each from four threads, through a
    server whose budget (two partitions, less the graphs' slot) evicts on
    every pass: every answer is bit-identical to the query's solo run,
    and most programs are replays."""
    import warnings
    from repro_torch.core.partition import PartitionedQuery
    from repro_torch.core.serve import QueryServer
    tables, shapes = _graph_tables(cuda_device)
    pt = tables["lineitem"]

    def make(name):
        return shapes[name].build(tables, PartitionedQuery)

    solo = {n: chip_smoke.host_result(make(n).run()) for n in GRAPH_SHAPES}
    plan = [[GRAPH_SHAPES[(t + i) % 4] for i in range(12)] for t in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the ring's clamp
        with QueryServer(pt, budget_bytes=2 * pt.max_partition_nbytes(),
                         max_batch=8) as srv:
            done = _serve_threads(srv, make, plan)
            stats = srv.stats()
    g = stats["graphs"]
    assert len(done) == 48 and stats["errors"] == 0
    assert stats["residency"]["evictions"] > 0
    assert g["fallbacks"] == 0 and g["captures"] > 0, srv.graphs.last_error
    assert g["replays"] > g["captures"] + g["eager"]
    for n, got in done:
        assert chip_smoke._bits(got) == chip_smoke._bits(solo[n]), n


@pytest.mark.gpu
def test_gpu_capture_that_syncs_falls_back_to_eager(cuda_device,
                                                    monkeypatch):
    """A program that reads a device value on the host cannot be
    captured: each key's capture fails, is counted, leaves the key eager,
    and every answer is still the solo run's."""
    from repro_torch.core import serve
    from repro_torch.core.encodings import tensor_leaves
    from repro_torch.core.partition import PartitionedQuery
    tables, shapes = _graph_tables(cuda_device)
    pt = tables["lineitem"]
    real = serve.base_masked_program

    def syncing(inner):
        program = real(inner)

        def run(cols, keys, rows):
            out = program(cols, keys, rows)
            tensor_leaves(out)[0].sum().item()  # a sync
            return out

        return run

    solo = {n: chip_smoke.host_result(
        shapes[n].build(tables, PartitionedQuery).run()) for n in GRAPH_SHAPES}
    monkeypatch.setattr(serve, "base_masked_program", syncing)
    with serve.QueryServer(pt, start=False) as srv:
        for _ in range(3):
            tickets = [(n, srv.submit(shapes[n].build(tables,
                                                      PartitionedQuery)))
                       for n in GRAPH_SHAPES]
            while srv.step():
                pass
            for n, t in tickets:
                got = chip_smoke.host_result(srv.result(t, timeout=0))
                assert chip_smoke._bits(got) == chip_smoke._bits(solo[n]), n
        g = srv.stats()["graphs"]
    assert g["fallbacks"] >= len(GRAPH_SHAPES)
    assert g["captures"] == g["replays"] == 0


@pytest.mark.gpu
def test_gpu_cancel_and_faults_act_between_replays(cuda_device):
    """Once every key replays, a fault injected at a partition's
    ``program`` site fails only its own query, and a ticket cancelled
    after a replay stops at the next partition boundary; the others'
    answers stay the solo runs'."""
    from repro_torch.core import faults, serve
    from repro_torch.core.faults import QueryCancelled
    from repro_torch.core.partition import PartitionedQuery
    tables, shapes = _graph_tables(cuda_device)
    pt = tables["lineitem"]

    def make(name):
        return shapes[name].build(tables, PartitionedQuery)

    solo = {n: chip_smoke._bits(chip_smoke.host_result(make(n).run()))
            for n in ("Q1", "Q6")}
    with serve.QueryServer(pt, start=False, max_batch=8) as srv:
        for _ in range(2):  # eager, then captures
            warm = [srv.submit(make(n)) for n in ("Q1", "Q6")]
            while srv.step():
                pass
            for t in warm:
                srv.result(t, timeout=0)
        replays0 = srv.stats()["graphs"]["replays"]
        plan = faults.FaultPlan().transient(part=2, site="program")
        t1, t6 = srv.submit(make("Q1")), srv.submit(make("Q6"))
        with plan:
            assert srv.step() == 2  # one shared pass
        assert isinstance(t1.error, faults.TransientTransferError)
        assert chip_smoke._bits(chip_smoke.host_result(t6.result)) == solo["Q6"]
        assert srv.stats()["graphs"]["replays"] > replays0
        real = srv.graphs.run
        victim = srv.submit(make("Q1"))
        other = srv.submit(make("Q6"))

        def run(entry, pid, *args):
            out = real(entry, pid, *args)
            if pid == 1 and out[1] == "replay":
                srv.cancel(victim)
            return out

        srv.graphs.run = run
        assert srv.step() == 2
        assert isinstance(victim.error, QueryCancelled)
        assert victim.stats is None
        assert chip_smoke._bits(chip_smoke.host_result(other.result)) == \
            solo["Q6"]


SMOKE_MODELS = list(model_configs.ARCHS)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SMOKE_MODELS)
def test_gpu_smoke_model_matches_cpu(cuda_device, arch):
    """Each smoke arch (the SSM families included) in float32 on the card
    against the CPU with
    the same weights: forward and teacher-forced decode logits within
    ``chip_smoke.MODEL_SMOKE_RTOL`` (relative max error), as the model
    phase of ``chip_smoke.py`` holds them."""
    rec = chip_smoke.smoke_model_check(arch, cuda_device)
    assert rec["forward_rel"] < chip_smoke.MODEL_SMOKE_RTOL, rec
    assert rec["decode_rel"] < chip_smoke.MODEL_SMOKE_RTOL, rec


@pytest.mark.gpu
def test_gpu_rmsnorm_and_router_are_batch_invariant(cuda_device):
    """A token's RMSNorm output and MoE router logits do not depend on how
    many tokens one call holds (float64 accumulation rounded to float32):
    at granite's width a float32 row mean on the card differs in some rows
    between 16 tokens at once and one at a time, and that difference flips
    bfloat16 outputs and MoE routing between prefill and decode."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4, 16, 1536, generator=g, device=cuda_device) * 3
    scale = {"scale": torch.randn(1536, generator=g, device=cuda_device)
             .bfloat16()}
    router = {"router": torch.randn(1536, 40, generator=g,
                                    device=cuda_device) / 40,
              "w_gate": torch.zeros(40, 1, 1, device=cuda_device)}
    for dtype in (torch.bfloat16, torch.float32):
        xs = x.to(dtype)
        whole = L.rmsnorm(scale, xs)
        split = torch.cat([L.rmsnorm(scale, xs[:, t:t + 1])
                           for t in range(16)], dim=1)
        assert torch.equal(whole, split)
        r16 = L.moe_route(router, whole, 8, 16.0)
        r1 = [L.moe_route(router, whole[:, t:t + 1], 8, 16.0)
              for t in range(16)]
        assert torch.equal(r16["expert"].reshape(4, 16, 8),
                           torch.cat([r["expert"].reshape(4, 1, 8)
                                      for r in r1], dim=1))
        assert torch.equal(r16["gate"].reshape(4, 16, 8),
                           torch.cat([r["gate"].reshape(4, 1, 8)
                                      for r in r1], dim=1))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm_360m", "zamba2_1p2b", "xlstm_350m"])
def test_gpu_smoke_train_step_matches_cpu(cuda_device, arch):
    """Two float32 train steps (``grad_accum`` 2) of a smoke arch on the
    card and on the CPU from the same weights and batch: the losses within
    rtol 1e-5; every parameter within atol 1e-5 after the steps (1% of the
    1e-3 step a first AdamW update takes), but for entries whose gradient
    is near zero, where a first AdamW step moves by about ``lr`` in the
    direction of the gradient's sign whatever its size: at most a few
    such entries (``tests/test_torch_train.py``'s count), none beyond two
    steps of ``lr``."""
    import dataclasses
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
    from repro_torch.train import pytree
    from repro_torch.train.step import init_train_state, state_for
    cfg = dataclasses.replace(model_configs.get_smoke_config(arch),
                              dtype=torch.float32)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=20), grad_accum=2)
    cpu = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                           "cpu")
    dev = state_for(params_from_numpy(cfg, params_to_numpy(cpu.params),
                                      cuda_device).requires_grad_(True), tcfg)
    step = make_train_step(cfg, tcfg)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    for _ in range(2):
        cpu, mc = step(cpu, {"tokens": tok, "labels": tok})
        dev, md = step(dev, {"tokens": tok.to(cuda_device),
                             "labels": tok.to(cuda_device)})
        assert abs(float(md["loss"]) - float(mc["loss"])) <= \
            1e-5 * abs(float(mc["loss"]))
    assert int(dev.step) == int(cpu.step) == 2
    flipped, n = 0, 0
    for (name, a), (_, b) in zip(pytree.named_leaves(dev.params),
                                 pytree.named_leaves(cpu.params)):
        d = (a.detach().cpu() - b.detach()).abs()
        assert float(d.max()) < 2.5e-3, (name, float(d.max()))
        flipped += int((d > 1e-5).sum())
        n += d.numel()
    assert flipped <= max(4, n // 10_000), (arch, flipped, n)


@pytest.mark.gpu
def test_gpu_training_checkpoint_round_trip(cuda_device, tmp_path):
    """A bf16 ``TrainState`` on the card saved and restored on the card bit
    for bit, and on the CPU equal to the card's."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.train import CheckpointManager, TrainConfig, pytree
    from repro_torch.train.step import init_train_state
    cfg = model_configs.get_smoke_config("zamba2_1p2b")
    state = init_train_state(cfg, TrainConfig(grad_compression="topk_index"),
                             torch.Generator(device=cuda_device).manual_seed(1),
                             cuda_device)
    ck = CheckpointManager(str(tmp_path))
    ck.save(0, state, blocking=True, extra={"data_cursor": 5})
    like = dataclasses.replace(
        pytree.map_tree(lambda t: torch.empty_like(t, device="meta"), state),
        params=M.init_params(cfg, device="meta").requires_grad_(True))
    for device in (cuda_device, torch.device("cpu")):
        got, meta = ck.restore(like, device=device)
        assert meta["extra"]["data_cursor"] == 5
        for (name, a), (_, b) in zip(pytree.named_leaves(got),
                                     pytree.named_leaves(state)):
            assert a.device.type == device.type and a.dtype == b.dtype, name
            assert torch.equal(chip_smoke._tensor_bits(a.cpu()),
                               chip_smoke._tensor_bits(b.cpu())), name


@pytest.mark.gpu
def test_gpu_training_data_path_matches_cpu(cuda_device, monkeypatch):
    """``chip_smoke.train_data_path`` at 2,000 documents: the selection on
    the card equals its decoded oracle and the CPU pipeline (positions,
    stream, first batch, stats), and launches the three kernels."""
    monkeypatch.setattr(chip_smoke, "TRAIN_DOCS", 2000)
    pipe, rec, launches = chip_smoke.train_data_path(cuda_device, 0, 49152)
    assert pipe.cursor() == 0 and rec["selected_tokens"] > 0
    assert all(launches[k] > 0 for k in chip_smoke.TRAIN_KERNELS), launches


@pytest.fixture
def nccl_mesh(cuda_device):
    """The (1, 1) mesh of an NCCL world of one, torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    mesh = make_host_mesh(cuda_device)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gpu_ep_body_equals_local_moe_at_smoke_width(nccl_mesh, cuda_device):
    """``chip_smoke.py``'s mesh step (a) at qwen3-moe's smoke width: the
    expert-parallel body over NCCL against the local ``moe``."""
    import dataclasses
    cfg = dataclasses.replace(
        model_configs.get_smoke_config("qwen3_moe_235b_a22b"),
        dtype=torch.bfloat16)
    rec = chip_smoke.mesh_moe_check(nccl_mesh, cfg, cuda_device, 0, 2, 16)
    assert rec["slots_equal"] and rec["kept"] < rec["entries"]
    assert rec["group_backends"] == {"data": "nccl", "model": "nccl"}


@pytest.mark.gpu
def test_gpu_dtensor_model_equals_plain_at_smoke_width(nccl_mesh,
                                                       cuda_device):
    """``chip_smoke.py``'s mesh step (b) at granite-moe's smoke width:
    forward and greedy decode on DTensors against the plain ones."""
    import dataclasses
    cfg = dataclasses.replace(
        model_configs.get_smoke_config("granite_moe_3b_a800m"),
        dtype=torch.bfloat16)
    rec = chip_smoke.mesh_model_check(nccl_mesh, cfg, cuda_device, 0, 4, 8,
                                      4)
    assert rec["greedy_ids_equal"]
    assert rec["logits_rel_err"] < chip_smoke.MESH_DT_BOUND
    assert rec["decode_logits_rel_err"] < chip_smoke.MESH_DT_BOUND
