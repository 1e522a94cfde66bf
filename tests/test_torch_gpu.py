"""The port's CUDA kernels and its query path on the card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips elsewhere (inside the ``cuda_device`` fixture, never at import).
The module imports no JAX, so the card's machine runs it alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (integer outputs and rle_decode exactly; segment_sum within the
reference tests' rtol 1e-4 of a float64 host sum and bit-identical
across launches; the three packed kernels exactly, on every bit width),
the TPC-H-shaped queries of ``chip_smoke.py`` are held against the same
queries on CPU tensors and the numpy oracle, and the streamed partitioned
path (pinned partitions, copy stream, events) against its CPU run.
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

from torch_twins import (BUCKETIZE_CASES, RLE_CASES, bucketize_cases,  # noqa: F401
                         cuda_device, rle_case)


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
