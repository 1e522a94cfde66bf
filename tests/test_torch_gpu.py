"""The port's CUDA kernels and its query path on the card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips elsewhere (inside the ``cuda_device`` fixture, never at import).
The module imports no JAX, so the card's machine runs it alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (integer outputs and rle_decode exactly; segment_sum within the
reference tests' rtol 1e-4 of a float64 host sum and bit-identical
across launches), and the TPC-H-shaped queries of ``chip_smoke.py`` are
held against the same queries on CPU tensors and the numpy oracle.
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
