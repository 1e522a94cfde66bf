"""The port's kernel layer (repro_torch.kernels) against repro.kernels.

On the CPU every kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (and the dispatch routes around them)
against the JAX package's Pallas kernels in interpret mode, on the edge
cases of tests/test_pallas_kernels.py and tests/test_kernels.py. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import dispatch as jdispatch, ops as jops, ref as jref
from repro_torch.core import telemetry as ttelemetry
from repro_torch.kernels import _build, dispatch, ops, ref
from repro_torch.kernels import bucketize as kb
from repro_torch.kernels.rle_decode import fill_bits, rle_decode_kernel
from repro_torch.kernels.segment_reduce import segment_sum_kernel

from torch_twins import (BUCKETIZE_CASES, RLE_CASES, assert_close,
                         assert_same, bucketize_cases, rle_case)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", BUCKETIZE_CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_bucketize_plain_matches_pallas(rng, case, dtype):
    b, q = bucketize_cases(rng)[case]
    b, q = b.astype(dtype), q.astype(dtype)
    for right in (True, False):
        want = jops.bucketize(jnp.asarray(b), jnp.asarray(q), right=right,
                              use_pallas=True, interpret=True)
        assert_same(want, ref.ref_bucketize(_t(b), _t(q), right),
                    f"ref {case} {right}")
        assert_same(want, ops.bucketize(_t(b), _t(q), right=right,
                                        use_kernel=True), f"ops {case}")
        if b.shape[0]:
            assert_same(want, kb.bucketize_count_kernel(_t(b), _t(q), right),
                        f"count route {case}")


def test_bucketize_nan_queries():
    """A NaN query counts every boundary on both packages."""
    b = np.array([1.0, 2.0, 3.0], np.float32)
    q = np.array([np.nan, 2.0, -1.0], np.float32)
    for right in (True, False):
        want = jref.ref_bucketize(jnp.asarray(b), jnp.asarray(q), right)
        assert_same(want, ref.ref_bucketize(_t(b), _t(q), right))


def test_bucketize_mixed_dtypes_promote_like_jax():
    b = np.array([-3, 0, 5, 9], np.int8)
    q = np.array([-300, 0, 4, 9, 1000], np.int32)
    for right in (True, False):
        want = jnp.searchsorted(jnp.asarray(b), jnp.asarray(q),
                                side="right" if right else "left")
        assert_same(np.asarray(want).astype(np.int32),
                    dispatch.bucketize(_t(b), _t(q), right))


def test_count_route_above_lowered_threshold(rng):
    """Boundaries beyond the shared-memory threshold take the count route
    on both packages and give identical counts."""
    b = np.sort(rng.integers(0, 5000, 300)).astype(np.int32)
    q = rng.integers(-10, 5010, 700).astype(np.int32)
    with jdispatch.overrides(use_pallas=True, interpret=True,
                             bucketize_min_queries=0,
                             bucketize_max_vmem_boundaries=64):
        want = jdispatch.bucketize(jnp.asarray(b), jnp.asarray(q), right=True)
    ttelemetry.reset()
    with dispatch.overrides(use_kernels=True, enable_trace=True,
                            bucketize_max_vmem_boundaries=64):
        got = dispatch.bucketize(_t(b), _t(q), right=True)
    assert_same(want, got)
    assert ttelemetry.registry().counter("route.bucketize.count_kernel") == 1
    ttelemetry.reset()


@pytest.mark.parametrize("case", RLE_CASES)
@pytest.mark.parametrize("as_float", [False, True])
def test_rle_decode_plain_matches_pallas(case, as_float):
    vals, starts, ends, n, nrows, fill = rle_case(case)
    if as_float:
        vals = vals.astype(np.float32)
    want = jops.rle_decode(jnp.asarray(vals), jnp.asarray(starts),
                           jnp.asarray(ends), jnp.asarray(n, jnp.int32), nrows,
                           fill=fill, use_pallas=True, interpret=True)
    nt = torch.tensor(n, dtype=torch.int32)
    assert_same(want, ref.ref_rle_decode(_t(vals), _t(starts), _t(ends), nt,
                                         nrows, fill))
    assert_same(want, rle_decode_kernel(_t(vals), _t(starts), _t(ends), nt,
                                        nrows, fill))


def test_rle_decode_zero_capacity_and_zero_rows():
    e = np.zeros(0, np.int32)
    want = jops.rle_decode(jnp.asarray(e), jnp.asarray(e), jnp.asarray(e),
                           jnp.asarray(0, jnp.int32), 10, fill=3,
                           use_pallas=True, interpret=True)
    assert_same(want, ops.rle_decode(_t(e), _t(e), _t(e), 0, 10, fill=3,
                                     use_kernel=True))
    assert ops.rle_decode(_t(e), _t(e), _t(e), 0, 0, use_kernel=True).shape == (0,)


@pytest.mark.parametrize("n,s,how", [
    (0, 4, "empty"), (1025, 1, "one_group"), (512, 8, "all_out"),
    (2048, 8, "every_fifth_dropped"), (3000, 33, "ragged"),
    (20000, 1000, "random"), (4101, 4096, "max_groups")])
def test_segment_sum_plain_matches_pallas(rng, n, s, how):
    v = rng.random(n).astype(np.float32)
    ids = rng.integers(0, s, n).astype(np.int32)
    if how == "all_out":
        ids[:] = s
    elif how == "every_fifth_dropped":
        ids[::5] = s
    want = jops.segment_reduce(jnp.asarray(v), jnp.asarray(ids), s,
                               use_pallas=True, interpret=True)
    keep = (ids >= 0) & (ids < s)
    exact = np.zeros(s, np.float64)
    np.add.at(exact, ids[keep], v[keep].astype(np.float64))
    got = segment_sum_kernel(_t(v), _t(ids), s)
    assert_close(want, got, how)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4, atol=1e-4)
    assert_close(want, ops.segment_reduce(_t(v), _t(ids), s, use_kernel=True))


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_segment_reduce_minmax(rng, reduce):
    v = rng.random(512).astype(np.float32)
    ids = rng.integers(0, 16, 512).astype(np.int32)
    want = jref.ref_segment_reduce(jnp.asarray(v), jnp.asarray(ids), 16, reduce)
    assert_same(want, ref.ref_segment_reduce(_t(v), _t(ids), 16, reduce))


def test_fill_bits_is_the_cast_value_pattern():
    assert fill_bits(7, torch.int32) == 7
    assert fill_bits(-1, torch.int32) == 0xFFFFFFFF
    assert fill_bits(1.5, torch.float32) == 0x3FC00000
    assert fill_bits(2.7, torch.int32) == 2  # cast first, as jnp.asarray does


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "two_d",
                                 "non_contiguous", "not_tensor"])
def test_bucketize_wrapper_rejects_bad_inputs(bad):
    b = torch.arange(10, dtype=torch.int32)
    q = torch.arange(5, dtype=torch.int32)
    if bad == "dtype":
        b, q = b.to(torch.int64), q.to(torch.int64)
    elif bad == "mixed_dtype":
        q = q.to(torch.float32)
    elif bad == "two_d":
        q = q.reshape(1, 5)
    elif bad == "non_contiguous":
        q = torch.arange(10, dtype=torch.int32)[::2]
    elif bad == "not_tensor":
        q = np.arange(5, dtype=np.int32)
    with pytest.raises((TypeError, ValueError)):
        kb.bucketize_kernel(b, q)
    with pytest.raises((TypeError, ValueError)):
        kb.bucketize_count_kernel(b, q)


@pytest.mark.parametrize("bad", ["values_dtype", "starts_dtype", "n_dtype",
                                 "capacity_mismatch", "negative_rows"])
def test_rle_decode_wrapper_rejects_bad_inputs(bad):
    v = torch.zeros(4, dtype=torch.int32)
    s = torch.tensor([0, 2, 6, 6], dtype=torch.int32)
    e = torch.tensor([1, 5, 6, 6], dtype=torch.int32)
    n, nrows = torch.tensor(2, dtype=torch.int32), 6
    if bad == "values_dtype":
        v = v.to(torch.int8)
    elif bad == "starts_dtype":
        s = s.to(torch.int64)
    elif bad == "n_dtype":
        n = n.to(torch.int64)
    elif bad == "capacity_mismatch":
        v = torch.zeros(3, dtype=torch.int32)
    elif bad == "negative_rows":
        nrows = -1
    with pytest.raises((TypeError, ValueError)):
        rle_decode_kernel(v, s, e, n, nrows)


@pytest.mark.parametrize("bad", ["values_dtype", "ids_dtype", "shape",
                                 "too_many_groups", "zero_groups"])
def test_segment_sum_wrapper_rejects_bad_inputs(bad):
    v = torch.ones(8, dtype=torch.float32)
    ids = torch.zeros(8, dtype=torch.int32)
    g = 4
    if bad == "values_dtype":
        v = v.to(torch.float64)
    elif bad == "ids_dtype":
        ids = ids.to(torch.int64)
    elif bad == "shape":
        ids = torch.zeros(7, dtype=torch.int32)
    elif bad == "too_many_groups":
        g = 4097
    elif bad == "zero_groups":
        g = 0
    with pytest.raises((TypeError, ValueError)):
        segment_sum_kernel(v, ids, g)


def test_cpu_wrappers_launch_nothing(rng):
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted."""
    _build.reset_launches()
    b = _t(np.sort(rng.integers(0, 50, 20)).astype(np.int32))
    q = _t(rng.integers(0, 50, 30).astype(np.int32))
    kb.bucketize_kernel(b, q)
    kb.bucketize_count_kernel(b, q)
    segment_sum_kernel(_t(rng.random(8).astype(np.float32)),
                       torch.zeros(8, dtype=torch.int32), 2)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_policy_from_env_parsing():
    pol = dispatch.policy_from_env({
        "REPRO_USE_KERNELS": "0",
        "REPRO_SORT_FREE": "off",
        "REPRO_SORT_FREE_MAX_DOMAIN": "4096",
        "REPRO_BUCKETIZE_MIN_QUERIES": "16",
        "REPRO_BUCKETIZE_MAX_VMEM_BOUNDARIES": "1024",
        "REPRO_RLE_DECODE_MIN_ROWS": "32",
        "REPRO_SEGSUM_MAX_GROUPS": "128",
        "REPRO_UNPACK_MIN_VALS": "64",
        "REPRO_TRACE": "1",
        "REPRO_SERVE_BUDGET_BYTES": "none",
        "REPRO_TRANSFER_BACKOFF_MS": "2.5",
    })
    assert pol.use_kernels is False
    assert not pol.kernels_enabled(torch.zeros(1))
    assert pol.enable_sort_free is False
    assert pol.sort_free_max_domain == 4096
    assert pol.bucketize_min_queries == 16
    assert pol.bucketize_max_vmem_boundaries == 1024
    assert pol.rle_decode_min_rows == 32
    assert pol.segment_sum_max_groups == 128
    assert pol.unpack_min_vals == 64
    assert pol.enable_trace is True
    assert pol.serve_budget_bytes is None
    assert pol.transfer_backoff_ms == 2.5
    auto = dispatch.policy_from_env({})
    assert auto.use_kernels is None and auto.enable_sort_free is True
    # auto: kernels exactly when the inputs are CUDA tensors
    assert not auto.kernels_enabled(torch.zeros(1))
    # TPU-tuned thresholds default to 0 on the card; the shared-memory
    # bound replaces the VMEM one
    assert (auto.bucketize_min_queries, auto.rle_decode_min_rows,
            auto.unpack_min_vals) == (0, 0, 0)
    assert auto.bucketize_max_vmem_boundaries == kb.MAX_SMEM_BOUNDARIES
    # the fields the JAX policy shares keep their defaults
    jauto = jdispatch.policy_from_env({})
    for f in ("segment_sum_max_groups", "sort_free_max_domain",
              "topk_min_rows", "topk_max_k", "pack_max_bits",
              "prefetch_depth", "plan_cache_size", "serve_max_batch",
              "trace_buffer_events", "transfer_retries"):
        assert getattr(auto, f) == getattr(jauto, f), f


@pytest.mark.parametrize("forced,path", [(None, "torch"), (True, "kernel")])
def test_dispatch_routes_are_recorded(rng, forced, path):
    b = _t(np.sort(rng.integers(0, 100, 50)).astype(np.int32))
    q = _t(rng.integers(0, 100, 64).astype(np.int32))
    v = _t(rng.random(64).astype(np.float32))
    ids = _t(rng.integers(0, 8, 64).astype(np.int32))
    ttelemetry.reset()
    with dispatch.overrides(use_kernels=forced, enable_trace=True):
        got = dispatch.bucketize(b, q, right=True)
        s = dispatch.segment_sum(v, ids, 8)
        dec = dispatch.maybe_rle_decode(b, b, b, torch.tensor(3, dtype=torch.int32),
                                        100)
        # integer sums keep exact scatter arithmetic on every route
        cnt = dispatch.segment_sum(ids, ids, 8)
    reg = ttelemetry.registry()
    assert reg.counter(f"route.bucketize.{path}") == 1
    assert reg.counter("route.segment_sum.kernel") == (1 if forced else 0)
    assert reg.counter("route.segment_sum.torch_scatter") == (1 if forced else 2)
    assert (dec is None) == (forced is None)
    assert cnt.dtype == torch.int32
    ttelemetry.reset()
    want = np.searchsorted(b.numpy(), q.numpy(), side="right")
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.zeros(8, np.float64)
    np.add.at(exact, ids.numpy(), v.numpy().astype(np.float64))
    np.testing.assert_allclose(s.numpy(), exact, rtol=1e-5)


def test_unported_routes_raise():
    with pytest.raises(NotImplementedError, match="B5"):
        dispatch.unpack(None)
    with pytest.raises(NotImplementedError, match="B8"):
        dispatch.topk(torch.zeros(4), 2)
