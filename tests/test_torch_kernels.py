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

from torch_twins import (BUCKETIZE_CASES, RLE_CASES, TOPK_CASES, I32MIN,
                         assert_close, assert_same, bucketize_cases, rle_case,
                         topk_case)


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


def test_bucketize_launch_plan():
    """The shared-memory route's host-side plan: four queries a thread, by
    one 16-byte load and store when the queries and the counts are both
    16-byte aligned, else by scalar loads 256 apart (a view at storage
    offset 1); either way the kernel's indexing takes every query of every
    tile once; one tile a block unless the boundaries outnumber a tile's
    queries, then a persistent grid."""
    for q_ptr, o_ptr, vec in ((0x1000, 0x2000, True), (0x1004, 0x2000, False),
                              (0x1000, 0x2008, False), (0x100c, 0x200c, False)):
        assert bool(kb.launch_plan(550, q_ptr, o_ptr) & kb.VECTORIZED) == vec
    base = torch.zeros(9, dtype=torch.int32)
    view, out = base[1:], torch.empty(8, dtype=torch.int32)
    assert view.is_contiguous() and view.storage_offset() == 1
    assert not kb.launch_plan(550, view.data_ptr(), out.data_ptr()) & kb.VECTORIZED
    t = np.arange(kb.THREADS)[None, :, None]
    j = np.arange(kb.PER_THREAD)[None, None, :]
    for nq in (1, 3, 5, 1023, 1024, 1025, 4099, 1_406_900):
        tile = np.arange(-(-nq // kb.TILE))[:, None, None] * kb.TILE
        for vec in (True, False):
            idx = tile + (kb.PER_THREAD * t + j if vec else t + kb.THREADS * j)
            assert np.array_equal(np.sort(idx[idx < nq]), np.arange(nq))
    for nb in (1, 550, kb.TILE):
        assert kb.launch_plan(nb, 0, 0) == kb.VECTORIZED
    for nb in (kb.TILE + 1, kb.MAX_SMEM_BOUNDARIES):
        assert kb.launch_plan(nb, 0, 0) == kb.VECTORIZED | kb.PERSISTENT
    assert kb.launch_plan(kb.TILE + 1, 4, 0) == kb.PERSISTENT
    # the C entry's other bits (float32 1, right 2, global 4) stay clear
    assert kb.VECTORIZED & 7 == kb.PERSISTENT & 7 == 0


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
            auto.unpack_min_vals, auto.topk_min_rows) == (0, 0, 0, 0)
    assert auto.bucketize_max_vmem_boundaries == kb.MAX_SMEM_BOUNDARIES
    # the fields the JAX policy shares keep their defaults
    jauto = jdispatch.policy_from_env({})
    for f in ("segment_sum_max_groups", "sort_free_max_domain",
              "topk_max_k", "pack_max_bits",
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
    """The routes that raised before their kernels were ported now run:
    top-k (B8) and the packed routes (B5-B7)."""
    v, i = dispatch.topk(torch.tensor([3, 9, 9, 1], dtype=torch.int32), 2)
    assert v.tolist() == [9, 9] and i.tolist() == [1, 2]
    with dispatch.overrides(use_kernels=True):
        v, i = dispatch.topk(torch.tensor([3.0, 9.0, 9.0, 1.0]), 3)
    assert v.tolist() == [9.0, 9.0, 3.0] and i.tolist() == [1, 2, 0]
    from repro_torch.core.encodings import PackedColumn
    words = torch.tensor([0b1110_0100], dtype=torch.int32)  # 0,1,2,3 at 2 bits
    got = dispatch.unpack(PackedColumn(words=words, nrows=4, bit_width=2,
                                       offset=-1))
    assert got.tolist() == [-1, 0, 1, 2]


# ---------------------------------------------------------------------------
# topk: the plain version and the forced-kernel CPU route against the
# Pallas kernel (interpret mode) and jax.lax.top_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_plain_matches_pallas(case):
    import jax
    from repro.kernels import topk as jtopk
    x, ks = topk_case(case)
    for k in ks:
        want = jtopk.topk_kernel(jnp.asarray(x), k, interpret=True)
        got = {"ref": ref.topk(_t(x), k),
               "ops kernel route": ops.topk(_t(x), k, use_kernel=True)}
        with dispatch.overrides(use_kernels=True):
            got["dispatch kernel route"] = dispatch.topk(_t(x), k)
        for how, (v, i) in got.items():
            assert_same(want[0], v, f"{case} k={k} {how} values")
            assert_same(want[1], i, f"{case} k={k} {how} indices")
        # lax.top_k (the reference's other route) takes k <= n only, and
        # orders -0.0 below +0.0 where the Pallas kernel ties them
        if len(x) >= k and case != "signed_zeros_float32":
            lv, li = jax.lax.top_k(jnp.asarray(x), k)
            assert_same(lv, got["ref"][0], f"{case} k={k} lax values")
            assert_same(li, got["ref"][1], f"{case} k={k} lax indices")


def _rank(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Permutation ordering (v, i) pairs by (value desc, index asc), the
    kernel's comparator; floats compare as numbers."""
    by_index = torch.sort(i.to(torch.int64), stable=True).indices
    key = v[by_index] + 0.0 if v.dtype.is_floating_point else v[by_index]
    return by_index[torch.sort(key, descending=True, stable=True).indices]


def _beats(v, i, tv, ti):
    """Pairs (v, i) ranked before the pair (tv, ti)."""
    return (v > tv) | ((v == tv) & (i < ti))


def _emulate_topk_kernel(values: torch.Tensor, k: int, max_blocks: int = 528,
                         misalign: int = 0):
    """``csrc/topk.cu``'s algorithm in plain PyTorch, launch by launch as
    ``topk.plan`` gives them: each block walks its range (a scalar head of
    ``(4 - misalign) % 4`` keys and the ragged tail first, then steps of
    ``CHUNK`` keys in thread order), tests every key against the last pair
    of its running top-k_pow2 list, appends the survivors to a
    ``BUFFER``-pair buffer, and when a step would overflow it (and at the
    end) flushes: sorts the buffer, takes the better of ``L[i]`` and
    ``B[K-1-i]`` (the first exchange of a bitonic merge), sorts that, and
    tests the step again. Pads are (worst, INT32_MAX); the one-block last
    launch gives a pad its slot as index. Returns ``(vals, idx, launches,
    flushes)``."""
    from repro_torch.kernels import topk as kt
    kp, pad = kt.k_pow2_of(k), np.iinfo(np.int32).max
    worst = ref.worst_value(values.dtype)
    cur_v, cur_i, launches, flushes = values, None, 0, 0
    for launch in kt.plan(values.shape[0], k, max_blocks):
        out_v, out_i = [], []
        skew = misalign if cur_i is None else 0
        for b in range(launch.grid):
            s = b * launch.range_rows
            e = min(launch.rows, s + launch.range_rows)
            lv = torch.full((kp,), worst, dtype=values.dtype)
            li = torch.full((kp,), pad, dtype=torch.int64)
            buf_v, buf_i = [], []

            def flush():
                nonlocal lv, li, flushes
                bv, bi = torch.cat(buf_v), torch.cat(buf_i)
                o = _rank(bv, bi)[:kp]
                bv = torch.cat([bv[o], torch.full((kp - o.numel(),), worst,
                                                  dtype=values.dtype)])
                bi = torch.cat([bi[o], torch.full((kp - o.numel(),), pad,
                                                  dtype=torch.int64)])
                rb_v, rb_i = bv.flip(0), bi.flip(0)
                first = ~_beats(rb_v, rb_i, lv, li)
                mv, mi = torch.where(first, lv, rb_v), torch.where(first, li, rb_i)
                o = _rank(mv, mi)
                lv, li = mv[o], mi[o]
                buf_v.clear()
                buf_i.clear()
                flushes += 1

            def offer(v, i):
                while True:
                    keep = _beats(v, i, lv[-1], li[-1])
                    total = int(keep.sum())
                    if total == 0:
                        return
                    if sum(x.numel() for x in buf_v) + total > kt.BUFFER:
                        flush()
                        continue
                    buf_v.append(v[keep])
                    buf_i.append(i[keep])
                    return

            rows = torch.arange(s, max(s, e), dtype=torch.int64)
            src_i = rows if cur_i is None else cur_i[s:e].to(torch.int64)
            src_v = cur_v[s:e]
            head = min((4 - skew) % 4, max(0, e - s))
            body = (max(0, e - s) - head) // 4 * 4
            ragged = torch.cat([torch.arange(head),
                                torch.arange(head + body, max(0, e - s))])
            if ragged.numel():
                offer(src_v[ragged], src_i[ragged])
            for base in range(head, head + body, kt.CHUNK):
                step = torch.arange(base, min(base + kt.CHUNK, head + body))
                # thread t holds keys 4t..4t+3 and half+4t..half+4t+3
                rel, half = step - base, 4 * kt.THREADS
                order = torch.argsort((rel % half) // 4 * 8 + rel // half * 4
                                      + rel % 4)
                offer(src_v[step[order]], src_i[step[order]])
            if buf_v:
                flush()
            out_v.append(lv)
            out_i.append(li)
        cur_v, cur_i = torch.cat(out_v), torch.cat(out_i)
        launches += 1
        if launch.grid == 1:
            slots = torch.arange(kp, dtype=torch.int64)
            cur_i = torch.where(cur_i == pad, slots, cur_i)
    return cur_v[:k], cur_i[:k].to(torch.int32), launches, flushes


@pytest.mark.parametrize("n,k", [(0, 3), (5, 8), (2049, 256), (9000, 100),
                                 (600_000, 256)])
def test_topk_survivor_passes_emulated(n, k):
    """The block-select design (running threshold, buffer flushes, one
    survivor block carrying source indices; pads lose to real rows
    holding the worst value) equals the stable sort and the Pallas kernel
    (interpret mode), and the launch count is ``topk.passes``."""
    from repro.kernels import topk as jtopk
    from repro_torch.kernels import topk as kt
    rng = np.random.default_rng(n)
    x = rng.integers(-3, 3, n).astype(np.int32)
    x[rng.random(n) < 0.3] = I32MIN
    v, i, launches, _ = _emulate_topk_kernel(_t(x), k)
    want_v, want_i = ref.topk(_t(x), k)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)
    pallas = jtopk.topk_kernel(jnp.asarray(x), k, interpret=True)
    assert_same(pallas[0], v, f"n={n} k={k} values")
    assert_same(pallas[1], i, f"n={n} k={k} indices")
    assert launches == kt.passes(n, k)
    assert kt.passes(59_986_052, 100) == 2  # R1's shape in chip_smoke.py
    assert kt.passes(1 << 23, 128) == 2  # one streamed partition


def _topk_pattern(name: str):
    rng = np.random.default_rng(len(name))
    n = 100_001  # three blocks of the range pass, a ragged tail
    if name == "ascending":
        return np.arange(n, dtype=np.int32) - 5, (128,)
    if name == "descending":
        return np.arange(n, 0, -1).astype(np.float32), (256,)
    if name == "all_equal":
        return np.full(n, -4, np.int32), (37,)
    if name == "int32_min_heavy":
        x = rng.integers(-2, 2, n).astype(np.int32)
        x[rng.random(n) < 0.999] = I32MIN  # fewer real rows above it than k
        return x, (256,)
    if name == "n_below_k":
        return rng.standard_normal(100).astype(np.float32), (128,)
    raise KeyError(name)


@pytest.mark.parametrize("pattern", ["ascending", "descending", "all_equal",
                                     "int32_min_heavy", "n_below_k"])
def test_topk_emulated_patterns(pattern):
    """The emulation equals ``ref.topk`` and the Pallas kernel (interpret
    mode) on the inputs that stress the threshold: every key a survivor
    (ascending: a flush every step), none after the first step
    (descending, all equal), the worst value on most rows, n < k; the
    answer does not depend on the grid cap or on a misaligned start."""
    from repro.kernels import topk as jtopk
    from repro_torch.kernels import topk as kt
    x, ks = _topk_pattern(pattern)
    n = x.shape[0]
    for k in ks:
        want = jtopk.topk_kernel(jnp.asarray(x), k, interpret=True)
        got = {}
        for cap, skew in ((528, 0), (2, 1), (7, 3)):
            v, i, launches, flushes = _emulate_topk_kernel(_t(x), k, cap, skew)
            assert launches == kt.passes(n, k, cap)
            assert_same(want[0], v, f"{pattern} k={k} cap={cap} values")
            assert_same(want[1], i, f"{pattern} k={k} cap={cap} indices")
            got[cap] = flushes
        wv, wi = ref.topk(_t(x), k)
        assert torch.equal(v, wv) and torch.equal(i, wi)
        if pattern == "ascending":  # a flush every other step at least
            assert got[528] >= n // kt.CHUNK // 2
        if pattern in ("descending", "all_equal"):
            # a block flushes when its first full steps overflow the
            # buffer (once more if its ragged keys came first), then never
            blocks = sum(launch.grid for launch in kt.plan(n, k, 528))
            assert got[528] <= 2 * blocks


def test_topk_launch_plan():
    """The range pass splits n keys into at most ``max_blocks`` contiguous
    ranges of at least ``MIN_RANGE`` keys (each a multiple of 4, so each
    starts 16-byte aligned when the input does) covering [0, n); more than
    one block adds one survivor launch of one block over their lists."""
    from repro_torch.kernels import topk as kt
    for n in (0, 1, 4097, kt.MIN_RANGE, 2 * kt.MIN_RANGE - 1,
              2 * kt.MIN_RANGE, 1_000_003, 1 << 23, 59_986_052):
        for cap in (1, 2, 7, 264, 528):
            launches = kt.plan(n, 100, cap)
            first = launches[0]
            assert first.rows == n and 1 <= first.grid <= cap
            assert first.range_rows % 4 == 0
            assert first.grid * first.range_rows >= n
            assert (first.grid - 1) * first.range_rows < max(n, 1)
            if first.grid > 1:
                assert first.range_rows >= kt.MIN_RANGE
            multi = n >= 2 * kt.MIN_RANGE and cap > 1
            assert first.grid > 1 if multi else first.grid == 1
            if multi:
                assert launches[1] == kt.Launch(first.grid * 128, 1,
                                                first.grid * 128)
            assert len(launches) == kt.passes(n, 100, cap) == 1 + multi
    # R1 on an H100 (132 SMs x BLOCKS_PER_SM): 264 ranges of 227,220 keys;
    # at a cap of 528, 528 of 113,612
    assert kt.plan(59_986_052, 100, 132 * kt.BLOCKS_PER_SM) == [
        kt.Launch(59_986_052, 264, 227_220), kt.Launch(264 * 128, 1, 264 * 128)]
    assert kt.plan(59_986_052, 100, 528) == [
        kt.Launch(59_986_052, 528, 113_612), kt.Launch(528 * 128, 1, 528 * 128)]
    assert kt.plan(1 << 23, 128, 528)[0] == kt.Launch(1 << 23, 256, 32_768)


@pytest.mark.parametrize("bad", ["k_zero", "k_beyond", "dtype", "two_d",
                                 "strided"])
def test_topk_wrapper_rejects_bad_inputs(bad):
    from repro_torch.kernels.topk import topk_kernel
    x = torch.arange(100, dtype=torch.int32)
    k = 5
    if bad == "k_zero":
        k = 0
    elif bad == "k_beyond":
        k = 300  # k_pow2 = 512 > MAX_KERNEL_K, as in the reference
    elif bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "two_d":
        x = x.reshape(10, 10)
    else:
        x = x[::2]
    with pytest.raises((TypeError, ValueError)):
        topk_kernel(x, k)


def test_topk_routes_by_k_and_rows():
    """Kernel route for 1 <= k <= min(topk_max_k, 256) at rows >=
    topk_min_rows, the plain route otherwise; both give the same answer
    (the reference's test_orderby.py routing case)."""
    x = _t(np.random.default_rng(3).integers(0, 97, 5000).astype(np.int32))
    want = ref.topk(x, 300)
    ttelemetry.reset()
    with dispatch.overrides(use_kernels=True, enable_trace=True):
        dispatch.topk(x, 16)
        with dispatch.overrides(topk_max_k=8):
            dispatch.topk(x, 16)
        got = dispatch.topk(x, 300)  # k beyond the kernel's limit
        with dispatch.overrides(topk_min_rows=10_000):
            dispatch.topk(x, 16)
    reg = ttelemetry.registry()
    assert reg.counter("route.topk.kernel") == 1
    assert reg.counter("route.topk.torch") == 3
    ttelemetry.reset()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
