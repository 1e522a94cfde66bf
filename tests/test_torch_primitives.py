"""Twin of tests/test_primitives.py: every Table-1 primitive of
repro_torch.core.primitives against repro.core.primitives on the same
seeded inputs. Outputs must match buffer for buffer (dtype, capacity,
sentinel padding, counts), on the port's default route and on its kernel
route (the wrappers' plain versions on the CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import primitives as JP
from repro_torch.core import primitives as TP
from repro_torch.kernels import dispatch as tdispatch

from torch_twins import assert_same, mask_twins, rle_col_twins

SEEDS = range(4)
ROUTES = [None, True]
# fixed shapes across seeds keep the JAX side's per-shape compile cache warm
N = 64
CAP = N + 1


def _tree_same(want, got, what="out"):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(want) == len(got), what
        for i, (w, g) in enumerate(zip(want, got)):
            _tree_same(w, g, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        assert_same(want, got, what)


def _both(name, jargs, targs, route, **kw):
    with tdispatch.overrides(use_kernels=route):
        got = getattr(TP, name)(*targs, **kw)
    want = getattr(JP, name)(*jargs, **kw)
    _tree_same(want, got, name)
    return want, got


def _dense(rng, n=N, p=None):
    p = rng.random() if p is None else p
    return rng.random(n) < p


def _mask_pair(rng, kind, n):
    d = _dense(rng, n)
    return d, mask_twins(kind, d, cap=CAP)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_range_intersect_and_union(seed, route):
    rng = np.random.default_rng(seed)
    n = N
    d1, (j1, t1) = _mask_pair(rng, "rle", n)
    d2, (j2, t2) = _mask_pair(rng, "rle", n)
    cap = j1.capacity + j2.capacity
    jargs = (j1.starts, j1.ends, j1.n, j2.starts, j2.ends, j2.n, n, cap)
    targs = (t1.starts, t1.ends, t1.n, t2.starts, t2.ends, t2.n, n, cap)
    _both("range_intersect", jargs, targs, route)
    _both("range_union", jargs, targs, route)
    with tdispatch.overrides(use_kernels=route):
        tm = TP.range_intersect_masks(t1, t2)
    jm = JP.range_intersect_masks(j1, j2)
    _tree_same((jm.starts, jm.ends, jm.n), (tm.starts, tm.ends, tm.n))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_range_intersect_multi(seed, route):
    rng = np.random.default_rng(seed)
    n = N
    k = 1 + seed % 4
    jl, tl = [], []
    for _ in range(k):
        if rng.random() < 0.5:
            _, (j, t) = _mask_pair(rng, "rle", n)
        else:
            j, t = rle_col_twins(rng.integers(0, 3, n).astype(np.int32),
                                 cap=CAP)
        jl.append((j.starts, j.ends, j.n))
        tl.append((t.starts, t.ends, t.n))
    cap = sum(s.shape[0] for s, _, _ in jl)
    _both("range_intersect_multi", (jl, n, cap), (tl, n, cap), route)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_index_rle_intersections(seed, route):
    rng = np.random.default_rng(seed)
    n = N
    _, (ji, ti) = _mask_pair(rng, "index", n)
    _, (jr, tr) = _mask_pair(rng, "rle", n)
    cap = ji.capacity + jr.capacity
    _both("idx_in_rle_mask", (ji.positions, ji.n, jr.starts, jr.ends, jr.n),
          (ti.positions, ti.n, tr.starts, tr.ends, tr.n), route)
    for fn in ("idx_in_rle", "rle_contain_idx"):
        _both(fn, (ji.positions, ji.n, jr.starts, jr.ends, jr.n, n, cap),
              (ti.positions, ti.n, tr.starts, tr.ends, tr.n, n, cap), route)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_index_index(seed, route):
    rng = np.random.default_rng(seed)
    n = N
    _, (j1, t1) = _mask_pair(rng, "index", n)
    _, (j2, t2) = _mask_pair(rng, "index", n)
    _both("idx_in_idx", (j1.positions, j1.n, j2.positions, j2.n, n, j1.capacity),
          (t1.positions, t1.n, t2.positions, t2.n, n, t1.capacity), route)
    cap = j1.capacity + j2.capacity
    _both("merge_sorted_idx", (j1.positions, j1.n, j2.positions, j2.n, n, cap),
          (t1.positions, t1.n, t2.positions, t2.n, n, cap), route)


@pytest.mark.parametrize("seed", SEEDS)
def test_complements_and_compact_rle(seed):
    rng = np.random.default_rng(seed)
    n = N
    _, (jr, tr) = _mask_pair(rng, "rle", n)
    _, (ji, ti) = _mask_pair(rng, "index", n)
    _both("complement_rle", (jr.starts, jr.ends, jr.n, n),
          (tr.starts, tr.ends, tr.n, n), None)
    _both("complement_index", (ji.positions, ji.n, n), (ti.positions, ti.n, n),
          None)
    _both("compact_rle", (jr.starts, jr.ends, jr.n, n),
          (tr.starts, tr.ends, tr.n, n), None)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_rle_conversions(seed, route):
    rng = np.random.default_rng(seed)
    n = N
    vals = rng.integers(0, 4, n).astype(np.int32)
    j, t = rle_col_twins(vals, cap=CAP)
    cap = n + 3
    _both("rle_to_index", (j.values, j.starts, j.ends, j.n, n, cap),
          (t.values, t.starts, t.ends, t.n, n, cap), route)
    _both("rle_to_index", (None, j.starts, j.ends, j.n, n, cap),
          (None, t.starts, t.ends, t.n, n, cap), route)
    for fill in (0, 5):
        _both("rle_to_plain", (j.values, j.starts, j.ends, j.n, n),
              (t.values, t.starts, t.ends, t.n, n), route, fill=fill)
    _both("rle_to_plain", (None, j.starts, j.ends, j.n, n),
          (None, t.starts, t.ends, t.n, n), route)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_plain_conversions(seed, route):
    rng = np.random.default_rng(seed)
    n = N
    vals = rng.integers(0, 6, n).astype(np.int32)
    d = _dense(rng, n)
    jv, tv = jnp.asarray(vals), torch.from_numpy(vals)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    _both("plain_to_rle", (jv, n + 1), (tv, n + 1), route)
    _both("plain_mask_to_rle", (jd, n + 1), (td, n + 1), route)
    _both("plain_mask_to_index", (jd, n + 1), (td, n + 1), route)
    _both("plain_to_rle_index", (jv, 3, n, n), (tv, 3, n, n), route)
    wide = np.where(rng.random(n) < 0.1, 10**6,
                    rng.integers(0, 90, n)).astype(np.int32)
    want = JP.plain_to_plain_index(jnp.asarray(wide), 0, 89, jnp.int8, n)
    got = TP.plain_to_plain_index(torch.from_numpy(wide), 0, 89, np.int8, n)
    _tree_same(want[:1] + want[2:], got[:1] + got[2:])
    assert int(want[1]) == int(got[1])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ROUTES)
def test_expansion_building_blocks(seed, route):
    rng = np.random.default_rng(seed)
    reps = rng.integers(0, 4, 24).astype(np.int32)
    cap = 100
    _both("repeat_interleave_capped", (jnp.asarray(reps), cap),
          (torch.from_numpy(reps), cap), route)
    starts = rng.integers(0, 30, reps.shape[0]).astype(np.int32)
    _both("range_arange_capped", (jnp.asarray(starts), jnp.asarray(reps), cap),
          (torch.from_numpy(starts), torch.from_numpy(reps), cap), route)
    flags = rng.random(reps.shape[0]) < 0.5
    arrays_j = (jnp.asarray(starts), jnp.asarray(reps.astype(np.float32)))
    arrays_t = (torch.from_numpy(starts),
                torch.from_numpy(reps.astype(np.float32)))
    _both("compact", (jnp.asarray(flags), arrays_j, 8, (99, -1.0)),
          (torch.from_numpy(flags), arrays_t, 8, (99, -1.0)), route)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float32])
def test_unique_with_inverse_and_bounded(seed, dtype):
    rng = np.random.default_rng(seed)
    n = 48
    vals = rng.integers(0, 10, n).astype(dtype)
    valid = rng.random(n) < 0.8
    _both("unique_with_inverse", (jnp.asarray(vals), jnp.asarray(valid), 16),
          (torch.from_numpy(vals), torch.from_numpy(valid), 16), None)
    if dtype != np.float32:
        _both("unique_bounded",
              (jnp.asarray(vals), jnp.asarray(valid), 10),
              (torch.from_numpy(vals), torch.from_numpy(valid), 10), None,
              cap_groups=16)


@pytest.mark.parametrize("seed", SEEDS)
def test_rank_select_bounded(seed):
    rng = np.random.default_rng(seed)
    e = 40
    codes = rng.integers(0, 12, e).astype(np.int32)
    lengths = rng.integers(0, 5, e).astype(np.int32)
    valid = rng.random(e) < 0.85
    limit = int(rng.integers(1, 40))
    _both("rank_select_bounded",
          (jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(valid), 12,
           limit),
          (torch.from_numpy(codes), torch.from_numpy(lengths),
           torch.from_numpy(valid), 12, limit), None)


def test_range_union_no_int32_overflow_near_2_31_rows():
    """The reference's overflow regression, on the port."""
    from repro_torch.core import encodings as TE
    nrows = 2**31 - 8
    m1 = TE.make_rle_mask([nrows - 1000], [nrows - 500], nrows, capacity=3,
                          device="cpu")
    m2 = TE.make_rle_mask([nrows - 700], [nrows - 100], nrows, capacity=3,
                          device="cpu")
    s, e, cnt = TP.range_union(m1.starts, m1.ends, m1.n, m2.starts, m2.ends,
                               m2.n, nrows, cap_out=6)
    assert int(cnt) == 1
    assert int(s[0]) == nrows - 1000 and int(e[0]) == nrows - 100
