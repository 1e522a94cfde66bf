"""Twins of tests/test_groupby_join.py and tests/test_sortfree_grouping.py:
group-by (§7: alignment, sort-free and argsort grouping, the hybrid
run-level path, run-aware aggregates) and joins (§8: join index, row
expansion, payload gathers, semi-join, PK-FK probe) held against repro on
the same seeded inputs. Grouping ids, keys, counts and every integer
buffer must match exactly; float aggregates within rtol 1e-4 (the
reference tests' tolerance)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import compress as jc, encodings as JE, groupby as JG, join as JJ
from repro.kernels import dispatch as jdispatch
from repro_torch.core import encodings as TE, groupby as TG, join as TJ
from repro_torch.kernels import dispatch as tdispatch

from torch_twins import (CPU, assert_close, assert_same, assert_same_encoded,
                         index_col_twins, mask_twins, rle_col_twins)

N = 64
CAP = N + 1
SPECS = [("s", "sum", "v"), ("c", "count", None), ("mn", "min", "v"),
         ("mx", "max", "v"), ("a", "avg", "v"), ("var", "var", "v"),
         ("sd", "std", "v")]


def _col(kind, vals, rng):
    if kind == "plain":
        return JE.make_plain(vals), TE.make_plain(vals, device=CPU)
    if kind == "rle":
        return rle_col_twins(vals, cap=CAP)
    return index_col_twins(vals, rng.random(len(vals)) < 0.7, cap=CAP)


def _assert_result(want, got, what):
    assert int(want.num_groups) == int(got.num_groups), what
    assert_same(want.valid, got.valid, f"{what} valid")
    for k in want.keys:
        assert_same(want.keys[k], got.keys[k], f"{what} key {k}")
    for k in want.aggs:
        w = np.asarray(want.aggs[k])
        if np.issubdtype(w.dtype, np.integer):
            assert_same(w, got.aggs[k], f"{what} {k}")
        else:
            assert_close(w, got.aggs[k], f"{what} {k}")


_MIXES = [(k, v, m) for k in ("plain", "rle", "index")
          for v in ("plain", "rle") for m in (None, "rle", "index", "plain")]


@pytest.mark.parametrize("kenc,venc,menc", _MIXES)
@pytest.mark.parametrize("domains", [False, True])
def test_groupby_aggregate(kenc, venc, menc, domains):
    rng = np.random.default_rng(len(kenc) * 31 + len(venc) * 7
                                + len(menc or "") + domains)
    keys = np.sort(rng.integers(-3, 4, N)).astype(np.int32)
    vals = np.repeat(rng.integers(0, 9, N // 4), 4).astype(np.float32)
    jk, tk = _col(kenc, keys, rng)
    jv, tv = _col(venc, vals, rng)
    jm = tm = None
    if menc:
        jm, tm = mask_twins(menc, rng.random(N) < 0.6, cap=CAP)
    doms = {"k": jc.column_domain(keys)} if domains else None
    want = JG.groupby_aggregate({"k": jk, "v": jv}, ["k"], SPECS, 16,
                                mask=jm, key_domains=doms)
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            got = TG.groupby_aggregate({"k": tk, "v": tv}, ["k"], SPECS, 16,
                                       mask=tm, key_domains=doms)
        _assert_result(want, got, f"{kenc}/{venc}/{menc} route={route}")


@pytest.mark.parametrize("sort_free", [True, False])
def test_multi_key_groupby(sort_free):
    rng = np.random.default_rng(4)
    k1 = np.sort(rng.integers(0, 3, N)).astype(np.int32)
    k2 = rng.integers(0, 4, N).astype(np.int8)
    v = rng.random(N).astype(np.float32)
    cols_j = {"a": rle_col_twins(k1, cap=CAP)[0], "b": JE.make_plain(k2),
              "v": JE.make_plain(v)}
    cols_t = {"a": rle_col_twins(k1, cap=CAP)[1],
              "b": TE.make_plain(k2, device=CPU), "v": TE.make_plain(v, device=CPU)}
    doms = {"a": (0, 3), "b": (0, 4)}
    with jdispatch.overrides(enable_sort_free=sort_free):
        want = JG.groupby_aggregate(cols_j, ["a", "b"], SPECS[:3], 16,
                                    key_domains=doms)
    with tdispatch.overrides(enable_sort_free=sort_free):
        got = TG.groupby_aggregate(cols_t, ["a", "b"], SPECS[:3], 16,
                                   key_domains=doms)
    _assert_result(want, got, f"sort_free={sort_free}")


def test_align_columns_run_level_view(rng):
    """All position-explicit inputs keep the view at run granularity."""
    k = np.sort(rng.integers(0, 3, N)).astype(np.int32)
    v = np.repeat(rng.integers(0, 5, N // 8), 8).astype(np.int32)
    jk, tk = rle_col_twins(k, cap=CAP)
    jv, tv = rle_col_twins(v, cap=CAP)
    jm, tm = mask_twins("rle", rng.random(N) < 0.5, cap=CAP)
    want = JG.align_columns({"k": jk, "v": jv}, mask=jm)
    got = TG.align_columns({"k": tk, "v": tv}, mask=tm)
    for f in ("lengths", "valid", "n", "starts", "ends"):
        assert_same(getattr(want, f), getattr(got, f), f)
    for name in want.values:
        assert_same(want.values[name], got.values[name], name)
    assert got.lengths.shape[0] <= 3 * CAP


@pytest.mark.parametrize("seed", range(3))
def test_join_index_and_row_expansion(seed):
    rng = np.random.default_rng(seed)
    lk = np.sort(rng.integers(0, 6, 20)).astype(np.int32)
    rk = np.sort(rng.integers(0, 6, 24)).astype(np.int32)
    jl, tl = rle_col_twins(lk, cap=21)
    jr, tr = JE.make_plain(rk), TE.make_plain(rk, device=CPU)
    cap = 20 * 24 + 4
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            ti = TJ.join_index(tl, tr, cap_pairs=cap)
            trows = TJ.expand_pairs_to_rows(ti, cap_rows=cap)
        ji = JJ.join_index(jl, jr, cap_pairs=cap)
        jrows = JJ.expand_pairs_to_rows(ji, cap_rows=cap)
        for f in ("left_entry", "right_entry", "left_start", "left_len",
                  "right_start", "right_len", "n", "total_rows"):
            assert_same(getattr(ji, f), getattr(ti, f), f)
        for w, g in zip(jrows, trows):
            assert_same(w, g, "expand")


@pytest.mark.parametrize("kind", ["plain", "rle", "index"])
def test_gather_rows(kind):
    rng = np.random.default_rng(len(kind))
    payload = np.sort(rng.integers(1, 6, N)).astype(np.int32)
    j, t = _col(kind, payload, rng)
    rows = rng.integers(0, N, 30).astype(np.int32)
    valid = rng.random(30) < 0.8
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            got = TJ.gather_rows(t, torch.from_numpy(rows),
                                 torch.from_numpy(valid))
        assert_same(JJ.gather_rows(j, jnp.asarray(rows), jnp.asarray(valid)),
                    got, kind)


@pytest.mark.parametrize("kind", ["plain", "rle", "index"])
@pytest.mark.parametrize("seed", range(2))
def test_semi_join_mask(kind, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 10, N)).astype(np.int32)
    dim = np.unique(rng.integers(0, 10, 5)).astype(np.int32)
    right = np.concatenate([dim, np.full(3, np.iinfo(np.int32).max, np.int32)])
    j, t = _col(kind, keys, rng)
    want = JJ.semi_join_mask(j, jnp.asarray(right),
                             jnp.asarray(len(dim), jnp.int32))
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            got = TJ.semi_join_mask(t, torch.from_numpy(right),
                                    torch.tensor(len(dim), dtype=torch.int32))
        assert_same_encoded(want, got, kind)


@pytest.mark.parametrize("kind", ["plain", "rle", "index", "rle_index"])
def test_pk_fk_join(kind):
    rng = np.random.default_rng(9)
    fk = np.sort(rng.integers(0, 40, N)).astype(np.int32)
    if kind == "rle_index":
        from torch_twins import encode_twins
        j, t = encode_twins(fk, {"plain_threshold": 10}, encoding="rle_index")
    else:
        j, t = _col(kind, fk, rng)
    dim = np.sort(rng.choice(40, 25, replace=False)).astype(np.int32)
    keys = np.concatenate([dim, np.full(7, np.iinfo(np.int32).max, np.int32)])
    pay = {"p": (np.arange(32) * 3 + 1).astype(np.int32),
           "f": (np.arange(32) / 4).astype(np.float32)}
    jm, jg = JJ.pk_fk_join(j, jnp.asarray(keys), jnp.asarray(25, jnp.int32),
                           {k: jnp.asarray(v) for k, v in pay.items()})
    for route in (None, True):
        with tdispatch.overrides(use_kernels=route):
            tm, tg = TJ.pk_fk_join(t, torch.from_numpy(keys),
                                   torch.tensor(25, dtype=torch.int32),
                                   {k: torch.from_numpy(v) for k, v in pay.items()})
        assert_same_encoded(jm, tm, f"{kind} mask")
        for name in pay:
            assert_same_encoded(jg[name], tg[name], f"{kind} {name}")


def test_sorted_unique_keys(rng):
    v = rng.integers(0, 9, 40).astype(np.int32)
    valid = rng.random(40) < 0.7
    want = JJ.sorted_unique_keys(jnp.asarray(v), jnp.asarray(valid), 16)
    got = TJ.sorted_unique_keys(torch.from_numpy(v), torch.from_numpy(valid), 16)
    for w, g in zip(want, got):
        assert_same(w, g)
