"""Ingest and decoding parity of the port (repro_torch.core.{compress,
table,encodings,convert}) with repro: the same host arrays give the same
chosen encodings, buffers, capacities, counts, domains and dictionaries,
and every encoding decodes to the same values on both packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import compress as jc, encodings as JE
from repro.core.table import Table as JTable
from repro.kernels import dispatch as jdispatch
from repro_torch.core import compress as tc, convert, encodings as TE
from repro_torch.core.table import Table as TTable
from repro_torch.kernels import dispatch as tdispatch

from torch_twins import (CPU, assert_same, assert_same_encoded,
                         describe_table, encode_twins, mask_twins)


def _columns(kind, rng, n=6000):
    if kind == "rle":
        return np.repeat(rng.integers(0, 5, 60), rng.integers(50, 150, 60)
                         ).astype(np.int32)
    if kind == "plain_index":
        return np.where(rng.random(n) < 0.01, 2**28,
                        rng.integers(0, 90, n)).astype(np.int32)
    if kind == "rle_index":
        runs = np.repeat(rng.integers(0, 5, 30), 40)
        noise = rng.integers(100, 200, 300)
        return np.concatenate([runs, noise, runs]).astype(np.int32)
    if kind == "centered_int8":
        return (rng.integers(0, 100, n) + 100000).astype(np.int32)
    if kind == "centered_int16":
        return (rng.integers(-20000, 20000, n)).astype(np.int32)
    if kind == "zero_center_int8":
        return rng.integers(0, 2, n).astype(np.int32)
    if kind == "wide_plain":
        return rng.integers(0, 2**20, n).astype(np.int32)
    if kind == "float":
        return (rng.random(n) * 1000).astype(np.float32)
    if kind == "float64_runs":
        return np.repeat(rng.random(40), 150)
    if kind == "bool":
        return np.sort(rng.random(n) < 0.3)
    if kind == "int64_small":
        return np.sort(rng.integers(0, 7, n))
    raise ValueError(kind)


_KINDS = ["rle", "plain_index", "rle_index", "centered_int8",
          "centered_int16", "zero_center_int8", "wide_plain", "float",
          "float64_runs", "bool", "int64_small"]


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("cfg", [{"plain_threshold": 100},
                                 {"plain_threshold": 100,
                                  "capacity_bucket": "pow2",
                                  "capacity_slack": 1.5}])
def test_encode_parity(rng, kind, cfg):
    vals = _columns(kind, rng)
    j, t = encode_twins(vals, cfg)
    assert_same_encoded(j, t, kind)


@pytest.mark.parametrize("force", ["plain", "rle", "index", "rle_index",
                                   "plain_index"])
def test_forced_encoding_parity(rng, force):
    vals = _columns("rle_index", rng)
    j, t = encode_twins(vals, {"plain_threshold": 100}, encoding=force)
    assert_same_encoded(j, t, force)


def test_heuristics_and_stats_match(rng):
    for kind in _KINDS:
        vals = _columns(kind, rng)
        js, ts = jc.analyze(vals), tc.analyze(vals)
        assert vars(js) == vars(ts), kind
        for thr in (100, 10**7):
            assert (jc.choose_encoding(js, jc.CompressionConfig(plain_threshold=thr))
                    == tc.choose_encoding(ts, tc.CompressionConfig(plain_threshold=thr)))
        assert jc.column_domain(vals) == tc.column_domain(vals)
        assert jc.column_is_sorted(vals) == tc.column_is_sorted(vals)
        assert jc.column_minmax(vals) == tc.column_minmax(vals)


@pytest.mark.parametrize("lo", [2**53 + 1, 2**60])
def test_wide_domains_dictionary_encode(lo):
    """Integers past int32 (the 2^53+1 / 2^60 domains) are
    dictionary-encoded at ingest identically on both packages."""
    vals = np.array([lo, lo + 1, lo + 7, lo + 1] * 300, np.int64)
    data = {"w": vals, "k": np.arange(1200, dtype=np.int32) % 5}
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(plain_threshold=100))
    tt = TTable.from_arrays(data, cfg=tc.CompressionConfig(plain_threshold=100),
                            device="cpu")
    _assert_tables_equal(jt, tt)
    np.testing.assert_array_equal(tt.decode("w"), vals)
    with pytest.raises(ValueError):
        tc.encode(vals, device="cpu")


def _assert_tables_equal(jt, tt):
    a, b = describe_table(jt), describe_table(tt)
    assert a["nrows"] == b["nrows"]
    assert a["domains"] == b["domains"]
    assert a["dictionaries"].keys() == b["dictionaries"].keys()
    for k in a["dictionaries"]:
        np.testing.assert_array_equal(a["dictionaries"][k], b["dictionaries"][k])
    assert a["columns"].keys() == b["columns"].keys()
    for name in a["columns"]:
        assert_same_encoded(a["columns"][name], b["columns"][name], name)


@pytest.mark.parametrize("order", ["Q1", "Q6", "Q17"])
def test_table_ingest_parity_tpch(rng, order):
    from benchmarks.bench_tpch import SORT_ORDERS, make_lineitem
    data = make_lineitem(rng, 20_000, order=SORT_ORDERS[order])
    data["status"] = np.sort(rng.choice(["paid", "pending", "refund"], 20_000))
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(plain_threshold=1000))
    tt = TTable.from_arrays(data, cfg=tc.CompressionConfig(plain_threshold=1000),
                            device="cpu")
    _assert_tables_equal(jt, tt)
    assert jt.encodings() == tt.encodings()
    assert jt.nbytes() == tt.nbytes()
    for name in data:
        np.testing.assert_array_equal(jt.decode(name), tt.decode(name))
        assert jt.code_for(name, "paid") == tt.code_for(name, "paid")
    assert jt.sorted_order("partkey") is None or np.array_equal(
        jt.sorted_order("partkey"), tt.sorted_order("partkey"))


def test_table_from_numpy_carries_reference_state(rng):
    """A repro table's description loads into the port unchanged, and the
    port's own description round-trips."""
    data = {"k": np.sort(rng.integers(0, 9, 5000)).astype(np.int32),
            "v": np.where(rng.random(5000) < 0.02, 10**7,
                          rng.integers(0, 50, 5000)).astype(np.int32),
            "s": np.sort(rng.choice(["a", "b", "c"], 5000))}
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(plain_threshold=100))
    state = describe_table(jt)
    tt = convert.table_from_numpy(state, device="cpu")
    _assert_tables_equal(jt, tt)
    back = convert.table_from_numpy(convert.table_to_numpy(tt), device="cpu")
    _assert_tables_equal(jt, back)
    assert isinstance(tt.columns["v"].base.offset, int)


def test_from_arrays_pack_is_not_ported(rng):
    """Left out of slice 1 and ported with the out-of-core slice: ``pack=True``
    ingest gives the reference's packed buffers, and ``validate()`` runs."""
    from repro.core.table import Table as JTable
    from repro_torch.core.encodings import PackedColumn
    data = {"a": np.arange(10, dtype=np.int32)}
    t = TTable.from_arrays(data, pack=True, device="cpu")
    assert isinstance(t.columns["a"].values, PackedColumn)
    assert_same_encoded(JTable.from_arrays(data, pack=True).columns["a"],
                        t.columns["a"])
    assert t.validate() is t
    assert TTable.from_arrays(data, device="cpu").validate() is not None


# ---------------------------------------------------------------------------
# decode_column / decode_mask for every encoding, on both dispatch routes
# ---------------------------------------------------------------------------

_ROUTES = {
    "default": ({}, {}),
    "kernel": ({"use_pallas": True, "interpret": True,
                "bucketize_min_queries": 0, "rle_decode_min_rows": 0},
               {"use_kernels": True}),
}


def _gapped_columns(rng):
    """(repro, repro_torch) pairs of gapped RLE / Index columns."""
    n = 3000
    starts = np.array([5, 700, 2047, 2900], np.int32)
    ends = np.array([90, 1500, 2500, 2999], np.int32)
    vals = np.array([1.5, -2.0, 3.25, 8.0], np.float32)
    rle = (JE.make_rle(vals, starts, ends, n, capacity=9),
           TE.make_rle(vals, starts, ends, n, capacity=9, device=CPU))
    pos = np.sort(rng.choice(n, 40, replace=False)).astype(np.int32)
    iv = rng.integers(-50, 50, 40).astype(np.int32)
    idx = (JE.make_index(iv, pos, n, capacity=48),
           TE.make_index(iv, pos, n, capacity=48, device=CPU))
    return {"gapped_rle": rle, "gapped_index": idx}


@pytest.mark.parametrize("route", list(_ROUTES))
@pytest.mark.parametrize("kind", _KINDS + ["gapped_rle", "gapped_index"])
def test_decode_column_parity(rng, route, kind):
    if kind.startswith("gapped"):
        j, t = _gapped_columns(rng)[kind]
    else:
        j, t = encode_twins(_columns(kind, rng), {"plain_threshold": 100})
    jo, to = _ROUTES[route]
    for fill in (0, 7):
        with jdispatch.overrides(**jo):
            want = JE.decode_column(j, fill)
            want_cov = JE.coverage(j)
        with tdispatch.overrides(**to):
            got = TE.decode_column(t, fill)
            got_cov = TE.coverage(t)
        assert_same(want, got, f"{kind} fill={fill}")
        assert_same(want_cov, got_cov, f"{kind} coverage")


@pytest.mark.parametrize("kind", ["plain", "rle", "index"])
def test_decode_mask_parity(rng, kind):
    d = rng.random(700) < 0.4
    d[100:300] = True
    j, t = mask_twins(kind, d)
    assert_same(JE.decode_mask(j), TE.decode_mask(t))
    np.testing.assert_array_equal(TE.decode_mask(t).numpy(), d)


def test_decode_composite_mask_and_lengths(rng):
    d1 = rng.random(400) < 0.5
    d2 = rng.random(400) < 0.1
    jr, tr = mask_twins("rle", d1)
    ji, ti = mask_twins("index", d2)
    jm = JE.RLEIndexMask(rle=jr, idx=ji, nrows=400)
    tm = TE.RLEIndexMask(rle=tr, idx=ti, nrows=400)
    assert_same(JE.decode_mask(jm), TE.decode_mask(tm))
    assert_same(jr.lengths, tr.lengths)


def test_helpers_follow_jax_index_semantics():
    x = torch.arange(5, dtype=torch.int32) * 10
    jx = jnp.arange(5, dtype=jnp.int32) * 10
    idx = np.array([0, 4, 5, 7, -1, -6], np.int32)
    assert_same(jx[jnp.asarray(idx)], TE.take_clamped(x, torch.from_numpy(idx)))
    upd = np.array([-1, 5, -6, 2], np.int32)
    want = jnp.zeros(5).at[jnp.asarray(upd)].set(1.0, mode="drop")
    got = TE.scatter_drop(torch.zeros(5), torch.from_numpy(upd), 1.0, "set")
    assert_same(np.asarray(want), got)
    want = jnp.zeros(5, jnp.int32).at[jnp.asarray(upd)].add(3, mode="drop")
    got = TE.scatter_drop(torch.zeros(5, dtype=torch.int32),
                          torch.from_numpy(upd), 3, "add")
    assert_same(want, got)


@pytest.mark.parametrize("how", ["set", "add", "amin", "amax"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scatter_drop_mostly_dropped_matches_jax(rng, how, dtype):
    """``scatter_drop`` with more than 90% of the updates out of range (at
    size, above it, below -size) or negative (in [-size, -1], which wrap
    once, as JAX's do) equals ``.at[idx].<how>(src, mode="drop")``
    exactly; the dropped updates spread over the spare block."""
    size, n = 64, 20_000
    idx = rng.integers(size, 3 * size, n)
    pick = rng.random(n)
    idx[pick < 0.5] = size
    idx[pick < 0.3] = rng.integers(-3 * size, -size, int((pick < 0.3).sum()))
    live = np.zeros(n, bool)
    if how == "set":  # one update a slot, so the winner is defined
        slots = rng.choice(size, size // 2, replace=False)
        where = rng.choice(n, len(slots), replace=False)
        idx[where] = np.where(rng.random(len(slots)) < 0.5, slots,
                              slots - size)
    else:
        where = rng.random(n) < 0.05
        idx[where] = rng.integers(-size, size, int(where.sum()))
    live[where] = True
    assert (~live).mean() > 0.9
    idx = idx.astype(np.int32)
    src = rng.integers(-500, 500, n).astype(dtype)
    base = rng.integers(-9, 9, size).astype(dtype)
    jx = jnp.asarray(base).at[jnp.asarray(idx)]
    jop = {"set": jx.set, "add": jx.add, "amin": jx.min, "amax": jx.max}[how]
    want = jop(jnp.asarray(src), mode="drop")
    got = TE.scatter_drop(torch.from_numpy(base), torch.from_numpy(idx),
                          torch.from_numpy(src), how)
    assert_same(want, got, how)
