"""The slice as a whole: the port's Query pipeline (repro_torch.core.plan)
against repro's on the TPC-H-shaped queries of benchmarks/bench_tpch.py
(Q1, Q3, Q6, Q17, Q19) and examples/quickstart.py queries 1-3.

Each query runs on ~20K rows with RLE, Index and composite encodings
present, once on a port table ingested from the raw arrays and once on a
port table loaded from the JAX table's own buffers
(``convert.table_from_numpy``). The JAX side routes its Pallas kernels in
interpret mode; the port runs its default route and its kernel route (the
wrappers' plain versions on the CPU). Integers must match exactly, float
aggregates within rtol 1e-4. The port's pipelines are the ones
``chip_smoke.py`` drives on the card, and its numpy oracles are checked
here too.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from benchmarks import bench_tpch as B
from repro.core import compress as jc
from repro.core.plan import Query as JQuery, col as jcol
from repro.core.plan import pk_fk_gather as jgather, plan_signature as jsig
from repro.core.table import Table as JTable
from repro.kernels import dispatch as jdispatch
from repro_torch.core import compress as tc, convert
from repro_torch.core.encodings import decode_column
from repro_torch.core.plan import Query as TQuery, col as tcol
from repro_torch.core.plan import pk_fk_gather as tgather, plan_signature as tsig
from repro_torch.core.table import Table as TTable
from repro_torch.kernels import dispatch as tdispatch

from torch_twins import assert_close, assert_same, describe_table

N = 20_000
JAX_KERNELS = dict(use_pallas=True, interpret=True, bucketize_min_queries=0,
                   rle_decode_min_rows=0)
# the bench's ingest, plus one that forces Index / RLE+Index / Plain+Index
CONFIGS = {
    "heuristic": None,
    "forced": {"quantity": "rle_index", "discount": "index",
               "shipdate": "plain_index"},
}
QUERIES = ["Q1", "Q3", "Q6", "Q17", "Q19"]
# (query, config) where repro's answer is wrong and the port's is right:
# AND of an RLE+Index mask with a Plain mask returns an empty mask in
# repro.core.logical._and_composite (ROADMAP queue C)
REFERENCE_FAULTS = {("Q19", "forced")}


@pytest.fixture(scope="module")
def tpch():
    rng = np.random.default_rng(2)
    part_keys = np.unique(rng.integers(0, N // 30, N // 600)).astype(np.int32)
    orders = B.make_orders(rng, N // 4)
    data = {q: B.make_lineitem(rng, N, order=B.SORT_ORDERS[q]) for q in QUERIES}
    cfg = dict(plain_threshold=1000)
    ojax = JTable.from_arrays(orders, cfg=jc.CompressionConfig(**cfg))
    otorch = TTable.from_arrays(orders, cfg=tc.CompressionConfig(**cfg),
                                device="cpu")
    return dict(part_keys=part_keys, orders=orders, data=data, cfg=cfg,
                ojax=ojax, otorch=otorch)


def _jax_query(name, t, env):
    if name == "Q3":
        return B.q3(t, env["ojax"])
    if name in ("Q17", "Q19"):
        return getattr(B, name.lower())(t, env["part_keys"])
    return getattr(B, name.lower())(t)


def _assert_results(want, got, what):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), what
        for k in want:
            w = np.asarray(want[k])
            if np.issubdtype(w.dtype, np.integer):
                assert_same(w, got[k], f"{what} {k}")
            else:
                assert_close(w, got[k], f"{what} {k}")
        return
    ng = int(want.num_groups)
    assert int(got.num_groups) == ng, what
    assert_same(want.valid, got.valid, f"{what} valid")
    for k in want.keys:
        assert_same(want.keys[k], got.keys[k], f"{what} key {k}")
    for k in want.aggs:
        w = np.asarray(want.aggs[k])
        if np.issubdtype(w.dtype, np.integer):
            assert_same(w, got.aggs[k], f"{what} {k}")
        else:
            assert_close(w, got.aggs[k], f"{what} {k}")


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", QUERIES)
def test_tpch_query_parity(tpch, name, config):
    data = tpch["data"][name]
    enc = CONFIGS[config]
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(**tpch["cfg"]),
                            encodings=enc)
    tt = TTable.from_arrays(data, cfg=tc.CompressionConfig(**tpch["cfg"]),
                            encodings=enc, device="cpu")
    assert jt.encodings() == tt.encodings()
    if config == "forced":
        assert {"RLEIndexColumn", "IndexColumn", "PlainIndexColumn"} <= set(
            tt.encodings().values())
    with jdispatch.overrides(**JAX_KERNELS):
        want = _jax_query(name, jt, tpch).run()
    loaded = convert.table_from_numpy(describe_table(jt), device="cpu")
    oracle = chip_smoke.oracle(name, data, orders=tpch["orders"],
                               part_keys=tpch["part_keys"])
    for table, how in ((tt, "ingested"), (loaded, "loaded")):
        for route in (None, True):
            with tdispatch.overrides(use_kernels=route):
                q = chip_smoke.build_query(name, table, tpch["otorch"],
                                           tpch["part_keys"])
                got = q.run()
                again = q.run()
            what = f"{name} {config} {how} route={route}"
            if (name, config) in REFERENCE_FAULTS:
                with pytest.raises(AssertionError):
                    chip_smoke.check_answer(name, chip_smoke.host_result(want),
                                            oracle)
            else:
                _assert_results(want, got, what)
            # runs are bit-identical, and the answer matches the numpy oracle
            assert chip_smoke._bits(chip_smoke.host_result(got)) == \
                chip_smoke._bits(chip_smoke.host_result(again)), what
            chip_smoke.check_answer(name, chip_smoke.host_result(got), oracle)


def test_explain_and_signature_match_reference(tpch):
    data = tpch["data"]["Q1"]
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(**tpch["cfg"]))
    tt = TTable.from_arrays(data, cfg=tc.CompressionConfig(**tpch["cfg"]),
                            device="cpu")
    for name in ("Q1", "Q3", "Q17"):
        jq = _jax_query(name, jt, tpch)
        tq = chip_smoke.build_query(name, tt, tpch["otorch"], tpch["part_keys"])
        # line 0 names the package's query id; every op line must agree
        assert jq.explain().splitlines()[1:] == tq.explain().splitlines()[1:]
        if name != "Q3":  # a join keys its dimension table by identity
            assert jsig(jq.ops) == tsig(tq.ops)


def test_partial_build_decomposes_aggregates(tpch):
    data = tpch["data"]["Q1"]
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(**tpch["cfg"]))
    tt = TTable.from_arrays(data, cfg=tc.CompressionConfig(**tpch["cfg"]),
                            device="cpu")
    jq, tq = B.q1(jt), chip_smoke.build_query("Q1", tt)
    want = jq.build(partial=True)(jt.columns, ())
    got = tq.build(partial=True)(tt.columns, ())
    assert set(got.aggs) == {"sum_qty", "sum_price", "avg_disc@sum",
                             "avg_disc@cnt", "cnt"}
    _assert_results(want, got, "partial Q1")


def test_unported_query_features_raise(tpch):
    tt = TTable.from_arrays({"a": np.arange(10, dtype=np.int32)}, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        TQuery(tt).order_by("a", limit=3)
    with pytest.raises(NotImplementedError):
        TQuery(tt).aggregate({"c": ("count", None)}).explain_analyze()


# ---------------------------------------------------------------------------
# examples/quickstart.py queries 1-3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sales():
    rng = np.random.default_rng(0)
    n = 20_000
    data = {
        "region": np.sort(rng.integers(0, 8, n)).astype(np.int32),
        "store": np.sort(rng.integers(0, 500, n)).astype(np.int32),
        "units": rng.integers(1, 20, n).astype(np.int32),
        "revenue": np.where(rng.random(n) < 0.001, 2_000_000_000,
                            rng.integers(1, 5000, n)).astype(np.int32),
        "status": np.sort(rng.choice(["paid", "pending", "refund"], n,
                                     p=[.9, .07, .03])),
    }
    jt = JTable.from_arrays(data, cfg=jc.CompressionConfig(plain_threshold=200))
    tt = TTable.from_arrays(data, cfg=tc.CompressionConfig(plain_threshold=200),
                            device="cpu")
    return dict(data=data, jt=jt, tt=tt, rng=rng)


@pytest.mark.parametrize("route", [None, True])
def test_quickstart_query1_filtered_groupby(sales, route):
    jt, tt, d = sales["jt"], sales["tt"], sales["data"]
    assert jt.encodings() == tt.encodings()
    assert tt.encoding_of("revenue") == "PlainIndexColumn"
    aggs = {"total_units": ("sum", "units"), "orders": ("count", None)}
    with jdispatch.overrides(**JAX_KERNELS):
        want = (JQuery(jt).filter((jcol("status") == "paid") & (jcol("units") > 2))
                .groupby(["region"], aggs, num_groups_cap=16).run())
    with tdispatch.overrides(use_kernels=route):
        got = (TQuery(tt).filter((tcol("status") == "paid") & (tcol("units") > 2))
               .groupby(["region"], aggs, num_groups_cap=16).run())
    _assert_results(want, got, "quickstart 1")
    sel = (d["status"] == "paid") & (d["units"] > 2)
    ng = int(got.num_groups)
    for r, u in zip(got.keys["region"][:ng].tolist(),
                    got.aggs["total_units"][:ng].tolist()):
        assert int(u) == int(d["units"][sel & (d["region"] == r)].sum())


@pytest.mark.parametrize("route", [None, True])
def test_quickstart_query2_semijoin_aggregate(sales, route):
    jt, tt, d = sales["jt"], sales["tt"], sales["data"]
    whitelist = np.random.default_rng(1).choice(500, 40, replace=False
                                                ).astype(np.int32)
    aggs = {"revenue": ("sum", "revenue"), "n": ("count", None)}
    with jdispatch.overrides(**JAX_KERNELS):
        want = JQuery(jt).semi_join("store", whitelist).aggregate(aggs).run()
    with tdispatch.overrides(use_kernels=route):
        got = TQuery(tt).semi_join("store", whitelist).aggregate(aggs).run()
    _assert_results(want, got, "quickstart 2")
    assert int(got["n"]) == int(np.isin(d["store"], whitelist).sum())


@pytest.mark.parametrize("route", [None, True])
def test_quickstart_query3_pk_fk_gather(sales, route):
    jt, tt, d = sales["jt"], sales["tt"], sales["data"]
    dim_keys = np.arange(500, dtype=np.int32)
    payload = np.random.default_rng(2).integers(0, 5, 500).astype(np.int32)
    want = jgather(jt.columns["store"], jnp.asarray(dim_keys),
                   jnp.asarray(payload))
    with tdispatch.overrides(use_kernels=route):
        got = tgather(tt.columns["store"], torch.from_numpy(dim_keys),
                      torch.from_numpy(payload))
    assert type(got).__name__ == type(want).__name__ == "RLEColumn"
    np.testing.assert_array_equal(decode_column(got).numpy(),
                                  payload[d["store"]])
    from torch_twins import assert_same_encoded
    assert_same_encoded(want, got)
