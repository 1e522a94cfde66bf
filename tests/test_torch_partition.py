"""Partitioned out-of-core execution of the port against the reference.

The twin of tests/test_partition.py. The same numpy inputs are ingested by
``repro.PartitionedTable`` and ``repro_torch.PartitionedTable`` on the
CPU: partitions, pow2 buckets, zone maps and encoded buffers must be
equal; ``PartitionedQuery`` answers must equal the reference's on all six
encodings, packed and not; a partition that zone maps prune is never
transferred (the module-level ``device_put`` is stubbed to count). The
TPC-H-shaped queries of ``chip_smoke.py`` run through the partitioned
path against their numpy oracles and the resident path.

Integers compare exactly; float sums within rtol 1e-4.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import compress as jc
from repro.core import partition as JP
from repro.core.plan import col as jcol
from repro_torch.core import arithmetic, compress as tc
from repro_torch.core import partition as TP
from repro_torch.core.faults import ValidationError
from repro_torch.core.plan import Query as TQuery, col
from repro_torch.core.table import Table as TTable
from repro_torch.kernels import dispatch

from torch_twins import (CPU, SIX_ENCODINGS, assert_payload_close,
                         assert_same_encoded, result_payload,
                         six_encoding_data)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

JCFG = jc.CompressionConfig(plain_threshold=1000)
TCFG = tc.CompressionConfig(plain_threshold=1000)


def _twins(data, pack=False, **split):
    j = JP.PartitionedTable.from_arrays(data, cfg=JCFG, pack=pack, **split)
    t = TP.PartitionedTable.from_arrays(data, cfg=TCFG, pack=pack,
                                        device=CPU, **split)
    return j, t


@pytest.fixture
def transfers(monkeypatch):
    """Count host->device transfers by stubbing the module-level
    ``device_put`` (one call per transferred partition)."""
    calls = []
    real = TP.device_put

    def counting(tree, device):
        calls.append(tree)
        return real(tree, device)

    monkeypatch.setattr(TP, "device_put", counting)
    return calls


# ---------------------------------------------------------------------------
# ingest: the same partitions as the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_partitions_match_reference(rng, enc, pack):
    data, encs = six_encoding_data(rng, enc, n=9_000)
    j, t = _twins(data, pack=pack, boundaries=[1000, 4100, 8999],
                  encodings=encs)
    assert len(t.partitions) == len(j.partitions) == 4
    assert t.domains == j.domains and t.col_dtypes == j.col_dtypes
    assert t.nbytes() == j.nbytes()
    assert t.nbytes_unpacked() == j.nbytes_unpacked()
    for pj, pt in zip(j.partitions, t.partitions):
        assert (pt.rows, pt.padded_rows, pt.row_offset) == \
            (pj.rows, pj.padded_rows, pj.row_offset)
        if pt.rows:  # pow2 row buckets
            assert pt.padded_rows & (pt.padded_rows - 1) == 0
        assert pt.zone_lo == pj.zone_lo and pt.zone_hi == pj.zone_hi
        for name in pj.table.columns:
            assert_same_encoded(pj.table.columns[name],
                                pt.table.columns[name], name)
    np.testing.assert_array_equal(t.decode("v"), j.decode("v"))
    t.validate()


@pytest.mark.parametrize("pack", [False, True])
def test_rows_for_budget_matches_reference(rng, pack):
    vocab = np.array([f"v{i:04d}" for i in range(500)])
    data = {"a": vocab[rng.integers(0, 500, 5000)],
            "u": rng.integers(0, 100, 5000).astype(np.int32),
            "f": rng.random(5000).astype(np.float32)}
    for budget in (1 << 16, 1 << 20):
        for depth in (0, 2):
            assert (TP.rows_for_budget(data, budget, pack=pack,
                                       prefetch_depth=depth)
                    == JP.rows_for_budget(data, budget, pack=pack,
                                          prefetch_depth=depth))
    with dispatch.overrides(enable_pack=False):
        assert (TP.rows_for_budget(data, 1 << 20, pack=True)
                == TP.rows_for_budget(data, 1 << 20))


def test_pinned_host_partitions_need_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.PartitionedTable.from_arrays({"a": np.arange(10, dtype=np.int32)},
                                        num_partitions=2)


# ---------------------------------------------------------------------------
# answers: the reference's, on all six encodings, packed and not
# ---------------------------------------------------------------------------


def _queries(P, c, pt, kf):
    yield (P.PartitionedQuery(pt).filter((c("k") == kf) | (c("v") > 500))
           .aggregate({"s": ("sum", "v"), "a": ("avg", "f"),
                       "m": ("min", "v"), "x": ("max", "f"),
                       "c": ("count", None)}))
    yield (P.PartitionedQuery(pt).filter(c("v") <= 1800)
           .groupby(["k"], {"s": ("sum", "v"), "a": ("avg", "f"),
                            "c": ("count", None)}, num_groups_cap=64))


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_partitioned_queries_match_reference(rng, enc, pack):
    data, encs = six_encoding_data(rng, enc)
    j, t = _twins(data, pack=pack, num_partitions=4, encodings=encs)
    kf = "key_010" if enc == "plain_dict" else 10
    want = [result_payload(q.run()) for q in _queries(JP, jcol, j, kf)]
    for kernels in (None, True):
        with dispatch.overrides(use_kernels=kernels):
            got = [result_payload(q.run()) for q in _queries(TP, col, t, kf)]
        for w, g in zip(want, got):
            assert_payload_close(w, g, f"{enc} pack={pack} kernels={kernels}")


@pytest.mark.parametrize("name", ["Q1", "Q3", "Q6", "Q17"])
def test_tpch_queries_partitioned_match_oracle_and_resident(name):
    """``chip_smoke.py``'s out-of-core phase at a small scale on the CPU:
    packed partitions, each answer against its numpy oracle and against
    the resident path, bit-identical across prefetch depths."""
    rng = np.random.default_rng(2)
    n = 40_000
    part_keys = np.unique(rng.integers(0, n // 30, n // 600)).astype(np.int32)
    orders = chip_smoke.make_orders(rng, n // 4)
    orders_table = TTable.from_arrays(orders, cfg=TCFG, device=CPU)
    data = chip_smoke.make_lineitem(rng, n, order=chip_smoke.SORT_ORDERS[name])
    want = chip_smoke.oracle(name, data, orders=orders, part_keys=part_keys)
    resident = TTable.from_arrays(data, cfg=TCFG, device=CPU)
    pt = TP.PartitionedTable.from_arrays(data, cfg=TCFG, partition_rows=1 << 13,
                                         pack=True, device=CPU)
    assert len(pt.partitions) == 5 and pt.partitions[-1].padded_rows == 8192
    got = {}
    for depth in (0, 1, 2):
        with dispatch.overrides(prefetch_depth=depth):
            q = chip_smoke.build_query(name, pt, orders_table, part_keys,
                                       query_cls=TP.PartitionedQuery)
            got[depth] = chip_smoke.host_result(q.run())
    chip_smoke.check_answer(name, got[0], want)
    for depth in (1, 2):
        assert chip_smoke._bits(got[depth]) == chip_smoke._bits(got[0])
    res = chip_smoke.host_result(chip_smoke.build_query(
        name, resident, orders_table, part_keys).run())
    chip_smoke.check_same(name, got[0], res)


# ---------------------------------------------------------------------------
# edge cases (the reference's own)
# ---------------------------------------------------------------------------


def test_empty_partitions_and_all_rows_filtered(rng):
    n = 10_000
    data = {"k": np.sort(rng.integers(0, 50, n)).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}
    j, t = _twins(data, boundaries=[2000, 2000, 7000, n - 1])
    assert [p.rows for p in t.partitions] == [2000, 0, 5000, n - 1 - 7000, 1]
    executed = []
    for expr_j, expr_t in (((jcol("k") >= 0), (col("k") >= 0)),
                           ((jcol("k") > 100), (col("k") > 100)),
                           ((jcol("k") == 10) & (jcol("v") > 2.0),
                            (col("k") == 10) & (col("v") > 2.0))):
        spec = {"c": ("count", None), "s": ("sum", "v")}
        want = JP.PartitionedQuery(j).filter(expr_j).aggregate(spec).run()
        q = TP.PartitionedQuery(t).filter(expr_t).aggregate(spec)
        assert_payload_close(result_payload(want), result_payload(q.run()))
        executed.append(q.last_stats["executed"])
    # the empty partition never runs; zone maps prove the others empty
    assert executed == [4, 0, 0]


def test_all_skipped_aggregates_keep_typed_identities(rng):
    n = 4000
    data = {"k": np.sort(rng.integers(0, 50, n)).astype(np.int32),
            "v": rng.integers(-7, 900, n).astype(np.int32),
            "f": rng.random(n).astype(np.float32)}
    j, t = _twins(data, num_partitions=4)
    spec = {"s": ("sum", "v"), "mn": ("min", "v"), "mx": ("max", "v"),
            "c": ("count", None), "fs": ("sum", "f")}
    want = JP.PartitionedQuery(j).filter(jcol("k") > 10_000).aggregate(spec)
    q = TP.PartitionedQuery(t).filter(col("k") > 10_000).aggregate(spec)
    got = result_payload(q.run())
    assert q.last_stats["executed"] == 0
    assert_payload_close(result_payload(want.run()), got)
    assert got["mn"] == np.iinfo(np.int64).max and got["fs"].dtype == np.float32


def test_groupby_merge_of_disjoint_groups(rng):
    k = np.repeat(np.arange(8, dtype=np.int32), 1000)
    v = rng.random(8000).astype(np.float32)
    j, t = _twins({"k": k, "v": v}, partition_rows=2000)
    spec = {"s": ("sum", "v"), "mn": ("min", "v"), "mx": ("max", "v"),
            "a": ("avg", "v"), "c": ("count", None)}
    want = JP.PartitionedQuery(j).groupby(["k"], spec, num_groups_cap=16).run()
    got = TP.PartitionedQuery(t).groupby(["k"], spec, num_groups_cap=16).run()
    assert got.num_groups == 8
    assert_payload_close(result_payload(want), result_payload(got))


def test_map_rebinding_disables_stale_zone_maps():
    data = {"v": np.full(1000, 5, np.int32)}
    _, t = _twins(data, num_partitions=4)
    q = (TP.PartitionedQuery(t)
         .map("v", lambda env: arithmetic.scalar_op(env["v"], "add", 100))
         .filter(col("v") > 50).aggregate({"c": ("count", None)}))
    assert int(q.run()["c"]) == 1000  # mapped values are 105 everywhere
    assert q.last_stats["skipped"] == 0


def test_nan_and_float64_zone_maps(rng):
    v = rng.random(800).astype(np.float32) * 10
    v[100] = np.nan
    _, t = _twins({"v": v}, num_partitions=4)
    r = (TP.PartitionedQuery(t).filter(col("v") > 2.0)
         .aggregate({"c": ("count", None)}).run())
    with np.errstate(invalid="ignore"):
        assert int(r["c"]) == int((v > 2.0).sum())
    # 999.99999999 rounds to 1000.0 in float32: pruning sees the narrowed
    # value, as the device does
    _, t = _twins({"v": np.full(512, 999.99999999, np.float64)},
                  num_partitions=4)
    r = (TP.PartitionedQuery(t).filter(col("v") >= 1000.0)
         .aggregate({"c": ("count", None)}).run())
    assert int(r["c"]) == 512


def test_one_program_built_per_query(rng):
    data = {"a": np.sort(rng.integers(0, 20, 4000)).astype(np.int32)}
    _, t = _twins(data, num_partitions=4)
    q = (TP.PartitionedQuery(t).filter(col("a") > 3)
         .aggregate({"c": ("count", None)}))
    want = int((data["a"] > 3).sum())
    assert int(q.run(jit=False)["c"]) == want
    assert int(q.run()["c"]) == want
    assert q.trace_count == 1  # programs built, not partitions run


def test_requires_terminal_aggregate_and_order_by_waits():
    _, t = _twins({"a": np.arange(100, dtype=np.int32)}, num_partitions=2)
    with pytest.raises(NotImplementedError):
        TP.PartitionedQuery(t).filter(col("a") > 3).run()
    # order_by is a terminal of its own (A10): the ranked merge runs
    r = TP.PartitionedQuery(t).order_by("a", limit=3).run()
    assert r.n == 3 and r.positions.tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# zone-map pushdown: a pruned partition is never transferred
# ---------------------------------------------------------------------------


def test_partition_skip_saves_transfers(rng, transfers):
    n = 40_000
    data = {"date": np.sort(rng.integers(0, 1000, n)).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}
    _, t = _twins(data, num_partitions=8)
    lo = int(t.partitions[3].zone_lo["date"])
    hi = int(t.partitions[3].zone_hi["date"])
    q = (TP.PartitionedQuery(t).filter(col("date").between(lo, hi))
         .aggregate({"c": ("count", None), "s": ("sum", "v")}))
    r = q.run()
    sel = (data["date"] >= lo) & (data["date"] <= hi)
    assert int(r["c"]) == int(sel.sum())
    np.testing.assert_allclose(float(r["s"]), data["v"][sel].sum(dtype=np.float64),
                               rtol=1e-4)
    assert len(transfers) == q.last_stats["executed"] <= 3
    assert q.last_stats["skipped"] >= 5
    before = len(transfers)
    q2 = (TP.PartitionedQuery(t).filter(col("date") > 10_000)
          .aggregate({"c": ("count", None)}))
    assert int(q2.run()["c"]) == 0
    assert len(transfers) == before  # no partition touched the device
    assert "k" not in str(q2.last_stats["pruned_by"])


def test_semi_join_and_join_zone_skips(rng, transfers):
    n = 20_000
    data = {"fk": np.sort(rng.integers(0, 1000, n)).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}
    j, t = _twins(data, num_partitions=10)
    keys = np.arange(0, 80, dtype=np.int32)  # only the first zone range
    q = (TP.PartitionedQuery(t).semi_join("fk", keys)
         .aggregate({"c": ("count", None)}))
    assert int(q.run()["c"]) == int(np.isin(data["fk"], keys).sum())
    assert q.last_stats["skipped"] > 0
    assert len(transfers) == q.last_stats["executed"]

    dim = {"id": np.arange(1000, dtype=np.int32),
           "seg": (np.arange(1000) % 7).astype(np.int32)}
    from repro.core.table import Table as JTable
    jd = JTable.from_arrays(dim, cfg=JCFG)
    td = TTable.from_arrays(dim, cfg=TCFG, device=CPU)
    spec = {"s": ("sum", "v"), "c": ("count", None)}
    want = (JP.PartitionedQuery(j).join(jd, fk="fk", on="id", cols=["seg"],
                                        where=jcol("id") < 150)
            .groupby(["seg"], spec, num_groups_cap=8).run())
    transfers.clear()
    q = (TP.PartitionedQuery(t).join(td, fk="fk", on="id", cols=["seg"],
                                     where=col("id") < 150)
         .groupby(["seg"], spec, num_groups_cap=8))
    assert_payload_close(result_payload(want), result_payload(q.run()))
    assert q.last_stats["skipped"] >= 7  # FK zone-map pushdown
    assert len(transfers) == q.last_stats["executed"]
    assert "join: no dimension key" in " ".join(q.last_stats["pruned_by"])


def test_explain_analyze_reconciles_with_transfers(rng, transfers):
    data = {"date": np.sort(rng.integers(0, 1000, 20_000)).astype(np.int32),
            "v": rng.integers(0, 9, 20_000).astype(np.int32)}
    _, t = _twins(data, num_partitions=6, pack=True)
    q = (TP.PartitionedQuery(t).filter(col("date") < 400)
         .aggregate({"s": ("sum", "v")}))
    assert "estimated partitions: visit 3 / skip 3 of 6" in q.explain()
    text = q.explain_analyze()
    a = q.last_analysis
    assert a["executed"] == len(transfers) == a["transfers_seen"] == 3
    assert a["bytes_moved"] == sum(p.nbytes() for p in t.partitions[:3])
    assert a["bytes_total"] == t.nbytes() and a["trace_count"] == 1
    assert "3 executed / 3 zone-pruned of 6" in text
    assert "stage ms: h2d" in text


def test_partitioned_validate_catches_stale_zone_map(rng):
    data = {"k": np.sort(rng.integers(0, 50, 4000)).astype(np.int32)}
    _, t = _twins(data, num_partitions=4, pack=True)
    t.validate()
    t.partitions[2].zone_hi["k"] = t.partitions[2].zone_hi["k"] + 5
    with pytest.raises(ValidationError, match="zone map"):
        t.validate()
