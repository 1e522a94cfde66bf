"""ORDER BY / TOP-K / LIMIT of the port against the reference.

The twin of tests/test_orderby.py: every test there has a test of the
same name here. The same numpy inputs, made from a fixed seed, go through
``repro`` and ``repro_torch`` (``device="cpu"``) and the pandas
``sort_values(kind="stable")`` oracle. Ranked results must agree with the
reference element for element: positions, decoded columns and ``n``
(gathered floats are stored values, so they compare exactly too);
group-by aggregates compare integers exactly and float sums within the
reference tests' rtol 1e-4. Each ranking path (bounded histogram, entry
sort, row-level top-k, and the row-level route through the kernel
wrapper) is forced through ``dispatch.overrides``. Transfers are counted
with the port's own ``telemetry.h2d_listener``.
"""
import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

from repro.core import compress as jc  # noqa: E402
from repro.core.partition import (PartitionedQuery as JPQuery,  # noqa: E402
                                  PartitionedTable as JPTable)
from repro.core.plan import Query as JQuery, col as jcol  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch.core import compress as tc  # noqa: E402
from repro_torch.core import order as order_mod, plan, telemetry  # noqa: E402
from repro_torch.core.partition import (PartitionedQuery,  # noqa: E402
                                        PartitionedTable)
from repro_torch.core.plan import Query, col  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

from torch_twins import CPU, assert_payload_close, result_payload  # noqa: E402

JCFG = jc.CompressionConfig(plain_threshold=1000)
CFG = tc.CompressionConfig(plain_threshold=1000)

ENCODINGS = [None, "plain", "rle", "index", "rle_index", "plain_index"]


def make_data(rng, n=20_000, n_keys=50):
    return {
        "k": np.sort(rng.integers(0, n_keys, n)).astype(np.int32),  # RLE-able
        "v": rng.integers(0, 1000, n).astype(np.int32),
        "f": rng.random(n).astype(np.float32),
        "s": rng.choice([f"C{i:02d}" for i in range(20)], n),
    }


def tables(data, **kw):
    """(repro Table, repro_torch Table) of the same arrays."""
    return (JTable.from_arrays(data, cfg=JCFG, **kw),
            Table.from_arrays(data, cfg=CFG, device=CPU, **kw))


def ptables(data, **kw):
    return (JPTable.from_arrays(data, cfg=JCFG, **kw),
            PartitionedTable.from_arrays(data, cfg=CFG, device=CPU, **kw))


def oracle(df, by, ascending, k=None):
    out = df.sort_values(by, ascending=ascending, kind="stable")
    return out.head(k) if k is not None else out


def check(res, want, cols=("k", "v")):
    np.testing.assert_array_equal(res.positions, want.index.values)
    for c in cols:
        if np.asarray(want[c].values).dtype.kind == "f":
            np.testing.assert_allclose(res.columns[c], want[c].values,
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(res.columns[c], want[c].values)


def assert_ranked_same(want, got, what=""):
    """Two RankedTables (reference, port) equal element for element."""
    assert isinstance(got, order_mod.RankedTable), what
    assert got.n == want.n, what
    np.testing.assert_array_equal(got.positions, np.asarray(want.positions),
                                  err_msg=what)
    assert got.positions.dtype == np.asarray(want.positions).dtype, what
    assert set(got.columns) == set(want.columns), what
    for c, w in want.columns.items():
        w, g = np.asarray(w), np.asarray(got.columns[c])
        assert g.dtype == w.dtype, f"{what} {c}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {c}")


def run_both(jt, tt, stage, **ov):
    """Stage the same pipeline on both packages (``stage(q, col)``) and run
    it under the same policy overrides; returns (reference, port)."""
    with jdispatch.overrides(**ov), dispatch.overrides(**ov):
        jr = stage(JQuery(jt) if isinstance(jt, JTable) else JPQuery(jt),
                   jcol).run()
        tr = stage(Query(tt) if isinstance(tt, Table) else
                   PartitionedQuery(tt), col).run()
    return jr, tr


@pytest.fixture
def transfer_counter():
    """Host->device transfers of the port, counted by its own telemetry
    listener (one call per transferred partition)."""
    calls = []
    with telemetry.h2d_listener(lambda nbytes, tree: calls.append(tree)):
        yield calls


# ---------------------------------------------------------------------------
# single-table conformance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("key", ["k", "v", "f", "s"])
def test_top_k_single_key(rng, key, desc):
    data = make_data(rng)
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    jr, r = run_both(jt, tt, lambda q, c: q.order_by(key, descending=desc,
                                                     limit=13))
    w = oracle(df, key, not desc, 13)
    check(r, w, cols=("k", "v", "f", "s"))
    assert r.n == 13
    assert_ranked_same(jr, r, key)


def test_ties_are_stable_row_order(rng):
    n = 5_000
    data = {"k": rng.integers(0, 4, n).astype(np.int32),
            "v": np.arange(n, dtype=np.int32)}
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    for desc in (False, True):
        jr, r = run_both(jt, tt, lambda q, c: q.order_by(
            "k", descending=desc, limit=50))
        check(r, oracle(df, "k", not desc, 50))
        assert_ranked_same(jr, r, f"desc={desc}")


def test_multi_key_mixed_directions(rng):
    data = make_data(rng)
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    jr, r = run_both(jt, tt, lambda q, c: q.filter(c("v") > 300).order_by(
        ["s", "f"], descending=[True, False], limit=19))
    w = oracle(df[df.v > 300], ["s", "f"], [False, True], 19)
    check(r, w, cols=("s", "f", "v"))
    assert_ranked_same(jr, r)


def test_nan_keys_rank_last_both_directions(rng):
    n = 2_000
    f = rng.random(n).astype(np.float32)
    f[rng.choice(n, 300, replace=False)] = np.nan
    data = {"f": f, "v": np.arange(n, dtype=np.int32)}
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    for desc in (False, True):
        jr, r = run_both(jt, tt, lambda q, c: q.order_by(
            "f", descending=desc, limit=n))
        w = oracle(df, "f", not desc)
        np.testing.assert_array_equal(r.positions, w.index.values)
        assert_ranked_same(jr, r, f"desc={desc}")


def test_nan_ranks_after_real_infinities(rng):
    """NaN keys rank strictly after genuine +/-inf values, on the dense
    (Plain) and entry-sort (RLE) paths, with entry ordering on and off,
    and on the partitioned merge."""
    f = np.array([np.nan, np.nan, -np.inf, -np.inf, np.inf, 5.0, 1.0,
                  np.nan, -np.inf, np.inf, 2.0, 3.0] * 4, np.float32)
    data = {"f": f, "v": np.arange(len(f), dtype=np.int32)}
    df = pd.DataFrame(data)
    plain = tables(data)
    rle = tables(data, encodings={"f": "rle"})
    parts = ptables(data, num_partitions=4)
    for desc in (False, True):
        want = oracle(df, "f", not desc)
        for jt, tt in (plain, rle):
            for ov in ({}, {"enable_entry_order": False}):
                jr, r = run_both(jt, tt, lambda q, c: q.order_by(
                    "f", descending=desc, limit=len(f)), **ov)
                np.testing.assert_array_equal(r.positions,
                                              want.index.values, (desc, ov))
                assert_ranked_same(jr, r, f"{desc} {ov}")
        jr, r = run_both(*parts, lambda q, c: q.order_by(
            "f", descending=desc, limit=len(f)))
        np.testing.assert_array_equal(r.positions, want.index.values)
        assert_ranked_same(jr, r, f"partitioned desc={desc}")


def test_limit_beyond_survivors_and_no_limit(rng):
    data = make_data(rng, n=3_000)
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    jr, r = run_both(jt, tt, lambda q, c: q.filter(c("v") > 990).order_by(
        "v", limit=500))
    w = oracle(df[df.v > 990], "v", True)
    assert r.n == len(w) < 500
    check(r, w)
    assert_ranked_same(jr, r, "limit beyond survivors")
    jr2, r2 = run_both(jt, tt, lambda q, c: q.order_by(["k", "v"],
                                                       limit=None))
    assert r2.n == len(df)
    check(r2, oracle(df, ["k", "v"], True))
    assert_ranked_same(jr2, r2, "no limit")


def test_empty_after_filter(rng):
    data = make_data(rng, n=2_000)
    jt, tt = tables(data)
    jr, r = run_both(jt, tt, lambda q, c: q.filter(c("v") > 10**6).order_by(
        "v", limit=5))
    assert r.n == 0
    assert len(r.positions) == 0
    assert len(r.columns["v"]) == 0
    assert_ranked_same(jr, r)


def test_paths_agree(rng):
    """Bounded-domain, entry-sort and row-level paths (the last also
    through the kernel wrapper) give identical ranked output, and each
    forced path is the one EXPLAIN names on both packages."""
    data = make_data(rng)
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    paths = (("bounded", {}, "bounded-histogram rank"),
             ("entry", {"sort_free_max_domain": 0}, "entry-granularity sort"),
             ("rowlevel", {"enable_entry_order": False}, "row-level top-k"))
    # the reference test's query: a Plain second key keeps every override
    # on the row-level path
    want = oracle(df, ["k", "v"], [False, True], 21)
    for name, ov, _ in paths:
        jr, r = run_both(jt, tt, lambda q, c: q.order_by(
            ["k", "v"], descending=[True, False], limit=21), **ov)
        np.testing.assert_array_equal(r.positions, want.index.values, name)
        assert_ranked_same(jr, r, name)
    # the RLE dict-domain key alone takes each path in turn
    want = oracle(df, "k", False, 300)
    for name, ov, path in paths:
        def stage(q, c):
            return q.order_by("k", descending=True, limit=300, cols=["v"])
        jr, r = run_both(jt, tt, stage, **ov)
        check(r, want)
        assert_ranked_same(jr, r, name)
        with jdispatch.overrides(**ov), dispatch.overrides(**ov):
            jq, q = stage(JQuery(jt), jcol), stage(Query(tt), col)
            assert q._order_path(q.order_op()) == \
                jq._order_path(jq.order_op())
            assert path in q.explain(), name
    # the row-level route of a single Plain key through the kernel wrapper
    # (its plain version on CPU tensors), recorded as the kernel route
    telemetry.reset()
    with dispatch.overrides(use_kernels=True, enable_trace=True):
        r = Query(tt).order_by("v", descending=True, limit=21).run()
        assert telemetry.registry().counter("route.topk.kernel") == 1
    telemetry.reset()
    check(r, oracle(df, "v", False, 21))


def test_order_by_cols_subset_and_validation(rng):
    data = make_data(rng, n=2_000)
    jt, tt = tables(data)
    jr, r = run_both(jt, tt, lambda q, c: q.order_by(
        "v", descending=True, limit=5, cols=["s"]))
    assert set(r.columns) == {"s", "v"}  # keys always ride along
    assert_ranked_same(jr, r)
    with pytest.raises(ValueError):
        Query(tt).order_by("v", limit=0)
    with pytest.raises(ValueError):
        Query(tt).order_by("v", descending=[True, False])
    with pytest.raises(ValueError):
        Query(tt).aggregate({"c": ("count", None)}).order_by("c")
    with pytest.raises(KeyError):
        (Query(tt).groupby(["k"], {"c": ("count", None)})
         .order_by("nope"))
    q = Query(tt).order_by("v")
    with pytest.raises(ValueError):
        q.order_by("k")
    q = Query(tt).order_by("v")
    q.ops.append(plan._FilterOp(col("v") > 3))  # staged behind the ranking
    with pytest.raises(ValueError, match="last op"):
        q.build()


# ---------------------------------------------------------------------------
# ordering composes with the rest of the pipeline
# ---------------------------------------------------------------------------


def test_order_on_join_gathered_column(rng):
    """Ranking on a dimension attribute gathered through a PK-FK join,
    with the dimension's dictionary decoding the output."""
    n = 8_000
    fact = {"fk": rng.integers(0, 40, n).astype(np.int32),
            "v": rng.integers(0, 100, n).astype(np.int32)}
    dim = {"fk": np.arange(40, dtype=np.int32),
           "name": np.array([f"N{i:02d}" for i in range(40)]),
           "w": rng.integers(0, 1000, 40).astype(np.int32)}
    jt, tt = tables(fact)
    jd, td = tables(dim)
    jr = (JQuery(jt).join(jd, fk="fk", cols=["name", "w"])
          .order_by(["w", "v"], descending=[True, False], limit=11).run())
    r = (Query(tt).join(td, fk="fk", cols=["name", "w"])
         .order_by(["w", "v"], descending=[True, False], limit=11).run())
    m = pd.DataFrame(fact).merge(pd.DataFrame(dim), on="fk")
    m = m.set_index(pd.DataFrame(fact).index)  # merge keeps fact order here
    w = oracle(m, ["w", "v"], [False, True], 11)
    np.testing.assert_array_equal(r.positions, w.index.values)
    np.testing.assert_array_equal(r.columns["name"], w.name.values)
    np.testing.assert_array_equal(r.columns["w"], w.w.values)
    assert_ranked_same(jr, r)


def test_order_groupby_result(rng):
    data = make_data(rng)
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    jr, r = run_both(jt, tt, lambda q, c: q.groupby(
        ["s"], {"rev": ("sum", "f"), "c": ("count", None)},
        num_groups_cap=64).order_by("rev", descending=True, limit=6))
    wg = (df.groupby("s").agg(rev=("f", "sum"), c=("f", "size"))
          .reset_index().sort_values("rev", ascending=False, kind="stable")
          .head(6))
    ng = int(r.num_groups)
    assert ng == 6
    np.testing.assert_allclose(r.aggs["rev"].numpy()[:ng], wg.rev.values,
                               rtol=1e-4)
    np.testing.assert_array_equal(r.aggs["c"].numpy()[:ng], wg.c.values)
    # the whole slot buffers (padding included) agree with the reference
    assert r.valid.shape[0] == np.asarray(jr.valid).shape[0] == 64
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(jr.valid))
    assert_payload_close(result_payload(jr), result_payload(r), "groupby")


def test_string_range_pushdown_matches_pandas(rng):
    """Range literals on dictionary columns push down via searchsorted
    boundary codes — exact and absent literals, all four operators, plus
    between() — without decoding, as in the reference."""
    data = make_data(rng, n=4_000)
    df = pd.DataFrame(data)
    jt, tt = tables(data)

    def count(pred):
        got = int(Query(tt).filter(pred(col)).aggregate(
            {"c": ("count", None)}).run()["c"])
        ref = int(JQuery(jt).filter(pred(jcol)).aggregate(
            {"c": ("count", None)}).run()["c"])
        assert got == ref
        return got

    assert count(lambda c: c("s") < "C07") == int((df.s < "C07").sum())
    assert count(lambda c: c("s") <= "C07") == int((df.s <= "C07").sum())
    assert count(lambda c: c("s") > "C12") == int((df.s > "C12").sum())
    assert count(lambda c: c("s") >= "C12") == int((df.s >= "C12").sum())
    assert count(lambda c: c("s") < "C07x") == int((df.s < "C07x").sum())
    assert count(lambda c: c("s") >= "C07x") == int((df.s >= "C07x").sum())
    assert count(lambda c: c("s") <= "A") == 0
    assert count(lambda c: c("s") > "ZZZ") == 0
    assert count(lambda c: c("s").between("C05", "C11x")) == int(
        df.s.between("C05", "C11x").sum())


def test_string_range_zone_map_pruning(rng, transfer_counter):
    """Range literals also prune partitions (zone maps on codes)."""
    n = 8_000
    data = {"s": np.sort(rng.choice([f"C{i:02d}" for i in range(40)], n)),
            "v": rng.integers(0, 100, n).astype(np.int32)}
    df = pd.DataFrame(data)
    jpt, pt = ptables(data, num_partitions=8)
    q = (PartitionedQuery(pt).filter(col("s") >= "C35")
         .aggregate({"c": ("count", None)}))
    assert int(q.run()["c"]) == int((df.s >= "C35").sum())
    assert q.last_stats["skipped"] >= 5
    assert len(transfer_counter) == q.last_stats["executed"]
    jq = (JPQuery(jpt).filter(jcol("s") >= "C35")
          .aggregate({"c": ("count", None)}))
    jq.run()
    assert jq.last_stats["skipped"] == q.last_stats["skipped"]


# ---------------------------------------------------------------------------
# partitioned == single-table, across the six key encodings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc", ENCODINGS)
def test_partitioned_equivalence_all_encodings(rng, enc):
    data = make_data(rng, n=12_000)
    df = pd.DataFrame(data)
    encodings = {"k": enc} if enc else None
    single = tables(data, encodings=encodings)
    parts = ptables(data, num_partitions=5, encodings=encodings)
    want = oracle(df[df.v > 200], ["k", "f"], [False, True], 15)

    def stage(q, c):
        return q.filter(c("v") > 200).order_by(
            ["k", "f"], descending=[True, False], limit=15)

    for jt, tt in (single, parts):
        jr, r = run_both(jt, tt, stage)
        np.testing.assert_array_equal(r.positions, want.index.values)
        np.testing.assert_array_equal(r.columns["k"], want.k.values)
        np.testing.assert_array_equal(r.columns["s"], want.s.values)
        assert_ranked_same(jr, r, f"{enc} {type(tt).__name__}")


def test_partitioned_groupby_order_matches_single(rng):
    data = make_data(rng, n=12_000)
    df = pd.DataFrame(data)
    jt, tt = tables(data)
    jpt, pt = ptables(data, num_partitions=4)
    wg = (df.groupby("k").agg(rev=("f", "sum")).reset_index()
          .sort_values("rev", ascending=False, kind="stable").head(7))

    def stage(q, c):
        return q.groupby(["k"], {"rev": ("sum", "f")},
                         num_groups_cap=64).order_by("rev", descending=True,
                                                     limit=7)

    jrs, rs = run_both(jt, tt, stage)
    jrp, rp = run_both(jpt, pt, stage)
    ngs = int(rs.num_groups)
    assert ngs == rp.num_groups == 7
    np.testing.assert_array_equal(rs.keys["k"].numpy()[:ngs], wg.k.values)
    np.testing.assert_array_equal(rp.keys["k"], wg.k.values)
    np.testing.assert_allclose(rp.aggs["rev"], wg.rev.values, rtol=1e-4)
    assert_payload_close(result_payload(jrs), result_payload(rs), "single")
    assert_payload_close(result_payload(jrp), result_payload(rp),
                         "partitioned")


# ---------------------------------------------------------------------------
# ranked zone-map pruning: held-bound partitions are never transferred
# ---------------------------------------------------------------------------


def test_ranked_pruning_skips_transfers(rng, transfer_counter):
    """On a clustered order key, holding k rows with bound B proves
    partitions whose key zone map cannot beat B contribute nothing — they
    are never transferred. Pinned to ``prefetch_depth=0``, where transfers
    == executed; the speculative depth >= 1 contract is in
    tests/test_torch_stream.py."""
    n = 40_000
    data = {"k": np.sort(rng.integers(0, 500, n)).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32)}
    df = pd.DataFrame(data)
    jpt, pt = ptables(data, num_partitions=8)
    want = oracle(df, "k", False, 10)

    with dispatch.overrides(prefetch_depth=0), \
            jdispatch.overrides(prefetch_depth=0):
        q = PartitionedQuery(pt).order_by("k", descending=True, limit=10)
        r = q.run()
        np.testing.assert_array_equal(r.positions, want.index.values)
        pruned_transfers = len(transfer_counter)
        assert q.last_stats["ranked_skipped"] >= 5
        assert pruned_transfers == q.last_stats["executed"] <= 3
        assert q.last_stats["prefetch_wasted"] == 0
        jq = JPQuery(jpt).order_by("k", descending=True, limit=10)
        assert_ranked_same(jq.run(), r)
        for key in ("executed", "skipped", "ranked_skipped",
                    "prefetch_wasted"):
            assert q.last_stats[key] == jq.last_stats[key], key
        text = PartitionedQuery(pt).order_by(
            "k", descending=True, limit=10).explain_analyze()
        assert "ranked-pruned" in text

        # pruning disabled: every partition transfers
        q2 = PartitionedQuery(pt).order_by("k", descending=True, limit=10)
        q2.ranked_pruning = False
        before = len(transfer_counter)
        r2 = q2.run()
        np.testing.assert_array_equal(r2.positions, r.positions)
        assert len(transfer_counter) - before == 8 > pruned_transfers

        # ascending ranks prune from the other end
        q3 = PartitionedQuery(pt).order_by("k", limit=10)
        r3 = q3.run()
        np.testing.assert_array_equal(r3.positions,
                                      oracle(df, "k", True, 10).index.values)
        assert q3.last_stats["ranked_skipped"] >= 5


def test_ranked_pruning_ties_at_bound_still_execute(rng):
    """A partition whose zone map EQUALS the k-th bound may still win the
    row-id tiebreak — it must execute, not skip, at every depth."""
    k = np.concatenate([np.full(100, 5, np.int32),
                        np.full(100, 3, np.int32),
                        np.full(100, 5, np.int32)])
    data = {"k": k, "v": np.arange(300, dtype=np.int32)}
    jpt, pt = ptables(data, boundaries=[100, 200])
    want = oracle(pd.DataFrame(data), "k", False, 150)
    jr = JPQuery(jpt).order_by("k", descending=True, limit=150).run()
    for depth in (0, 1, 2):
        with dispatch.overrides(prefetch_depth=depth):
            q = PartitionedQuery(pt).order_by("k", descending=True, limit=150)
            r = q.run()
        np.testing.assert_array_equal(r.positions, want.index.values)
        assert_ranked_same(jr, r, f"depth {depth}")
        assert q.last_stats["executed"] == 2
        assert q.last_stats["ranked_skipped"] == 1


# ---------------------------------------------------------------------------
# top-k routing + parity (the kernel's own twins: test_torch_kernels.py)
# ---------------------------------------------------------------------------


def test_topk_kernel_routes_and_matches(rng):
    import jax
    import jax.numpy as jnp

    xn = rng.integers(0, 97, 20_000).astype(np.int32)
    x = torch.from_numpy(xn)
    want_v, want_i = jax.lax.top_k(jnp.asarray(xn), 37)
    telemetry.reset()
    with dispatch.overrides(use_kernels=True, topk_min_rows=1,
                            enable_trace=True):
        got_v, got_i = dispatch.topk(x, 37)
        assert telemetry.registry().counter("route.topk.kernel") == 1
        # k beyond the policy's limit takes the plain route (no error)
        with dispatch.overrides(topk_max_k=8):
            v, i = dispatch.topk(x, 16)
        assert telemetry.registry().counter("route.topk.torch") == 1
    telemetry.reset()
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32
    jv, ji = jax.lax.top_k(jnp.asarray(xn), 16)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # floats with ties, through the default (auto) route
    xf = rng.choice([0.5, 1.5, -2.0, 3.25], 10_000).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(xf), 64)
    got_v, got_i = dispatch.topk(torch.from_numpy(xf), 64)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
