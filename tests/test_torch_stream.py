"""The port's streamed executor against the reference (DESIGN.md §12).

The twin of tests/test_stream.py:

  1. the pipeline drivers with synthetic callbacks (no tensors): the port's
     ``pipelined_fold`` / ``pipelined_ranked_fold`` issue the same
     transfer/compute/fold sequence as the reference's at every depth, and
     ``clamp_depth`` does the same budget arithmetic;
  2. depth invariance: partitioned answers are bit-identical at prefetch
     depth 0/1/4 on all six encodings (packed), and equal the reference's;
  3. release of retired partitions: once a partition's partial is folded,
     no reference to the tensors transferred for an earlier partition is
     left (``weakref``s on them), so the allocator can recycle them;
  4. the budget clamp, budget-derived partition rows and the stage keys
     of ``last_stats``.
"""
import gc
import weakref

import numpy as np
import pytest

from repro.core import compress as jc
from repro.core import partition as JP
from repro.core import stream as jstream
from repro.core.plan import col as jcol
from repro.core.table import Table as JTable
from repro.kernels import dispatch as jdispatch
from repro_torch.core import compress as tc
from repro_torch.core import groupby as tgroupby
from repro_torch.core import partition as TP
from repro_torch.core import stream as tstream
from repro_torch.core.encodings import tensor_leaves
from repro_torch.core.plan import col
from repro_torch.core.table import Table as TTable
from repro_torch.kernels import dispatch

from torch_twins import (CPU, SIX_ENCODINGS, assert_payload_close,
                         assert_payload_same, result_payload,
                         six_encoding_data)

JCFG = jc.CompressionConfig(plain_threshold=1000)
TCFG = tc.CompressionConfig(plain_threshold=1000)
DEPTHS = (0, 1, 4)


# ---------------------------------------------------------------------------
# 1. the drivers, with synthetic callbacks
# ---------------------------------------------------------------------------


def _fold_events(mod, items, depth, nbytes=None):
    stats = mod.StreamStats(prefetch_depth=depth)
    events = []

    def transfer(x):
        events.append(("put", x))
        return x

    def compute(x, cols):
        events.append(("exec", x))
        return cols * 10

    def fold(acc, x, partial):
        events.append(("fold", x))
        return acc + [partial]

    out = mod.pipelined_fold(items, transfer, compute, fold, [], depth,
                             stats, nbytes_of=nbytes)
    return out, events, stats


@pytest.mark.parametrize("depth", [0, 1, 2, 4, 7])
def test_pipelined_fold_order_and_counts(depth):
    items = list(range(5))
    out, events, stats = _fold_events(tstream, items, depth)
    assert out == [x * 10 for x in items]  # folded strictly in order
    assert [x for k, x in events if k == "fold"] == items
    assert stats.transferred == stats.executed == 5
    for i, (kind, x) in enumerate(events):  # ring occupancy
        if kind == "put":
            assert x <= len([1 for k, _ in events[:i] if k == "fold"]) + depth
    ref_out, _, ref_stats = _fold_events(jstream, items, depth)
    assert out == ref_out
    assert stats.as_dict().keys() == ref_stats.as_dict().keys()
    assert (stats.transferred, stats.executed) == \
        (ref_stats.transferred, ref_stats.executed)


def test_pipelined_fold_inflight_bytes_and_empty():
    for depth, want in ((0, 100), (3, 400)):
        _, _, s = _fold_events(tstream, list(range(6)), depth,
                               nbytes=lambda x: 100)
        _, _, r = _fold_events(jstream, list(range(6)), depth,
                               nbytes=lambda x: 100)
        assert s.inflight_bytes_max == r.inflight_bytes_max == want
    out, events, stats = _fold_events(tstream, [], 2)
    assert out == [] and events == [] and stats.transferred == 0


def test_pending_values_wait_on_their_own_event():
    waited = []

    class Event:
        def synchronize(self):
            waited.append(1)

    tstream._block(tstream.Pending(3, Event()))
    tstream._block(tstream.Pending(3))  # nothing pending (CPU)
    tstream._block(7)  # plain values are ready as they are
    assert waited == [1]


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_pipelined_ranked_fold_gates_execution(depth):
    """Items arrive best-first; the bound forms after the first fold and
    prunes every later item: exactly ONE executes at any depth, and
    speculation wastes at most ``depth`` transfers."""
    for mod in (tstream, jstream):
        executed = []
        stats = mod.StreamStats(prefetch_depth=depth)

        def compute(x, cols):
            executed.append(x)
            return x

        state, skipped, wasted = mod.pipelined_ranked_fold(
            [5, 4, 3, 2, 1], lambda x: x, compute,
            lambda s, x, p: (s or []) + [p],
            lambda state, x: state is not None, depth, stats)
        assert executed == [5] and state == [5] and skipped == 4
        assert wasted <= depth
        assert stats.transferred == stats.executed + wasted


def test_clamp_depth_matches_reference():
    cases = [(4, 100, None), (4, 100, 1000), (4, 100, 150), (8, 100, 250),
             (1, 100, 50), (0, 100, 10), (3, 0, 10)]
    for depth, part, budget in cases:
        with _maybe_warns(depth, part, budget):
            got = tstream.clamp_depth(depth, part, budget)
        with _maybe_warns(depth, part, budget):
            want = jstream.clamp_depth(depth, part, budget)
        assert got == want, (depth, part, budget)
    with pytest.warns(UserWarning, match="clamping"):
        assert tstream.clamp_depth(4, 100, 150) == 1


def _maybe_warns(depth, part, budget):
    import contextlib
    fits = budget is None or part <= 0 or depth <= 1 \
        or depth <= max(budget // part, 1)
    return contextlib.nullcontext() if fits else \
        pytest.warns(UserWarning, match="clamping")


# ---------------------------------------------------------------------------
# 2. depth invariance, against the reference
# ---------------------------------------------------------------------------


def _agg_and_groupby(P, c, pt, kf):
    yield (P.PartitionedQuery(pt).filter((c("k") == kf) | (c("v") > 500))
           .aggregate({"s": ("sum", "v"), "a": ("avg", "f"),
                       "m": ("min", "v"), "c": ("count", None)}))
    yield (P.PartitionedQuery(pt).filter(c("v") <= 1800)
           .groupby(["k"], {"s": ("sum", "v"), "a": ("avg", "f")},
                    num_groups_cap=64))


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_depth_invariance_all_encodings(rng, enc, pack):
    data, encs = six_encoding_data(rng, enc)
    kf = "key_010" if enc == "plain_dict" else 10
    jp = JP.PartitionedTable.from_arrays(data, cfg=JCFG, num_partitions=5,
                                         encodings=encs, pack=pack)
    tp = TP.PartitionedTable.from_arrays(data, cfg=TCFG, num_partitions=5,
                                         encodings=encs, pack=pack,
                                         device=CPU)
    want = [result_payload(q.run()) for q in _agg_and_groupby(JP, jcol, jp, kf)]
    base = None
    for depth in DEPTHS:
        with dispatch.overrides(prefetch_depth=depth):
            got = [result_payload(q.run())
                   for q in _agg_and_groupby(TP, col, tp, kf)]
        if base is None:
            base = got
            for w, g in zip(want, got):
                assert_payload_close(w, g, f"{enc} pack={pack} vs reference")
            continue
        for b, g in zip(base, got):  # identical fold order: bit-identical
            assert_payload_same(b, g, f"{enc} pack={pack} depth={depth}")


def test_depth_invariance_join_pipeline(rng):
    """The dimension side is prepared once per run and shared by every
    partition's program, at any depth."""
    n = 8_000
    fact = {"fk": rng.integers(0, 50, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32)}
    dim = {"id": np.arange(50, dtype=np.int32),
           "seg": (np.arange(50, dtype=np.int32) % 4)}
    jd = JTable.from_arrays(dim, cfg=JCFG)
    td = TTable.from_arrays(dim, cfg=TCFG, device=CPU)
    jp = JP.PartitionedTable.from_arrays(fact, cfg=JCFG, num_partitions=6)
    want = result_payload(JP.PartitionedQuery(jp)
                          .join(jd, fk="fk", cols=["seg"], on="id")
                          .groupby(["seg"], {"s": ("sum", "v")},
                                   num_groups_cap=8).run())
    tp = TP.PartitionedTable.from_arrays(fact, cfg=TCFG, num_partitions=6,
                                         device=CPU)
    for depth in DEPTHS:
        with dispatch.overrides(prefetch_depth=depth):
            got = result_payload(TP.PartitionedQuery(tp)
                                 .join(td, fk="fk", cols=["seg"], on="id")
                                 .groupby(["seg"], {"s": ("sum", "v")},
                                          num_groups_cap=8).run())
        assert_payload_close(want, got, f"depth={depth}")


# ---------------------------------------------------------------------------
# 3. retired partitions are released
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_retired_partitions_are_released(rng, monkeypatch, depth):
    """When partition ``i``'s partial is folded, nothing holds the tensors
    transferred for partitions before ``i`` any more (the eager meaning of
    the reference's buffer donation), and a re-run stays correct."""
    n = 96
    data = {"k": np.array([f"g{i % 13:02d}" for i in range(n)]),
            "v": (rng.random(n) * 100).astype(np.float32)}
    pt = TP.PartitionedTable.from_arrays(data, cfg=TCFG, partition_rows=16,
                                         device=CPU)
    refs = []  # per transferred partition: weakrefs to its tensors
    real_put = TP.device_put

    def recording(tree, device):
        out = real_put(tree, device)
        refs.append([weakref.ref(t) for t in tensor_leaves(out)])
        return out

    alive_at_fold = []
    real_fold = tgroupby.fold_groupby_partial

    def checking(acc, r, *a):
        gc.collect()
        folded = len(alive_at_fold)
        alive_at_fold.append(sum(w() is not None for part in refs[:folded]
                                 for w in part))
        return real_fold(acc, r, *a)

    monkeypatch.setattr(TP, "device_put", recording)
    monkeypatch.setattr(tgroupby, "fold_groupby_partial", checking)
    q = (TP.PartitionedQuery(pt).filter(col("v") < 90)
         .groupby(["k"], {"s": ("sum", "v")}, num_groups_cap=16))
    with dispatch.overrides(prefetch_depth=depth):
        r1 = q.run()
        assert len(refs) == q.last_stats["executed"] == 6
        assert alive_at_fold == [0] * 6
        gc.collect()
        assert all(w() is None for part in refs for w in part)
        r2 = q.run()
    assert_payload_same(result_payload(r1), result_payload(r2))
    keep = data["v"] < 90
    want = [data["v"][keep][data["k"][keep] == g].sum(dtype=np.float64)
            for g in np.unique(data["k"][keep])]
    np.testing.assert_allclose(r1.aggs["s"], want, rtol=1e-4)


# ---------------------------------------------------------------------------
# 4. budget clamp, budget-derived partitions, stage keys
# ---------------------------------------------------------------------------


def test_budget_clamps_runtime_depth(rng):
    data = {"k": rng.integers(0, 10, 20_000).astype(np.int32),
            "v": rng.integers(0, 100, 20_000).astype(np.int32)}
    budget = sum(a.nbytes for a in data.values()) // 4
    pt = TP.PartitionedTable.from_arrays(data, cfg=TCFG, num_partitions=8,
                                         budget_bytes=budget, device=CPU)
    q = TP.PartitionedQuery(pt).aggregate({"s": ("sum", "v")})
    with dispatch.overrides(prefetch_depth=6):
        with pytest.warns(UserWarning, match="clamping"):
            q.run()
    assert q.last_stats["prefetch_depth"] < 6
    assert (q.last_stats["inflight_bytes_max"]
            <= (q.last_stats["prefetch_depth"] + 1)
            * pt.max_partition_nbytes())


def test_budget_bytes_derives_partition_rows(rng):
    data = {"v": rng.integers(0, 100, 50_000).astype(np.int32),
            "f": rng.random(50_000).astype(np.float32)}
    sizes = {}
    for depth in (0, 3):
        with dispatch.overrides(prefetch_depth=depth), \
                jdispatch.overrides(prefetch_depth=depth):
            t = TP.PartitionedTable.from_arrays(data, cfg=TCFG,
                                                budget_bytes=1 << 16,
                                                device=CPU)
            j = JP.PartitionedTable.from_arrays(data, cfg=JCFG,
                                                budget_bytes=1 << 16)
        assert [p.rows for p in t.partitions] == [p.rows for p in j.partitions]
        sizes[depth] = t
    assert len(sizes[3].partitions) >= 4 * len(sizes[0].partitions) - 4
    got = TP.PartitionedQuery(sizes[0]).aggregate({"s": ("sum", "v")}).run()
    assert int(got["s"]) == int(np.sum(data["v"], dtype=np.int64))


def test_last_stats_observability_keys(rng):
    data = {"k": rng.integers(0, 10, 9_000).astype(np.int32),
            "v": rng.integers(0, 100, 9_000).astype(np.int32)}
    pt = TP.PartitionedTable.from_arrays(data, cfg=TCFG, num_partitions=5,
                                         device=CPU)
    q = (TP.PartitionedQuery(pt)
         .groupby(["k"], {"s": ("sum", "v")}, num_groups_cap=16))
    q.run()
    s = q.last_stats
    for key in ("h2d_ms", "compute_ms", "merge_ms", "prefetch_depth",
                "inflight_bytes_max", "transferred", "partitions",
                "executed", "skipped", "retries", "degradations", "qid"):
        assert key in s, key
    assert s["prefetch_depth"] == dispatch.policy().prefetch_depth
    assert s["h2d_ms"] >= 0 and s["compute_ms"] > 0 and s["merge_ms"] > 0
    assert s["transferred"] == s["executed"] == 5
    assert 0 < s["inflight_bytes_max"] <= (
        (s["prefetch_depth"] + 1) * pt.max_partition_nbytes())
