"""Engine-wide telemetry of the port against the reference (DESIGN.md §14).

The twin of tests/test_telemetry.py. Each scenario runs through
``repro`` and ``repro_torch`` on the CPU (one function, handed either
package) and the two observations must be equal:

  1. registry units — span/instant/counter recording, the bounded event
     ring, Chrome trace-event export, the disabled path's shared no-op
     span;
  2. ``StreamStats`` completeness — ``as_dict`` covers every field, and
     the port's fields are the reference's;
  3. EXPLAIN / EXPLAIN ANALYZE — the plan tree, the zone-map estimate, and
     the analyzed run's movement report reconciling exactly with
     ``last_stats`` and an H2D listener;
  4. wiring — per-partition executor spans, zone-map verdicts with the
     responsible bound, dispatch routing records (the port's non-kernel
     route is ``torch_scatter``), the always-on H2D counters;
  5. concurrency + cost — traced concurrent serving reconciles per-query
     attribution with ticket stats, and trace-ON wall stays within the
     reference's bound of trace-OFF on the streamed path (port only: the
     bound is a property of the port's own instrumentation).
"""
import dataclasses
import json
import statistics
import threading
import time
import types

import numpy as np
import torch

from repro.core import compress as jc
from repro.core import stream as jstream
from repro.core import telemetry as jtelemetry
from repro.core.partition import PartitionedQuery as JPQ
from repro.core.partition import PartitionedTable as JPT
from repro.core.partition import partition_match_verdict as jverdict
from repro.core.plan import Query as JQuery
from repro.core.plan import col as jcol
from repro.core.serve import QueryServer as JQueryServer
from repro.core.table import Table as JTable
from repro.kernels import dispatch as jdispatch
from repro_torch.core import compress as tc
from repro_torch.core import stream, telemetry
from repro_torch.core.partition import (
    PartitionedQuery,
    PartitionedTable,
    partition_match_verdict,
)
from repro_torch.core.plan import Query, col
from repro_torch.core.serve import QueryServer
from repro_torch.core.table import Table
from repro_torch.kernels import dispatch

from torch_twins import CPU, assert_payload_close, host

REF = types.SimpleNamespace(
    name="repro", PT=JPT, PQ=JPQ, Q=JQuery, T=JTable, col=jcol,
    Server=JQueryServer, telemetry=jtelemetry, dispatch=jdispatch,
    stream=jstream, verdict=jverdict,
    cfg=jc.CompressionConfig(plain_threshold=1000), dev={})
PORT = types.SimpleNamespace(
    name="repro_torch", PT=PartitionedTable, PQ=PartitionedQuery, Q=Query,
    T=Table, col=col, Server=QueryServer, telemetry=telemetry,
    dispatch=dispatch, stream=stream, verdict=partition_match_verdict,
    cfg=tc.CompressionConfig(plain_threshold=1000), dev={"device": CPU})


def _both(scenario, *args):
    """``scenario`` through the reference, then the port; the observation
    dicts must be equal (``answer*`` keys within rtol 1e-4)."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith("answer"):
            assert_payload_close(w, got[key], key)
        else:
            assert got[key] == w, (key, got[key], w)
    return got


def _clustered_pt(P, n=24_000, parts=8):
    """qty-clustered partitioned table: zone maps are selective."""
    rng = np.random.default_rng(0)
    data = {
        "qty": np.sort(rng.integers(0, 1000, n)).astype(np.int32),
        "units": rng.integers(0, 100, n).astype(np.int32),
        "region": rng.integers(0, 5, n).astype(np.int32),
    }
    return P.PT.from_arrays(data, cfg=P.cfg, num_partitions=parts, **P.dev)


# ---------------------------------------------------------------------------
# 1. registry units
# ---------------------------------------------------------------------------


def test_span_records_only_when_enabled():
    def scenario(P):
        tel = P.telemetry
        tel.reset()
        with tel.span("cold", "device", qid=7):
            pass
        assert tel.registry().events(name="cold") == []  # default: off
        assert tel.span("a") is tel.span("b")  # ONE shared no-op object
        with P.dispatch.overrides(enable_trace=True):
            with tel.span("hot", "device", qid=7, part=3):
                pass
            tel.instant("mark", "main", qid=7)
        (ev,) = tel.registry().events(name="hot")
        assert ev["dur"] > 0
        (mk,) = tel.registry().events(name="mark")
        assert mk["dur"] == 0.0
        return {"hot": (ev["track"], ev["attrs"]), "mark": mk["attrs"],
                "trace": sorted(e["name"] for e in tel.query_trace(7))}

    got = _both(scenario)
    assert got["hot"] == ("device", {"qid": 7, "part": 3})
    assert got["trace"] == ["hot", "mark"]


def test_counters_accumulate_and_reset():
    def scenario(P):
        tel = P.telemetry
        tel.reset()
        tel.add_counter("x")
        tel.add_counter("x", 4)
        obs = {"x": tel.registry().counter("x"),
               "all": tel.registry().counters()["x"]}
        tel.reset()
        obs["after_reset"] = tel.registry().counter("x")
        return obs

    assert _both(scenario) == {"x": 5, "all": 5, "after_reset": 0}


def test_event_ring_drops_oldest_and_counts():
    def scenario(P):
        tel = P.telemetry
        tel.reset()
        with P.dispatch.overrides(enable_trace=True, trace_buffer_events=16):
            for i in range(40):
                tel.instant("e", seq=i)
            evs = tel.registry().events(name="e")
            return {"seqs": [e["attrs"]["seq"] for e in evs],
                    "dropped": tel.registry().dropped,
                    "counter": tel.registry().counter("dropped_events")}

    got = _both(scenario)
    assert got == {"seqs": list(range(24, 40)), "dropped": 24, "counter": 24}


def test_chrome_trace_export(tmp_path):
    def scenario(P):
        tel = P.telemetry
        tel.reset()
        with P.dispatch.overrides(enable_trace=True):
            with tel.span("work", "device", qid=1):
                pass
            tel.instant("h2d", "transfer", bytes=64, skipped=None)
        path = tel.export_chrome_trace(str(tmp_path / f"{P.name}.json"))
        with open(path) as f:
            doc = json.load(f)
        evs = doc["traceEvents"]
        names = {e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert set(tel.TRACKS) <= names  # one named row per track
        (x,) = [e for e in evs if e["ph"] == "X"]
        assert x["dur"] > 0 and x["ts"] >= 0
        (i,) = [e for e in evs if e["ph"] == "i"]
        return {"tracks": sorted(names), "x": x["name"],
                "i": (i["s"], i["args"]), "unit": doc["displayTimeUnit"]}

    got = _both(scenario)
    assert got["i"] == ("t", {"bytes": 64})  # None-valued attrs filtered
    assert got["unit"] == "ms"


def test_env_knobs():
    for env in ({"REPRO_TRACE": "1", "REPRO_TRACE_BUFFER": "128"},
                {"REPRO_TRACE": "0"}, {}):
        got = dispatch.policy_from_env(env)
        want = jdispatch.policy_from_env(env)
        assert (got.enable_trace, got.trace_buffer_events) == \
            (want.enable_trace, want.trace_buffer_events)
    assert dispatch.policy_from_env({}).enable_trace is False  # auto: off


# ---------------------------------------------------------------------------
# 2. StreamStats completeness
# ---------------------------------------------------------------------------


def test_streamstats_as_dict_is_field_complete():
    fields = [f.name for f in dataclasses.fields(stream.StreamStats)]
    assert fields == [f.name for f in dataclasses.fields(jstream.StreamStats)]
    st = stream.StreamStats()
    # populate EVERY field non-default so a dropped key is detectable
    for i, name in enumerate(fields):
        setattr(st, name, i + 1)
    d = st.as_dict()
    assert set(d) == set(fields)
    assert d["executed"] == fields.index("executed") + 1


# ---------------------------------------------------------------------------
# 3. EXPLAIN / EXPLAIN ANALYZE
# ---------------------------------------------------------------------------


def test_explain_renders_plan_and_estimate():
    def scenario(P):
        pt = _clustered_pt(P)
        q = (P.PQ(pt).filter(P.col("qty") < 250)
             .groupby(["region"], {"s": ("sum", "units")}, num_groups_cap=8))
        text = q.explain()
        assert f"qid={q.qid}" in text
        est = sum(P.verdict(p, q.ops, pt)[0] for p in pt.partitions)
        line = f"visit {est} / skip {len(pt.partitions) - est}"
        assert line in text
        return {"estimate": line,
                "has": [s in text for s in ("filter qty lt 250",
                                            "groupby[region]",
                                            "sort-free scatter",
                                            "estimated partitions:")]}

    got = _both(scenario)
    assert all(got["has"])


def test_explain_analyze_reconciles_with_stats():
    def scenario(P):
        pt = _clustered_pt(P)
        q = (P.PQ(pt).filter(P.col("qty") < 250)
             .aggregate({"s": ("sum", "units"), "c": ("count", None)}))
        seen = []
        with P.telemetry.h2d_listener(lambda nb, tree: seen.append(nb)):
            text = q.explain_analyze()
        la = q.last_analysis
        # exact reconciliation with the engine's own accounting
        assert la["executed"] == q.last_stats["executed"]
        assert la["pruned"] == q.last_stats["skipped"]
        assert la["transferred"] == q.last_stats["transferred"]
        # ... and with an independent listener (same analyzed run)
        assert la["transfers_seen"] == len(seen)
        assert la["bytes_moved"] <= la["bytes_total"] == pt.nbytes()
        assert "actual: wall" in text
        assert f"{la['executed']} executed" in text
        assert la["pruned"] > 0
        return {k: la[k] for k in ("executed", "pruned", "transferred",
                                   "transfers_seen", "bytes_moved",
                                   "bytes_total", "pruned_by",
                                   "partitions")}

    got = _both(scenario)
    assert any("qty lt 250 outside zone" in c for c in got["pruned_by"])


def test_explain_analyze_resident_table():
    def scenario(P):
        rng = np.random.default_rng(0)
        t = P.T.from_arrays({"v": rng.integers(0, 50, 3000).astype(np.int32)},
                            cfg=P.cfg, **P.dev)
        q = P.Q(t).filter(P.col("v") >= 10).aggregate({"c": ("count", None)})
        text = q.explain_analyze()
        assert "actual: wall" in text
        assert q.last_analysis["wall_ms"] >= 0
        return {"plan": "filter v ge 10" in q.explain()}

    assert _both(scenario) == {"plan": True}


def test_explain_analyze_leaves_trace_policy_off():
    def scenario(P):
        pt = _clustered_pt(P)
        q = (P.PQ(pt).filter(P.col("qty") < 250)
             .aggregate({"c": ("count", None)}))
        q.explain_analyze()
        return {"trace": P.dispatch.policy().enable_trace}

    assert _both(scenario) == {"trace": False}


# ---------------------------------------------------------------------------
# 4. wiring: executor spans, zone verdicts, routing, H2D counters
# ---------------------------------------------------------------------------


def test_streamed_run_emits_qid_tagged_spans():
    def scenario(P):
        pt = _clustered_pt(P)
        q = (P.PQ(pt).filter(P.col("qty") < 250)
             .aggregate({"s": ("sum", "units")}))
        P.telemetry.reset()
        with P.dispatch.overrides(enable_trace=True):
            q.run()
        tr = P.telemetry.query_trace(q.qid)
        names = {e["name"] for e in tr}
        assert {"transfer", "program", "fold", "zone_map"} <= names
        # one program span per executed partition, labelled with its index
        progs = [e for e in tr if e["name"] == "program"]
        assert len(progs) == q.last_stats["executed"]
        assert all(isinstance(e["attrs"].get("part"), int) for e in progs)
        # zone-map instants: one verdict per partition, skips carry a cause
        zm = [e for e in tr if e["name"] == "zone_map"]
        assert len(zm) == len(pt.partitions)
        skips = [e for e in zm if e["attrs"]["verdict"] == "skip"]
        assert len(skips) == q.last_stats["skipped"] > 0
        assert all("outside zone" in e["attrs"]["cause"] for e in skips)
        return {"names": sorted(names),
                "programs": sorted(e["attrs"]["part"] for e in progs),
                "verdicts": [(e["attrs"]["part"], e["attrs"]["verdict"],
                              e["attrs"]["cause"]) for e in zm]}

    _both(scenario)


def test_route_records_mark_compilations():
    telemetry.reset()
    vals = torch.arange(64, dtype=torch.int32)
    segs = torch.zeros(64, dtype=torch.int32)
    with dispatch.overrides(enable_trace=True):
        out = dispatch.segment_sum(vals, segs, 1)
    assert int(out[0]) == int(vals.sum())
    reg = telemetry.registry()
    routed = [k for k in reg.counters() if k.startswith("route.segment_sum.")]
    assert len(routed) == 1 and reg.counter(routed[0]) == 1
    (ev,) = reg.events(name="route.segment_sum")
    # CPU tensors take the non-kernel route: the port names it
    # torch_scatter where the reference says xla_scatter
    assert ev["attrs"]["path"] == "torch_scatter"
    assert ev["attrs"]["reason"] == "inputs not on CUDA"


def test_h2d_counters_always_on():
    def scenario(P):
        pt = _clustered_pt(P, n=6000, parts=4)
        q = P.PQ(pt).aggregate({"c": ("count", None)})
        P.telemetry.reset()
        q.run()  # tracing OFF — the transfer counters must book anyway
        reg = P.telemetry.registry()
        assert reg.counter("h2d_calls") == q.last_stats["transferred"]
        assert reg.events() == []  # but no events were recorded
        return {"calls": reg.counter("h2d_calls"),
                "bytes": reg.counter("h2d_bytes")}

    got = _both(scenario)
    assert got["calls"] == 4 and got["bytes"] > 0


def test_h2d_listener_scoped():
    def scenario(P):
        pt = _clustered_pt(P, n=6000, parts=4)
        q = P.PQ(pt).aggregate({"c": ("count", None)})
        seen = []
        with P.telemetry.h2d_listener(lambda nbytes, tree: seen.append(nbytes)):
            q.run()
        before = list(seen)
        q.run()  # outside the scope: the listener is unhooked
        assert seen == before
        return {"seen": before}

    got = _both(scenario)
    assert len(got["seen"]) == 4 and all(b > 0 for b in got["seen"])


# ---------------------------------------------------------------------------
# 5. concurrency + cost
# ---------------------------------------------------------------------------


def _payload(r):
    if hasattr(r, "num_groups"):
        ng = int(r.num_groups)
        return {**{f"k:{g}": host(r.keys[g])[:ng] for g in r.keys},
                **{f"a:{o}": host(r.aggs[o])[:ng] for o in r.aggs}}
    return {o: host(r[o]) for o in r}


def test_traced_concurrent_serving_reconciles():
    def scenario(P):
        pt = _clustered_pt(P)

        def mk_queries():
            return [
                (P.PQ(pt).filter(P.col("qty") < 250)
                 .aggregate({"s": ("sum", "units"), "c": ("count", None)})),
                (P.PQ(pt).filter(P.col("qty") < 250)
                 .groupby(["region"], {"s": ("sum", "units")},
                          num_groups_cap=8)),
                (P.PQ(pt).filter(P.col("qty") >= 750)
                 .aggregate({"m": ("max", "units")})),
            ]

        P.telemetry.reset()
        results = [None, None]
        with P.dispatch.overrides(enable_trace=True):
            with P.Server(pt) as srv:
                def client(slot):
                    qs = mk_queries()
                    tickets = [srv.submit(q) for q in qs]
                    for t in tickets:
                        srv.result(t, timeout=120)
                    results[slot] = (qs, tickets)

                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                assert not any(t.is_alive() for t in threads)

        total_transferred = 0
        answers = {}
        for slot, (qs, tickets) in enumerate(results):
            for j, (q, t) in enumerate(zip(qs, tickets)):
                assert t.error is None
                st = t.stats
                total_transferred += st.get("transferred", 0)
                tr = P.telemetry.query_trace(q.qid)
                progs = [e for e in tr if e["name"] == "serve.program"]
                # per-query attribution: span count == executed, and the
                # span-level source tags sum to the ticket's attribution
                assert len(progs) == st["executed"]
                srcs = {}
                for e in progs:
                    s = e["attrs"]["src"]
                    srcs[s] = srcs.get(s, 0) + 1
                assert srcs.get("miss", 0) == st.get("transferred", 0)
                assert srcs.get("lru", 0) == st.get("lru_hits", 0)
                assert srcs.get("shared", 0) == st.get("shared_hits", 0)
                answers[f"answer{slot}{j}"] = _payload(t.result)
        # across the whole run: tickets' transfers == actual transfers
        assert total_transferred == \
            P.telemetry.registry().counter("h2d_calls")
        # batching follows the threads' timing: transfers are at most one
        # a visited partition (the LRU holds them all)
        return {"transfers_at_most_one_each":
                total_transferred <= len(pt.partitions), **answers}

    assert _both(scenario)["transfers_at_most_one_each"]


def test_trace_overhead_within_noise():
    """Trace-ON wall vs trace-OFF wall on the depth-2 streamed path, under
    the reference test's bound: the median, over 40 back-to-back pairs
    (the pair's order alternating), of each pair's ratio.

    The enabled path strictly dominates the disabled path (every span
    site allocates and locks), so this ratio upper-bounds what the
    default-off instrumentation can cost; the bound exists to catch
    order-of-magnitude regressions (e.g. an eager span on the disabled
    path). A pair's two runs share the host's load, and the median drops
    the pairs a stall hit. The reference's best of each arm did not hold
    under six test workers: a run that found the host idle set one arm
    alone (ratios up to 1.5 with 40 repeats)."""
    pt = _clustered_pt(PORT, n=60_000, parts=8)
    q = (PartitionedQuery(pt).filter(col("units") < 90)
         .groupby(["region"], {"s": ("sum", "qty")}, num_groups_cap=8))
    q.run()  # build the program once
    telemetry.reset()

    def timed(trace):
        with dispatch.overrides(prefetch_depth=2, enable_trace=trace):
            t0 = time.perf_counter()
            q.run()
            return time.perf_counter() - t0

    ratios = []
    for i in range(40):
        order = (False, True) if i % 2 == 0 else (True, False)
        wall = {trace: timed(trace) for trace in order}
        ratios.append(wall[True] / wall[False])
    assert statistics.median(ratios) < 1.25


def test_serving_stats_unchanged_when_disabled():
    """Tracing off (the default) must not change serving results or the
    stats schema — the instrumentation is observation only."""
    def scenario(P):
        pt = _clustered_pt(P, n=6000, parts=4)
        q1, q2 = (P.PQ(pt).filter(P.col("qty") < 500)
                  .aggregate({"s": ("sum", "units")}) for _ in range(2))
        solo = q1.run()
        with P.Server(pt) as srv:
            t = srv.submit(q2)
            served = srv.result(t, timeout=120)
        np.testing.assert_array_equal(host(solo["s"]), host(served["s"]))
        assert {"executed", "skipped", "transferred"} <= set(t.stats)
        return {"answer": {"s": host(served["s"])}}

    _both(scenario)
