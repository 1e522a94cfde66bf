"""The port's own spans in the profiler's trace, and what they time
(DESIGN.md §14). Port only: no twin in the reference.

  * off (no ``enable_trace``, no profiler): ``span()`` is the shared
    no-op and no profiler range opens; routes build no reason text;
  * a ``torch.profiler`` run, configured as the benchmark's harness
    configures it, turns recording on: a span opened on another thread
    lands in the ring and in the profiler's events as ``repro.<name>``,
    a CPU op and no user annotation (whose copy on the device's timeline
    would read as device time);
  * the planner's ``plan.join_side`` / ``plan.program``, the server's
    ``serve.queue`` / ``serve.prep`` beside a ticket's ``queue_ms`` /
    ``prep_ms``, ``serve.program`` on the main track, ``kernel`` instants
    with the launch's bytes, the export on the profiler's clock, and
    ``stats()``'s bounded latency history.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import compress, serve, stream, telemetry
from repro_torch.core.partition import PartitionedQuery, PartitionedTable
from repro_torch.core.plan import Query, col
from repro_torch.core.table import Table
from repro_torch.kernels import _build, dispatch

CPU = torch.device("cpu")
CFG = compress.CompressionConfig(plain_threshold=1000)


@pytest.fixture(autouse=True)
def fresh_ring():
    telemetry.reset()
    yield
    telemetry.reset()


def _profiler():
    """A CPU profiler configured as ``perfbench.harness._profile_slice``
    configures its own: every thread."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _star(n=6_000, parts=40):
    """A LINEITEM-like fact table and a PART-like dimension (Q19's shape:
    a filtered dimension joined by key, its brand brought over)."""
    rng = np.random.default_rng(5)
    fact = {"partkey": rng.integers(0, parts, n).astype(np.int32),
            "qty": rng.integers(1, 50, n).astype(np.int32),
            "price": rng.uniform(1, 100, n).astype(np.float32)}
    dim = {"partkey": np.arange(parts, dtype=np.int32),
           "brand": (np.arange(parts) % 5).astype(np.int32),
           "size": (np.arange(parts) % 12 + 1).astype(np.int32)}
    return fact, dim


def _join_query(fact_t, dim_t, query_cls=Query):
    return (query_cls(fact_t).filter(col("qty") < 40)
            .join(dim_t, fk="partkey", cols=["brand"],
                  where=col("size").between(1, 6))
            .filter(col("brand") >= 2)
            .aggregate({"rev": ("sum", "price"), "n": ("count", None)}))


# ---------------------------------------------------------------------------
# off: the shared no-op
# ---------------------------------------------------------------------------


def test_off_span_is_the_shared_noop_and_opens_no_range(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(telemetry, "_Range", Range)
    assert not dispatch.policy().enable_trace and not telemetry.profiling()
    assert telemetry.span("a") is telemetry.span("b") is telemetry._NULL_SPAN
    with telemetry.span("cold", qid=1):
        pass
    # a stage is timed off too, into its field, without a range or event
    st = stream.StreamStats(qid=1)
    with stream.stage(st, "merge_ms", "fold"):
        time.sleep(0.002)
    assert st.merge_ms >= 2.0
    assert opened == [] and telemetry.registry().events() == []
    with dispatch.overrides(enable_trace=True):
        with telemetry.span("hot", qid=1):
            pass
    assert opened == ["repro.hot"]
    assert [e["name"] for e in telemetry.registry().events()] == ["hot"]


def test_a_stage_that_raises_adds_no_stats_and_records_its_error():
    st = stream.StreamStats(qid=4)
    with pytest.raises(RuntimeError):  # off: neither stats nor a record
        with stream.stage(st, "compute_ms", "program", "device"):
            raise RuntimeError("program failed")
    assert st.compute_ms == 0.0 and telemetry.registry().events() == []
    with dispatch.overrides(enable_trace=True):
        with pytest.raises(RuntimeError):
            with stream.stage(st, "compute_ms", "program", "device"):
                raise RuntimeError("program failed")
        with pytest.raises(KeyError):
            with telemetry.span("plain", qid=4):
                raise KeyError("x")
    assert st.compute_ms == 0.0
    got = [(e["name"], e["attrs"]) for e in telemetry.registry().events()]
    assert got == [("program", {"qid": 4, "error": "RuntimeError"}),
                   ("plain", {"qid": 4, "error": "KeyError"})]


def test_off_routes_build_no_reason(monkeypatch):
    def boom(pol):
        raise AssertionError("reason text built with tracing off")

    monkeypatch.setattr(dispatch, "_off_reason", boom)
    vals = torch.arange(64, dtype=torch.int32)
    out = dispatch.segment_sum(vals, torch.zeros(64, dtype=torch.int32), 1)
    assert int(out[0]) == int(vals.sum())
    monkeypatch.undo()
    with dispatch.overrides(enable_trace=True):
        dispatch.segment_sum(vals, torch.zeros(64, dtype=torch.int32), 1)
    (ev,) = telemetry.registry().events(name="route.segment_sum")
    assert ev["attrs"]["reason"] == "inputs not on CUDA"


# ---------------------------------------------------------------------------
# a running profiler records, on its own clock
# ---------------------------------------------------------------------------


def test_running_profiler_records_a_span_on_another_thread():
    assert not dispatch.policy().enable_trace

    def work():
        with telemetry.span("side", "main", qid=11):
            torch.ones(8) + 1

    prof = _profiler()
    prof.start()
    try:
        assert telemetry.enabled()
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        prof.stop()
    assert not telemetry.enabled()
    (ev,) = telemetry.registry().events(name="side")
    assert ev["attrs"] == {"qid": 11} and ev["dur"] > 0
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "repro.side"]
    assert len(ranges) == 1
    assert not ranges[0].is_user_annotation()  # a CPU op: no device copy
    # the ring's perf_counter times land on the profiler's epoch clock
    # (which torch derives from its own approximate clock: milliseconds
    # apart from the host's, where a relative clock would be decades)
    start_ns = telemetry.registry().epoch_ns + ev["ts"] * 1e9
    assert abs(start_ns - ranges[0].start_ns()) < 1e8


def test_export_is_on_the_profiler_clock(tmp_path):
    before_us = time.time_ns() / 1e3
    with dispatch.overrides(enable_trace=True):
        with telemetry.span("work", qid=2):
            time.sleep(0.001)
    after_us = time.time_ns() / 1e3
    path = telemetry.export_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        (x,) = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert before_us - 1e3 <= x["ts"] <= x["ts"] + x["dur"] <= after_us + 1e3


# ---------------------------------------------------------------------------
# the planner's spans
# ---------------------------------------------------------------------------


def test_resident_join_records_join_side_and_program():
    fact, dim = _star()
    fact_t = Table.from_arrays(fact, cfg=CFG, device=CPU)
    dim_t = Table.from_arrays(dim, cfg=CFG, device=CPU)
    q = _join_query(fact_t, dim_t)
    off = q.run()
    assert telemetry.registry().events() == []
    q2 = _join_query(fact_t, dim_t)
    with dispatch.overrides(enable_trace=True):
        on = q2.run()
    assert int(on["n"]) == int(off["n"]) > 0
    names = [e["name"] for e in telemetry.query_trace(q2.qid)]
    assert names == ["plan.join_side", "plan.program"]
    side, prog = telemetry.query_trace(q2.qid)
    assert side["ts"] + side["dur"] <= prog["ts"]
    # the dimension's own filter runs inside the join side, not as a
    # program of its own
    assert len(telemetry.registry().events(name="plan.program")) == 1


def test_partitioned_join_records_join_side_only():
    fact, dim = _star()
    pt = PartitionedTable.from_arrays(fact, cfg=CFG, num_partitions=3,
                                      device=CPU)
    dim_t = Table.from_arrays(dim, cfg=CFG, device=CPU)
    q = _join_query(pt, dim_t, PartitionedQuery)
    with dispatch.overrides(enable_trace=True):
        q.run()
    names = {e["name"] for e in telemetry.query_trace(q.qid)}
    assert "plan.join_side" in names and "plan.program" not in names
    assert {"transfer", "program", "fold"} <= names


# ---------------------------------------------------------------------------
# the server's spans and a ticket's times
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", [False, True])
def test_served_ticket_times_equal_its_spans(trace):
    fact, dim = _star()
    pt = PartitionedTable.from_arrays(fact, cfg=CFG, num_partitions=3,
                                      device=CPU)
    dim_t = Table.from_arrays(dim, cfg=CFG, device=CPU)
    with dispatch.overrides(enable_trace=trace):
        with serve.QueryServer(pt, start=False) as srv:
            tickets = [srv.submit(_join_query(pt, dim_t, PartitionedQuery))
                       for _ in range(3)]
            time.sleep(0.01)  # a queue wait of at least this
            while srv.step():
                pass
    for t in tickets:
        assert t.error is None
        assert t.stats["queue_ms"] >= 10.0 and t.stats["prep_ms"] > 0
        assert t.stats["queue_ms"] == round(t.queue_ms, 3)
        assert t.stats["prep_ms"] == round(t.prep_ms, 3)
        tr = {e["name"]: e for e in telemetry.registry().events()
              if e["attrs"].get("ticket") == t.qid
              and e["name"] in ("serve.queue", "serve.prep")}
        if not trace:
            assert tr == {}
            continue
        assert round(tr["serve.queue"]["dur"] * 1e3, 3) == t.stats["queue_ms"]
        assert round(tr["serve.prep"]["dur"] * 1e3, 3) == t.stats["prep_ms"]
        assert tr["serve.queue"]["attrs"]["qid"] == t.query.qid
        assert tr["serve.queue"]["ts"] == t.submitted
        # the join side runs inside the ticket's preparation
        (side,) = telemetry.registry().events(qid=t.query.qid,
                                              name="plan.join_side")
        prep = tr["serve.prep"]
        assert prep["ts"] <= side["ts"]
        assert side["ts"] + side["dur"] <= prep["ts"] + prep["dur"]
    if trace:
        progs = telemetry.registry().events(name="serve.program")
        assert progs and {e["track"] for e in progs} == {"main"}


def test_served_batch_that_raises_is_recorded_with_its_error():
    """A pass that runs out of device memory (injected) falls back to solo
    passes; the failed ``serve.batch`` stays in the trace."""
    from repro_torch.core import faults
    fact, dim = _star()
    pt = PartitionedTable.from_arrays(fact, cfg=CFG, num_partitions=3,
                                      device=CPU)
    dim_t = Table.from_arrays(dim, cfg=CFG, device=CPU)
    plan = faults.FaultPlan()
    for attempt in range(3):  # exhaust depth 2 -> 1 -> 0 in the pass
        plan.oom(part=1, attempt=attempt, site="compute")
    with dispatch.overrides(enable_trace=True, prefetch_depth=2,
                            transfer_backoff_ms=0.0):
        with serve.QueryServer(pt, start=False) as srv:
            tickets = [srv.submit(_join_query(pt, dim_t, PartitionedQuery))
                       for _ in range(2)]
            with plan:
                srv.step()
            assert all(srv.result(t) is not None for t in tickets)
            assert srv.stats()["oom_fallbacks"] >= 1
    batches = telemetry.registry().events(name="serve.batch")
    failed = [e for e in batches if "error" in e["attrs"]]
    assert [e["attrs"]["error"] for e in failed] == ["DeviceOOMError"]
    assert failed[0]["attrs"]["queries"] == 2 and failed[0]["dur"] > 0
    assert len(batches) > len(failed)  # the solo passes that answered


def test_stats_rank_the_last_completions(monkeypatch):
    monkeypatch.setattr(serve, "LATENCY_HISTORY", 4)
    fact, _ = _star(n=600)
    pt = PartitionedTable.from_arrays(fact, cfg=CFG, num_partitions=2,
                                      device=CPU)
    with serve.QueryServer(pt, start=False) as srv:
        now = time.perf_counter()
        for i, lat_s in enumerate([9.0] * 6 + [0.1, 0.2, 0.3, 0.4]):
            t = serve.Ticket(qid=i, query=None, submitted=now - lat_s,
                             part_ids=frozenset())
            srv._finish(t, result=i, stats={})
        s = srv.stats()
    assert s["completed"] == 10
    assert 100.0 <= s["p50_ms"] < 1_000.0  # the 9 s latencies are gone
    assert s["p99_ms"] < 1_000.0 and s["mean_ms"] < 1_000.0


# ---------------------------------------------------------------------------
# the kernels' bytes
# ---------------------------------------------------------------------------


def test_count_launch_records_bytes_only_while_recording():
    launches = dict(_build.LAUNCHES)
    shapes = {k: dict(v) for k, v in _build.SHAPES.items()}
    try:
        _build.count_launch("unpack_kernel", 10, "n=2^4 bits=3", 56)
        assert telemetry.registry().events() == []
        with dispatch.overrides(enable_trace=True):
            _build.count_launch("unpack_kernel", 10, "n=2^4 bits=3", 56)
        (ev,) = telemetry.registry().events(name="kernel")
        assert ev["track"] == "device" and ev["dur"] == 0.0
        assert ev["attrs"] == {"kernel": "unpack_kernel", "nbytes": 56}
        assert _build.LAUNCHES["unpack_kernel"] == \
            launches["unpack_kernel"] + 2
    finally:
        _build.LAUNCHES.update(launches)
        _build.SHAPES.update(shapes)


def test_stream_stats_fields_unchanged():
    """``queue_ms`` / ``prep_ms`` ride on the ticket, not on
    ``StreamStats``, whose fields are the reference's."""
    names = {f.name for f in dataclasses.fields(stream.StreamStats)}
    assert not {"queue_ms", "prep_ms"} & names
