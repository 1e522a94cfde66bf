"""Fault tolerance and integrity validation of the port (DESIGN.md §15).

The twin of tests/test_faults.py:

  1. ``FaultPlan`` units — the port's copy of ``faults`` schedules the same
     seeded coordinates as the reference and fires at exact (site,
     partition, attempt) coordinates;
  2. the retry and degradation matrix with synthetic callbacks: transient
     transfer faults retry and stay bit-identical, exhaustion re-raises,
     an OOM halves the depth and resumes from the failed partition, the
     ring always cleans up — each outcome the same as the reference's;
  3. real-engine recovery: a fault schedule on a partitioned query gives
     the clean run's answer bit for bit on the six encodings, and
     ``explain_analyze`` reports the retries;
  4. serving resilience: deadlines (while queued and at a partition
     boundary), cancellation, ``result(timeout=)`` dequeuing, a poisoned
     subscriber isolated, the LRU-evicting OOM fallback to solo passes,
     ``close(drain=False)`` and ``recover()`` — each scenario run through
     both packages' ``QueryServer``, with the same outcomes and counters;
  5. ``Table.validate()`` / ``PartitionedTable.validate()``: clean tables
     pass, corrupted run lists, positions, sentinels, dictionary codes,
     domains and packed widths raise ``ValidationError``, as in the
     reference.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.core import faults as jfaults
from repro.core import stream as jstream
from repro.core import telemetry as jtelemetry
from repro.core.partition import PartitionedQuery as JPQ
from repro.core.partition import PartitionedTable as JPT
from repro.core.plan import col as jcol
from repro.core.serve import QueryServer as JQueryServer
from repro.kernels import dispatch as jdispatch
from repro_torch.core import compress as tc
from repro_torch.core import faults, stream, telemetry
from repro_torch.core.encodings import IndexColumn, RLEColumn
from repro_torch.core.faults import (
    DeviceOOMError,
    Fault,
    FaultPlan,
    TransientTransferError,
    ValidationError,
)
from repro_torch.core.partition import PartitionedQuery, PartitionedTable
from repro_torch.core.plan import col
from repro_torch.core.serve import QueryServer
from repro_torch.core.table import Table
from repro_torch.kernels import dispatch

from torch_twins import (CPU, SIX_ENCODINGS, assert_payload_close,
                         assert_payload_same, result_payload,
                         six_encoding_data)

CFG = tc.CompressionConfig(plain_threshold=1000)


def _counter(name):
    return telemetry.registry().counter(name)


# ---------------------------------------------------------------------------
# 1. FaultPlan units
# ---------------------------------------------------------------------------


def test_maybe_inject_is_noop_without_plan():
    assert not dispatch.policy().enable_fault_injection
    faults.maybe_inject("transfer", 0)
    assert faults.active() is None


def test_plan_fires_at_exact_coordinates():
    plan = FaultPlan().transient(part=2, attempt=1)
    with plan:
        assert dispatch.policy().enable_fault_injection
        faults.maybe_inject("transfer", 2)  # attempt 0: scheduled at 1
        faults.maybe_inject("transfer", 3)
        faults.maybe_inject("compute", 2)
        with pytest.raises(TransientTransferError):
            faults.maybe_inject("transfer", 2)
        faults.maybe_inject("transfer", 2)
        assert plan.attempts("transfer", 2) == 3
    assert not dispatch.policy().enable_fault_injection
    assert [f.attempt for f in plan.fired] == [1]


def test_plan_kinds_validation_and_nesting():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan().add(Fault("transfer", 0, 0, "gremlin"))
    plan = FaultPlan().oom(1, site="compute").latency(0, ms=5)
    with plan:
        t0 = time.perf_counter()
        faults.maybe_inject("transfer", 0)
        assert time.perf_counter() - t0 >= 4e-3
        with pytest.raises(DeviceOOMError):
            faults.maybe_inject("compute", 1)
        with pytest.raises(RuntimeError, match="already active"):
            with FaultPlan():
                pass
    assert sorted(f.kind for f in plan.fired) == ["latency", "oom"]
    assert faults.active() is None


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_seeded_plan_matches_reference(seed):
    got = FaultPlan.seeded(seed, parts=8, transients=3, ooms=1).scheduled()
    want = jfaults.FaultPlan.seeded(seed, parts=8, transients=3,
                                    ooms=1).scheduled()
    assert [(f.site, f.part, f.attempt, f.kind) for f in got] == \
        [(f.site, f.part, f.attempt, f.kind) for f in want]
    with pytest.raises(ValueError, match="distinct partitions"):
        FaultPlan.seeded(seed, parts=3, transients=3, ooms=1)


def test_fault_env_knobs():
    pol = dispatch.policy_from_env({"REPRO_FAULTS": "1",
                                    "REPRO_TRANSFER_RETRIES": "5",
                                    "REPRO_TRANSFER_BACKOFF_MS": "2.5"})
    assert pol.enable_fault_injection and pol.transfer_retries == 5
    assert pol.transfer_backoff_ms == 2.5
    off = dispatch.policy_from_env({})
    assert not off.enable_fault_injection
    assert (off.transfer_retries, off.transfer_backoff_ms) == (3, 10.0)


# ---------------------------------------------------------------------------
# 2. the retry and degradation matrix (synthetic callbacks)
# ---------------------------------------------------------------------------


def _fold(pkg, plan, depth, items=None, **over):
    """``pipelined_fold`` of package ``pkg`` under ``plan``: (out, stats,
    transfer calls) or the exception raised."""
    mod, disp, plans = pkg
    items = list(range(6)) if items is None else items
    stats = mod.StreamStats(prefetch_depth=depth)
    calls = {"transfer": 0}

    def transfer(x):
        calls["transfer"] += 1
        return x

    try:
        with disp.overrides(transfer_backoff_ms=0.0, **over):
            with plan:
                out = mod.pipelined_fold(items, transfer, lambda x, c: c * 10,
                                         lambda acc, x, p: acc + [p], [],
                                         depth, stats)
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return type(exc).__name__, stats.as_dict(), calls
    return out, stats.as_dict(), calls


PORT = (stream, dispatch, faults)
REF = (jstream, jdispatch, jfaults)


def _plan(pkg, build):
    return build(pkg[2].FaultPlan())


MATRIX = {
    "transients_depth0": (0, {}, lambda p: p.transient(3).transient(1)),
    "transients_depth2": (2, {}, lambda p: p.transient(3).transient(1)),
    "exhaustion": (2, {"transfer_retries": 2},
                   lambda p: p.transient(4, 0).transient(4, 1)
                   .transient(4, 2)),
    "oom_compute": (4, {}, lambda p: p.oom(2, site="compute")),
    "oom_fold": (4, {}, lambda p: p.oom(2, site="fold")),
    "oom_to_zero": (2, {}, lambda p: p.oom(1, 0, site="compute")
                    .oom(1, 1, site="compute").oom(1, 2, site="compute")),
    "terminal_depth0": (0, {}, lambda p: p.oom(5, site="fold")),
    "latency": (1, {}, lambda p: p.latency(2, ms=1)),
}


@pytest.mark.parametrize("case", list(MATRIX))
def test_retry_and_degradation_matrix_matches_reference(case):
    depth, over, build = MATRIX[case]
    got_plan, want_plan = _plan(PORT, build), _plan(REF, build)
    got = _fold(PORT, got_plan, depth, **over)
    want = _fold(REF, want_plan, depth, **over)
    g_out, g_stats, g_calls = got
    w_out, w_stats, w_calls = want
    assert g_out == w_out, case  # the answer, or the same terminal error
    for key in ("retries", "degradations", "prefetch_depth", "transferred",
                "executed"):
        assert g_stats[key] == w_stats[key], (case, key)
    assert g_calls == w_calls
    assert [(f.site, f.part, f.attempt, f.kind) for f in got_plan.fired] == \
        [(f.site, f.part, f.attempt, f.kind) for f in want_plan.fired]
    if isinstance(g_out, list):
        assert g_out == [x * 10 for x in range(6)]


def test_terminal_fault_cleans_up_ring_threads():
    n0 = threading.active_count()
    out, _, _ = _fold(PORT, FaultPlan().oom(part=5, site="fold"), 2,
                      transfer_retries=0)
    assert out == [x * 10 for x in range(6)]  # depth 2 degrades, recovers
    out, _, _ = _fold(PORT, FaultPlan().oom(part=5, site="fold"), 0)
    assert out == "DeviceOOMError"
    deadline = time.perf_counter() + 5
    while threading.active_count() > n0 and time.perf_counter() < deadline:
        time.sleep(0.01)  # executor shutdown is asynchronous
    assert threading.active_count() <= n0


def test_fault_events_hit_always_on_counters():
    before = {k: _counter(f"fault.{k}") for k in ("injected", "retry",
                                                   "degrade")}
    _fold(PORT, FaultPlan().transient(part=0).oom(part=3, site="compute"), 2)
    assert _counter("fault.injected") - before["injected"] == 2
    assert _counter("fault.retry") - before["retry"] == 1
    assert _counter("fault.degrade") - before["degrade"] == 1


# ---------------------------------------------------------------------------
# 3. real-engine recovery
# ---------------------------------------------------------------------------


def _table(rng, enc, n=9_000, parts=6):
    data, encs = six_encoding_data(rng, enc, n)
    return PartitionedTable.from_arrays(data, cfg=CFG, num_partitions=parts,
                                        encodings=encs, pack=True, device=CPU)


def _terminals(pt):
    yield lambda: (PartitionedQuery(pt).filter(col("v") > 100)
                   .aggregate({"s": ("sum", "v"), "c": ("count", None)}))
    yield lambda: (PartitionedQuery(pt).filter(col("v") > 100)
                   .groupby(["k"], {"s": ("sum", "v")}, num_groups_cap=64))


@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_recovered_runs_equal_clean_runs(rng, enc):
    pt = _table(rng, enc)
    for mk in _terminals(pt):
        clean = result_payload(mk().run())
        q = mk()
        plan = FaultPlan().transient(0).transient(2).oom(4, site="compute")
        with dispatch.overrides(transfer_backoff_ms=0.0, prefetch_depth=2):
            with plan:
                faulted = result_payload(q.run())
        assert_payload_same(clean, faulted, enc)
        assert q.last_stats["retries"] == 2
        assert q.last_stats["degradations"] == 1
        assert q.last_stats["prefetch_depth"] == 1
        assert len(plan.fired) == 3


def test_seeded_chaos_plan_recovers_bit_identically(rng):
    """``chip_smoke.py``'s chaos run at a small size: a seeded plan of three
    transient transfers and one OOM over 8 partitions fires in full and
    the recovered answer is the clean one, bit for bit."""
    pt = _table(rng, "rle", n=16_000, parts=8)
    clean = result_payload(next(_terminals(pt))().run())
    plan = FaultPlan.seeded(5, parts=8, transients=3, ooms=1)
    q = next(_terminals(pt))()
    with dispatch.overrides(transfer_backoff_ms=0.0):
        with plan:
            got = result_payload(q.run())
    assert len(plan.fired) == len(plan.scheduled()) == 4
    assert_payload_same(clean, got)


def test_terminal_fault_surfaces_cleanly(rng):
    pt = _table(rng, "plain", n=4_000, parts=4)
    q = (PartitionedQuery(pt).filter(col("v") > 100)
         .aggregate({"s": ("sum", "v")}))
    plan = FaultPlan().transient(part=2, attempt=0).transient(part=2,
                                                              attempt=1)
    with dispatch.overrides(transfer_retries=1, transfer_backoff_ms=0.0):
        with plan:
            with pytest.raises(TransientTransferError):
                q.run()
    assert q.last_stats.get("retries") == 1  # stats finalized on failure
    expected = result_payload((PartitionedQuery(pt).filter(col("v") > 100)
                               .aggregate({"s": ("sum", "v")})).run())
    assert_payload_same(expected, result_payload(q.run()))


def test_explain_analyze_surfaces_resilience(rng):
    pt = _table(rng, "plain", n=4_000, parts=4)
    q = (PartitionedQuery(pt).filter(col("v") > 100)
         .aggregate({"s": ("sum", "v")}))
    with dispatch.overrides(transfer_backoff_ms=0.0):
        with FaultPlan().transient(1):
            text = q.explain_analyze()
    assert "resilience:" in text and "1 transfer retry" in text


# ---------------------------------------------------------------------------
# 4. serving resilience (each scenario through both packages)
# ---------------------------------------------------------------------------

SREF = types.SimpleNamespace(
    name="repro", PT=JPT, PQ=JPQ, col=jcol, Server=JQueryServer,
    faults=jfaults, telemetry=jtelemetry, dispatch=jdispatch,
    cfg=jc.CompressionConfig(plain_threshold=1000), dev={})
SPORT = types.SimpleNamespace(
    name="repro_torch", PT=PartitionedTable, PQ=PartitionedQuery, col=col,
    Server=QueryServer, faults=faults, telemetry=telemetry,
    dispatch=dispatch, cfg=CFG, dev={"device": CPU})


@pytest.fixture
def servers():
    """``open(P, table, **kw)`` builds package ``P``'s server; every one
    is closed when the test ends."""
    opened = []

    def open_(P, pt, **kw):
        srv = P.Server(pt, **kw)
        opened.append(srv)
        return srv

    yield open_
    for srv in opened:
        srv.close(drain=False)


def _serve_table(P, n=6_000, parts=4):
    rng = np.random.default_rng(0)
    data = {
        "k": np.sort(rng.integers(0, 16, n)).astype(np.int32),
        "v": rng.integers(0, 2000, n).astype(np.int32),
    }
    return P.PT.from_arrays(data, cfg=P.cfg, num_partitions=parts, **P.dev)


def _agg_q(P, pt, lit=100):
    return (P.PQ(pt).filter(P.col("v") > lit)
            .aggregate({"s": ("sum", "v"), "c": ("count", None)}))


_OUTCOME_KEYS = ("completed", "errors", "timeouts", "cancelled", "expired")


def _outcome(srv, tickets=()):
    """What a scenario leaves behind: the server's outcome counters and
    each ticket's error class (None when it was answered)."""
    s = srv.stats()
    return {"stats": {k: s[k] for k in _OUTCOME_KEYS},
            "errors": [None if t.error is None else type(t.error).__name__
                       for t in tickets]}


def _serve_both(scenario):
    """``scenario`` through the reference, then the port: the two
    observation dicts must be equal (answers within rtol 1e-4)."""
    want = scenario(SREF)
    got = scenario(SPORT)
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith("answer"):
            assert_payload_close(w, got[key], key)
        else:
            assert got[key] == w, (key, got[key], w)
    return got


def _scalar_payload(r):
    return {k: np.asarray(r[k]) for k in r}


def test_deadline_expired_while_queued(servers):
    def scenario(P):
        pt = _serve_table(P)
        srv = servers(P, pt, start=False)
        t = srv.submit(_agg_q(P, pt), deadline_s=0.0)
        time.sleep(0.005)
        assert srv.step() == 0  # reaped at batch formation, never run
        with pytest.raises(P.faults.QueryDeadlineExceeded):
            srv.result(t)
        return _outcome(srv, [t])

    got = _serve_both(scenario)
    assert got["stats"]["expired"] == 1 and got["stats"]["completed"] == 0


def test_deadline_expires_at_partition_boundary(servers):
    def scenario(P):
        pt = _serve_table(P)
        srv = servers(P, pt, start=False)
        # warm the plan cache so building cannot eat the deadline budget
        warm = srv.submit(_agg_q(P, pt))
        srv.step()
        assert srv.result(warm, timeout=60)["c"] > 0
        t = srv.submit(_agg_q(P, pt), deadline_s=0.25)
        # 600 ms of injected latency in front of partition 1's copy: the
        # deadline check at the NEXT partition boundary must fire (the
        # LRU holds every partition, so the copy never happens: the
        # latency probe still fires at the transfer site)
        with P.faults.FaultPlan().latency(part=1, ms=600):
            srv.step()
        with pytest.raises(P.faults.QueryDeadlineExceeded):
            srv.result(t)
        assert t.stats is None  # failed tickets carry no stats dict
        return _outcome(srv, [warm, t])

    got = _serve_both(scenario)
    assert got["stats"]["expired"] == 1


def test_cancel_queued_and_finished(servers):
    def scenario(P):
        pt = _serve_table(P)
        srv = servers(P, pt, start=False)
        t = srv.submit(_agg_q(P, pt))
        assert srv.cancel(t) is True
        with pytest.raises(P.faults.QueryCancelled):
            srv.result(t)
        assert srv.step() == 0  # dequeued: nothing left to run
        t2 = srv.submit(_agg_q(P, pt))
        srv.step()
        answer = _scalar_payload(srv.result(t2, timeout=60))
        assert srv.cancel(t2) is False  # already finished: result stands
        return {**_outcome(srv, [t, t2]), "answer": answer}

    got = _serve_both(scenario)
    assert got["stats"]["cancelled"] == 1 and got["stats"]["completed"] == 1


def test_result_timeout_dequeues_ticket(servers):
    def scenario(P):
        pt = _serve_table(P)
        srv = servers(P, pt, start=False)  # no drain: the ticket waits
        t = srv.submit(_agg_q(P, pt))
        with pytest.raises(TimeoutError):
            srv.result(t, timeout=0.01)
        assert t.done.is_set()
        with pytest.raises(P.faults.QueryCancelled):
            srv.result(t)
        assert srv.step() == 0
        return _outcome(srv, [t])

    got = _serve_both(scenario)
    assert got["stats"]["timeouts"] == 1 and got["stats"]["cancelled"] == 1


def test_poisoned_subscriber_is_isolated(servers):
    def scenario(P):
        pt = _serve_table(P)
        expected = _scalar_payload(_agg_q(P, pt).run())
        srv = servers(P, pt, start=False)
        bad = srv.submit(_agg_q(P, pt))
        good = srv.submit(_agg_q(P, pt))
        # "program" faults fire per (partition, subscriber): attempt 0 on
        # partition 0 is the FIRST subscriber's program — the batch head
        with P.faults.FaultPlan().transient(part=0, site="program"):
            assert srv.step() == 2  # both admitted to one shared pass
        with pytest.raises(P.faults.TransientTransferError):
            srv.result(bad)
        answer = _scalar_payload(srv.result(good))
        assert set(answer) == set(expected)
        for k in expected:
            np.testing.assert_array_equal(answer[k], expected[k])
        assert good.shared_with == 1
        return {**_outcome(srv, [bad, good]), "answer": answer,
                "shared_with": good.shared_with}

    got = _serve_both(scenario)
    assert got["stats"]["errors"] == 1 and got["stats"]["completed"] == 1


def test_shared_scan_oom_falls_back_to_solo_passes(servers):
    def scenario(P):
        pt = _serve_table(P)
        expected = [_scalar_payload(_agg_q(P, pt, lit).run())
                    for lit in (100, 500)]
        srv = servers(P, pt, start=False)
        oom0 = P.telemetry.registry().counter("fault.serve_oom")
        tickets = [srv.submit(_agg_q(P, pt, lit)) for lit in (100, 500)]
        plan = P.faults.FaultPlan()
        for attempt in range(3):  # exhaust depth 2 -> 1 -> 0 in the pass
            plan.oom(part=1, attempt=attempt, site="compute")
        with P.dispatch.overrides(prefetch_depth=2, transfer_backoff_ms=0.0):
            with plan:
                srv.step()
        answers = [_scalar_payload(srv.result(t)) for t in tickets]
        for a, e in zip(answers, expected):
            for k in e:
                np.testing.assert_array_equal(a[k], e[k])
        fallbacks = srv.stats()["oom_fallbacks"]
        assert fallbacks >= 1
        assert P.telemetry.registry().counter("fault.serve_oom") > oom0
        return {**_outcome(srv, tickets), "oom_fallbacks": fallbacks,
                "answer0": answers[0], "answer1": answers[1]}

    _serve_both(scenario)


def test_close_drain_false_cancels_queue(servers):
    def scenario(P):
        pt = _serve_table(P)
        srv = servers(P, pt, start=False)
        tickets = [srv.submit(_agg_q(P, pt)) for _ in range(3)]
        srv.close(drain=False)
        for t in tickets:
            with pytest.raises(P.faults.QueryCancelled, match="drain=False"):
                srv.result(t)
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(_agg_q(P, pt))
        return _outcome(srv, tickets)

    got = _serve_both(scenario)
    assert got["stats"]["cancelled"] == 3


def test_recover_clears_fatal_state(servers):
    def scenario(P):
        pt = _serve_table(P)
        srv = servers(P, pt, start=False)
        srv._fatal = RuntimeError("plan-cache contract violated (simulated)")
        with pytest.raises(RuntimeError, match="simulated"):
            srv.submit(_agg_q(P, pt))
        srv.recover()
        t = srv.submit(_agg_q(P, pt))
        srv.step()
        answer = _scalar_payload(srv.result(t, timeout=60))
        assert answer["c"] > 0
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.recover()
        return {**_outcome(srv, [t]), "answer": answer}

    _serve_both(scenario)


# ---------------------------------------------------------------------------
# 5. integrity validation
# ---------------------------------------------------------------------------


def test_unpack_array_inverts_pack_array(rng):
    for bits in (1, 5, 11, 17, 23, 31, 32):
        for n in (0, 1, 7, 100):
            off = int(rng.integers(-5000, 5000))
            vals = off + rng.integers(0, min(1 << bits, 1 << 31), size=n)
            words = tc.pack_array(vals, off, bits)
            np.testing.assert_array_equal(tc.unpack_array(words, off, bits, n),
                                          vals)
            np.testing.assert_array_equal(
                tc.unpack_array(words.view(np.int32), off, bits, n), vals)


@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_every_encoding_validates_clean(rng, enc):
    pt = _table(rng, enc, n=4_000, parts=4)
    assert pt.validate() is pt
    k = np.sort(rng.integers(0, 20, 2048)).astype(np.int32)
    encs = None if enc == "plain_dict" else {"k": enc}
    if enc == "plain_dict":
        k = np.array([f"s{i}" for i in range(20)])[k]
    for pack in (False, True):
        t = Table.from_arrays({"k": k}, cfg=CFG, encodings=encs, pack=pack,
                              device=CPU)
        assert t.validate() is t


def _i32(*a):
    return torch.tensor(a, dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("overlap", "overlap"), ("sentinel", "sentinel"),
    ("unsorted", "strictly increasing"), ("run_count", "outside capacity")])
def test_validate_catches_corrupted_structure(case, match):
    n2 = torch.tensor(2, dtype=torch.int32)
    if case == "overlap":  # runs [0,4] and [3,6]
        c = RLEColumn(values=_i32(5, 7, 0, 0), starts=_i32(0, 3, 8, 8),
                      ends=_i32(4, 6, 8, 8), n=n2, nrows=8)
    elif case == "sentinel":
        c = IndexColumn(values=_i32(5, 7, 0, 0), positions=_i32(1, 3, 0, 8),
                        n=n2, nrows=8)
    elif case == "unsorted":
        c = IndexColumn(values=_i32(5, 7, 0, 0), positions=_i32(3, 1, 8, 8),
                        n=n2, nrows=8)
    else:
        c = RLEColumn(values=_i32(5, 7), starts=_i32(0, 3), ends=_i32(2, 6),
                      n=torch.tensor(3, dtype=torch.int32), nrows=8)
    with pytest.raises(ValidationError, match=match):
        tc.validate_encoded(c, "x", 8)


def test_validate_catches_dictionary_and_domain_escapes(rng):
    codes = rng.integers(0, 4, 256).astype(np.int32)
    t = Table.from_arrays({"c": np.array(["a", "b", "c", "d"])[codes]},
                          cfg=CFG, device=CPU)
    t.dictionaries["c"] = t.dictionaries["c"][:2]
    with pytest.raises(ValidationError, match="dictionary"):
        t.validate()
    vals = rng.integers(0, 100, 2048).astype(np.int32)
    t = Table.from_arrays({"v": vals}, cfg=CFG, device=CPU)
    t.domains["v"] = (0, 50)
    with pytest.raises(ValidationError, match="domain"):
        t.validate()


def test_validate_catches_too_narrow_packed_width(rng):
    vals = rng.integers(0, 100, 4096).astype(np.int32)
    t = Table.from_arrays({"v": vals}, cfg=CFG, pack=True, device=CPU)
    t.validate()
    t.domains["v"] = (0, 1 << 20)
    with pytest.raises(ValidationError, match="cannot represent"):
        t.validate()
