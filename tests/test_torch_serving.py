"""The query server of the port against the reference (DESIGN.md §13).

The twin of tests/test_serving.py. Each scenario runs the same seeded
table and submissions through ``repro.core.serve.QueryServer`` and
``repro_torch.core.serve.QueryServer`` on the CPU (one function, handed
either package), asserts the reference test's own properties on both, and
then holds the port's answers and serving counters to the reference's:

  1. correctness under concurrency — submitter threads firing a mixed
     workload get answers bit-identical to solo ``PartitionedQuery.run()``;
  2. shared scans over the six encodings, with per-query attribution (who
     paid the transfer, who rode an LRU hit, who rode a co-query's copy);
  3. the device-residency LRU: a hot partition is transferred once,
     eviction respects the byte budget and never changes an answer;
  4. the plan cache: a hit builds no program (the reference's "retrace
     free", restated for eager programs), capacity bounds the entries;
  5. admission, stats keys, knobs and validation.

Integers, masks and counters compare exactly; float aggregates across the
packages within rtol 1e-4; served against solo within one package bit for
bit. Every server a test opens is closed by the ``servers`` fixture, so no
drain thread outlives its test and feeds a later test's H2D listener.
"""
import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest

from repro.core import compress as jc
from repro.core import serve as jserve
from repro.core import telemetry as jtelemetry
from repro.core.partition import PartitionedQuery as JPQ
from repro.core.partition import PartitionedTable as JPT
from repro.core.plan import col as jcol
from repro.core.plan import plan_signature as jplan_signature
from repro.kernels import dispatch as jdispatch
from repro_torch.core import compress as tc
from repro_torch.core import serve, stream, telemetry
from repro_torch.core.partition import PartitionedQuery, PartitionedTable
from repro_torch.core.plan import col, plan_signature
from repro_torch.core.serve import DeviceResidencyLRU, QueryServer
from repro_torch.kernels import dispatch

from torch_twins import (CPU, SIX_ENCODINGS, assert_payload_close, host,
                         six_encoding_data)

REF = types.SimpleNamespace(
    name="repro", PT=JPT, PQ=JPQ, col=jcol, Server=jserve.QueryServer,
    LRU=jserve.DeviceResidencyLRU, telemetry=jtelemetry, dispatch=jdispatch,
    plan_signature=jplan_signature,
    cfg=jc.CompressionConfig(plain_threshold=1000), dev={})
PORT = types.SimpleNamespace(
    name="repro_torch", PT=PartitionedTable, PQ=PartitionedQuery, col=col,
    Server=QueryServer, LRU=DeviceResidencyLRU, telemetry=telemetry,
    dispatch=dispatch, plan_signature=plan_signature,
    cfg=tc.CompressionConfig(plain_threshold=1000), dev={"device": CPU})


@pytest.fixture
def servers():
    """``open(P, table, **kw)`` builds package ``P``'s server; every one
    is closed when the test ends, pass or fail."""
    opened = []

    def open_(P, pt, **kw):
        srv = P.Server(pt, **kw)
        opened.append(srv)
        return srv

    yield open_
    for srv in opened:
        srv.close()


def _transfers(P):
    """A scoped H2D listener of package ``P``: (context, calls list)."""
    calls = []
    return P.telemetry.h2d_listener(lambda nb, tree: calls.append(nb)), calls


def _mixed_table(P, seed=0, n=18_000, parts=6, **kw):
    rng = np.random.default_rng(seed)
    data = {
        "k": np.sort(rng.integers(0, 40, n)).astype(np.int32),
        "v": rng.integers(0, 2000, n).astype(np.int32),
        "f": rng.random(n).astype(np.float32),
    }
    return P.PT.from_arrays(data, cfg=P.cfg, num_partitions=parts, **kw,
                            **P.dev)


# the four terminal shapes of a serving mix; each returns a FRESH query
def _mk_agg(P, pt):
    return (P.PQ(pt).filter(P.col("v") > 500)
            .aggregate({"s": ("sum", "v"), "a": ("avg", "f"),
                        "c": ("count", None)}))


def _mk_groupby(P, pt):
    return (P.PQ(pt).filter(P.col("v") <= 1800)
            .groupby(["k"], {"s": ("sum", "v"), "a": ("avg", "f")},
                     num_groups_cap=64))


def _mk_ranked(P, pt):
    return (P.PQ(pt).filter(P.col("v") > 100)
            .order_by("v", descending=True, limit=9, cols=["k"]))


def _mk_groupby_ranked(P, pt):
    return (P.PQ(pt)
            .groupby(["k"], {"s": ("sum", "v")}, num_groups_cap=64)
            .order_by("s", descending=True, limit=5))


MAKERS = (_mk_agg, _mk_groupby, _mk_ranked, _mk_groupby_ranked)


def _payload(r):
    """Host payload of any terminal result shape, of either package."""
    if hasattr(r, "num_groups"):  # MergedGroupBy
        ng = int(r.num_groups)
        return {**{f"k:{g}": host(r.keys[g])[:ng] for g in r.keys},
                **{f"a:{o}": host(r.aggs[o])[:ng] for o in r.aggs}}
    if hasattr(r, "positions"):  # RankedTable
        return {"pos": host(r.positions),
                **{f"c:{n}": host(r.columns[n]) for n in r.columns}}
    return {o: host(r[o]) for o in r}  # scalar aggregate dict


def _assert_same(a, b, what=""):
    """Bit-identical payloads: keys, dtypes and values."""
    assert set(a) == set(b), what
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _attribution(ticket):
    st = ticket.stats
    return {k: st.get(k, 0) for k in ("executed", "skipped", "lru_hits",
                                      "transferred", "shared_hits")} | {
        "shared_with": ticket.shared_with, "plan_hit": ticket.plan_hit}


def _counters(srv):
    """Every deterministic counter of ``stats()``."""
    s = srv.stats()
    out = {k: s[k] for k in ("completed", "errors", "timeouts", "cancelled",
                             "expired", "oom_fallbacks")}
    out["plan_cache"] = {k: s["plan_cache"][k]
                         for k in ("hits", "misses", "size", "capacity")}
    out["residency"] = {k: s["residency"][k]
                        for k in ("hits", "misses", "evictions",
                                  "resident_bytes", "resident_partitions",
                                  "budget_bytes")}
    out["scans"] = dict(s["scans"])
    return out


def _both(scenario, *args):
    """``scenario`` run through the reference, then the port: the two
    observation dicts, held equal (answers within tolerance)."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith("answer"):
            assert_payload_close(w, got[key], key)
        else:
            assert got[key] == w, (key, got[key], w)
    return got


# ---------------------------------------------------------------------------
# 1. concurrency correctness
# ---------------------------------------------------------------------------


def test_threaded_submissions_bit_identical(servers):
    def scenario(P):
        pt = _mixed_table(P)
        expected = [_payload(mk(P, pt).run()) for mk in MAKERS]
        n_threads = 4
        got = [None] * n_threads
        srv = servers(P, pt)

        def client(slot):
            tickets = [srv.submit(mk(P, pt)) for mk in MAKERS]
            got[slot] = [_payload(srv.result(t, timeout=120))
                         for t in tickets]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        srv.close()
        stats = srv.stats()
        for slot in range(n_threads):
            for i, exp in enumerate(expected):
                _assert_same(got[slot][i], exp, P.name)
        # batching follows the threads' timing: only totals compare
        return {"completed": stats["completed"], "errors": stats["errors"],
                **{f"answer{i}": exp for i, exp in enumerate(expected)}}

    got = _both(scenario)
    assert got["completed"] == 4 * len(MAKERS) and got["errors"] == 0


def test_concurrent_submitters_lose_no_update(servers):
    """More submitter threads than cores, with a short interpreter switch
    interval: no ticket, cache count or residency count is lost (each
    partition is transferred once, every submission is counted once by
    the plan cache and once by the scan split)."""
    import os
    import sys
    pt = _mixed_table(PORT, n=6_000, parts=4)
    n_threads = max(2 * (os.cpu_count() or 1), 16)
    per_thread = 3
    listen, calls = _transfers(PORT)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with listen:
            srv = servers(PORT, pt)
            errors = []

            def client():
                try:
                    for i in range(per_thread):
                        mk = (_mk_agg, _mk_groupby)[i % 2]
                        srv.result(srv.submit(mk(PORT, pt)), timeout=300)
                except Exception as exc:  # noqa: BLE001 - asserted
                    errors.append(exc)

            threads = [threading.Thread(target=client)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            srv.close()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:1]
    total = n_threads * per_thread
    s = srv.stats()
    assert s["completed"] == total and s["errors"] == 0
    assert s["plan_cache"]["hits"] + s["plan_cache"]["misses"] == total
    assert s["plan_cache"]["misses"] == 2
    assert s["scans"]["shared_queries"] + s["scans"]["solo_queries"] == total
    assert s["residency"]["misses"] == len(calls) == len(pt.partitions)


def _enc_table(P, enc):
    data, encs = six_encoding_data(np.random.default_rng(0), enc)
    return P.PT.from_arrays(data, cfg=P.cfg, num_partitions=5,
                            encodings=encs, pack=True, **P.dev)


@pytest.mark.parametrize("enc", SIX_ENCODINGS)
def test_shared_scan_equals_per_query_all_encodings(servers, enc):
    makers = (_mk_agg, _mk_groupby, _mk_groupby_ranked)

    def scenario(P):
        pt = _enc_table(P, enc)
        srv = servers(P, pt, start=False)
        tickets = [srv.submit(mk(P, pt)) for mk in makers]
        assert srv.step() == len(makers)  # ONE admitted batch, one pass
        obs = {"counters": _counters(srv),
               "tickets": [_attribution(t) for t in tickets]}
        for i, t in enumerate(tickets):
            obs[f"answer{i}"] = _payload(srv.result(t, timeout=0))
        return obs

    got = _both(scenario)
    assert got["counters"]["scans"] == {"passes": 1, "shared_queries": 3,
                                        "solo_queries": 0}
    assert [t["shared_with"] for t in got["tickets"]] == [2, 2, 2]
    # served == solo, bit for bit, in the port
    pt = _enc_table(PORT, enc)
    for i, mk in enumerate(makers):
        _assert_same(got[f"answer{i}"], _payload(mk(PORT, pt).run()), enc)


def test_shared_scan_folds_one_pending_per_partition(servers, monkeypatch):
    """The shared pass's ``compute`` returns ONE ``stream.Pending`` holding
    every subscriber's host partial (on a card its event follows the last
    device-to-host copy, and the ring folds nothing before it)."""
    seen = []
    real = stream.pipelined_fold

    def spy(items, transfer, compute, fold, init, *a, **kw):
        def wrapped(item, cols):
            out = compute(item, cols)
            seen.append(out)
            return out
        return real(items, transfer, wrapped, fold, init, *a, **kw)

    monkeypatch.setattr(stream, "pipelined_fold", spy)
    pt = _mixed_table(PORT)
    srv = servers(PORT, pt, start=False)
    for mk in (_mk_agg, _mk_groupby):
        srv.submit(mk(PORT, pt))
    assert srv.step() == 2
    assert len(seen) == len(pt.partitions)
    assert all(isinstance(p, stream.Pending) and set(p.value) == {0, 1}
               for p in seen)


# ---------------------------------------------------------------------------
# 2. device-residency LRU
# ---------------------------------------------------------------------------


def test_hot_partition_does_zero_device_put(servers):
    def scenario(P):
        pt = _mixed_table(P)
        srv = servers(P, pt, start=False)  # unbounded residency budget
        listen, calls = _transfers(P)
        with listen:
            srv.submit(_mk_agg(P, pt))
            srv.step()
            cold = len(calls)
            # first pass moves them all
            assert cold == len(pt.partitions), (P.name, cold,
                                                len(pt.partitions))
            # different shape, same partitions: ALL resident, zero copies
            t2 = srv.submit(_mk_groupby(P, pt))
            srv.step()
            after2 = len(calls)
            # ranked queries ride the LRU too (solo execution path)
            t3 = srv.submit(_mk_ranked(P, pt))
            srv.step()
        counts = (P.name, cold, after2, len(calls), len(pt.partitions))
        assert after2 == len(calls) == cold, counts
        assert t2.stats["lru_hits"] == t3.stats["lru_hits"] == \
            len(pt.partitions), (counts, t2.stats, t3.stats)
        assert t2.stats["transferred"] == 0, (counts, t2.stats)
        return {"transfers": len(calls), "t2": _attribution(t2),
                "t3": {k: t3.stats[k] for k in ("lru_hits", "transferred",
                                                "executed")},
                "counters": _counters(srv)}

    _both(scenario)


class _LazyFuture(Future):
    """A future whose work runs only when it is waited for: a ring worker
    that has not yet picked the copy up when the head re-check comes."""

    def __init__(self, fn, args):
        super().__init__()
        self._call = (fn, args)

    def _run(self):
        if not self.done() and self.set_running_or_notify_cancel():
            fn, args = self._call
            try:
                self.set_result(fn(*args))
            except BaseException as exc:  # noqa: BLE001 - handed on
                self.set_exception(exc)

    def result(self, timeout=None):
        self._run()
        return super().result(timeout)

    def exception(self, timeout=None):
        self._run()
        return super().exception(timeout)


class _LazyPool:
    def __init__(self, max_workers=1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        return _LazyFuture(fn, args)


def test_ranked_speculation_does_not_depend_on_worker_timing(servers,
                                                             monkeypatch):
    """ROADMAP.md C7: a speculative fetch pruned at the ring's head runs
    on and is waited for when the pass ends, never cancelled, so the
    ranked query rides the LRU once a partition however late the ring's
    worker picks the fetch up (here: never before it is waited for)."""
    pt = _mixed_table(PORT)
    srv = servers(PORT, pt, start=False)
    srv.submit(_mk_agg(PORT, pt))
    srv.step()  # every partition resident
    solo = _payload(_mk_ranked(PORT, pt).run())
    monkeypatch.setattr(stream, "ThreadPoolExecutor", _LazyPool)
    t3 = srv.submit(_mk_ranked(PORT, pt))
    srv.step()
    assert t3.stats["lru_hits"] == len(pt.partitions), t3.stats
    assert t3.stats["executed"] == len(pt.partitions) - 1
    assert t3.stats["prefetch_wasted"] == 1
    _assert_same(_payload(srv.result(t3, timeout=0)), solo, PORT.name)


def test_lru_eviction_respects_byte_budget(servers):
    def scenario(P):
        pt = _mixed_table(P)
        budget = 2 * pt.max_partition_nbytes()  # room for 2 of 6 partitions
        srv = servers(P, pt, budget_bytes=budget, start=False)
        for mk in (_mk_agg, _mk_groupby, _mk_agg):
            srv.submit(mk(P, pt))
            srv.step()
        assert srv.lru.resident_bytes <= budget
        assert srv.lru.evictions > 0
        assert srv.stats()["residency"]["budget_bytes"] == budget
        # correctness is unaffected by eviction pressure
        t = srv.submit(_mk_groupby(P, pt))
        srv.step()
        served = _payload(srv.result(t, timeout=0))
        _assert_same(served, _payload(_mk_groupby(P, pt).run()), P.name)
        return {"counters": _counters(srv), "answer": served}

    _both(scenario)


def test_lru_unit_hit_miss_evict():
    def scenario(P):
        pt = _mixed_table(P, parts=4)
        parts = [p for p in pt.partitions if p.rows]
        kw = {"device": CPU} if P is PORT else {}
        lru = P.LRU(budget_bytes=2 * pt.max_partition_nbytes(), **kw)
        _, hit = lru.fetch(0, parts[0])
        assert not hit and lru.misses == 1
        _, hit = lru.fetch(0, parts[0])
        assert hit and lru.hits == 1
        for i, p in enumerate(parts):
            lru.fetch(i, p)
        assert lru.resident_bytes <= lru.budget_bytes
        assert lru.evictions >= len(parts) - 2
        obs = {k: getattr(lru, k) for k in ("hits", "misses", "evictions",
                                            "resident_bytes")}
        obs["entries"] = len(lru)
        lru.clear()
        assert len(lru) == 0 and lru.resident_bytes == 0
        return obs

    _both(scenario)


def test_lru_stores_the_transfer_and_its_event():
    """A fetch returns what ``partition._put_columns`` returned — the tree
    and its copies' event (None on the CPU) — and a hit returns the same
    object, so every later use waits on the same event."""
    pt = _mixed_table(PORT, parts=2)
    lru = DeviceResidencyLRU(budget_bytes=None, device=CPU)
    put, hit = lru.fetch(0, pt.partitions[0])
    assert not hit and isinstance(put, stream.Pending) and put.event is None
    again, hit = lru.fetch(0, pt.partitions[0])
    assert hit and again is put


# ---------------------------------------------------------------------------
# 3. plan cache
# ---------------------------------------------------------------------------


def test_plan_cache_hit_builds_no_program(servers):
    def scenario(P):
        pt = _mixed_table(P)
        srv = servers(P, pt, start=False)
        t1 = srv.submit(_mk_groupby(P, pt))
        srv.step()
        assert not t1.plan_hit
        entry = next(iter(srv.plans._entries.values()))
        built = entry.trace_count
        assert built > 0 and entry.warm
        # second submission, same shape: a hit, and the counter stays
        # flat (a violation would raise RuntimeError out of step())
        t2 = srv.submit(_mk_groupby(P, pt))
        srv.step()
        assert t2.plan_hit
        assert entry.trace_count == built
        return {"counters": _counters(srv), "hit": t2.plan_hit,
                "answer": _payload(srv.result(t2, timeout=0))}

    got = _both(scenario)
    assert got["counters"]["plan_cache"]["hits"] == 1


def test_plan_cache_hit_program_built_once():
    """The port's count is exact: one program a cache entry, however many
    submissions hit it, and the submitted queries build none."""
    pt = _mixed_table(PORT)
    srv = QueryServer(pt, start=False)
    try:
        qs = [_mk_groupby(PORT, pt) for _ in range(3)]
        for q in qs:
            srv.submit(q)
            srv.step()
        (entry,) = srv.plans._entries.values()
        assert entry.trace_count == 1 and entry.hits == 2
        assert [q.trace_count for q in qs] == [0, 0, 0]
    finally:
        srv.close()


def test_plan_signature_distinguishes_literals():
    def scenario(P):
        pt = _mixed_table(P)
        a, b, c = (P.PQ(pt).filter(P.col("v") > lit)
                   .aggregate({"c": ("count", None)})
                   for lit in (500, 501, 500))
        sa, sb, sc = (P.plan_signature(q.ops) for q in (a, b, c))
        assert sa != sb and sa == sc
        return {"a==b": sa == sb, "a==c": sa == sc}

    _both(scenario)


def test_plan_cache_capacity_bounds_entries(servers):
    def scenario(P):
        pt = _mixed_table(P)
        srv = servers(P, pt, plan_cache_size=2, start=False)
        for lit in (100, 200, 300):  # three distinct signatures
            srv.submit(P.PQ(pt).filter(P.col("v") > lit)
                       .aggregate({"c": ("count", None)}))
            srv.step()
        assert len(srv.plans) == 2  # LRU-evicted down to capacity
        assert srv.stats()["plan_cache"]["misses"] == 3
        return {"counters": _counters(srv)}

    _both(scenario)


# ---------------------------------------------------------------------------
# 4. shared-scan attribution + admission
# ---------------------------------------------------------------------------


def test_shared_scan_transfer_attribution(servers):
    def scenario(P):
        pt = _mixed_table(P)
        nparts = len(pt.partitions)
        srv = servers(P, pt, start=False)
        listen, calls = _transfers(P)
        with listen:
            ta = srv.submit(_mk_agg(P, pt))  # pays the cold transfers
            tb = srv.submit(_mk_groupby(P, pt))  # rides the same copies
            assert srv.step() == 2
        assert len(calls) == nparts
        assert ta.stats["transferred"] == nparts
        assert ta.stats["shared_hits"] == 0
        assert tb.stats["transferred"] == 0
        assert tb.stats["shared_hits"] == nparts
        return {"transfers": len(calls), "a": _attribution(ta),
                "b": _attribution(tb)}

    _both(scenario)


def test_budget_admission_limits_batch(servers):
    def scenario(P):
        pt = _mixed_table(P)
        budget = pt.max_partition_nbytes()  # one partition's worth
        with pytest.warns(UserWarning):  # depth clamp against the budget
            srv = servers(P, pt, budget_bytes=budget, start=False)
            tickets = [srv.submit(_mk_agg(P, pt)) for _ in range(3)]
            served = []
            while True:
                k = srv.step()
                if not k:
                    break
                served.append(k)
        assert served == [1, 1, 1]  # the union never fits a second query
        exp = _payload(_mk_agg(P, pt).run())
        for t in tickets:
            _assert_same(_payload(srv.result(t, timeout=0)), exp, P.name)
        return {"served": served, "counters": _counters(srv), "answer": exp}

    _both(scenario)


def test_max_batch_knob_limits_batch(servers):
    def scenario(P):
        pt = _mixed_table(P)
        srv = servers(P, pt, max_batch=2, start=False)
        for _ in range(3):
            srv.submit(_mk_agg(P, pt))
        steps = [srv.step(), srv.step(), srv.step()]
        assert steps == [2, 1, 0]
        return {"steps": steps, "counters": _counters(srv)}

    _both(scenario)


# ---------------------------------------------------------------------------
# 5. stats / knobs / validation
# ---------------------------------------------------------------------------


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_serving_stats_keys(servers):
    def scenario(P):
        pt = _mixed_table(P)
        srv = servers(P, pt)
        tickets = [srv.submit(mk(P, pt)) for mk in MAKERS]
        for t in tickets:
            srv.result(t, timeout=120)
        s = srv.stats()
        # the port's CUDA-graph counters have no twin in the reference
        graphs = s.pop("graphs", None)
        if P is PORT:
            assert set(graphs) == {"captures", "replays", "eager",
                                   "fallbacks", "slot_bytes", "pool_bytes"}
        assert s["completed"] == len(MAKERS) and s["errors"] == 0
        assert s["qps"] > 0
        assert 0 < s["p50_ms"] <= s["p99_ms"]
        for section, keys in (("plan_cache", ("hits", "misses", "hit_rate")),
                              ("residency", ("hits", "misses", "evictions",
                                             "resident_bytes", "hit_rate")),
                              ("scans", ("passes", "shared_queries",
                                         "solo_queries"))):
            for k in keys:
                assert k in s[section], (section, k)
        return {"keys": _key_tree(s), "order": list(s)}

    _both(scenario)


def test_serve_env_knobs():
    names = ("serve_budget_bytes", "plan_cache_size", "serve_max_batch")
    for env in ({}, {"REPRO_SERVE_BUDGET_BYTES": str(1 << 20),
                     "REPRO_PLAN_CACHE_SIZE": "4",
                     "REPRO_SERVE_MAX_BATCH": "2"}):
        got = dispatch.policy_from_env(env)
        want = jdispatch.policy_from_env(env)
        assert [getattr(got, n) for n in names] == \
            [getattr(want, n) for n in names]
    pol = dispatch.policy_from_env({})
    assert pol.serve_budget_bytes is None
    assert pol.plan_cache_size == 32 and pol.serve_max_batch == 8


def test_server_reads_policy_knobs(servers):
    def scenario(P):
        pt = _mixed_table(P)
        with P.dispatch.overrides(serve_max_batch=1, plan_cache_size=3):
            srv = servers(P, pt, start=False)
        assert srv.max_batch == 1 and srv.plans.capacity == 3
        return {"max_batch": srv.max_batch, "capacity": srv.plans.capacity}

    _both(scenario)


def test_submit_validation(servers):
    def scenario(P):
        pt = _mixed_table(P)
        other = _mixed_table(P, seed=1, n=4000, parts=2)
        srv = servers(P, pt, start=False)
        with pytest.raises(ValueError, match="different table"):
            srv.submit(_mk_agg(P, other))
        with pytest.raises(NotImplementedError, match="terminal"):
            srv.submit(P.PQ(pt).filter(P.col("v") > 0))
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(_mk_agg(P, pt))
        return {}

    _both(scenario)


def test_serve_module_reexported():
    import repro_torch.core as core
    assert core.QueryServer is QueryServer
    assert core.serve is serve
