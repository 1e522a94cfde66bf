"""The served per-partition program as a CUDA graph (``core/graphs.py``,
DESIGN.md §13), on the CPU. Port only: no twin in the reference.

  * a guard over the TPC-H-shaped partition programs of the benchmark's
    served cell (Q1, Q6, Q19 at a tiny size): none builds a device
    tensor from host data, moves a host tensor to the device, reads a
    device value on the host or takes a shape from device data, which is
    what keeps them capturable;
  * the graph key separates partition layouts, key-set capacities and
    the dispatch policy's routes;
  * a capture holds its launch and route records back, and every replay
    books them (``kernels._build.tape``), as eager runs book theirs;
  * the static slot's bytes come out of the server's budget;
  * off CUDA every program counts as ``eager`` and ``stats()`` has the
    ``graphs`` counters; a capture that fails leaves its key eager, is
    counted, and the answers stay the eager ones.

The card's half (replays bit-identical to the eager program) is in
``tests/test_torch_gpu.py``.
"""
import dataclasses
import json
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import compress, graphs, serve, telemetry
from repro_torch.core.partition import (
    PartitionedQuery,
    PartitionedTable,
    base_masked_program,
    device_put,
)
from repro_torch.core.table import Table
from repro_torch.kernels import _build, dispatch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHAPES = ("Q1", "Q1s", "Q6", "Q19")
SCALE = 0.003  # TPC-H scale factor: about 18,000 LINEITEM rows
PART_ROWS = 1 << 12  # 5 partitions, the last one shorter


@pytest.fixture(scope="module")
def served():
    """The served cell's tables at a tiny size, on the CPU: LINEITEM as
    packed partitions, PART resident; and the cell's query shapes."""
    from perfbench import generate, harness
    cfg = json.loads((ROOT / "perfbench/configs/tpch_sf10_served_third.json")
                     .read_text())
    data = generate.make(cfg, 3_000_000_019, device=CPU, scale=SCALE)
    comp = compress.CompressionConfig(**cfg["deployment"]["compression"])
    pt = PartitionedTable.from_arrays(data.lineitem, cfg=comp,
                                      partition_rows=PART_ROWS, pack=True,
                                      device=CPU)
    tables = {"lineitem": pt,
              "part": Table.from_arrays(data.part, cfg=comp, device=CPU)}
    shapes = {n: harness.plugin("shapes", n) for n in SHAPES}
    return tables, shapes


class _Guard(TorchFunctionMode):
    """Records every call that a CUDA graph cannot hold: a tensor built
    from host data for a device, a host-built tensor moved to one, a
    device value read on the host, a shape taken from device data."""

    FACTORIES = {torch.tensor, torch.as_tensor, torch.asarray,
                torch.scalar_tensor}
    READS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__", "nonzero", "masked_select",
             "unique", "unique_consecutive", "bincount", "argwhere"}

    def __init__(self):
        super().__init__()
        self.host_built = {}  # id -> weakref of each host-built tensor
        self.found = []

    def _host(self, t) -> bool:
        ref = self.host_built.get(id(t))
        return ref is not None and ref() is t

    def _mark(self, t) -> None:
        self.host_built[id(t)] = weakref.ref(t)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        out = func(*args, **kwargs)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        host = all(self._host(t) for t in tensors)
        if func in self.FACTORIES:
            if not isinstance(args[0], torch.Tensor):
                if "device" in kwargs:
                    self.found.append(f"{name}(host data, device=...)")
                elif isinstance(out, torch.Tensor):
                    self._mark(out)
        elif tensors and host and name in ("to", "cuda", "copy_") and (
                "device" in kwargs or name == "cuda"
                or any(isinstance(a, (str, torch.device)) for a in args[1:])):
            self.found.append(f"host-built tensor .{name}(device)")
        elif tensors and not host and name in self.READS:
            self.found.append(f".{name}() of a device value")
        elif (name == "repeat_interleave" and "output_size" not in kwargs):
            self.found.append("repeat_interleave without output_size")
        elif (name == "__getitem__" and len(args) > 1
              and isinstance(args[1], torch.Tensor)
              and args[1].dtype == torch.bool):
            self.found.append("boolean-mask indexing")
        elif tensors and host and isinstance(out, torch.Tensor):
            self._mark(out)
        return out


def _no_numpy(*_a, **_k):
    raise AssertionError("torch.from_numpy inside a partition program")


@pytest.mark.parametrize("kernels", [None, True], ids=["auto", "kernels"])
@pytest.mark.parametrize("shape", ["Q1", "Q6", "Q19"])
def test_partition_programs_build_nothing_from_host_data(served, shape,
                                                         kernels,
                                                         monkeypatch):
    """Every partition's program of the served cell's Q1, Q6 and Q19, on
    the plain route and on the kernels' (their CPU versions), makes no
    call that a CUDA graph capture refuses or that synchronises."""
    tables, shapes = served
    q = shapes[shape].build(tables, PartitionedQuery)
    key_sets = tuple(q._prepare_inputs())
    program = base_masked_program(q.build(partial=True))
    monkeypatch.setattr(torch, "from_numpy", _no_numpy)
    with dispatch.overrides(use_kernels=kernels):
        for i, part in enumerate(tables["lineitem"].partitions):
            cols = device_put(part.table.columns, CPU)
            guard = _Guard()
            with guard:
                program(cols, key_sets, part.rows)
            assert guard.found == [], (shape, i, guard.found)


def test_guard_sees_what_capture_refuses():
    """The guard itself: each forbidden pattern is reported."""
    x = torch.arange(6)
    cases = {
        "build": lambda: torch.tensor(3, device=x.device),
        "move": lambda: torch.tensor(3).to(x.device),
        "read": lambda: int(x.sum()),
        "shape": lambda: x[x > 2],
    }
    for what, call in cases.items():
        guard = _Guard()
        with guard:
            call()
        assert len(guard.found) == 1, (what, guard.found)
    guard = _Guard()
    with guard:  # host-only scratch and fill kernels are fine
        torch.tensor(7).to(torch.int8).item()
        torch.where(x > 2, x, 9)
        torch.full((), 5, dtype=torch.int32, device=x.device)
    assert guard.found == []


def test_key_separates_layouts_and_key_set_capacities(served):
    tables, shapes = served
    pt = tables["lineitem"]
    runner = graphs.ProgramGraphs(pt, CPU)
    layouts = runner._layouts
    assert len(layouts) == len(pt.partitions) == 5
    # the last partition is shorter: another layout than the first
    assert layouts[-1] != layouts[0]
    assert pt.partitions[-1].padded_rows < pt.partitions[0].padded_rows
    # a layout is its tree's description: the same tree gives the same key
    p0 = pt.partitions[0]
    assert graphs.layout_key((p0.table.columns, p0.rows)) == layouts[0]
    assert graphs.layout_key((device_put(p0.table.columns, CPU),
                              p0.rows)) == layouts[0]
    # the real row count is baked into the base mask: part of the key
    assert (graphs.layout_key((p0.table.columns, p0.rows - 1))
            != layouts[0])
    # Q19's join side at two capacities: two keys
    q = shapes["Q19"].build(tables, PartitionedQuery)
    (keys, n, pay), = q._prepare_inputs()
    wider = ((torch.cat([keys, keys]), n,
              {c: torch.cat([v, v]) for c, v in pay.items()}),)
    assert graphs.layout_key(((keys, n, pay),)) != graphs.layout_key(wider)
    fresh = tuple(shapes["Q19"].build(tables, PartitionedQuery)
                  ._prepare_inputs())
    assert graphs.layout_key(fresh) == graphs.layout_key(((keys, n, pay),))
    # host values are typed: an offset of 5 and of 5.0 promote differently
    assert graphs.layout_key(5) != graphs.layout_key(5.0)


def test_route_key_follows_the_dispatch_policy():
    """The routes a capture bakes in are part of the key: every route
    field is the policy's, and changing one (kernels off, a threshold)
    changes the key; a field that picks no route (tracing) does not."""
    fields = {f.name for f in dataclasses.fields(dispatch.DispatchPolicy)}
    assert set(graphs.ROUTE_FIELDS) <= fields
    base = graphs.route_key(dispatch.policy())
    for kw in ({"use_kernels": False}, {"use_kernels": True},
               {"rle_decode_min_rows": 1 << 30},
               {"bucketize_min_queries": 1 << 30},
               {"enable_sort_free": False}, {"topk_min_rows": 1 << 30}):
        with dispatch.overrides(**kw) as pol:
            assert graphs.route_key(pol) != base, kw
    with dispatch.overrides(enable_trace=True, prefetch_depth=0) as pol:
        assert graphs.route_key(pol) == base


def test_tape_holds_launches_and_routes_for_each_replay():
    """Inside ``tape()`` a launch and a routing decision book nothing;
    each ``play`` books them as a launch made then would: the launch
    count, its shape class and its ``kernel`` instant with its bytes,
    and the route counter."""
    saved = ({k: v for k, v in _build.LAUNCHES.items()},
             {k: dict(v) for k, v in _build.SHAPES.items()})
    _build.reset_launches()
    telemetry.reset()
    try:
        with dispatch.overrides(enable_trace=True):
            with _build.tape() as taped:
                _build.count_launch("unpack_kernel", 64, "w=7", 320)
                dispatch._route("unpack", "kernel", lambda: "n=64")
                assert _build.taping()
            assert not _build.taping()
            reg = telemetry.registry()
            assert len(taped) == 2
            assert _build.LAUNCHES["unpack_kernel"] == 0
            assert reg.events(name="kernel") == []
            assert reg.counters().get("route.unpack.kernel", 0) == 0
            for _ in range(2):
                _build.play(taped)
            assert _build.LAUNCHES["unpack_kernel"] == 2
            assert _build.SHAPES["unpack_kernel"] == {"w=7": 2}
            assert [e["attrs"]["nbytes"]
                    for e in reg.events(name="kernel")] == [320, 320]
            assert reg.counters()["route.unpack.kernel"] == 2
    finally:
        telemetry.reset()
        _build.LAUNCHES.update(saved[0])
        _build.SHAPES.update(saved[1])


class _NoGraph:
    def replay(self):
        pass


class _Taping(graphs.ProgramGraphs):
    """Takes the server for a card's and "captures" by running the
    program eagerly (under the runner's tape, as a real capture is);
    its "replays" run nothing, so its answers are stale. What it checks
    is the runner's bookkeeping: the records booked and the keys kept."""

    def __init__(self, table, device):
        super().__init__(table, torch.device("cuda"))

    def _capture(self, program, layout, cols, key_sets, rows):
        return graphs._Graph(_NoGraph(), key_sets,
                             program(cols, key_sets, rows))

    def _fill(self, layout, cols, keys, key_sets):
        pass


def _routes_by_round(pt, tables, shapes, rounds, **over):
    """The route counters each round of the four shapes books, and the
    server (closed)."""
    out = []
    try:
        with dispatch.overrides(enable_trace=True, **over):
            with serve.QueryServer(pt, start=False) as srv:
                for _ in range(rounds):
                    telemetry.reset()
                    _answers(srv, tables, shapes, rounds=1)
                    out.append({k: v for k, v in
                                telemetry.registry().counters().items()
                                if k.startswith("route.")})
    finally:
        telemetry.reset()
    return out, srv


def test_replays_book_the_routes_eager_runs_book(served, monkeypatch):
    """Round by round, a runner that captures and replays books the
    routing records that eager runs book; a change of route policy on a
    live server is a new key, first run eagerly, not a replay of the old
    routes."""
    tables, shapes = served
    pt = tables["lineitem"]
    eager, _ = _routes_by_round(pt, tables, shapes, rounds=3)
    monkeypatch.setattr(serve.graphs_mod, "ProgramGraphs", _Taping)
    graphed, srv = _routes_by_round(pt, tables, shapes, rounds=3)
    g = srv.graphs.stats()
    assert g["replays"] > g["captures"] > 0
    assert sum(eager[-1].values()) > 0
    assert graphed == eager
    with serve.QueryServer(pt, start=False) as srv:
        _answers(srv, tables, shapes, rounds=2)
        before = srv.graphs.stats()
        with dispatch.overrides(use_kernels=True):
            _answers(srv, tables, shapes, rounds=1)
        after = srv.graphs.stats()
        keys = [k for e in srv.plans._entries.values() for k in e.graphs]
    new = [k for k in keys
           if k[2] != graphs.route_key(dispatch.policy())]
    assert len({k[2] for k in keys}) == 2 and new
    # each new key's first sighting ran eagerly, its second captured
    assert after["eager"] - before["eager"] == len(new)
    assert after["captures"] > before["captures"]


def test_slot_bytes_come_out_of_the_budget(served):
    """On a card the slot holds the largest partition's tree, and the
    residency LRU and the prefetch ring get the budget less the slot;
    off CUDA there is no slot."""
    tables, _ = served
    pt = tables["lineitem"]
    on_card = graphs.ProgramGraphs(pt, torch.device("cuda"))
    largest = max(graphs.slot_nbytes(p.table.columns) for p in pt.partitions)
    assert on_card.slot_nbytes == largest >= pt.max_partition_nbytes()
    assert on_card.slot_nbytes % graphs.SLOT_ALIGN == 0
    assert graphs.ProgramGraphs(pt, CPU).slot_nbytes == 0
    budget = 3 * pt.max_partition_nbytes()
    with serve.QueryServer(pt, budget_bytes=budget, start=False) as srv:
        assert srv.lru.budget_bytes == budget  # CPU: nothing held back
        assert srv.stats()["graphs"]["slot_bytes"] == 0

    class _OnCard(graphs.ProgramGraphs):
        def __init__(self, table, device):
            super().__init__(table, torch.device("cuda"))

    real = serve.graphs_mod.ProgramGraphs
    serve.graphs_mod.ProgramGraphs = _OnCard
    try:
        srv = serve.QueryServer(pt, budget_bytes=budget, start=False)
    finally:
        serve.graphs_mod.ProgramGraphs = real
    try:
        s = srv.stats()
        assert srv.lru.budget_bytes == budget - on_card.slot_nbytes
        assert s["graphs"]["slot_bytes"] == on_card.slot_nbytes
        assert s["residency"]["budget_bytes"] == budget
    finally:
        srv.close()


def _answers(srv, tables, shapes, rounds):
    out = []
    for _ in range(rounds):
        tickets = [(n, srv.submit(shapes[n].build(tables, PartitionedQuery)))
                   for n in SHAPES]
        while srv.step():
            pass
        out += [(n, srv.result(t, timeout=0), t.stats) for n, t in tickets]
    return out


def _same(a, b):
    if isinstance(a, dict):
        return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                   for k in a) and set(a) == set(b)
    return (int(a.num_groups) == int(b.num_groups)
            and _same(dict(a.keys), dict(b.keys))
            and _same(dict(a.aggs), dict(b.aggs)))


def test_off_cuda_every_program_is_eager(served):
    """Three rounds of the mix on the CPU: every (query, partition)
    program runs eagerly and is counted so; each ``serve.program`` span
    says ``graph=eager``; answers equal the solo runs'."""
    tables, shapes = served
    pt = tables["lineitem"]
    solo = {n: shapes[n].build(tables, PartitionedQuery).run()
            for n in SHAPES}
    telemetry.reset()
    try:
        with dispatch.overrides(enable_trace=True):
            with serve.QueryServer(pt, start=False) as srv:
                got = _answers(srv, tables, shapes, rounds=3)
                g = srv.stats()["graphs"]
        spans = telemetry.registry().events(name="serve.program")
    finally:
        telemetry.reset()
    programs = sum(st["executed"] for _, _, st in got)
    assert programs >= 3 * len(SHAPES) * 2  # zone maps prune the rest
    assert g == {"captures": 0, "replays": 0, "eager": programs,
                 "fallbacks": 0, "slot_bytes": 0, "pool_bytes": 0}
    assert len(spans) == programs
    assert {e["attrs"]["graph"] for e in spans} == {"eager"}
    for n, res, _ in got:
        assert _same(res, solo[n]), n


def test_failed_capture_falls_back_to_eager_for_good(served, monkeypatch):
    """A runner that takes the server for a card's: each key's second
    sighting tries a capture, which fails;
    the key runs eagerly from then on, the fallback is counted once a
    key, and the answers are the eager ones."""
    tables, shapes = served
    pt = tables["lineitem"]
    solo = {n: shapes[n].build(tables, PartitionedQuery).run()
            for n in SHAPES}

    class _OnCard(graphs.ProgramGraphs):
        def __init__(self, table, device):
            super().__init__(table, torch.device("cuda"))

        def _capture(self, program, layout, cols, key_sets, rows):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(serve.graphs_mod, "ProgramGraphs", _OnCard)
    with serve.QueryServer(pt, start=False) as srv:
        got = _answers(srv, tables, shapes, rounds=3)
        g = srv.stats()["graphs"]
        # one key a (query, layout): partitions of one layout share it
        states = [st for e in srv.plans._entries.values()
                  for st in e.graphs.values()]
    assert len(states) >= len(SHAPES)
    assert set(states) == {graphs._EAGER}
    assert g["fallbacks"] == len(states)
    assert g["captures"] == g["replays"] == 0
    assert g["eager"] == sum(st["executed"] for _, _, st in got)
    for n, res, _ in got:
        assert _same(res, solo[n]), n
