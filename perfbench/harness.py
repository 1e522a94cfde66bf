"""One run of one cell: set-up, a closed loop over the timed window, with
``trace`` a profiled slice after it, then the check against the plain
reference and the result line.

Everything that belongs to one configuration, traffic mix, query shape or
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives: ``configs/<config>.json`` (with its deployment's
code in ``deployments/<kind>.py``), ``workloads/<traffic>.json``,
``shapes/<shape>.py`` beside ``reference/<shape>.py``, and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from perfbench import generate, trace
from perfbench.reference import compare as compare_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
KERNELS = tuple(k["name"] for k in json.loads(
    (BENCH / "kernels.json").read_text())["kernels"])
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LATE_S = 60.0  # how long past the window's close an answer may still come


def plugin(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``, or where there is no
    such file, the one named by ``name`` up to its first dot (a metric
    such as ``p95_ms.host`` is ``p95_ms`` read in other cells)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    modname = f"perfbench.{kind}.{path.stem.replace('.', '__')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, bench_file: Path = ROOT / "BENCHMARK.json"):
    """(benchmark, cell entry, configuration file, traffic file) of
    ``workload``."""
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{cell['traffic']}.json")
                         .read_text())
    if traffic["config"] != cell["config"]:
        raise ValueError(f"traffic {cell['traffic']} is for {traffic['config']}, "
                         f"cell {workload} for {cell['config']}")
    return bench, cell, cfg, traffic


def metrics_of(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with ``traced`` the per-layer ones."""
    out = []
    for m in bench["per_layer" if traced else "end_to_end"]:
        if workload in m.get("workloads", [workload]):
            out.append(m)
    return out


@dataclasses.dataclass
class Request:
    client: int
    shape: str
    t_call: float
    t_done: float = 0.0
    answer: Optional[dict] = None
    stats: Optional[dict] = None  # the server's attribution of a ticket
    error: Optional[str] = None

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_call) * 1e3


@dataclasses.dataclass
class Run:
    """What one run saw; the metric readers read it."""

    workload: str
    seed: int
    seconds: float
    traced: bool
    cfg: dict
    traffic: dict
    device: object
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    requests: List[Request] = dataclasses.field(default_factory=list)
    window: tuple = (0.0, 0.0)  # host clock
    slice_window: Optional[tuple] = None  # host clock, traced runs
    counters: Dict[str, dict] = dataclasses.field(default_factory=dict)
    stored_bytes: int = 0
    plain_bytes: int = 0
    peak_bytes: int = 0
    input_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    slice: Optional[trace.Slice] = None

    def done(self, window=None) -> List[Request]:
        """Requests answered inside ``window`` (default: the timed one)."""
        t0, t1 = self.window if window is None else window
        return [r for r in self.requests
                if r.error is None and t0 <= r.t_done <= t1]

    def counter_delta(self, name: str) -> int:
        return self.counters["end"][name] - self.counters["start"][name]


def shape_bag(traffic: dict) -> List[str]:
    """The shapes of one block of a client's sequence: each name repeated
    by its weight (whole numbers)."""
    bag = []
    for name, weight in sorted(traffic["shapes"].items()):
        if int(weight) != weight or weight < 1:
            raise ValueError(f"weight of {name} must be a whole number >= 1")
        bag += [name] * int(weight)
    return bag


class Loop:
    """Closed-loop clients: each sends its next request when the last has
    answered, in blocks that hold every shape of the mix by its weight, in
    an order drawn from the seed; no new request once ``stop`` is set."""

    def __init__(self, deployment, shapes: dict, traffic: dict, seed: int,
                 label: bool):
        self.deployment = deployment
        self.shapes = shapes
        self.bag = shape_bag(traffic)
        self.clients = int(traffic["clients"])
        self.seed = seed
        self.label = label
        self.requests: List[Request] = []
        self._lock = threading.Lock()
        self.stop = threading.Event()

    def _client(self, c: int) -> None:
        import torch
        rng = generate.rng_for(self.seed, 1, c)
        block: List[str] = []
        while not self.stop.is_set():
            if not block:
                block = [self.bag[i] for i in rng.permutation(len(self.bag))]
            name = block.pop()
            req = Request(client=c, shape=name, t_call=time.perf_counter())
            try:
                if self.label:
                    with torch.profiler.record_function(trace.REQUEST + name):
                        req.answer, req.stats = self.deployment.request(
                            self.shapes[name])
                else:
                    req.answer, req.stats = self.deployment.request(
                        self.shapes[name])
            except Exception as exc:  # noqa: BLE001 - counted as failed
                req.error = f"{type(exc).__name__}: {exc}"
            req.t_done = time.perf_counter()
            with self._lock:
                self.requests.append(req)

    def start(self) -> List[threading.Thread]:
        threads = [threading.Thread(target=self._client, args=(c,),
                                    name=f"perfbench-client-{c}", daemon=True)
                   for c in range(self.clients)]
        for t in threads:
            t.start()
        return threads


def _log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    if getattr(device, "type", device) == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _profile_slice(run: Run, slice_s: float, loop: Loop):
    """Profile ``slice_s`` seconds, counted from when the profiler is
    ready (its start takes seconds), stop the clients, and keep the
    reduced slice."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        extra = {"experimental_config":
                 _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    prof = profile(activities=acts, **extra)
    prof.start()
    t0 = time.perf_counter()
    with record_function(trace.SLICE):
        time.sleep(slice_s)
        _sync(run.device)
    t1 = time.perf_counter()
    prof.stop()
    loop.stop.set()
    run.slice_window = (t0, t1)
    t = time.perf_counter()
    run.slice = trace.reduce(trace.events_of(prof), KERNELS)
    run.timings["trace_read_s"] = time.perf_counter() - t


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names among ``modules`` (default: this process's) that
    are JAX, its libraries or the JAX package, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def check_answers(run: Run, data):
    """Every answered request against its shape's reference. Returns the
    compared numbers, each with its limit, and whether all hold."""
    want = {name: plugin("reference", name).answer(data)
            for name in sorted({r.shape for r in run.requests})}
    mismatches, rel = 0, 0.0
    for r in run.requests:
        if r.error is not None:
            continue
        bad, err = compare_mod.compare(r.answer, want[r.shape])
        mismatches += bad
        rel = max(rel, err)
    unanswered = sum(1 for r in run.requests if r.error is not None)
    limits = run.cfg["correct"]
    checks = {
        "exact_mismatches": {"value": mismatches,
                             "limit": limits["exact_mismatches"]},
        "float_rel_err": {"value": rel, "limit": limits["float_rel_err"]},
        "unanswered": {"value": unanswered, "limit": 0},
    }
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return checks, ok


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: Optional[float] = None,
             scale: Optional[float] = None,
             slice_s: Optional[float] = None) -> dict:
    """Run ``workload`` once on ``device`` and return the result line.
    ``scale`` replaces the configuration's scale factor and ``slice_s``
    shortens the profiled slice (the CPU tests)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench, _, cfg, traffic = cell_spec(workload)
    device = torch.device(device)
    run = Run(workload=workload, seed=seed, seconds=seconds, traced=traced,
              cfg=cfg, traffic=traffic, device=device)
    shapes = {name: plugin("shapes", name) for name in traffic["shapes"]}

    t = time.perf_counter()
    data = generate.make(cfg, seed, device=device, scale=scale)
    run.timings["generate_s"] = time.perf_counter() - t
    run.plain_bytes = data.plain_bytes()
    _log(f"generate: LINEITEM {len(data.lineitem['price'])} rows, PART "
         f"{len(data.part['partkey'])}: {run.timings['generate_s']:.3f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    t = time.perf_counter()
    dep_mod = plugin("deployments", cfg["deployment"]["kind"])
    deployment = dep_mod.Deployment(cfg, data, device)
    _sync(device)
    run.timings["ingest_s"] = time.perf_counter() - t
    run.stored_bytes = deployment.stored_bytes
    _log(f"ingest: {run.stored_bytes} B stored for {run.plain_bytes} B plain: "
         f"{run.timings['ingest_s']:.3f} s")
    loop = None
    try:
        t = time.perf_counter()
        deployment.warm(shapes)
        _sync(device)
        run.timings["warm_s"] = time.perf_counter() - t
        _log(f"warm-up: {len(shapes)} shapes: {run.timings['warm_s']:.3f} s")
        run.input_bytes = {n: int(s.input_bytes(deployment.tables))
                           for n, s in shapes.items()}

        loop = Loop(deployment, shapes, traffic, seed, label=traced)
        if not traced:
            slice_s = 0.0
        elif slice_s is None:
            slice_s = float(traffic["trace_slice_s"])
        run.counters["start"] = deployment.counters()
        t0 = time.perf_counter()
        run.timings["setup_s"] = t0 - t_start
        window_end = t0 + seconds
        threads = loop.start()
        time.sleep(max(window_end - time.perf_counter(), 0.0))
        run.counters["end"] = deployment.counters()
        run.window = (t0, window_end)
        if traced:
            _profile_slice(run, slice_s, loop)
        loop.stop.set()
        late_by = time.perf_counter() + LATE_S
        for th in threads:
            th.join(timeout=max(late_by - time.perf_counter(), 0.1))
        if any(th.is_alive() for th in threads):
            raise RuntimeError(f"a client still waits {LATE_S} s past the "
                               "window's close")
        run.requests = sorted(loop.requests, key=lambda r: r.t_call)
        if device.type == "cuda":
            run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    finally:
        if loop is not None:
            loop.stop.set()
        deployment.close()
    del deployment, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _log(f"window: {len(run.done())} answered in {seconds} s, "
         f"{len(run.requests)} requests in all")

    t = time.perf_counter()
    checks, ok = check_answers(run, data)
    run.timings["reference_s"] = time.perf_counter() - t
    _log(f"reference: {run.timings['reference_s']:.3f} s")

    metrics = {}
    for m in metrics_of(bench, workload, traced):
        value = plugin("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": ok,
        "attempted": len(run.requests),
        "failed": sum(1 for r in run.requests if r.error is not None),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": run.peak_bytes,
        },
    }
    if traced and run.slice is not None:
        line["device"]["busy_s"] = run.slice.busy_s
        line["device"]["window_s"] = run.slice.window_s
        line["breakdown"] = {"device_ops": run.slice.device_ops,
                             "idle_gaps": run.slice.idle_gaps}
    line["checks"] = checks
    return line


def print_result(line: dict, modules=None) -> int:
    """Print the check's numbers (last on standard error) and the result
    line (last on standard output); refuse a process that loaded JAX, its
    libraries or the JAX package (``modules``: ``sys.modules`` by
    default). Returns the exit code."""
    found = forbidden_modules(modules)
    if found:
        print(f"refused: the process loaded {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0
