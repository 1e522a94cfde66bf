"""What the benchmark's files must hold without a run: no import of JAX or
the JAX package, a reference that imports nothing of the program, a
``BENCHMARK.json`` whose every name has its file, and the arithmetic of
the profiled slice's reduction."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness, trace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (relative imports
    resolved against the package it sits in)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("perfbench" if node.level else node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"numpy", "perfbench", "__future__"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            assert (node.module or "").startswith("perfbench.reference"), node.module


def test_benchmark_json_names_and_files():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(SPEC) == keys
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert set(c["reduced"]) <= set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        _, _, cfg, traffic = harness.cell_spec(w["name"])
        for shape in traffic["shapes"]:
            assert (BENCH / "shapes" / f"{shape}.py").is_file()
            assert (BENCH / "reference" / f"{shape}.py").is_file()
        e2e = harness.metrics_of(SPEC, w["name"], False)
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert harness.metrics_of(SPEC, w["name"], True)
        assert (BENCH / "deployments" / f"{cfg['deployment']['kind']}.py").is_file()
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(harness.plugin("metrics", m["name"]).read)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  harness.metrics_of(SPEC, w, False)}


def _ev(name, s, e, device):
    return trace.Event(name, float(s), float(e), device)


def test_slice_reduction():
    sym = ("topk_select_kernel", "unpack_kernel")
    events = [
        _ev(trace.SLICE, 0, 1000, False),
        _ev(trace.REQUEST + "Q1", 0, 600, False),
        _ev("aten::nonzero", 100, 400, False),
        _ev("cudaLaunchKernel", 50, 52, False),
        _ev("cudaMemcpyAsync", 60, 61, False),
        _ev("cudaStreamSynchronize", 70, 90, False),
        # two streams overlap: 0-100 and 50-150 merge to 0-150
        _ev("void topk_select_kernel<int, 4>(int const*)", 0, 100, True),
        _ev("Memcpy HtoD (Pinned -> Device)", 50, 150, True),
        _ev("at::native::(anonymous namespace)::elementwise_kernel<128>", 500,
            700, True),
        _ev("void unpack_kernel(Packed)", 990, 1200, True),  # clipped at 1000
    ]
    s = trace.reduce(events, sym)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((150 + 200 + 10) / 1e6)
    assert s.seconds_by_kind["port"] == pytest.approx(110e-6)
    assert s.seconds_by_kind["copy"] == pytest.approx(100e-6)
    assert s.seconds_by_kind["library"] == pytest.approx(200e-6)
    assert s.runtime_calls == 2
    assert s.idle_gaps[0] == ["Q1: aten::nonzero", pytest.approx(350e-6)]
    # 700-990: no op and no request open, after the op that ended at 400
    assert s.idle_gaps[1][0] == "python after aten::nonzero"
    assert [n for n, _ in s.device_ops][:2] == ["at::native::elementwise_kernel",
                                               "topk_select_kernel"]
    assert trace.reduce([_ev(trace.SLICE, 0, 10, False)], sym) is None


def test_port_symbols_are_the_kernels():
    """The frozen list names each kernel once, where its source defines
    it; a metric's reader of another name falls back to its stem."""
    kernels = json.loads((BENCH / "kernels.json").read_text())["kernels"]
    assert len(harness.KERNELS) == len(set(harness.KERNELS)) == len(kernels)
    for k in kernels:
        src = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ",
                     (ROOT / k["file"]).read_text())
        assert re.search(rf"__global__[^(;{{]*\b{k['name']}\s*\(", src, re.S), k
    assert harness.plugin("metrics", "p95_ms.host") is harness.plugin("metrics", "p95_ms")
    with pytest.raises(FileNotFoundError):
        harness.plugin("metrics", "no_such_metric.host")
    assert trace.union([(5, 6), (0, 2), (1, 3), (7, 7)]) == [(0, 3), (5, 6)]
