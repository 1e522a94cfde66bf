"""The harness end to end on the CPU at a tiny scale, and its refusals."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests._tiny import CELLS, LINE_KEYS, quiet_warnings, run_cell  # noqa: F401

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_matches_the_reference(workload, traced, quiet_warnings):  # noqa: F811
    line = run_cell(workload, traced=traced)
    assert LINE_KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["exact_mismatches"]["value"] == 0
    want = {m["name"] for m in harness.metrics_of(
        json.loads((ROOT / "BENCHMARK.json").read_text()), workload, traced)}
    # the CPU has no device metrics: those come from the card alone
    device_only = {"peak_mib", "launch_calls_per_query", "op_ms_per_query",
                   "kernel_ms_per_query", "idle_share", "hbm_roofline"}
    assert set(line["metrics"]) == {n for n in want
                                    if n.split(".")[0] not in device_only}
    assert line["device"]["platform"] == "cpu"
    json.dumps(line)  # the line is JSON
    if workload == "served_mix" and traced:  # deltas over the window
        m = line["metrics"]
        assert m["queries_per_pass"]["value"] >= 1.0
        assert 0.0 <= m["lru_hit_rate"]["value"] <= 1.0
        assert m["h2d_mb_per_query"]["value"] > 0


def _run_cli(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "resident_scan",
         "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=env)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_cli_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_cli(ROOT, env=env)
    assert proc.returncode != 0 and _no_result(proc), proc.stdout


def test_cli_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and _no_result(proc), proc.stdout


def test_result_refused_when_jax_was_loaded(capsys):
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {}, "checks": {"unanswered": {"value": 0, "limit": 0}}}
    clean = {"numpy": None, "torch": None, "repro_torch.core": None,
             "repro_torch_extra": None}  # longer names are not repro
    for loaded in ("jax", "jaxlib.xla_client", "flax", "repro.core"):
        assert harness.print_result(line, {**clean, loaded: None}) != 0
        out, err = capsys.readouterr()
        assert "{" not in out and loaded.split(".")[0] in err
    assert harness.print_result(line, clean) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check unanswered: 0")


def test_same_seed_same_inputs_and_sequences():
    from perfbench import generate
    _, _, cfg, traffic = harness.cell_spec("served_mix")
    a = generate.make(cfg, 2**31 + 7, scale=0.001)
    b = generate.make(cfg, 2**31 + 7, scale=0.001)
    c = generate.make(cfg, 2**31 + 8, scale=0.001)
    assert all((a.lineitem[k] == b.lineitem[k]).all() for k in a.lineitem)
    assert len(a.lineitem["price"]) == len(c.lineitem["price"])  # the same sizes
    assert not (a.lineitem["price"] == c.lineitem["price"]).all()
    # every block of a client's sequence holds the whole mix once
    bag = harness.shape_bag(traffic)
    assert sorted(bag) == sorted(traffic["shapes"])


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card_tiny(workload, card, quiet_warnings):  # noqa: F811
    line = harness.run_cell(workload, 11, 0.5, True, card,
                            scale=0.05, slice_s=0.5)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
    by_stem = {n.split(".")[0]: m["value"] for n, m in line["metrics"].items()}
    for name in ("idle_share", "kernel_ms_per_query", "hbm_roofline"):
        assert name in by_stem, sorted(line["metrics"])
    assert by_stem["hbm_roofline"] <= 100.0
