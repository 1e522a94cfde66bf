"""Twins of ``repro.launch.hlo_cost`` and ``repro.launch.dryrun`` in the
port (``repro_torch.launch.hlo_cost`` over recorded aten ops,
``repro_torch.launch.dryrun`` on the meta device), on the CPU.

* ``hlo_cost.analyze`` on tiny programs against the reference's
  ``analyze(jit(f).lower(...).compile().as_text())``: FLOPs equal for a
  lone ``mm``, a ``bmm``, an elementwise chain; bytes equal where XLA:CPU
  leaves the op alone (``mm``, ``bmm``). Where XLA:CPU changes the
  program, the test names the change and holds each side to its own
  count: it fuses the elementwise chain into one loop fusion (one HBM
  round trip, where the eager port makes three), and it splits a row sum
  into a ``reduce-window`` of 32-wide partial sums and a ``reduce`` of
  the partials (the partials counted again).
* Collectives: ``allreduce_topk`` traced on a gloo world of one, its
  all-gather and all-reduce bytes and counts under the reference's names.
* A smoke forward's dot FLOPs equal to an analytic count.
* ``run_cell`` with ``status == "ok"`` on two full-size cells, every op
  on the meta device; the CLI's records, skips and errors.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.launch import hlo_cost as RH
from repro_torch import configs as TC
from repro_torch.distributed import compression as TComp
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_cost as TH
from repro_torch.launch import mesh as TMesh
from repro_torch.models import model as TM


def _ref(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return RH.analyze(jax.jit(f).lower(*args).compile().as_text())


def _port(f, *shapes):
    args = [torch.empty(s, device="meta") for s in shapes]
    with TH.Trace() as trace:
        f(*args)
    return TH.analyze(trace), trace


def test_mm_flops_and_bytes_equal_the_reference():
    want = _ref(lambda a, b: a @ b, (64, 32), (32, 48))
    got, trace = _port(lambda a, b: a @ b, (64, 32), (32, 48))
    assert [op.name for op in trace.ops] == ["mm"]
    assert got["flops"] == want["flops"] == 2.0 * 64 * 48 * 32
    assert got["bytes"] == want["bytes"] == 4 * (64 * 32 + 32 * 48 + 64 * 48)


def test_bmm_flops_and_bytes_equal_the_reference():
    want = _ref(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                (4, 16, 8), (4, 8, 12))
    got, trace = _port(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       (4, 16, 8), (4, 8, 12))
    assert "bmm" in [op.name for op in trace.ops]
    assert got["flops"] == want["flops"] == 2.0 * 4 * 16 * 12 * 8
    assert got["bytes"] == want["bytes"]


def test_elementwise_chain_flops_equal_the_reference():
    """XLA:CPU fuses mul, add, tanh into one loop fusion: one round trip
    of x and the result; the eager port makes three."""
    n = 128 * 64
    want = _ref(lambda x: jnp.tanh(x * x + x), (128, 64))
    got, trace = _port(lambda x: torch.tanh(x * x + x), (128, 64))
    assert [op.name for op in trace.ops] == ["mul", "add", "tanh"]
    assert got["flops"] == want["flops"] == 3.0 * n
    assert want["bytes"] == 4 * 2 * n  # the fusion
    # x*x reads x once (2n), x*x+x two operands (3n), tanh (2n)
    assert got["bytes"] == 4 * (2 * n + 3 * n + 2 * n)


def test_row_sum_flops():
    """XLA:CPU splits the row sum into a reduce-window to [128, 2] partials
    and a reduce of them: the reference counts the partials again (and the
    init scalar as an operand); the port's one ``sum`` counts its
    operand."""
    rows, cols = 128, 64
    want = _ref(lambda x: x.sum(-1), (rows, cols))
    got, _ = _port(lambda x: x.sum(-1), (rows, cols))
    assert got["flops"] == rows * cols
    assert want["flops"] == rows * cols + rows * 2
    assert got["bytes"] == 4 * (rows * cols + rows)


def test_views_move_no_bytes_and_gathers_follow_the_reference_rule():
    def f(w, idx):
        rows = w[3]  # a view
        picked = torch.index_select(w, 0, idx)  # a gather
        return rows, picked
    w = torch.empty((16, 8), device="meta")
    idx = torch.empty((5,), dtype=torch.int64, device="meta")
    with TH.Trace() as trace:
        f(w, idx)
    kinds = {op.name: op.kind for op in trace.ops}
    assert kinds == {"select": "view", "index_select": "gather"}
    got = TH.analyze(trace)
    assert got["flops"] == 0
    assert got["bytes"] == 2 * (5 * 8 * 4) + 5 * 8


def test_collectives_under_the_reference_names():
    TMesh.make_host_mesh("cpu")
    try:
        g = torch.randn(100)
        with TH.Trace() as trace:
            TComp.allreduce_topk(g, None, 0.1)  # k = 10: two all-gathers
            TComp.allreduce_topk(g, None, 1.0)  # k >= n: one all-reduce
    finally:
        dist.destroy_process_group()
    got = TH.analyze(trace)
    assert got["collective_count_by_type"]["all-gather"] == 2
    assert got["collective_bytes_by_type"]["all-gather"] == 10 * 4 + 10 * 4
    assert got["collective_count_by_type"]["all-reduce"] == 1
    assert got["collective_bytes_by_type"]["all-reduce"] == 100 * 4
    assert got["collective_bytes_total"] == 480
    assert set(got["collective_bytes_by_type"]) == set(RH.COLLECTIVES)


def test_smoke_forward_dot_flops_equal_the_analytic_count():
    cfg = TC.get_smoke_config("qwen2_1p5b")
    B, L = 2, 16
    params = TM.init_params(cfg, device="meta")
    batch = {"tokens": torch.zeros((B, L), dtype=torch.int32,
                                   device="meta")}
    with TH.Trace() as trace:
        TM.forward(params, cfg, batch)
    dots = [op for op in trace.ops if op.kind == "dot"]
    got = TH.analyze(dots)["flops"]
    d, H, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    per_layer = (2 * B * L * d * (H + 2 * kv) * hd   # q, k, v projections
                 + 2 * 2 * B * H * L * L * hd        # scores, then AV
                 + 2 * B * L * H * hd * d            # output projection
                 + 3 * 2 * B * L * d * ff)           # gate, up, down
    head = 2 * B * L * d * cfg.padded_vocab
    assert got == cfg.n_layers * per_layer + head


class _OnlyMeta(TorchDispatchMode):
    """Fails on any op whose tensors are not on the meta device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta", (func, t.device)
        return out


@pytest.mark.parametrize("arch,shape", [("qwen2_1p5b", "decode_32k"),
                                        ("smollm_360m", "prefill_32k")])
def test_run_cell_traces_full_size_cells_on_meta(arch, shape):
    with _OnlyMeta():
        rec = D.run_cell(arch, shape, multi_pod=False)
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 256
    mem = rec["memory"]
    assert 0 < mem["argument_bytes_per_device"] < \
        mem["argument_bytes_one_device"]
    assert mem["peak_estimate_bytes_one_device"] == \
        mem["argument_bytes_one_device"] + mem["step_live_bytes_one_device"]
    assert rec["fits_hbm"] is False  # a 32k context at batch 128 / 32
    assert rec["hbm"]["bytes"] == D.H100_HBM_BYTES
    assert rec["cost"]["flops_one_device"] > rec["model_flops_global"] > 0
    assert rec["collectives"]["total_bytes"] == 0
    json.dumps(rec)


def test_cli_writes_records_skips_and_errors(tmp_path, monkeypatch):
    assert D.main(["--arch", "zamba2_1p2b", "--shape", "long_500k",
                   "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "zamba2_1p2b_long_500k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["fits_hbm"] is True
    assert D.main(["--arch", "qwen2_1p5b", "--shape", "long_500k",
                   "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen2_1p5b_long_500k_single.json")
                     .read_text())
    assert rec["status"] == "skipped"

    def host_read(arch, shape, mesh):  # a step that reads a value
        x = torch.zeros((), device="meta")
        return (lambda t: t.item()), (x,), (D.Sh.P(),), None
    monkeypatch.setattr(D, "build_cell", host_read)
    assert D.main(["--arch", "yi_9b", "--shape", "decode_32k", "--mesh",
                   "multi", "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "yi_9b_decode_32k_multi.json").read_text())
    assert rec["status"] == "error" and "meta" in rec["error"].lower()
