"""Twins of ``repro.launch.hlo_cost`` and ``repro.launch.dryrun`` in the
port (``repro_torch.launch.hlo_cost`` over recorded aten ops,
``repro_torch.launch.dryrun`` as one rank of the production mesh), on the
CPU.

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
* Per device on a (2, 4) mesh: the port as rank 0 of a fake world of
  eight (``tests/torch_dryrun_twins.py``), the reference compiled for
  eight forced host devices in a subprocess. A lone sharded matmul's
  FLOPs, bytes and all-reduce equal; the mini train cell's argument bytes
  and dot FLOPs equal; the expert-parallel body's all-gathers,
  all-to-alls and (in the backward) reduce-scatters, counts and bytes,
  equal forward and backward.
* Full-width, two-layer copies of nine cells on (16, 16), both packages
  (the reference compiled for 256 forced host devices in a subprocess):
  each one's FLOPs a device within 0.8-1.25x of the reference's; four of
  them zamba2-1.2b's and xlstm-350m's (the recurrent layers split over
  "model").
* sLSTM's time loop counted once a token (``hlo_cost.Trace.repeat``) on
  a small xlstm copy as rank 0 of a (2, 4) world: the same FLOPs and
  collectives as the trace of every step, and no lower a peak.
* ``run_cell`` with ``status == "ok"`` on three full-size cells as rank 0
  of the (16, 16) mesh, every op of the rank on the meta device; the
  (2, 16, 16) record of qwen2-1.5b x decode_32k and the (16, 16) records
  of xlstm-350m and zamba2-1.2b x train_4k equal to the ones
  ``chip_smoke.py`` holds the card's run to; the reference's figures
  written into ``chip_smoke.py`` equal to its dry run of every cell; the
  CLI's records, skips and errors.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

import chip_smoke
import torch_dryrun_twins as Twins
import torch_mesh_world as W
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


# ---- per device on a (2, 4) mesh: the port's fake world of eight against
# the reference compiled for eight forced host devices ----------------------

_REF = r"""
import dataclasses, json, re, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.distributed import sharding as Sh
from repro.launch import hlo_cost as H
from repro.launch.mesh import activate_mesh, make_mesh_compat
from repro.models import layers as L
from repro.train import optimizer as opt, step as TS
assert len(jax.devices()) == 8
mini = {k: tuple(v) if isinstance(v, list) else v
        for k, v in json.loads(sys.argv[1]).items()}
mesh = make_mesh_compat((2, 4), ("data", "model"))
f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
res = {}


def named(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda s: isinstance(s, P))


def costs(compiled, body_only=False):
    hlo = compiled.as_text()
    if body_only:  # collectives GSPMD adds around the shard_map body
        hlo = "\n".join(ln if "shard_map" in ln else re.sub(
            r"\b(all-gather|all-to-all|all-reduce|reduce-scatter)\(",
            r"\1x(", ln) for ln in hlo.splitlines())
    got = H.analyze(hlo)
    # renamed, a dot is no op the parse knows: the difference is the dots'
    got["dot_flops"] = got["flops"] - H.analyze(
        re.sub(r"\bdot\(", "dotx(", hlo))["flops"]
    got["argument_bytes"] = compiled.memory_analysis().argument_size_in_bytes
    return got


with activate_mesh(mesh):
    res["matmul"] = costs(jax.jit(
        lambda a, b: a @ b,
        in_shardings=named((P("data", "model"), P("model", None))),
        out_shardings=named(P("data", None))).lower(
            f32(8, 16), f32(16, 32)).compile())

cfg = dataclasses.replace(configs.get_smoke_config("qwen2_1p5b"), **mini)
tcfg = TS.TrainConfig(adamw=opt.AdamWConfig())
state = jax.eval_shape(lambda k: TS.init_train_state(cfg, tcfg, k),
                       jax.random.PRNGKey(0))
i32 = jax.ShapeDtypeStruct((8, 64), jnp.int32)
batch = {"tokens": i32, "labels": i32}
sh = named(Sh.param_shardings(state, mesh))
with activate_mesh(mesh):
    res["train"] = costs(jax.jit(
        TS.make_train_step(cfg, tcfg),
        in_shardings=(sh, named(Sh.batch_shardings(batch, mesh, 8))),
        out_shardings=(sh, NamedSharding(mesh, P())),
        donate_argnums=(0,)).lower(state, batch).compile())

p = jax.eval_shape(lambda k: L.init_moe(k, 16, 32, 6, jnp.float32,
                                        n_padded=8), jax.random.PRNGKey(6))
p_sh = named({"router": P(None, None), "w_gate": P("model", "data", None),
              "w_up": P("model", "data", None),
              "w_down": P("model", None, "data")})
x_sh = named(P("data", "model", None))


def moe(p_, x_):
    return L.moe(p_, x_, 2, 100.0, group_axes=("data",), expert_axis="model")


def loss(p_, x_):
    y, aux = moe(p_, x_)
    return jnp.sum(y) + aux


with activate_mesh(mesh):
    for name, fn in (("ep_fwd", moe),
                     ("ep_fwd_bwd", jax.grad(loss, argnums=(0, 1)))):
        res[name] = costs(jax.jit(fn, in_shardings=(p_sh, x_sh)).lower(
            p, f32(4, 16, 16)).compile(), body_only=True)
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    out = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps({**W.MINI, **W.MINI_AXES})],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    return Twins.run_all()


def _colls(rec, *types):
    return {(k, c): rec[f"collective_{k}_by_type"][c]
            for k in ("count", "bytes") for c in types}


def test_sharded_matmul_per_device_equals_the_reference(ref, port):
    """[4, 4] x [4, 32] blocks a device, then one all-reduce of the
    [4, 32] partial sums over the model axis."""
    got, want = port["matmul"], ref["matmul"]
    assert got["flops"] == want["flops"] == 2.0 * 4 * 32 * 4
    assert got["bytes"] == want["bytes"] == 4 * (
        4 * 4 + 4 * 32 + 4 * 32 + 2 * 4 * 32)
    assert got["argument_bytes"] == want["argument_bytes"] == 4 * (
        4 * 4 + 4 * 32)
    for key in ("collective_count_by_type", "collective_bytes_by_type"):
        assert got[key] == want[key]
    assert got["collective_count_by_type"]["all-reduce"] == 1
    assert got["collective_bytes_by_type"]["all-reduce"] == 4 * 4 * 32


def test_mini_train_cell_per_device_equals_the_reference(ref, port):
    """The reference's mini dry-run cell on (2, 4): the same arguments a
    device; collectives on both sides (GSPMD's and the port's own choice
    of them); the same dot FLOPs a device. The reference splits every
    product of the step over the eight devices: its count times eight is
    the step's on one device (the port's, without a mesh). So does the
    port: its attention splits over the model axis by heads (4 heads on
    4 ranks; the 2 kv heads by head_dim), its output projection and that
    weight's gradient with it."""
    got, want = port["train"], ref["train"]
    assert got["argument_bytes"] == want["argument_bytes"] > 0
    assert got["collective_bytes_by_type"]["all-gather"] > 0
    assert want["collective_bytes_by_type"]["all-gather"] > 0
    one = got["one_device_dot_flops"]
    assert want["dot_flops"] * 8 == one
    assert got["dot_flops"] == want["dot_flops"]


@pytest.mark.parametrize("case", ["ep_fwd", "ep_fwd_bwd"])
def test_expert_parallel_body_collectives_equal_the_reference(ref, port,
                                                              case):
    """The body's three FSDP all-gathers and its two tiled all-to-alls
    (two more for the gradient), counts and operand bytes a device. The
    reference's count is of its ``shard_map`` body: GSPMD gathers the
    routing around it, which the port runs inside the body. A gathered
    weight's gradient is a reduce-scatter on both sides
    (``launch.mesh._AllGather``'s backward, which the gloo world runs
    too): the same count and operand bytes; DTensor's own reduce-scatters
    around the body are not counted."""
    types = ("all-gather", "all-to-all")
    assert _colls(port[case], *types) == _colls(ref[case], *types)
    n = 2 * (1 + (case == "ep_fwd_bwd"))
    assert port[case]["collective_count_by_type"]["all-to-all"] == n
    assert port[case]["collective_count_by_type"]["all-gather"] == 3
    want = {"count": ref[case]["collective_count_by_type"]["reduce-scatter"],
            "bytes": ref[case]["collective_bytes_by_type"]["reduce-scatter"]}
    assert port[case]["mesh_reduce_scatter"] == want
    assert want["count"] == (3 if case == "ep_fwd_bwd" else 0)


# (arch, shape) of the two-layer twins: attention split by heads (yi's 32
# heads, its 4 kv heads by head_dim), by query rows (smollm's 15 heads and
# qwen2's 12 on 16 ranks), and decode on a cache split over its sequence;
# the recurrent layers split over "model" (Mamba2 by rows, mLSTM by query
# rows, sLSTM by the state's d, its loop counted once a token) and their
# decodes on states split by cache_shardings
TWO_LAYER_CELLS = (("yi_9b", "train_4k"), ("smollm_360m", "train_4k"),
                   ("qwen2_1p5b", "prefill_32k"), ("qwen2_1p5b", "decode_32k"),
                   ("zamba2_1p2b", "train_4k"), ("zamba2_1p2b", "prefill_32k"),
                   ("xlstm_350m", "train_4k"), ("xlstm_350m", "prefill_32k"),
                   ("xlstm_350m", "decode_32k"))

_REF_CELLS = r"""
import dataclasses, json, sys
import jax
assert len(jax.devices()) == 256
from repro import configs
from repro.launch import dryrun as D
get = configs.get_config
configs.get_config = lambda a: dataclasses.replace(get(a), n_layers=2)
print(json.dumps({f"{a}/{s}": D.run_cell(a, s, multi_pod=False)["cost"][
    "flops_per_device"] for a, s in json.loads(sys.argv[1])}))
"""


def test_two_layer_cells_flops_a_device_near_the_reference(monkeypatch):
    """The four ``TWO_LAYER_CELLS`` at full width and two layers, as rank 0
    of the (16, 16) world, against the reference's record of the same
    copies: FLOPs a device within 0.8-1.25x (the split of every product,
    the attention's included, over the 256 devices). The reference
    compiles in a subprocess while the port traces."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_CELLS, json.dumps(TWO_LAYER_CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        get = TC.get_config
        monkeypatch.setattr(TC, "get_config", lambda a: dataclasses.replace(
            get(a), n_layers=2))
        got = {f"{a}/{s}": D.run_cell(a, s, multi_pod=False)["cost"][
            "flops_per_device"] for a, s in TWO_LAYER_CELLS}
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for cell, flops in want.items():
        assert 0.8 <= got[cell] / flops <= 1.25, (cell, got[cell], flops)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_slstm_loop_counted_once_a_token(shape, monkeypatch):
    """A small xlstm copy (two layers, d_model 64, 32 tokens, batch 4) as
    rank 0 of a (2, 4) world of eight, traced with sLSTM's loop counted
    (one step in ``Trace.repeat(l)``, its backward and the remat
    recompute likewise) and step by step: the same FLOPs and collectives
    (counts and bytes), a peak no lower than 0.9x the per-token trace's,
    and far fewer recorded ops. The two differ only in ops that move
    bytes: the unbind and stack of the per-step tensors."""
    get = TC.get_config
    monkeypatch.setattr(TC, "get_config", lambda a: dataclasses.replace(
        get(a), n_layers=2, d_model=64, vocab_size=256))
    monkeypatch.setitem(TC.SHAPES, shape, (32, 4, TC.SHAPES[shape][2]))
    monkeypatch.setattr(D, "make_production_mesh", lambda multi_pod: (
        TMesh.ShapeMesh((2, 4), ("data", "model"))))
    counted = D.run_cell("xlstm_350m", shape, multi_pod=False)
    # no trace in sight: the loop runs every step
    monkeypatch.setattr(TH, "active_trace", lambda: None)
    stepped = D.run_cell("xlstm_350m", shape, multi_pod=False)
    assert counted["status"] == stepped["status"] == "ok"
    assert counted["cost"]["flops_per_device"] == \
        stepped["cost"]["flops_per_device"]
    for key in ("count_by_type", "bytes_by_type"):
        assert counted["collectives"][key] == stepped["collectives"][key]
    assert counted["collectives"]["count_by_type"]["all-gather"] > 32
    peak = "peak_estimate_bytes"
    assert counted["memory"][peak] >= 0.9 * stepped["memory"][peak]
    assert counted["aten_ops"] < stepped["aten_ops"] / 2


class _MetaTrace(TH.Trace):
    """``Trace`` that fails on any op of the rank whose tensors are not on
    the meta device (DTensor's shape propagation runs on fake tensors)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or TH._in_fake_mode():
            return out
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta", (func, t.device)
        return out


@pytest.mark.parametrize("arch,shape", [
    ("qwen2_1p5b", "decode_32k"), ("smollm_360m", "prefill_32k"),
    ("granite_moe_3b_a800m", "prefill_32k")])
def test_run_cell_traces_full_size_cells_on_meta(arch, shape, monkeypatch):
    monkeypatch.setattr(D.hlo_cost, "Trace", _MetaTrace)
    rec = D.run_cell(arch, shape, multi_pod=False)
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 256
    assert not dist.is_initialized()  # the fake world is gone
    mem = rec["memory"]
    assert 0 < mem["output_bytes"] <= mem["temp_bytes"]
    assert mem["peak_estimate_bytes"] == \
        mem["argument_bytes"] + mem["temp_bytes"]
    if (arch, shape) == ("qwen2_1p5b", "decode_32k"):
        # the sharding rules' specs a device, as before the mesh
        assert mem["argument_bytes"] == 482_111_012
    assert rec["fits_hbm"] is (mem["peak_estimate_bytes"] <= D.H100_HBM_BYTES)
    assert rec["hbm"]["bytes"] == D.H100_HBM_BYTES
    assert rec["cost"]["flops_per_device"] > rec["model_flops_global"] / 256
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0
    assert (coll["count_by_type"]["all-to-all"] > 0) is arch.startswith(
        "granite")  # the expert-parallel body's exchanges
    json.dumps(rec)


def test_multi_pod_record_equals_the_card_record():
    """qwen2-1.5b x decode_32k on the (2, 16, 16) mesh, 512 ranks: the
    record ``chip_smoke.py`` requires of the card's run under this torch
    release, but for the timings and the memory the card reports. The
    releases' records share every field the sharding rules fix and the
    EP body's own exchanges; DTensor's redistributions are their own.
    Each record's FLOPs and peak a device lie within the bounds the card
    run holds them to of the reference's."""
    arch, shape, mesh = chip_smoke.MESH_CELLS[1]
    rec = D.run_cell(arch, shape, multi_pod=mesh == "multi")
    assert rec["n_devices"] == 512
    records = chip_smoke.MESH_CELL_RECORDS
    assert chip_smoke.cell_fields(rec) == \
        records[torch.__version__.split("+")[0]][1]
    for cells in zip(*records.values()):
        for key in ("arch", "shape", "mesh", "n_devices", "status",
                    "model_flops_global", "act_seq_axis", "remat",
                    "fits_hbm"):
            assert len({c[key] for c in cells}) == 1, key
        for key in ("argument_bytes", "output_bytes"):
            assert len({c["memory"][key] for c in cells}) == 1, key
        for key in ("count_by_type", "bytes_by_type"):
            assert len({c["collectives"][key]["all-to-all"]
                        for c in cells}) == 1, key
    # every release's record within the card run's bounds of the
    # reference's FLOPs and peak a device
    for cells in records.values():
        for cell, want in zip(cells, chip_smoke.MESH_CELL_REFERENCE):
            got = {**cell["cost"], **cell["memory"]}
            for key, (lo, hi) in chip_smoke.MESH_CELL_BOUNDS.items():
                assert lo <= got[key] / want[key] <= hi, (cell["arch"], key)


@pytest.mark.parametrize("i", [2, 3])
def test_recurrent_train_cell_record_equals_the_card_record(i):
    """xlstm-350m and zamba2-1.2b x train_4k on (16, 16) (sLSTM's loop
    counted once a token, the recurrent layers split over "model"): the
    record ``chip_smoke.py`` requires of the card's run under this torch
    release, every release's within the bounds of the reference's."""
    arch, shape, mesh = chip_smoke.MESH_CELLS[i]
    assert TC.get_config(arch).family in ("xlstm", "hybrid_mamba")
    rec = D.run_cell(arch, shape, multi_pod=mesh == "multi")
    records = chip_smoke.MESH_CELL_RECORDS
    assert chip_smoke.cell_fields(rec) == \
        records[torch.__version__.split("+")[0]][i]
    want = chip_smoke.MESH_CELL_REFERENCE[i]
    for cells in records.values():
        got = {**cells[i]["cost"], **cells[i]["memory"]}
        for key, (lo, hi) in chip_smoke.MESH_CELL_BOUNDS.items():
            assert lo <= got[key] / want[key] <= hi, (arch, key)


_REF_CELL = r"""
import json, sys
from repro.launch import dryrun as D
rec = D.run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "multi")
print(json.dumps({"flops_per_device": rec["cost"]["flops_per_device"],
                  "peak_estimate_bytes": rec["memory"]["peak_estimate_bytes"]}))
"""


@pytest.mark.parametrize("i", range(len(chip_smoke.MESH_CELLS)))
def test_mesh_cell_reference_equals_the_reference_dry_run(i):
    """``chip_smoke.MESH_CELL_REFERENCE``, the reference's FLOPs and peak a
    device that the card run bounds the port's by, equal to the
    reference's own dry run of each cell (compiled for 256 / 512 forced
    host devices in a subprocess)."""
    assert len(chip_smoke.MESH_CELL_REFERENCE) == len(chip_smoke.MESH_CELLS)
    arch, shape, mesh = chip_smoke.MESH_CELLS[i]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count="
               f"{512 if mesh == 'multi' else 256}",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, "-c", _REF_CELL, arch, shape, mesh],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        chip_smoke.MESH_CELL_REFERENCE[i]


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
        x = D._block(torch.zeros((), device="meta"), D.Sh.P(), mesh)
        return (lambda t: t.to_local().item()), (x,), None
    monkeypatch.setattr(D, "build_cell", host_read)
    assert D.main(["--arch", "yi_9b", "--shape", "decode_32k", "--mesh",
                   "multi", "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "yi_9b_decode_32k_multi.json").read_text())
    assert rec["status"] == "error" and "meta" in rec["error"].lower()
