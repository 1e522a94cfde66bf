"""The port's side of the dry-run twins, as rank 0 of a fake world of eight.

    python tests/torch_dryrun_twins.py

``tests/test_torch_dryrun.py`` holds these against the reference's
compiled programs on a (2, 4) ("data", "model") mesh of eight forced host
devices. Each scenario runs on ``launch.mesh.fake_device_mesh`` of that
shape, its arguments DTensors built from rank 0's meta blocks
(``launch.dryrun``'s layout), traced by ``launch.hlo_cost.Trace``:

  * ``matmul``: a lone [8, 16] x [16, 32] product, the operands split
    P("data", "model") and P("model", None), the result laid out
    P("data", None): one all-reduce of the partial sums;
  * ``train``: one step of the reference's mini dry-run cell
    (``tests/test_sharding_dist.py::test_mini_dryrun_cell_8dev``'s config,
    ``torch_mesh_world.mini_config``; AdamW, batch 8 x 64), with the dot
    FLOPs of the same step on one device, without a mesh;
  * ``ep_fwd`` / ``ep_fwd_bwd``: ``moe``'s expert-parallel branch on the
    reference's ``test_moe_ep_parity_8dev`` shapes (d 16, d_ff 32, 6
    experts padded to 8, top 2, capacity factor 100, x [4, 16, 16]), its
    inputs laid out as its body takes them; forward, then forward and the
    gradients of ``sum(y) + aux``.

Each scenario also counts the reduce-scatters of ``launch.mesh``'s own
collectives (``mesh_reduce_scatter``), which the reference's body issues
as its all-gathers' transposes.

This module imports no JAX; run as a script it prints every scenario's
numbers as one JSON line, for a check on another machine's torch.
"""
import json

import torch

import torch_mesh_world as W
from repro_torch import configs as TC
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_cost as TH
from repro_torch.launch.mesh import (P, ShapeMesh, activate_mesh,
                                     fake_device_mesh)
from repro_torch.models import layers as L
from repro_torch.train import optimizer as opt
from repro_torch.train import step as TS

MESH = ShapeMesh((2, 4), ("data", "model"))
EP_SPECS = {"router": P(None, None), "w_gate": P("model", "data", None),
            "w_up": P("model", "data", None),
            "w_down": P("model", None, "data")}
EP_X = ((4, 16, 16), P("data", "model", None))
KEYS = ("flops", "bytes", "collective_bytes_by_type",
        "collective_count_by_type")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _costs(trace, args=()):
    got = {k: v for k, v in TH.analyze(trace).items() if k in KEYS}
    got["dot_flops"] = TH.analyze(
        [op for op in trace.ops if op.kind == "dot"])["flops"]
    got["argument_bytes"] = D._storage_bytes(
        [t for a in args for t in D._locals(a)])
    # the reduce-scatters ``launch.mesh`` issues (a gathered block's
    # gradient), apart from DTensor's own (``reduce_scatter_tensor``)
    mine = [op for op in trace.ops if op.name == "_reduce_scatter_base_"]
    got["mesh_reduce_scatter"] = {
        "count": len(mine),
        "bytes": TH.analyze(mine)["collective_bytes_by_type"][
            "reduce-scatter"]}
    return got


def matmul(mesh):
    a = D._block(_meta(8, 16), P("data", "model"), mesh)
    b = D._block(_meta(16, 32), P("model", None), mesh)
    out = Sh.NamedSharding(mesh, P("data", None)).placements
    with TH.Trace() as trace:
        (a @ b).redistribute(mesh, out)
    return _costs(trace, (a, b))


def mini_train_cell():
    cfg = W.mini_config(TC.get_smoke_config("qwen2_1p5b"))
    tcfg = TS.TrainConfig(adamw=opt.AdamWConfig())
    batch = {k: _meta(8, 64, dtype=torch.int32) for k in ("tokens", "labels")}
    return cfg, tcfg, batch


def train(mesh):
    cfg, tcfg, batch = mini_train_cell()
    state = TS.init_train_state(cfg, tcfg, None, "meta")
    args = (D._laid_out(state, Sh.param_shardings(state, mesh), mesh),
            D._laid_out(batch, Sh.batch_shardings(batch, mesh, 8), mesh))
    with activate_mesh(mesh), TH.Trace() as trace:
        TS.make_train_step(cfg, tcfg)(*args)
    got = _costs(trace, args)
    with TH.Trace() as one:
        TS.make_train_step(cfg, tcfg)(
            TS.init_train_state(cfg, tcfg, None, "meta"), batch)
    got["one_device_dot_flops"] = _costs(one)["dot_flops"]
    return got


def ep(mesh, backward: bool):
    p = {k: D._block(v, EP_SPECS[k], mesh).requires_grad_(backward)
         for k, v in L.init_moe(None, 16, 32, 6, torch.float32,
                                torch.device("meta"), n_padded=8).items()}
    x = D._block(_meta(*EP_X[0]), EP_X[1], mesh).requires_grad_(backward)
    with activate_mesh(mesh), TH.Trace() as trace:
        y, aux = L.moe(p, x, 2, W.NO_DROP, group_axes=("data",),
                       expert_axis="model")
        if backward:
            torch.autograd.grad(y.sum() + aux, [*p.values(), x])
    return _costs(trace)


def run_all():
    with fake_device_mesh(MESH) as mesh:
        return {"matmul": matmul(mesh), "train": train(mesh),
                "ep_fwd": ep(mesh, False), "ep_fwd_bwd": ep(mesh, True)}


if __name__ == "__main__":
    print(json.dumps({"torch": torch.__version__, **run_all()}))
