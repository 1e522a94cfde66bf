"""Dry run of every (arch x shape) cell: build it on the meta device, trace
one step, and record its roofline terms, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1p5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40-cell sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

The reference lowers and compiles each cell for the production meshes
(256 / 512 TPU chips) and reads XLA's memory and cost analyses. The
port's nearest meaning, for one H100:

  * the cell's state, parameters, batch and cache are built on the
    ``meta`` device (``build_cell``), with the reference's execution config
    (``exec_config``: remat, q-chunking, grad accumulation, bf16 optimizer
    state for the 235B config);
  * one step (train / prefill / decode) runs on those meta tensors under
    ``hlo_cost.Trace``: its FLOPs, bytes and collective bytes come from the
    recorded aten ops (``hlo_cost.analyze``; collectives are 0 on one
    device), and its peak live bytes from the storages the step holds at
    once;
  * the argument bytes per device come from the sharding rules' specs on
    the shape-only production mesh (``distributed.sharding``);
  * ``fits_hbm`` holds the step's peak on one device (arguments plus the
    step's live bytes) against the card's memory
    (``torch.cuda.get_device_properties``; without a card, the H100 80GB
    HBM3's 80 GB, ``H100_HBM_BYTES``).

A cell whose step reads a value on the host (which a meta tensor has not)
cannot be traced without data, and is recorded with ``"status": "error"``
and its reason. Records go to ``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json``
(``--out``); a record already there is kept.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import (activate_mesh, axis_sizes, data_axes,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train import pytree
from repro_torch.train import step as TS

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# NVIDIA's data sheet: 80 GB of HBM3 on the H100 SXM
H100_HBM_BYTES = 80 * 10**9

# microbatch accumulation for the models whose per-layer saved stacks and
# transients exceed device memory at full batch
GRAD_ACCUM = {
    "qwen3_moe_235b_a22b": 8,
    "llava_next_34b": 2,
    "zamba2_1p2b": 2,
}

# per-arch train-time q_chunk: chunking costs k/v re-reads per chunk, so
# it is on only where the f32 score block would otherwise not fit.
# 0 = unchunked.
Q_CHUNK_TRAIN = {
    "chatglm3_6b": 0, "yi_9b": 0, "granite_moe_3b_a800m": 0,
    "smollm_360m": 0, "qwen2_1p5b": 0, "xlstm_350m": 0,
    "musicgen_large": 1024, "zamba2_1p2b": 1024,
    "llava_next_34b": 2048, "qwen3_moe_235b_a22b": 1024,
}
# bf16 optimizer moments + bf16 grad accumulation for the 235B config
BF16_STATE = {"qwen3_moe_235b_a22b"}

_META = torch.device("meta")


def exec_config(cfg: M.ModelConfig, shape: str, mesh,
                arch: str = "") -> M.ModelConfig:
    """Execution-tuned config for a dry-run cell (remat + the activation
    layout fields, which constrain nothing on one device)."""
    seq, gb, kind = configs.SHAPES[shape]
    sizes = axis_sizes(mesh)
    axes = data_axes(mesh)
    dp = math.prod(sizes[a] for a in axes)
    batch_axes = axes if (gb % dp == 0 and gb >= dp) else None
    seq_axis = None
    if kind in ("train", "prefill") and "model" in sizes:
        if seq % sizes["model"] == 0:
            seq_axis = "model"
    remat = "full" if kind == "train" else "none"
    # q-chunked attention bounds f32 score memory
    q_chunk = 1024 if (kind in ("train", "prefill") and seq >= 4096) else 0
    if kind == "train" and arch in Q_CHUNK_TRAIN:
        q_chunk = Q_CHUNK_TRAIN[arch]
    moe_e, moe_c, e_mult = None, None, 1
    if cfg.n_experts and "model" in sizes:
        moe_e = "model"  # EP; phantom-pad experts to the model axis
        e_mult = sizes["model"]
    vocab_axis = None
    if "model" in sizes and cfg.padded_vocab % sizes["model"] == 0:
        vocab_axis = "model"
    return dataclasses.replace(
        cfg, remat=remat, act_batch_axes=batch_axes, act_seq_axis=seq_axis,
        q_chunk=q_chunk, moe_expert_axis=moe_e, moe_cap_axis=moe_c,
        ssm_head_axis=None, expert_pad_multiple=e_mult,
        score_seq_axis=None, vocab_axis=vocab_axis)


def build_cell(arch: str, shape: str, mesh):
    """(step function, its meta arguments, their spec trees on ``mesh``,
    the execution config); nothing is allocated."""
    cfg = exec_config(configs.get_config(arch), shape, mesh, arch=arch)
    seq, gb, kind = configs.SHAPES[shape]

    if kind == "train":
        big = arch in BF16_STATE
        tcfg = TS.TrainConfig(
            adamw=opt.AdamWConfig(), grad_accum=GRAD_ACCUM.get(arch, 1),
            opt_state_dtype=torch.bfloat16 if big else torch.float32,
            accum_dtype=torch.bfloat16 if big else torch.float32)
        state = TS.init_train_state(cfg, tcfg, None, _META)
        batch = configs.input_specs(cfg, shape)
        specs = (Sh.param_shardings(state, mesh),
                 Sh.batch_shardings(batch, mesh, gb))
        return TS.make_train_step(cfg, tcfg), (state, batch), specs, cfg

    params = M.init_params(cfg, device=_META)
    if kind == "prefill":
        batch = configs.input_specs(cfg, shape)
        specs = (Sh.param_shardings(params, mesh),
                 Sh.batch_shardings(batch, mesh, gb))

        def prefill(p, b):
            return M.forward(p, cfg, b, last_only=True)
        return prefill, (params, batch), specs, cfg

    batch, cache, pos = configs.input_specs(cfg, shape)
    specs = (Sh.param_shardings(params, mesh),
             Sh.cache_shardings(cache, mesh, gb),
             Sh.batch_shardings(batch, mesh, gb), Sh.P())

    def decode(p, c, b, pos_):
        return M.decode_step(p, cfg, c, b, pos_)
    return decode, (params, cache, batch, pos), specs, cfg


def model_flops(cfg: M.ModelConfig, shape: str) -> float:
    """MODEL_FLOPS: 6·N·D train (N = active params), 2·N·D prefill,
    2·N·B per decoded token."""
    seq, gb, kind = configs.SHAPES[shape]
    n_active = M.active_param_count(cfg, M.init_params(cfg, device=_META))
    tokens = gb * seq
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * gb  # decode: one token per sequence


def _leaves(tree):
    return [leaf for _, leaf in pytree.named_leaves(tree)]


def argument_bytes_per_device(args, specs, mesh) -> int:
    """Bytes of the arguments on one device of ``mesh``, each leaf divided
    by the product of the axis sizes its spec shards it over."""
    sizes = axis_sizes(mesh)
    total = 0
    for arg, spec in zip(args, specs):
        arg_leaves = _leaves(arg) if not isinstance(arg, torch.Tensor) \
            else [arg]
        spec_leaves = [s for _, s in pytree.named_leaves(
            spec, leaf_types=(Sh.PartitionSpec,))]
        for leaf, s in zip(arg_leaves, spec_leaves):
            shards = math.prod(
                sizes[a] for entry in s if entry is not None
                for a in (entry if isinstance(entry, tuple) else (entry,)))
            total += leaf.numel() * leaf.element_size() // shards
    return total


def hbm_bytes() -> Dict[str, Any]:
    """The card's memory, or the H100's named constant without a card."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"bytes": int(props.total_memory), "source": props.name}
    return {"bytes": H100_HBM_BYTES, "source": "H100 80GB HBM3 data sheet"}


def run_cell(arch: str, shape: str, multi_pod: bool) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"
    cfg0 = configs.get_config(arch)
    ok, why = configs.shape_applicable(cfg0, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "n_devices": mesh.size}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    t0 = time.perf_counter()
    fn, args, specs, cfg = build_cell(arch, shape, mesh)
    t_build = time.perf_counter() - t0
    t1 = time.perf_counter()
    with activate_mesh(mesh), hlo_cost.Trace() as trace:
        fn(*args)
    t_trace = time.perf_counter() - t1
    t2 = time.perf_counter()
    parsed = hlo_cost.analyze(trace)
    t_parse = time.perf_counter() - t2

    arg_bytes = sum(leaf.numel() * leaf.element_size()
                    for a in args for leaf in
                    ([a] if isinstance(a, torch.Tensor) else _leaves(a)))
    peak = arg_bytes + trace.peak_live_bytes
    hbm = hbm_bytes()
    rec.update({
        "status": "ok",
        "build_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "aten_ops": len(trace.ops),
        "memory": {
            "argument_bytes_per_device": argument_bytes_per_device(
                args, specs, mesh),
            "argument_bytes_one_device": arg_bytes,
            "step_live_bytes_one_device": trace.peak_live_bytes,
            "peak_estimate_bytes_one_device": peak,
        },
        # the whole step on one device, from the recorded aten ops
        "cost": {
            "flops_one_device": parsed["flops"],
            "bytes_accessed_one_device": parsed["bytes"],
            "parse_s": round(t_parse, 2),
        },
        "collectives": {
            "bytes_by_type": parsed["collective_bytes_by_type"],
            "count_by_type": parsed["collective_count_by_type"],
            "total_bytes": parsed["collective_bytes_total"],
        },
        "model_flops_global": model_flops(cfg, shape),
        "act_seq_axis": cfg.act_seq_axis,
        "remat": cfg.remat,
        "hbm": hbm,
        "fits_hbm": peak <= hbm["bytes"],
    })
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = configs.ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(configs.SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                out_path = os.path.join(args.out,
                                        f"{arch}_{shape}_{mesh_name}.json")
                if os.path.exists(out_path):
                    print(f"[dryrun] {arch} x {shape} x {mesh_name}: cached")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                      flush=True)
                try:
                    rec = run_cell(arch, shape,
                                   multi_pod=(mesh_name == "multi"))
                except Exception as e:  # noqa: BLE001 - report and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e)[:2000]}
                    failures += 1
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    m = rec["memory"]
                    print(f"  ok: trace {rec['trace_s']}s, args/device "
                          f"{m['argument_bytes_per_device'] / 2**30:.2f} GiB, "
                          f"peak one device "
                          f"{m['peak_estimate_bytes_one_device'] / 2**30:.2f}"
                          f" GiB, flops {rec['cost']['flops_one_device']:.3e}",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec['error'][:300]}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
