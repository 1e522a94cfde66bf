"""Dry run of every (arch x shape) cell as one device of the production
mesh: build the cell's rank-0 blocks on the meta device, trace one step,
and record its per-device memory, roofline terms and collectives, with
nothing allocated and no card needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1p5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40-cell sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

The reference lowers and compiles each cell for the production meshes
(256 / 512 TPU chips: (16, 16) and (2, 16, 16), ``launch.mesh``) and reads
XLA's per-device memory and cost analyses. The port runs each cell as
rank 0 of a world of that many ranks on PyTorch's ``fake`` backend
(``launch.mesh.fake_device_mesh``), in this one process:

  * the cell's state or parameters, batch and cache are DTensors on that
    ``DeviceMesh``, laid out by the sharding rules' specs
    (``distributed.sharding``: ``param_shardings``, ``batch_shardings``,
    ``cache_shardings``), each built from its rank's local block on the
    ``meta`` device (``build_cell``), with the reference's execution
    config (``exec_config``: remat, q-chunking, grad accumulation, bf16
    optimizer state for the 235B config, and the activation layout axes,
    which now constrain: the residual stream, the vocab dim, the MoE's
    expert parallelism over "model");
  * the attention splits over "model" as the reference's does
    (``models.layers``): in train and prefill each rank all-gathers the
    sequence-parallel residual, attends its ``H / 16`` heads and
    reduce-scatters its out-projection back, or, where the heads do not
    divide the axis (qwen2, smollm, granite, llava), attends its own
    query rows against k and v all-gathered along the sequence; in decode
    each rank scores its stripe of the cache and all-reduces the
    softmax's max and exp-sum, the weighted sums and the out-projection.
    So the rank's FLOPs and score memory are 1/16 of a data rank's, as
    the reference's are; its FSDP weight slices are all-gathered over
    "data" inside the attention and reduce-scattered back;
  * the recurrent layers split over "model" too (``models.ssm``): Mamba2
    by rows of the sequence (its SSD's state carried across ranks),
    mLSTM by query rows, sLSTM by the state's d, and their decodes on the
    state as ``cache_shardings`` splits it;
  * one step (train / prefill / decode) runs on them under the mesh and
    ``hlo_cost.Trace``, which records the rank's own program: its local
    ops with local shapes and every collective it issues. One loop is
    not run step by step: sLSTM's time loop (xlstm-350m's 4,096 or
    32,768 steps a layer) traces one step, its backward and its remat
    recompute, counted once a token (``Trace.repeat``), the reference's
    trip-count multiplication of its ``lax.scan``; the tensors the loop
    keeps for its backward are allocated, so the peak holds them;
  * the record takes the reference's per-device keys: ``memory``
    (``argument_bytes``: the rank's blocks of the arguments;
    ``temp_bytes``: the most bytes the step's own allocations hold at
    once, its outputs among them, since an eager step allocates its
    outputs as it goes; ``output_bytes``: the outputs that are not
    arguments written in place; ``peak_estimate_bytes``: arguments plus
    temporaries), ``cost`` (``flops_per_device``,
    ``bytes_accessed_per_device``, ``hlo_cost.analyze``) and
    ``collectives`` by type, counts and operand bytes;
  * ``fits_hbm`` holds the per-device peak against the card's memory
    (``torch.cuda.get_device_properties``; without a card, the H100 80GB
    HBM3's 80 GB, ``H100_HBM_BYTES``).

XLA-only fields are not kept: ``xla_cost_raw`` is XLA's own cost analysis
(which counts a loop body once), and ``alias_bytes`` the donated buffers
the compiled program writes its outputs into; an eager step updates its
state and cache in place, so its peak has no alias term.

DTensor reduces a ``Partial`` over both mesh dims as two all-reduces, one
a dim, where XLA issues one over both; the record counts what the port
issues. A cell whose step reads a value on the host (which a meta tensor
has not) cannot be traced without data, and is recorded with
``"status": "error"`` and its reason. Records go to
``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json`` (``--out``); a
record already there is kept.
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
                                     fake_device_mesh, from_local,
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
    layout fields)."""
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


def _block(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``leaf`` (a global meta tensor) as a DTensor on ``mesh`` laid out by
    ``spec``, built from its rank's block, on the meta device."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
    shape = [n // math.prod(sizes[a] for a in (
        e if isinstance(e, tuple) else (e,)) if a is not None)
        for n, e in zip(leaf.shape, spec)]
    local = torch.empty(shape, dtype=leaf.dtype, device=_META)
    return from_local(local, mesh, Sh.P(*spec), like=leaf)


def _laid_out(tree, specs, mesh):
    """Every leaf of ``tree`` as ``_block`` of its spec; a ``ParamTree``
    stays one (a ``TrainState``'s parameters trainable)."""
    if isinstance(tree, torch.Tensor):
        return _block(tree, specs, mesh)
    out = pytree.map_tree(lambda leaf, spec: _block(leaf, spec, mesh),
                          tree, specs)
    if isinstance(tree, M.ParamTree):
        return M.ParamTree(out)
    if isinstance(tree, TS.TrainState):
        return dataclasses.replace(
            out, params=M.ParamTree(out.params).requires_grad_(True))
    return out


def build_cell(arch: str, shape: str, mesh):
    """(step function, its arguments as DTensors on ``mesh`` (a
    ``DeviceMesh``), the execution config); nothing is allocated."""
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
        args = (_laid_out(state, Sh.param_shardings(state, mesh), mesh),
                _laid_out(batch, Sh.batch_shardings(batch, mesh, gb), mesh))
        return TS.make_train_step(cfg, tcfg), args, cfg

    params = M.init_params(cfg, device=_META)
    params = _laid_out(params, Sh.param_shardings(params, mesh), mesh)
    if kind == "prefill":
        batch = configs.input_specs(cfg, shape)

        def prefill(p, b):
            return M.forward(p, cfg, b, last_only=True)
        return prefill, (params, _laid_out(
            batch, Sh.batch_shardings(batch, mesh, gb), mesh)), cfg

    batch, cache, pos = configs.input_specs(cfg, shape)
    args = (params,
            _laid_out(cache, Sh.cache_shardings(cache, mesh, gb), mesh),
            _laid_out(batch, Sh.batch_shardings(batch, mesh, gb), mesh),
            _laid_out(pos, Sh.P(), mesh))

    def decode(p, c, b, pos_):
        return M.decode_step(p, cfg, c, b, pos_)
    return decode, args, cfg


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


def _locals(tree):
    """The rank's blocks of a tree's DTensor leaves (plain tensors as
    they are)."""
    from torch.distributed.tensor import DTensor
    flat = [tree] if isinstance(tree, torch.Tensor) else pytree.leaves(tree)
    return [t.to_local() if isinstance(t, DTensor) else t for t in flat
            if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors, skip=frozenset()) -> int:
    """Bytes of the distinct storages of ``tensors`` not in ``skip``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in skip:
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def hbm_bytes() -> Dict[str, Any]:
    """The card's memory, or the H100's named constant without a card."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"bytes": int(props.total_memory), "source": props.name}
    return {"bytes": H100_HBM_BYTES, "source": "H100 80GB HBM3 data sheet"}


def run_cell(arch: str, shape: str, multi_pod: bool) -> Dict[str, Any]:
    shape_mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"
    cfg0 = configs.get_config(arch)
    ok, why = configs.shape_applicable(cfg0, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "n_devices": shape_mesh.size}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    with fake_device_mesh(shape_mesh) as mesh:
        t0 = time.perf_counter()
        fn, args, cfg = build_cell(arch, shape, mesh)
        t_build = time.perf_counter() - t0
        arg_blocks = [t for a in args for t in _locals(a)]
        t1 = time.perf_counter()
        with activate_mesh(mesh), hlo_cost.Trace() as trace:
            out = fn(*args)
        t_trace = time.perf_counter() - t1
        out_blocks = _locals(out)
        del out
    t2 = time.perf_counter()
    parsed = hlo_cost.analyze(trace)
    t_parse = time.perf_counter() - t2

    arg_bytes = _storage_bytes(arg_blocks)
    out_bytes = _storage_bytes(out_blocks, skip={
        t.untyped_storage()._cdata for t in arg_blocks})
    peak = arg_bytes + trace.peak_live_bytes
    hbm = hbm_bytes()
    rec.update({
        "status": "ok",
        "build_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "aten_ops": len(trace.ops),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": trace.peak_live_bytes,
            "peak_estimate_bytes": peak,
        },
        "cost": {
            "flops_per_device": parsed["flops"],
            "bytes_accessed_per_device": parsed["bytes"],
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
                    print(f"  ok: trace {rec['trace_s']}s, peak/device "
                          f"{m['peak_estimate_bytes'] / 2**30:.2f} GiB, "
                          f"flops/device "
                          f"{rec['cost']['flops_per_device']:.3e}, coll "
                          f"{rec['collectives']['total_bytes'] / 2**30:.3f}"
                          f" GiB", flush=True)
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec['error'][:300]}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
