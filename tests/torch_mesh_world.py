"""One rank of a gloo world of four running the port's mesh dataflow.

    python tests/torch_mesh_world.py RANK STORE INPUTS OUT

``tests/test_torch_mesh_models.py`` starts four of these (a file store at
``STORE``, a (2, 2) ("data", "model") mesh on the CPU). Every rank runs
every scenario on the inputs and weights in ``INPUTS`` (an ``.npz`` of the
reference's draws, ``/``-joined names); rank 0 saves the global results
to ``OUT``, beside the same computations on one device without a mesh.
This module imports no JAX.

Scenarios (the names of the saved arrays start with them):
  * ``i``: ``moe`` with ``group_axes=("data",)``, ``expert_axis="model"``
    under the ambient mesh (the expert-parallel branch), plain tensors, at
    capacity factors 100 and 1.25: y, aux and slots; the slots of
    ``moe_route(..., n_sub=2)``.
  * ``ii``: gradients of ``sum(y * cot) + aux`` of that branch at 100.
  * ``iii``: ``moe`` on 5 tokens (the local branch under the mesh).
  * ``iv``: the reference's mini dry-run config (qwen2 smoke, d 64, batch
    8 x 64) on DTensor params (``named_shardings``) and a DTensor batch
    (``batch_shardings``): ``loss_fn`` and every gradient leaf.
  * ``v``: granite-moe (expert axis), zamba2 (Mamba2 head axis) and
    smollm (sequence, vocab and score axes; its 3 heads do not divide the
    model axis) smoke forwards on DTensors; granite also at capacity factor 1.25
    and two teacher-forced ``decode_step`` calls on a DTensor cache
    (``cache_shardings``).
  * ``vi``: ``causal_attention``'s mesh branch on plain tensors under the
    ambient mesh (``ATTN``: split by heads with the kv heads split, by
    heads with the kv heads' head_dim split, and by query rows), y and
    the gradients of ``sum(y * cot)``, beside one device; the shape of
    every score block the rank's softmax took (``hlo_cost.Trace``).
  * ``vii``: ``attention_decode`` on DTensor caches split over the
    sequence, the kv heads or head_dim (``DECODE``), two steps whose
    positions fall in different ranks' stripes: y and both caches, beside
    one device.
  * ``viii``: the recurrent layers (``REC``): ``mamba2`` split by the
    sequence (plain tensors under the ambient mesh) and by heads (DTensor
    weights and x, ``head_axis="model"``), ``mlstm`` and ``slstm``: y and
    the gradients of ``sum(y * cot)``, beside one device, and the shape
    of every mLSTM score block the rank's stabiliser took; their decodes
    (``REC_DECODE``) on states laid out by ``cache_shardings``, two steps:
    y and every state leaf, beside one device.
"""
import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as TC
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import hlo_cost as TH
from repro_torch.launch import mesh as TMesh
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

WORLD = 4
MOE_TOP_K = 2
MINI = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128}
MINI_AXES = {"act_batch_axes": ("data",), "act_seq_axis": "model",
             "vocab_axis": "model", "remat": "full"}
# no drops: the expert-parallel branch ranks each sequence in sub-groups,
# so only without drops does it compute what one device computes
NO_DROP = 100.0
SMOKE_AXES = {"granite_moe_3b_a800m": {"moe_expert_axis": "model"},
              "zamba2_1p2b": {"ssm_head_axis": "model"},
              # 3 heads on a model axis of 2: the head-dim fallback, and
              # the attention split by query rows
              "smollm_360m": {"act_seq_axis": "model",
                              "vocab_axis": "model"}}

# attention shapes of ``vi`` / ``vii``: (d, heads, kv heads, head_dim,
# qkv bias, q_chunk), on a batch of ATTN_B x ATTN_L
ATTN = {"heads": (64, 4, 2, 16, False, 16),
        "heads_hd": (64, 4, 1, 16, True, 0),
        "rows": (60, 3, 1, 20, True, 8)}
ATTN_B, ATTN_L = 4, 32
# decode: (attention shape, the cache dim split over "model"), a cache of
# DECODE_S positions, steps at DECODE_POS
DECODE = (("heads", "seq"), ("heads", "kv"), ("heads_hd", "hd"),
          ("rows", "seq"))
DECODE_S, DECODE_POS = 8, (3, 5)
# recurrent layers of ``viii``: name -> (layer, its ``init_*`` arguments
# after the generator, mamba2's head_axis), on a batch of REC_B x REC_L;
# mlstm's 3 heads do not divide the model axis (``C`` split by key rows),
# mlstm_heads' 2 do (``C`` and ``m`` by heads)
REC = {"mamba2": ("mamba2", (32, 8, 8), None),
       "mamba2_heads": ("mamba2", (32, 8, 8), "model"),
       "mlstm": ("mlstm", (24, 3), None),
       "mlstm_heads": ("mlstm", (24, 2), None),
       "slstm": ("slstm", (24, 3), None)}
REC_B, REC_L, REC_CHUNK = 4, 16, 4
REC_DECODE = ("mamba2", "mlstm", "mlstm_heads", "slstm")
CACHE_SPECS = {"seq": ("data", "model", None, None),
               "kv": ("data", None, "model", None),
               "hd": ("data", None, None, "model")}


def mini_config(cfg):
    """The reference's ``test_mini_dryrun_cell_8dev`` config (float32)."""
    return dataclasses.replace(cfg, **MINI, **MINI_AXES)


def smoke_config(cfg, arch, capacity_factor=NO_DROP):
    return dataclasses.replace(cfg, act_batch_axes=("data",),
                               capacity_factor=capacity_factor,
                               **SMOKE_AXES[arch])


def nest(flat, prefix):
    """The ``prefix/``-named arrays of ``flat`` as a nested dict."""
    tree = {}
    for name, a in flat.items():
        if name.startswith(prefix + "/"):
            *path, leaf = name[len(prefix) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = a
    return tree


def _host(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def _grads(params, out, prefix):
    for name, p in params.named_parameters():
        out[f"{prefix}/{name.replace('.', '/')}"] = _host(p.grad)


def _moe_scenarios(mesh, inp, out):
    p = {k: torch.from_numpy(v) for k, v in nest(inp, "moe").items()}
    x = torch.from_numpy(inp["x"])
    axes = {"group_axes": ("data",), "expert_axis": "model"}
    for cf in (NO_DROP, 1.25):
        with TMesh.activate_mesh(mesh):
            y, aux, slot = L._moe(p, x, MOE_TOP_K, cf, **axes)
        y1, aux1, slot1 = L._moe(p, x, MOE_TOP_K, cf)
        out.update({f"i/y/{cf}": _host(y), f"i/aux/{cf}": _host(aux),
                    f"i/slot/{cf}": _host(slot), f"i/y1/{cf}": _host(y1),
                    f"i/aux1/{cf}": _host(aux1), f"i/slot1/{cf}": _host(slot1),
                    f"i/route2/{cf}": _host(L.moe_route(
                        p, x, MOE_TOP_K, cf, n_sub=2)["slot"])})
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xg = x.clone().requires_grad_()
    with TMesh.activate_mesh(mesh):
        y, aux = L.moe(leaves, xg, MOE_TOP_K, NO_DROP, **axes)
    val = (y * torch.from_numpy(inp["cot"])).sum() + aux
    val.backward()
    out["ii/val"] = _host(val)
    out["ii/x"] = _host(xg.grad)
    out.update({f"ii/{k}": _host(v.grad) for k, v in leaves.items()})
    xo = torch.from_numpy(inp["x_odd"])
    with TMesh.activate_mesh(mesh):
        y, aux = L.moe(p, xo, MOE_TOP_K, 1.25, **axes)
    y1, aux1 = L.moe(p, xo, MOE_TOP_K, 1.25)
    out.update({"iii/y": _host(y), "iii/aux": _host(aux),
                "iii/y1": _host(y1), "iii/aux1": _host(aux1)})


def _laid_out(mesh, params, batch):
    """``params`` by ``named_shardings`` and ``batch`` by
    ``batch_shardings``, as DTensors."""
    from torch.distributed.tensor import distribute_tensor
    dp = Sh.distribute(params, Sh.named_shardings(params, mesh))
    specs = Sh.batch_shardings(batch, mesh, next(iter(batch.values())).shape[0])
    return dp, {k: distribute_tensor(v, mesh, TMesh.placements(specs[k], mesh))
                for k, v in batch.items()}


def _mini_scenario(mesh, inp, out):
    cfg = mini_config(dataclasses.replace(
        TC.get_smoke_config("qwen2_1p5b"), dtype=torch.float32))
    batch = {k: torch.from_numpy(inp[f"mini/{k}"]) for k in ("tokens",
                                                            "labels")}
    params = params_from_numpy(cfg, nest(inp, "mini/params"), "cpu")
    dp, dbatch = _laid_out(mesh, params, batch)
    out["iv/params_type"] = np.array(type(dp).__name__)
    dp.requires_grad_()
    with TMesh.activate_mesh(mesh):
        loss = TM.loss_fn(dp, cfg, dbatch)
    loss.backward()
    out["iv/loss"] = _host(loss)
    _grads(dp, out, "iv/g")
    params.requires_grad_()
    loss1 = TM.loss_fn(params, cfg, batch)
    loss1.backward()
    out["iv/loss1"] = _host(loss1)
    _grads(params, out, "iv/g1")


def _smoke_scenarios(mesh, inp, out):
    from torch.distributed.tensor import distribute_tensor
    for arch in SMOKE_AXES:
        base = dataclasses.replace(TC.get_smoke_config(arch),
                                   dtype=torch.float32)
        tokens = torch.from_numpy(inp[f"{arch}/tokens"])
        params = params_from_numpy(base, nest(inp, f"{arch}/params"), "cpu")
        dp, dbatch = _laid_out(mesh, params, {"tokens": tokens})
        cfs = (NO_DROP, 1.25) if base.family == "moe" else (NO_DROP,)
        for cf in cfs:
            cfg = smoke_config(base, arch, cf)
            with TMesh.activate_mesh(mesh), torch.no_grad():
                logits, _ = TM.forward(dp, cfg, dbatch)
            with torch.no_grad():
                want, _ = TM.forward(params, cfg, {"tokens": tokens})
            out[f"v/{arch}/{cf}"] = _host(logits)
            out[f"v/{arch}/{cf}/one"] = _host(want)
        if base.family != "moe":
            continue
        cfg = smoke_config(base, arch)
        b = tokens.shape[0]
        cache1 = TM.init_cache(cfg, b, 2, "cpu")
        specs = Sh.cache_shardings(cache1, mesh, b)
        cache = {k: distribute_tensor(v.clone(), mesh,
                                      TMesh.placements(specs[k], mesh))
                 for k, v in cache1.items()}
        steps, steps1 = [], []
        with TMesh.activate_mesh(mesh), torch.no_grad():
            for i in range(2):
                lg, _ = TM.decode_step(dp, cfg, cache,
                                       {"tokens": dbatch["tokens"][:, i:i + 1]}, i)
                steps.append(_host(lg))
        with torch.no_grad():
            for i in range(2):
                lg, _ = TM.decode_step(params, cfg, cache1,
                                       {"tokens": tokens[:, i:i + 1]}, i)
                steps1.append(_host(lg))
        out[f"v/{arch}/decode"] = np.stack(steps)
        out[f"v/{arch}/decode/one"] = np.stack(steps1)


def _attention_scenarios(mesh, inp, out):
    from torch.distributed.tensor import distribute_tensor
    pos = torch.arange(ATTN_L, dtype=torch.int32)
    for name, (*_, q_chunk) in ATTN.items():
        p = {k: torch.from_numpy(v) for k, v in
             nest(inp, f"attn/{name}/p").items()}
        x, cot = (torch.from_numpy(inp[f"attn/{name}/{k}"])
                  for k in ("x", "cot"))
        for tag, on_mesh in (("", True), ("1", False)):
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            xg = x.clone().requires_grad_()
            with TMesh.activate_mesh(mesh if on_mesh else None), \
                    TH.Trace() as trace:
                y = L.causal_attention(leaves, xg, pos, 10000.0, q_chunk,
                                       batch_axes=("data",))
            (y * cot).sum().backward()
            out[f"vi/{name}/y{tag}"] = _host(y)
            out[f"vi/{name}/gx{tag}"] = _host(xg.grad)
            out.update({f"vi/{name}/g{tag}/{k}": _host(v.grad)
                        for k, v in leaves.items()})
            out[f"vi/{name}/scores{tag}"] = np.array(
                [op.ins[0][0] for op in trace.ops if op.kind == "softmax"])
    for name, layout in DECODE:
        p = {k: torch.from_numpy(v) for k, v in
             nest(inp, f"attn/{name}/p").items()}
        spec = TMesh.P(*CACHE_SPECS[layout])
        caches = [torch.from_numpy(inp[f"dec/{name}/{k}"]) for k in "kv"]
        one = [c.clone() for c in caches]
        laid = [distribute_tensor(c.clone(), mesh,
                                  TMesh.placements(spec, mesh))
                for c in caches]
        for i, at in enumerate(DECODE_POS):
            x = torch.from_numpy(inp[f"dec/{name}/x"][i])
            with torch.no_grad():
                y1, _, _ = L.attention_decode(p, x, *one, at)
                with TMesh.activate_mesh(mesh):
                    y, _, _ = L.attention_decode(p, x, *laid,
                                                 torch.tensor(at))
            key = f"vii/{name}/{layout}/{i}"
            out[key + "/y"], out[key + "/y/one"] = _host(y), _host(y1)
            for k, c, c1 in zip("kv", laid, one):  # copies: c1 moves on
                out[f"{key}/{k}"] = _host(c).copy()
                out[f"{key}/{k}/one"] = _host(c1).copy()


def rec_params(name, inp):
    """``viii``'s weights of layer ``name`` as torch tensors."""
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in nest(inp, f"rec/{name}/p").items()}


def rec_layer(name):
    """``viii``'s forward of layer ``name``: f(params, x, batch_axes)."""
    from repro_torch.models import ssm as S
    kind, _, head_axis = REC[name]
    if kind == "mamba2":
        return lambda p, x, axes: S.mamba2(p, x, REC_CHUNK, axes, head_axis)
    return lambda p, x, axes: getattr(S, kind)(p, x, batch_axes=axes)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _recurrent_scenarios(mesh, inp, out):
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.models import ssm as S
    for name, (kind, _, head_axis) in REC.items():
        p = rec_params(name, inp)
        x, cot = (torch.from_numpy(inp[f"rec/{name}/{k}"]) for k in ("x", "cot"))
        f = rec_layer(name)
        for tag, on_mesh in (("", True), ("1", False)):
            leaves = _tree_map(lambda t: t.clone().requires_grad_(), p)
            xg = x.clone().requires_grad_()
            if on_mesh and head_axis is not None:  # DTensors split by heads
                tree = {"mamba": p}
                leaves = _tree_map(lambda t: t.requires_grad_(), Sh.distribute(
                    tree, Sh.named_shardings(tree, mesh))["mamba"])
                xg = distribute_tensor(x, mesh, TMesh.placements(
                    TMesh.P("data", "model", None), mesh)).requires_grad_()
            args = leaves, xg
            with TMesh.activate_mesh(mesh if on_mesh else None), \
                    TH.Trace() as trace:
                y = f(*args, ("data",))
            if isinstance(y, DTensor):
                y = y.full_tensor()
            (y * cot).sum().backward()
            out[f"viii/{name}/y{tag}"] = _host(y)
            out[f"viii/{name}/gx{tag}"] = _host(args[1].grad)
            out.update({f"viii/{name}/g{tag}/{k}": _host(v.grad)
                        for k, v in _named(args[0])})
            out[f"viii/{name}/scores{tag}"] = np.array(
                [op.ins[0][0] for op in trace.ops if op.name == "amax"])
    for name in REC_DECODE:
        kind = REC[name][0]
        p = rec_params(name, inp)
        one = {k: torch.from_numpy(v).to(  # the window bf16, as the model's
            torch.bfloat16 if k == "conv" else torch.float32)
            for k, v in nest(inp, f"rec/{name}/st").items()}
        stacked = {k: v[None] for k, v in one.items()}
        specs = Sh.cache_shardings(stacked, mesh, REC_B)
        laid = {k: distribute_tensor(v.clone(), mesh,
                                     TMesh.placements(specs[k], mesh))
                for k, v in stacked.items()}
        step = getattr(S, kind + "_decode")
        for i in range(2):
            x = torch.from_numpy(inp[f"rec/{name}/dec_x"][i])
            with torch.no_grad():
                y1, one = step(p, x, one)
                with TMesh.activate_mesh(mesh):
                    y, _ = step(p, x, {k: v[0] for k, v in laid.items()})
            key = f"viii/{name}/dec/{i}"
            out[key + "/y"], out[key + "/y/one"] = _host(y), _host(y1)
            for k in one:
                out[f"{key}/{k}"] = _host(laid[k].float())[0].copy()
                out[f"{key}/{k}/one"] = _host(one[k].float()).copy()


def main(argv):
    rank, store, inp_path, out_path = argv
    rank = int(rank)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = TMesh.make_mesh_compat((2, 2), ("data", "model"), "cpu")
        inp = dict(np.load(inp_path))
        out = {}
        for name, run in (("moe", _moe_scenarios), ("mini", _mini_scenario),
                          ("smoke", _smoke_scenarios),
                          ("attention", _attention_scenarios),
                          ("recurrent", _recurrent_scenarios)):
            t0 = time.perf_counter()
            run(mesh, inp, out)
            out[f"wall/{name}"] = np.array(time.perf_counter() - t0)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.manual_seed(0)
    main(sys.argv[1:])
