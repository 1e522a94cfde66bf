"""One model for every family of the reference's model zoo.

Families:
  dense        — llama-style GQA transformer (smollm, chatglm3, yi, qwen2)
  moe          — GQA attention + top-k MoE FFN (granite-moe, qwen3-moe)
  hybrid_mamba — Mamba2 backbone + ONE shared attention block applied every
                 ``attn_every`` layers, Zamba-style param sharing (zamba2)
  xlstm        — alternating mLSTM / sLSTM blocks (xlstm)
  audio        — dense backbone over precomputed EnCodec frame embeddings
                 (STUB frontend) + ``n_codebooks`` output heads (musicgen)
  vlm          — dense backbone over [patch-embeds ; token-embeds] (STUB
                 anyres frontend) (llava-next)

Parameters live in a ``ParamTree``, an ``nn.Module`` whose leaves carry the
reference's names and shapes, layer stacks included (``layers.attn.wq``
is ``[n_layers, d, h, hd]``; zamba2's ``mamba_main`` is ``[n_groups,
attn_every, ...]``), so weights carry across as copies
(``models.convert``). The reference's ``lax.scan`` over stacked layers is
a Python loop over per-layer views; its ``dynamic_update_slice`` of
donated caches is an in-place write. Leaves are frozen as built; training
makes them trainable (``requires_grad_()``, ``train.step``). ``remat``
takes its nearest torch meaning while gradients are recorded
(``_maybe_remat``).

On a mesh the entry points take a DTensor tree: parameters laid out by
``distributed.sharding.named_shardings`` (``distribute`` keeps the
``ParamTree``), a batch by ``batch_shardings``. They then run under
``torch.distributed.tensor.experimental.implicit_replication``: every
tensor they create (positions, masks, the aux sum) enters as replicated.
The activation-sharding fields of ``ModelConfig`` constrain the layout at
the reference's sites (``launch.mesh.with_sharding_constraint``): the
residual stream at every block boundary (``act_batch_axes``,
``act_seq_axis``), the MoE (``moe_expert_axis``, ``moe_cap_axis``:
expert parallelism under an ambient ``DeviceMesh``), the Mamba2 heads
(``ssm_head_axis``) and the logits (``vocab_axis``). The attention splits
over "model" on a mesh by itself (``layers.causal_attention``), so
``score_seq_axis``, kept so the config holds the reference's fields, has
no effect; so do the recurrent layers (``models.ssm``; Mamba2 by the
sequence unless ``ssm_head_axis`` splits its heads). On plain tensors
each constraint is the identity, so a call with no DTensor computes what
it computed before.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import contextlib

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import (P, abstract_mesh_compat, activate_mesh,
                                     with_sharding_constraint)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

ATTENTION_FAMILIES = ("dense", "moe", "audio", "vlm")
FAMILIES = ATTENTION_FAMILIES + ("hybrid_mamba", "xlstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid_mamba | xlstm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (zamba2)
    ssm_state: int = 0
    attn_every: int = 6
    mamba_head_dim: int = 64
    # audio (musicgen)
    n_codebooks: int = 0
    # vlm (llava-next)
    n_image_tokens: int = 0
    # execution knobs
    q_chunk: int = 0
    ssd_chunk: int = 64
    remat: str = "none"  # none | full | dots (training: _maybe_remat)
    vocab_pad_multiple: int = 16
    # the mesh layout of activations (None: no constraint); the launcher
    # sets them (launch.dryrun.exec_config)
    act_batch_axes: Any = None
    act_seq_axis: Any = None
    moe_expert_axis: Any = None
    moe_cap_axis: Any = None
    ssm_head_axis: Any = None
    score_seq_axis: Any = None  # the reference's; no effect here
    vocab_axis: Any = None
    # phantom-expert padding multiple (like vocab padding)
    expert_pad_multiple: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def padded_experts(self) -> int:
        m = self.expert_pad_multiple
        return -(-self.n_experts // m) * m

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("hybrid_mamba", "xlstm")

    @property
    def takes_embeds(self) -> bool:
        return self.family == "audio"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Parameters named as the reference's dict pytree: a nested key is a
    submodule, a leaf an ``nn.Parameter`` (frozen as built;
    ``requires_grad_()`` makes every leaf trainable). Indexing by key gives
    the leaf or the subtree, so layer functions take it as the reference's
    dicts; ``layer(i)`` gives layer i of a stacked tree as views
    (``layer(g, j)`` of a two-level stack)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
        self._layers: Optional[Dict[Tuple[int, ...], Dict[str, Any]]] = None

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self) -> Iterator[str]:
        yield from self._parameters
        yield from self._modules

    def tree(self) -> Dict[str, Any]:
        """The leaves as a nested dict of tensors."""
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out

    def layer(self, *index: int) -> Dict[str, Any]:
        """Layer ``index`` of a stacked tree: a nested dict of views
        ``leaf[index]``. Views are cached while no gradient is recorded
        (they follow in-place copies into the leaves); while autograd
        records into trainable leaves, each call builds fresh views, so no
        view carries one step's graph into the next."""
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            return _index_tree(self.tree(), index)
        if self._layers is None:
            self._layers = {}
        views = self._layers.get(index)
        if views is None:
            views = self._layers[index] = _index_tree(self.tree(), index)
        return views

    def _apply(self, fn, *args, **kwargs):
        # ``.to()`` and friends replace the leaves: drop the cached views
        for m in self.modules():
            m._layers = None
        return super()._apply(fn, *args, **kwargs)


def _index_tree(tree: Mapping[str, Any], i) -> Dict[str, Any]:
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in tree.items()}


def _layer_tree(cfg: ModelConfig, gen, device, stack: Tuple[int, ...]
                ) -> Dict[str, Any]:
    tree = {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, device, stack),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
                                 cfg.dtype, device, stack),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, device, stack),
    }
    if cfg.family == "moe":
        tree["moe"] = L.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                 cfg.dtype, device,
                                 n_padded=cfg.padded_experts, stack=stack)
    else:
        tree["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                                 device, stack)
    return tree


def _mamba_layer_tree(cfg: ModelConfig, gen, device,
                      stack: Tuple[int, ...]) -> Dict[str, Any]:
    return {
        "ln": L.init_rmsnorm(cfg.d_model, cfg.dtype, device, stack),
        "mamba": S.init_mamba2(gen, cfg.d_model, cfg.ssm_state,
                               cfg.mamba_head_dim, dtype=cfg.dtype,
                               device=device, stack=stack),
    }


def _xlstm_pair_tree(cfg: ModelConfig, gen, device,
                     stack: Tuple[int, ...]) -> Dict[str, Any]:
    return {
        "ln_m": L.init_rmsnorm(cfg.d_model, cfg.dtype, device, stack),
        "mlstm": S.init_mlstm(gen, cfg.d_model, cfg.n_heads, dtype=cfg.dtype,
                              device=device, stack=stack),
        "ln_s": L.init_rmsnorm(cfg.d_model, cfg.dtype, device, stack),
        "slstm": S.init_slstm(gen, cfg.d_model, cfg.n_heads, dtype=cfg.dtype,
                              device=device, stack=stack),
    }


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups of ``attn_every`` Mamba2 layers, Mamba2 layers after them)."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> ParamTree:
    """Random parameters of ``cfg`` drawn from ``generator`` (a fresh one
    seeded 0 when None) on ``device`` (the card when None; ``"meta"`` gives
    shapes and dtypes only). The reference's tree, leaf for leaf; the
    values differ from the reference's draws (``convert`` carries those)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator
    if gen is None and device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)
    V, d = cfg.padded_vocab, cfg.d_model
    s = 1.0 / math.sqrt(d)
    tree: Dict[str, Any] = {
        "embed": L._normal(gen, (V, d), s, cfg.dtype, device),
        "ln_f": L.init_rmsnorm(d, cfg.dtype, device),
    }
    if not cfg.tie_embeddings:
        if cfg.family == "audio":
            tree["lm_heads"] = L._normal(gen, (cfg.n_codebooks, V, d), s,
                                         cfg.dtype, device)
        else:
            tree["lm_head"] = L._normal(gen, (V, d), s, cfg.dtype, device)
    if cfg.family in ATTENTION_FAMILIES:
        tree["layers"] = _layer_tree(cfg, gen, device, (cfg.n_layers,))
    elif cfg.family == "hybrid_mamba":
        n_groups, tail = _hybrid_groups(cfg)
        tree["mamba_main"] = _mamba_layer_tree(cfg, gen, device,
                                               (n_groups, cfg.attn_every))
        if tail:
            tree["mamba_tail"] = _mamba_layer_tree(cfg, gen, device, (tail,))
        tree["shared_attn"] = _layer_tree(cfg, gen, device, ())
    else:  # xlstm
        tree["pairs"] = _xlstm_pair_tree(cfg, gen, device,
                                         (cfg.n_layers // 2,))
    if cfg.family == "vlm":
        tree["img_proj"] = L._normal(gen, (d, d), s, cfg.dtype, device)
    return ParamTree(tree)


def param_count(params: ParamTree) -> int:
    return sum(int(p.numel()) for p in params.parameters())


def active_param_count(cfg: ModelConfig, params: ParamTree) -> int:
    """Active params per token (MoE: top_k of n_experts expert params)."""
    total = param_count(params)
    if cfg.family != "moe" or not cfg.n_experts:
        return total
    expert = sum(int(p.numel()) for name, p in params.named_parameters()
                 if name.split(".")[-1] in ("w_gate", "w_up", "w_down")
                 and "moe" in name.split("."))
    return total - expert + int(expert * cfg.top_k / cfg.n_experts)


# ---------------------------------------------------------------------------
# Blocks (with the remat policy)
# ---------------------------------------------------------------------------


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig):
    """``run(block, *args)`` under ``cfg.remat``, the nearest meaning of
    the reference's ``jax.checkpoint`` policies, while gradients are
    recorded (otherwise the block just runs):
      * ``full``: ``torch.utils.checkpoint`` of the whole block: only its
        inputs are kept, everything inside is recomputed in the backward;
      * ``dots``: the block under a selective checkpoint that keeps the
        output of every matrix product (``mm``, ``bmm``, ``addmm``) and
        recomputes the rest, the elementwise tail (norms, activations,
        softmax, gates): ``checkpoint_dots_with_no_batch_dims`` without its
        batch-dimension filter (torch's einsum lowers plain and batched
        products alike to ``bmm``)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}")

    def run(block, *args):
        if cfg.remat == "none" or not torch.is_grad_enabled():
            return block(*args)
        kw: Dict[str, Any] = {"use_reentrant": False}
        if cfg.remat == "dots":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _save_dots)
        mesh = abstract_mesh_compat()

        def again(*a):  # the recompute sees the forward's mesh and mode
            with activate_mesh(mesh), _on_mesh(*a):
                return block(*a)

        return _ckpt.checkpoint(again, *args, **kw)

    return run


rmsn = L.rmsnorm


def _shard_act(x, cfg: ModelConfig):
    """The residual stream's layout: batch over ``act_batch_axes``,
    sequence over ``act_seq_axis``."""
    if cfg.act_batch_axes is None and cfg.act_seq_axis is None:
        return x
    spec = P(cfg.act_batch_axes, cfg.act_seq_axis, *([None] * (x.ndim - 2)))
    return with_sharding_constraint(x, spec)


def _moe_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"group_axes": cfg.act_batch_axes,
            "expert_axis": cfg.moe_expert_axis, "cap_axis": cfg.moe_cap_axis}


def _dense_block(cfg: ModelConfig, lp, x, positions):
    h = x + L.causal_attention(lp["attn"], rmsn(lp["ln1"], x), positions,
                               cfg.rope_theta, cfg.q_chunk,
                               batch_axes=cfg.act_batch_axes)
    return h + L.mlp(lp["mlp"], rmsn(lp["ln2"], h))


def _moe_block(cfg: ModelConfig, lp, x, positions):
    h = x + L.causal_attention(lp["attn"], rmsn(lp["ln1"], x), positions,
                               cfg.rope_theta, cfg.q_chunk,
                               batch_axes=cfg.act_batch_axes)
    y, aux = L.moe(lp["moe"], rmsn(lp["ln2"], h), cfg.top_k,
                   cfg.capacity_factor, **_moe_axes(cfg))
    return h + y, aux


def _mamba_block(cfg: ModelConfig, lp, x):
    return x + S.mamba2(lp["mamba"], rmsn(lp["ln"], x), cfg.ssd_chunk,
                        batch_axes=cfg.act_batch_axes,
                        head_axis=cfg.ssm_head_axis)


def _xlstm_pair_block(cfg: ModelConfig, lp, x):
    h = x + S.mlstm(lp["mlstm"], rmsn(lp["ln_m"], x),
                    batch_axes=cfg.act_batch_axes)
    return h + S.slstm(lp["slstm"], rmsn(lp["ln_s"], h),
                       batch_axes=cfg.act_batch_axes)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def embed_inputs(params: ParamTree, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]):
    """Token/frame/patch embedding per family. Returns (x [b,l,d],
    positions [l])."""
    if cfg.family == "audio":
        x = batch["embeds"].to(cfg.dtype)  # STUB frontend output
    elif cfg.family == "vlm":
        tok = _lookup(params["embed"], batch["tokens"])
        img = torch.einsum("bld,de->ble", batch["patch_embeds"].to(cfg.dtype),
                           params["img_proj"])
        x = torch.cat([img, tok], dim=1)
    else:
        x = _lookup(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, L.replicated(positions, x)


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table`` (a negative id counts from the end).

    A DTensor table is looked up vocab-parallel: its vocab dim keeps its
    sharding and the rest is gathered (the FSDP slices); each rank reads
    the ids that fall in its block of rows, zeros elsewhere, and the
    result is a partial sum over the vocab's mesh dims, laid out over the
    others as the ids are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    rows_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    # the first row of this rank's block, by DTensor's chunking: blocks of
    # ceil(rows / ranks) over the vocab's mesh dims, in mesh order
    lo, n = 0, table.shape[0]
    for d in (d for d, v in enumerate(vocab) if v):
        size, r = -(-n // mesh.size(d)), mesh.get_local_rank(d)
        lo += min(r * size, n)
        n = max(0, min(size, n - r * size))
    if isinstance(ids, DTensor):
        id_pl = tuple(Replicate() if v else p
                      for v, p in zip(vocab, ids.placements))
        shape, ids = ids.shape, ids.redistribute(mesh, id_pl).to_local()
    else:
        id_pl, shape = (Replicate(),) * mesh.ndim, ids.shape
    # where the ids are split, each rank's row gradient is a partial sum
    rows = table.redistribute(mesh, rows_pl).to_local(grad_placements=tuple(
        r if v or isinstance(p, Replicate) else Partial()
        for v, r, p in zip(vocab, rows_pl, id_pl)))
    ids = ids.long()
    local = torch.where(ids < 0, ids + table.shape[0], ids) - lo
    hit = (local >= 0) & (local < rows.shape[0])
    out = rows[local.clamp(0, rows.shape[0] - 1)] * hit[..., None]
    shape = (*shape, table.shape[1])
    return DTensor.from_local(
        out, mesh, tuple(Partial() if v else p for v, p in zip(vocab, id_pl)),
        run_check=False, shape=shape, stride=tuple(
            math.prod(shape[i + 1:]) for i in range(len(shape))))


def _on_mesh(*tensors):
    """``implicit_replication`` for a call on DTensors (the tensors it
    creates, plain, enter as replicated); otherwise no context."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(t, DTensor) for t in tensors):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _head(params: ParamTree, cfg: ModelConfig, x: torch.Tensor,
          constrain: bool = False):
    """Logits; ``constrain`` lays them out with the vocab dim over
    ``vocab_axis`` (the forward's, not decode's, as in the reference)."""
    from torch.distributed.tensor import DTensor
    x = rmsn(params["ln_f"], L.batch_split(x))
    if cfg.family == "audio":
        heads = params["lm_heads"]
        if isinstance(heads, DTensor):
            # one product a codebook, its vocab laid out as the head's:
            # the einsum folds (codebook, vocab) into one dim, which
            # unfolds only where it is not split
            logits = torch.stack([torch.einsum("bld,vd->blv", x, heads[c])
                                  for c in range(heads.shape[0])], dim=2)
        else:
            logits = torch.einsum("bld,cvd->blcv", x, heads)
    else:
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("bld,vd->blv", x, head)
    if constrain and cfg.vocab_axis is not None:
        logits = with_sharding_constraint(logits, P(
            cfg.act_batch_axes, *([None] * (logits.ndim - 2)),
            cfg.vocab_axis))
    return logits


def forward(params: ParamTree, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor], last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    ``last_only=True`` is the serving-prefill form: logits for the final
    position only, the [b, S, V] logits never materialised. On DTensors
    (module docstring) it runs under ``implicit_replication``."""
    _check_family(cfg)
    with _on_mesh(params["embed"], *batch.values()):
        return _forward(params, cfg, batch, last_only)


def _forward(params, cfg, batch, last_only):
    x, positions = embed_inputs(params, cfg, batch)
    x = _shard_act(x, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _maybe_remat(cfg)
    if cfg.family in ATTENTION_FAMILIES:
        layers = params["layers"]
        for i in range(cfg.n_layers):
            lp = layers.layer(i)
            if cfg.family == "moe":
                x, aux = remat(functools.partial(_moe_block, cfg, lp), x,
                               positions)
                aux_total = aux_total + aux
            else:
                x = remat(functools.partial(_dense_block, cfg, lp), x,
                          positions)
            x = _shard_act(x, cfg)
    elif cfg.family == "hybrid_mamba":
        main, shared = params["mamba_main"], params["shared_attn"]
        n_groups, per = main["ln"]["scale"].shape[:2]

        def group(g, h):
            for j in range(per):
                h = _mamba_block(cfg, main.layer(g, j), h)
            return _dense_block(cfg, shared, h, positions)  # shared attn+MLP

        for g in range(n_groups):
            x = _shard_act(remat(functools.partial(group, g), x), cfg)
        if "mamba_tail" in params:
            tail = params["mamba_tail"]
            for i in range(tail["ln"]["scale"].shape[0]):
                x = _mamba_block(cfg, tail.layer(i), x)
    else:  # xlstm
        pairs = params["pairs"]
        for i in range(pairs["ln_m"]["scale"].shape[0]):
            x = _shard_act(remat(functools.partial(
                _xlstm_pair_block, cfg, pairs.layer(i)), x), cfg)
    if last_only:
        x = x[:, -1:, :]
    return _head(params, cfg, x, constrain=True), aux_total


def _vocab_ids(logits: torch.Tensor) -> torch.Tensor:
    """``arange(V)`` of the logits' last dim, laid out as that dim is (a
    DTensor split where the logits' vocab is: the masks it meets stay a
    rank's block of the vocab, not the whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ids = torch.arange(logits.shape[-1], device=logits.device)
    if not isinstance(logits, DTensor):
        return ids
    last = Shard(logits.ndim - 1)
    pl = tuple(Shard(0) if p == last else Replicate()
               for p in logits.placements)
    return L.replicated(ids, logits).redistribute(logits.device_mesh, pl)


def _grad_as_value(t):
    """A DTensor ``t`` whose gradient comes back laid out as ``t`` is (a
    redistribution to its own placements). A sum over the split vocab
    hands its summand a whole gradient (an expand); torch 2.11's DTensor
    then takes ``where``'s and ``exp``'s gradients whole, [b, l, V] a rank
    (13 GB in xlstm-350m's train step), where 2.13 keeps the rank's block;
    laid out first, the gradient is the rank's slice on both."""
    return t.redistribute(t.device_mesh, t.placements)


def loss_fn(params: ParamTree, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Causal-LM loss (next-token). Padded-vocab logits are masked.
    Differentiable: with trainable leaves, ``backward()`` fills their
    ``.grad`` (DTensor leaves: DTensor gradients on the leaf's mesh).
    On vocab-sharded DTensor logits the gold logit is a masked sum over
    the vocab (a partial sum a rank), not a gather, and the log-sum-exp
    is taken from the vocab's max and exp-sum, each reduced over the
    ranks."""
    from torch.distributed.tensor import DTensor
    logits, aux = forward(params, cfg, batch)
    with _on_mesh(params["embed"], *batch.values()):
        labels = batch["labels"].long()
        logits = logits.float()
        vocab = _vocab_ids(logits)
        if cfg.padded_vocab != cfg.vocab_size:
            logits = torch.where(vocab >= cfg.vocab_size, -1e9, logits)
        # ``take_along_axis`` counts a negative label from the end, as the
        # embedding's indexing does a negative id (ROADMAP.md C8)
        labels = torch.where(labels < 0, labels + logits.shape[-1], labels)
        if isinstance(logits, DTensor):
            # the vocab's max and exp-sum all-reduced over its ranks (to
            # the batch layout: a gradient in another would gather the
            # logits), the logits never gathered
            top = L.batch_split(logits.detach().amax(dim=-1, keepdim=True))
            logz = L.batch_split(_grad_as_value(
                (logits - top).exp()).sum(dim=-1)).log() + top[..., 0]
            gold = L.batch_split(_grad_as_value(torch.where(
                labels[..., None] == vocab, logits, 0.0)).sum(dim=-1))
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = logz - gold
        if cfg.family == "vlm":  # loss only on text positions (after image)
            nll = nll[:, cfg.n_image_tokens:]
        return torch.mean(nll) + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """KV / SSM state buffers for single-token decode. Attention families:
    ``k``/``v`` [n_layers, b, S, kv, hd]. hybrid_mamba: ``ssm_main`` (each
    Mamba2 state leaf stacked ``[n_groups, attn_every, ...]``; the conv
    window bfloat16 whatever ``cfg.dtype``), ``shared_k``/``shared_v``
    [n_groups, b, S, kv, hd] and ``ssm_tail``. xlstm: ``mlstm`` and
    ``slstm`` states stacked over the pairs, the stabilisers ``m`` at
    -1e30 (the reference's ``init_cache``; its ``*_init_state`` use -inf)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv_shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ATTENTION_FAMILIES:
        return {"k": zeros((cfg.n_layers,) + kv_shape, cfg.dtype),
                "v": zeros((cfg.n_layers,) + kv_shape, cfg.dtype)}
    f32 = torch.float32
    if cfg.family == "hybrid_mamba":
        proto = S.init_mamba2(None, cfg.d_model, cfg.ssm_state,
                              cfg.mamba_head_dim, dtype=cfg.dtype,
                              device=torch.device("meta"))
        st = S.mamba2_init_state(proto, batch, torch.device("meta"))
        n_groups, tail = _hybrid_groups(cfg)
        cache: Dict[str, Any] = {
            "ssm_main": {k: zeros((n_groups, cfg.attn_every) + v.shape,
                                  v.dtype) for k, v in st.items()},
            "shared_k": zeros((n_groups,) + kv_shape, cfg.dtype),
            "shared_v": zeros((n_groups,) + kv_shape, cfg.dtype),
        }
        if tail:
            cache["ssm_tail"] = {k: zeros((tail,) + v.shape, v.dtype)
                                 for k, v in st.items()}
        return cache
    n_pairs = cfg.n_layers // 2
    d_inner = int(cfg.d_model * 2)
    hd = d_inner // cfg.n_heads
    H, d = cfg.n_heads, cfg.d_model
    return {
        "mlstm": {
            "C": zeros((n_pairs, batch, H, hd, hd), f32),
            "nvec": zeros((n_pairs, batch, H, hd), f32),
            "m": torch.full((n_pairs, batch, H), -1e30, dtype=f32,
                            device=device),
        },
        "slstm": {
            "c": zeros((n_pairs, batch, d), f32),
            "nvec": zeros((n_pairs, batch, d), f32),
            "h": zeros((n_pairs, batch, d), f32),
            "m": torch.full((n_pairs, batch, d), -1e30, dtype=f32,
                            device=device),
        },
    }


def _write_state(views: Mapping[str, torch.Tensor],
                 new: Mapping[str, torch.Tensor]) -> None:
    """The reference's ``dynamic_update_slice`` of a layer's state (a
    step on a mesh writes its blocks in place and returns the views)."""
    for k, v in views.items():
        if new[k] is not v:
            v.copy_(new[k])


def _mamba_decode(lp, x, states, index):
    st = {k: v[index] for k, v in states.items()}
    y, st2 = S.mamba2_decode(lp["mamba"], rmsn(lp["ln"], x), st)
    _write_state(st, st2)
    return x + y


def decode_step(params: ParamTree, cfg: ModelConfig,
                cache: Dict[str, Any],
                batch: Mapping[str, torch.Tensor], pos):
    """One-token decode. batch: {"tokens": [b, 1]} (``embeds`` for audio);
    pos: an int or a 0-d integer tensor. Writes each layer's key and value,
    or its recurrent state, into ``cache`` in place. Returns (logits
    [b, 1, V], cache). On DTensors it runs under ``implicit_replication``
    (module docstring); the MoE takes the config's mesh axes."""
    _check_family(cfg)
    with _on_mesh(params["embed"], *batch.values()):
        return _decode_step(params, cfg, cache, batch, pos)


def _decode_step(params, cfg, cache, batch, pos):
    if cfg.family == "audio":
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = _lookup(params["embed"], batch["tokens"])
    kv = cache.get("k", cache.get("shared_k"))
    if kv is not None and not isinstance(pos, torch.Tensor):
        S_ = kv.shape[2]
        if not 0 <= pos < S_:
            raise ValueError(f"decode position {pos} outside a cache of {S_}")
        pos = torch.tensor(pos, dtype=torch.int64).to(x.device,
                                                      non_blocking=True)
    if cfg.family in ATTENTION_FAMILIES:
        layers = params["layers"]
        for i in range(cfg.n_layers):
            lp = layers.layer(i)
            a, _, _ = L.attention_decode(lp["attn"], rmsn(lp["ln1"], x),
                                         cache["k"][i], cache["v"][i], pos,
                                         cfg.rope_theta)
            h = x + a
            if cfg.family == "moe":
                y, _ = L.moe(lp["moe"], rmsn(lp["ln2"], h), cfg.top_k,
                             cfg.capacity_factor, **_moe_axes(cfg))
            else:
                y = L.mlp(lp["mlp"], rmsn(lp["ln2"], h))
            x = h + y
    elif cfg.family == "hybrid_mamba":
        main, shared = params["mamba_main"], params["shared_attn"]
        n_groups, per = main["ln"]["scale"].shape[:2]
        for g in range(n_groups):
            for j in range(per):
                x = _mamba_decode(main.layer(g, j), x,
                                  cache["ssm_main"], (g, j))
            a, _, _ = L.attention_decode(shared["attn"],
                                         rmsn(shared["ln1"], x),
                                         cache["shared_k"][g],
                                         cache["shared_v"][g], pos,
                                         cfg.rope_theta)
            x = x + a
            x = x + L.mlp(shared["mlp"], rmsn(shared["ln2"], x))
        if "mamba_tail" in params:
            tail = params["mamba_tail"]
            for i in range(tail["ln"]["scale"].shape[0]):
                x = _mamba_decode(tail.layer(i), x, cache["ssm_tail"], i)
    else:  # xlstm
        pairs = params["pairs"]
        for i in range(pairs["ln_m"]["scale"].shape[0]):
            lp = pairs.layer(i)
            mst = {k: v[i] for k, v in cache["mlstm"].items()}
            y, mst2 = S.mlstm_decode(lp["mlstm"], rmsn(lp["ln_m"], x), mst)
            x = x + y
            sst = {k: v[i] for k, v in cache["slstm"].items()}
            y, sst2 = S.slstm_decode(lp["slstm"], rmsn(lp["ln_s"], x), sst)
            _write_state(mst, mst2)
            _write_state(sst, sst2)
            x = x + y
    return _head(params, cfg, x), cache
