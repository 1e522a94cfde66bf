"""One model for the attention families of the reference's model zoo.

Families served by this port:
  dense — llama-style GQA transformer (smollm, chatglm3, yi, qwen2)
  moe   — GQA attention + top-k MoE FFN (granite-moe, qwen3-moe)
  audio — dense backbone over precomputed EnCodec frame embeddings
          (STUB frontend) + ``n_codebooks`` output heads (musicgen)
  vlm   — dense backbone over [patch-embeds ; token-embeds] (STUB anyres
          frontend) (llava-next)
``hybrid_mamba`` (zamba2) and ``xlstm`` need the SSM layers, which are not
ported yet (ROADMAP.md A16): every entry point raises
``NotImplementedError`` for them.

Parameters live in a ``ParamTree``, an ``nn.Module`` whose leaves carry the
reference's names and shapes, layer stacks included (``layers.attn.wq``
is ``[n_layers, d, h, hd]``), so weights carry across as copies
(``models.convert``). The reference's ``lax.scan`` over stacked layers is
a Python loop over per-layer views; its ``dynamic_update_slice`` of
donated caches is an in-place write. The activation-sharding fields of
``ModelConfig`` (``act_*``, ``moe_*_axis``, ``ssm_head_axis``,
``score_seq_axis``, ``vocab_axis``) are kept and constrain nothing on one
device; ``remat`` is kept for the training slice and ignored.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

ATTENTION_FAMILIES = ("dense", "moe", "audio", "vlm")


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
    remat: str = "none"  # none | full | dots (training; ignored here)
    vocab_pad_multiple: int = 16
    # the reference's mesh layout of activations; one device: no constraint
    act_batch_axes: Any = None
    act_seq_axis: Any = None
    moe_expert_axis: Any = None
    moe_cap_axis: Any = None
    ssm_head_axis: Any = None
    score_seq_axis: Any = None
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


def _require_attention_family(cfg: ModelConfig) -> None:
    if cfg.family in ("hybrid_mamba", "xlstm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family needs the SSM layers "
            "(models/ssm.py), not ported yet (ROADMAP.md A16)")
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Parameters named as the reference's dict pytree: a nested key is a
    submodule, a leaf a frozen ``nn.Parameter``. Indexing by key gives the
    leaf or the subtree, so layer functions take it as the reference's
    dicts; ``layer(i)`` gives layer i of a stacked tree as views."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
        self._layers: Optional[List[Dict[str, Any]]] = None

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

    def layer(self, i: int) -> Dict[str, Any]:
        """Layer i of a stacked tree: a nested dict of views ``leaf[i]``
        (built once; the views follow in-place copies into the leaves)."""
        if self._layers is None:
            n = next(iter(self.parameters())).shape[0]
            self._layers = [_index_tree(self.tree(), j) for j in range(n)]
        return self._layers[i]

    def _apply(self, fn, *args, **kwargs):
        # ``.to()`` and friends replace the leaves: drop the cached views
        for m in self.modules():
            m._layers = None
        return super()._apply(fn, *args, **kwargs)


def _index_tree(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in tree.items()}


def _layer_tree(cfg: ModelConfig, gen, device, n: int) -> Dict[str, Any]:
    stack = (n,)
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


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> ParamTree:
    """Random parameters of ``cfg`` drawn from ``generator`` (a fresh one
    seeded 0 when None) on ``device`` (the card when None; ``"meta"`` gives
    shapes and dtypes only). The reference's tree, leaf for leaf; the
    values differ from the reference's draws (``convert`` carries those)."""
    _require_attention_family(cfg)
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
    tree["layers"] = _layer_tree(cfg, gen, device, cfg.n_layers)
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
# Forward (prefill)
# ---------------------------------------------------------------------------


rmsn = L.rmsnorm


def _dense_block(cfg: ModelConfig, lp, x, positions):
    h = x + L.causal_attention(lp["attn"], rmsn(lp["ln1"], x), positions,
                               cfg.rope_theta, cfg.q_chunk)
    return h + L.mlp(lp["mlp"], rmsn(lp["ln2"], h))


def _moe_block(cfg: ModelConfig, lp, x, positions):
    h = x + L.causal_attention(lp["attn"], rmsn(lp["ln1"], x), positions,
                               cfg.rope_theta, cfg.q_chunk)
    y, aux = L.moe(lp["moe"], rmsn(lp["ln2"], h), cfg.top_k,
                   cfg.capacity_factor)
    return h + y, aux


def embed_inputs(params: ParamTree, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]):
    """Token/frame/patch embedding per family. Returns (x [b,l,d],
    positions [l])."""
    if cfg.family == "audio":
        x = batch["embeds"].to(cfg.dtype)  # STUB frontend output
    elif cfg.family == "vlm":
        tok = params["embed"][batch["tokens"]]
        img = torch.einsum("bld,de->ble", batch["patch_embeds"].to(cfg.dtype),
                           params["img_proj"])
        x = torch.cat([img, tok], dim=1)
    else:
        x = params["embed"][batch["tokens"]]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _head(params: ParamTree, cfg: ModelConfig, x: torch.Tensor):
    x = rmsn(params["ln_f"], x)
    if cfg.family == "audio":
        return torch.einsum("bld,cvd->blcv", x, params["lm_heads"])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bld,vd->blv", x, head)


def forward(params: ParamTree, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor], last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    ``last_only=True`` is the serving-prefill form: logits for the final
    position only, the [b, S, V] logits never materialised."""
    _require_attention_family(cfg)
    x, positions = embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layers.layer(i)
        if cfg.family == "moe":
            x, aux = _moe_block(cfg, lp, x, positions)
            aux_total = aux_total + aux
        else:
            x = _dense_block(cfg, lp, x, positions)
    if last_only:
        x = x[:, -1:, :]
    return _head(params, cfg, x), aux_total


def loss_fn(params: ParamTree, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Causal-LM loss (next-token), forward only. Padded-vocab logits are
    masked."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"].long()
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, -1e9, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if cfg.family == "vlm":  # loss only on text positions (after the image)
        nll = nll[:, cfg.n_image_tokens:]
    return torch.mean(nll) + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """KV buffers for single-token decode: [n_layers, b, S, kv, hd] each."""
    _require_attention_family(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(params: ParamTree, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor],
                batch: Mapping[str, torch.Tensor], pos):
    """One-token decode. batch: {"tokens": [b, 1]} (``embeds`` for audio);
    pos: an int or a 0-d integer tensor. Writes each layer's key and value
    into ``cache`` in place. Returns (logits [b, 1, V], cache)."""
    _require_attention_family(cfg)
    if cfg.family == "audio":
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = params["embed"][batch["tokens"]]
    if not isinstance(pos, torch.Tensor):
        S = cache["k"].shape[2]
        if not 0 <= pos < S:
            raise ValueError(f"decode position {pos} outside a cache of {S}")
        pos = torch.tensor(pos, dtype=torch.int64).to(x.device,
                                                      non_blocking=True)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layers.layer(i)
        a, _, _ = L.attention_decode(lp["attn"], rmsn(lp["ln1"], x),
                                     cache["k"][i], cache["v"][i], pos,
                                     cfg.rope_theta)
        h = x + a
        if cfg.family == "moe":
            y, _ = L.moe(lp["moe"], rmsn(lp["ln2"], h), cfg.top_k,
                         cfg.capacity_factor)
        else:
            y = L.mlp(lp["mlp"], rmsn(lp["ln2"], h))
        x = h + y
    return _head(params, cfg, x), cache
