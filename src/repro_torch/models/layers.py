"""Model layers of the port: RMSNorm, RoPE, GQA attention, SwiGLU MLP, MoE.

Plain functions on tensors, mirroring ``repro.models.layers`` op for op:
the same einsums, the same float32 islands (RMSNorm, RoPE, the softmaxes,
the router logits) and the same casts back to the compute dtype, so the
CPU twins compare tightly. Parameters are mappings of tensors named as the
reference's dict pytree; every ``init_*`` draws from an explicit
``torch.Generator`` and takes a ``stack`` prefix, so a layer stack is
drawn as one ``[n_layers, ...]`` tensor a leaf, the reference's
``jax.vmap(init)`` layout.

On one H100 the reference's mesh-specific pieces take their single-device
meaning:
  * ``moe``'s expert-parallel ``shard_map`` branch (all-to-all over the
    model axis) becomes the local branch, which is what the reference runs
    without an ambient mesh; its sharding arguments (``group_axes``,
    ``expert_axis``, ``cap_axis``) are not taken;
  * ``causal_attention``'s ``score_shard`` (the context-parallel layout
    of the scores) is not taken;
  * the ``lax.scan`` over query chunks is a Python loop over query blocks
    (``jax.checkpoint`` of its body is a training matter: this slice
    serves only).
No product here is a hand-written kernel: the reference computes this
path in plain ``jnp``, and the port keeps ``torch.einsum`` and plain ops
(no fused attention: ``scaled_dot_product_attention`` would change the
rounding points the twins hold).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Mapping[str, Any]


def _normal(gen: Optional[torch.Generator], shape, scale: float, dtype,
            device: torch.device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 and cast to ``dtype`` (the
    reference's ``_norm_init``); on the meta device, shapes only."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device: torch.device,
                 stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(stack + (d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, cast back to x's dtype. The mean of squares is
    accumulated in float64 and rounded to float32: a float32 row sum's
    order on the card depends on how many rows one call holds (11 of 64
    rows of 1,536 differ between 16 tokens at once and one at a time on an
    H100), and a last-bit change of the mean flips bfloat16 outputs, which
    flip MoE routing downstream; rounded from float64, a token normalizes
    alike in prefill and in decode."""
    x32 = x.float()
    var = torch.mean(x32.double() ** 2, dim=-1, keepdim=True).float()
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split rotation, computed in float32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)  # [half]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable [..., seq]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * inv[None, :]  # [.., seq, half]
    sin = torch.sin(ang)[..., :, None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool, dtype, device: torch.device,
                   stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    s = 1.0 / math.sqrt(d_model)
    p = {
        "wq": _normal(gen, stack + (d_model, n_heads, head_dim), s, dtype,
                      device),
        "wk": _normal(gen, stack + (d_model, n_kv, head_dim), s, dtype,
                      device),
        "wv": _normal(gen, stack + (d_model, n_kv, head_dim), s, dtype,
                      device),
        "wo": _normal(gen, stack + (n_heads, head_dim, d_model),
                      1.0 / math.sqrt(n_heads * head_dim), dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros(stack + (n_heads, head_dim), dtype=dtype,
                              device=device)
        p["bk"] = torch.zeros(stack + (n_kv, head_dim), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros(stack + (n_kv, head_dim), dtype=dtype,
                              device=device)
    return p


def _project_qkv(params: Params, x: torch.Tensor):
    q = torch.einsum("bld,dhk->blhk", x, params["wq"])
    k = torch.einsum("bld,dhk->blhk", x, params["wk"])
    v = torch.einsum("bld,dhk->blhk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
         rope_theta: float):
    q, k, v = _project_qkv(params, x)
    return apply_rope(q, positions, rope_theta), \
        apply_rope(k, positions, rope_theta), v


def causal_attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
                     rope_theta: float = 10000.0,
                     q_chunk: int = 0) -> torch.Tensor:
    """Full causal self-attention (prefill). positions: [l] int32.

    GQA in grouped form: q as [b, l, kv, rep, hd] against kv-width k/v,
    never repeated to n_heads. ``q_chunk`` > 0 (dividing l, below it)
    attends one block of queries at a time: O(q_chunk * l) score memory.
    """
    b, l, _ = x.shape
    q, k, v = _qkv(params, x, positions[None, :], rope_theta)
    n_heads, n_kv = q.shape[2], k.shape[2]
    n_rep = n_heads // n_kv
    hd = q.shape[-1]
    qg = q.reshape(b, l, n_kv, n_rep, hd)
    scale = 1.0 / math.sqrt(hd)

    def attend(qi, qpi):
        # qi: [b, qc, kv, rep, hd]; scores [b, kv, rep, qc, l]
        s = torch.einsum("bqgrk,blgk->bgrql", qi, k) * scale
        mask = qpi[:, None] >= positions[None, :]  # [qc, l]
        s = torch.where(mask, s.float(), -math.inf)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bgrql,blgk->bqgrk", a, v)

    if q_chunk and l > q_chunk and l % q_chunk == 0:
        o = torch.cat([attend(qg[:, i:i + q_chunk], positions[i:i + q_chunk])
                       for i in range(0, l, q_chunk)], dim=1)
    else:
        o = attend(qg, positions)
    o = o.reshape(b, l, n_heads, hd)
    return torch.einsum("bqhk,hkd->bqd", o, params["wo"])


def attention_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, rope_theta: float = 10000.0):
    """One-token decode against a KV cache, written in place.

    x: [b, 1, d]; cache_k/v: [b, S, n_kv, hd]; pos: the current position
    (an int or a 0-d integer tensor on x's device). The new key and value
    are written into the caches at ``pos`` (the reference's
    ``dynamic_update_slice`` of a donated buffer) and keys ``<= pos``
    attend. Returns (out [b, 1, d], cache_k, cache_v): the same buffers.
    """
    b = x.shape[0]
    S = cache_k.shape[1]
    if not isinstance(pos, torch.Tensor) and not 0 <= pos < S:
        raise ValueError(f"decode position {pos} outside a cache of {S}")
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    positions = pos_t.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(params, x)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    cache_k.index_copy_(1, pos_t.reshape(1), k.to(cache_k.dtype))
    cache_v.index_copy_(1, pos_t.reshape(1), v.to(cache_v.dtype))
    n_heads, n_kv = q.shape[2], cache_k.shape[2]
    n_rep = n_heads // n_kv
    scale = 1.0 / math.sqrt(q.shape[-1])
    # grouped attention without materialising repeated KV
    qg = q.reshape(b, 1, n_kv, n_rep, -1)
    s = torch.einsum("bqgrk,bsgk->bgrqs", qg, cache_k) * scale
    valid = torch.arange(S, device=x.device) <= pos_t
    s = torch.where(valid, s.float(), -math.inf)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bgrqs,bsgk->bqgrk", a, cache_v).reshape(b, 1, n_heads, -1)
    out = torch.einsum("bqhk,hkd->bqd", o, params["wo"])
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, dtype, device: torch.device,
             stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": _normal(gen, stack + (d_model, d_ff), s_in, dtype, device),
        "w_up": _normal(gen, stack + (d_model, d_ff), s_in, dtype, device),
        "w_down": _normal(gen, stack + (d_ff, d_model), s_out, dtype, device),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, one
    op at a time: in bfloat16 each op rounds, as the reference's
    ``jax.nn.silu`` lowers on its CPU backend (``F.silu`` rounds once and
    differs in about 40% of bfloat16 outputs)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bld,df->blf", x, params["w_gate"])
    u = torch.einsum("bld,df->blf", x, params["w_up"])
    return torch.einsum("blf,fd->bld", silu(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k routing, capacity dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, dtype,
             device: torch.device, n_padded: int = 0,
             stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``n_padded`` >= n_experts pads the expert stacks with phantom
    zero-weight experts; the router stays at n_experts, so a phantom
    expert is never routed to."""
    n_padded = max(n_padded, n_experts)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    ax = len(stack)

    def padded(shape, scale):
        w = _normal(gen, stack + (n_experts,) + shape, scale, dtype, device)
        if n_padded == n_experts:
            return w
        pad = torch.zeros(stack + (n_padded - n_experts,) + shape,
                          dtype=dtype, device=device)
        return torch.cat([w, pad], dim=ax)

    return {
        "router": _normal(gen, stack + (d_model, n_experts), s_in,
                          torch.float32, device),
        "w_gate": padded((d_model, d_ff), s_in),
        "w_up": padded((d_model, d_ff), s_in),
        "w_down": padded((d_ff, d_model), s_out),
    }


def _expert_rank(flat_expert: torch.Tensor) -> torch.Tensor:
    """Rank of each (token, k) in its expert's queue, per group row.

    flat_expert: [g, n] expert ids. Returns [g, n]: the exclusive rank
    among equal ids in row order (a stable argsort, a max-scan of run
    starts), never the [n, E] one-hot.
    """
    g, n = flat_expert.shape
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_e = torch.gather(flat_expert, 1, order)
    idx = torch.arange(n, device=flat_expert.device).expand(g, n)
    change = torch.ones_like(sorted_e, dtype=torch.bool)
    change[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    rank = torch.empty_like(idx)
    return rank.scatter_(1, order, idx - run_start)


def _dispatch_combine_local(x, slot, gate, overflow: int, E: int, C: int,
                            ffn):
    """Dispatch each group's kept (token, k) entries into [b, E, C, d]
    expert queues, run ``ffn``, and combine the gated outputs per token.
    Dropped entries go to the spare row ``overflow`` and come back as 0."""
    b, l, d = x.shape
    k = slot.shape[1] // l
    src = x.repeat_interleave(k, dim=1)  # entry j is token j // k
    buf = torch.zeros(b, overflow + 1, d, dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), src)
    y_exp = ffn(buf[:, :overflow].reshape(b, E, C, d)).reshape(b, E * C, d)
    y_pad = torch.cat([y_exp, y_exp.new_zeros(b, 1, d)], dim=1)
    gathered = torch.gather(y_pad, 1, slot[..., None].expand(-1, -1, d))
    gathered = gathered * gate[..., None].to(y_exp.dtype)
    # one rounding of the k-term sum (the reference's scatter-add rounds
    # after each add in bfloat16: the same for k <= 2)
    return gathered.reshape(b, l, k, d).sum(dim=2)


def moe_route(params: Params, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25) -> Dict[str, Any]:
    """The router of ``moe``: softmax over the experts, top-k, per-expert
    ranks and capacity, each entry's slot (``e * capacity + rank``, or the
    drop slot ``e_pad * capacity``), its gate and the Switch aux loss."""
    b, l, _ = x.shape
    n_experts = params["router"].shape[-1]
    # the reference's bf16 dot with float32 output: the products of two
    # bf16 values are exact, accumulated here in float64 and rounded to
    # float32, so a token's logits do not depend on how many tokens one
    # call routes (a float32 product's order on the card does, and a gate
    # one bfloat16 ulp away changes the token's whole MoE output)
    logits = torch.einsum("bld,de->ble", x.double(),
                          params["router"].to(x.dtype).double()).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # [b, l, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e
    f_frac = F.one_hot(expert_idx, n_experts).float().mean(dim=(0, 1, 2)) \
        * top_k
    aux = n_experts * torch.sum(f_frac * probs.mean(dim=(0, 1)))
    e_pad = params["w_gate"].shape[0]  # >= n_experts (phantom experts)
    capacity = max(1, int(l * top_k * capacity_factor / n_experts))
    flat_expert = expert_idx.reshape(b, l * top_k)
    rank = _expert_rank(flat_expert)
    keep = rank < capacity
    overflow = e_pad * capacity  # dedicated drop slot
    slot = torch.where(keep, flat_expert * capacity + rank, overflow)
    return {"expert": flat_expert, "rank": rank, "keep": keep, "slot": slot,
            "gate": gate_vals.reshape(b, l * top_k).float(), "aux": aux,
            "capacity": capacity, "overflow": overflow, "e_pad": e_pad}


def moe(params: Params, x: torch.Tensor, top_k: int,
        capacity_factor: float = 1.25):
    """Grouped top-k MoE with per-expert capacity (Switch drops): each batch
    row is one ranking group, the reference's local path. Returns (y,
    aux_loss)."""
    r = moe_route(params, x, top_k, capacity_factor)

    def ffn(x_disp):
        g = torch.einsum("becd,edf->becf", x_disp, params["w_gate"])
        u = torch.einsum("becd,edf->becf", x_disp, params["w_up"])
        return torch.einsum("becf,efd->becd", silu(g) * u, params["w_down"])

    y = _dispatch_combine_local(x, r["slot"], r["gate"], r["overflow"],
                                r["e_pad"], r["capacity"], ffn)
    return y.to(x.dtype), r["aux"]
