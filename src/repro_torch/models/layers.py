"""Model layers of the port: RMSNorm, RoPE, GQA attention, SwiGLU MLP, MoE.

Plain functions on tensors, mirroring ``repro.models.layers`` op for op:
the same einsums, the same float32 islands (RMSNorm, RoPE, the softmaxes,
the router logits) and the same casts back to the compute dtype, so the
CPU twins compare tightly. Parameters are mappings of tensors named as the
reference's dict pytree; every ``init_*`` draws from an explicit
``torch.Generator`` and takes a ``stack`` prefix, so a layer stack is
drawn as one ``[n_layers, ...]`` tensor a leaf, the reference's
``jax.vmap(init)`` layout.

Under a mesh the reference's sharding sites act as they do there:
  * ``causal_attention``'s ``score_shard`` constrains the scores, and
    ``moe``'s local branch its dispatch buffer, through
    ``launch.mesh.with_sharding_constraint`` (a DTensor is redistributed,
    a plain tensor passes as it is: the one-device meaning);
  * ``moe`` has the reference's three branches: no mesh (the local path,
    bit for bit what it was), expert parallelism over an ambient
    ``DeviceMesh`` (a ``shard_map_compat`` body that all-gathers the
    weights' FSDP slices and exchanges expert queues with two tiled
    all-to-alls) and the local branch under a mesh (per rank, the
    dispatch buffer constrained over the expert axis). DTensor cannot
    carry the routing's scatter, so under a mesh the routing runs per
    rank on local blocks, and only the aux loss's sums cross ranks;
  * the ``lax.scan`` over query chunks is a Python loop over query blocks
    (``jax.checkpoint`` of its body is a training matter: ``remat``).
No product here is a hand-written kernel: the reference computes this
path in plain ``jnp``, and the port keeps ``torch.einsum`` and plain ops
(no fused attention: ``scaled_dot_product_attention`` would change the
rounding points the twins hold).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (P, abstract_mesh_compat, activate_mesh,
                                     all_gather, all_to_all, axis_group,
                                     from_local, shard_map_compat,
                                     with_sharding_constraint)

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


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bld,dhk->blhk")``. A DTensor weight is contracted as one
    [d, h * hd] matrix and the heads are split off after the product is
    gathered to the batch layout: DTensor may split the folded (h, hd)
    dim of the product where the heads do not divide the model axis, and
    such a dim cannot be unfolded in place."""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return torch.einsum("bld,dhk->blhk", x, w)
    d, h, k = w.shape
    y = torch.einsum("bld,dn->bln", x, _folded(_whole(w, 2), 1, 2))
    return batch_split(y).unflatten(-1, (h, k))


def _folded(t: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``t`` with dims ``start``..``end`` folded into one, for a product.
    A DTensor's gradient comes back laid out as the folded value (a
    redistribution to its own placements), which unfolds: the product's
    own gradient layout may split the folded dim where its first factor
    (the heads) does not divide the mesh axis."""
    from torch.distributed.tensor import DTensor
    t = t.flatten(start, end)
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def _out_project(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhk,hkd->bqd")``; on DTensors one [b, q, h * hd] x
    [h * hd, d] product of ``_folded`` operands."""
    from torch.distributed.tensor import DTensor
    wo = _whole(wo, 1)
    if not isinstance(o, DTensor):
        return torch.einsum("bqhk,hkd->bqd", o, wo)
    return torch.einsum("bqn,nd->bqd", _folded(o, 2, 3), _folded(wo, 0, 1))


def _project_qkv(params: Params, x: torch.Tensor):
    x = batch_split(x)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return batch_split(q), batch_split(k), batch_split(v)


def _whole(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor weight with ``dim`` (the head dim, split where the heads
    do not divide the model axis) gathered: the einsum folds it into the
    heads, and a split head dim after them cannot be folded. A plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(w, DTensor) or Shard(dim) not in w.placements:
        return w
    return w.redistribute(w.device_mesh, tuple(
        Replicate() if p == Shard(dim) else p for p in w.placements))


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, created by the call, as a replicated DTensor when ``like``
    is a DTensor: the masks and states it yields are saved for the
    backward pass, which runs outside ``implicit_replication``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def batch_split(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its batch dim's layout kept and every other dim
    whole (partial sums reduced; a sequence-parallel residual gathered).
    A layer's einsums flatten (batch, sequence) or (batch, kv-heads) into
    one dim, which DTensor's view rules allow only when no dim after the
    first of the group is split; each layer takes its input, and the
    attention its q/k/v, in this layout, and gives its output through it,
    so the gradient reaching its last einsum comes back in the layout of
    that einsum's output, not in the residual stream's. A plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, tuple(
        p if p == Shard(0) else Replicate() for p in t.placements))


def _qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
         rope_theta: float):
    q, k, v = _project_qkv(params, x)
    return apply_rope(q, positions, rope_theta), \
        apply_rope(k, positions, rope_theta), v


def causal_attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
                     rope_theta: float = 10000.0,
                     q_chunk: int = 0, score_shard=None) -> torch.Tensor:
    """Full causal self-attention (prefill). positions: [l] int32.

    GQA in grouped form: q as [b, l, kv, rep, hd] against kv-width k/v,
    never repeated to n_heads. ``q_chunk`` > 0 (dividing l, below it)
    attends one block of queries at a time: O(q_chunk * l) score memory.
    ``score_shard=(batch_axes, key_axis)`` lays the [b, kv, rep, q, l]
    scores out with their key dim over ``key_axis`` (context-parallel
    attention, where the heads do not divide the model axis).
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
        if score_shard is not None:
            s = with_sharding_constraint(
                s, P(score_shard[0], None, None, None, score_shard[1]))
        mask = qpi[:, None] >= positions[None, :]  # [qc, l]
        s = torch.where(mask, s.float(), -math.inf)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bgrql,blgk->bqgrk", a, v)

    if q_chunk and l > q_chunk and l % q_chunk == 0:
        o = torch.cat([attend(qg[:, i:i + q_chunk], positions[i:i + q_chunk])
                       for i in range(0, l, q_chunk)], dim=1)
    else:
        o = attend(qg, positions)
    o = batch_split(o.reshape(b, l, n_heads, hd))
    return batch_split(_out_project(o, params["wo"]))


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
    _write_at(cache_k, pos_t, k)
    _write_at(cache_v, pos_t, v)
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
    out = torch.einsum("bqhk,hkd->bqd", o, _whole(params["wo"], 1))
    return batch_split(out), cache_k, cache_v


def _write_at(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor):
    """``cache[:, pos] = new`` in place. A DTensor cache, laid out over any
    of its dims, takes it as one masked select over the sequence (DTensor
    has no rule for ``index_copy_``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, pos.reshape(1), new.to(cache.dtype))
        return
    at = torch.arange(cache.shape[1], device=pos.device) == pos
    cache.copy_(torch.where(at[:, None, None], new.to(cache.dtype), cache))


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
    x = batch_split(x)
    g = torch.einsum("bld,df->blf", x, params["w_gate"])
    u = torch.einsum("bld,df->blf", x, params["w_up"])
    return batch_split(torch.einsum("blf,fd->bld", silu(g) * u,
                                    params["w_down"]))


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
              capacity_factor: float = 1.25, n_sub: int = 1,
              e_pad: Optional[int] = None) -> Dict[str, Any]:
    """The router of ``moe``: softmax over the experts, top-k, per-expert
    ranks and capacity, each entry's slot (``e * capacity + rank``, or the
    drop slot ``e_pad * capacity``), its gate and the Switch aux loss.

    Each batch row ranks as ``n_sub`` sub-groups of ``l // n_sub`` tokens,
    each with its own capacity: the expert-parallel branch's ranking, where
    a sub-group is one rank's block of the sequence (that rank routes its
    block alone, ``n_sub`` 1, to the same slots). ``e_pad`` is the padded
    expert count when ``params`` holds one rank's slice of the experts."""
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
    if e_pad is None:
        e_pad = params["w_gate"].shape[0]  # >= n_experts (phantom experts)
    l_sub = l // n_sub
    capacity = max(1, int(l_sub * top_k * capacity_factor / n_experts))
    flat_expert = expert_idx.reshape(b * n_sub, l_sub * top_k)
    rank = _expert_rank(flat_expert)
    keep = rank < capacity
    overflow = e_pad * capacity  # dedicated drop slot
    slot = torch.where(keep, flat_expert * capacity + rank, overflow)
    n = l * top_k
    return {"expert": flat_expert.reshape(b, n), "rank": rank.reshape(b, n),
            "keep": keep.reshape(b, n), "slot": slot.reshape(b, n),
            "gate": gate_vals.reshape(b, n).float(), "aux": aux,
            "probs": probs, "capacity": capacity, "overflow": overflow,
            "e_pad": e_pad}


def _experts(x_disp, w_gate, w_up, w_down):
    """SwiGLU of each expert's queue: [b, E, C, d] -> [b, E, C, d]."""
    g = torch.einsum("becd,edf->becf", x_disp, w_gate)
    u = torch.einsum("becd,edf->becf", x_disp, w_up)
    return torch.einsum("becf,efd->becd", silu(g) * u, w_down)


def _route_stats(r, n_experts: int) -> torch.Tensor:
    """[2, E]: the routed entries and the router probabilities summed over
    this rank's tokens, the aux loss's two means before the division."""
    counts = F.one_hot(r["expert"], n_experts).float().sum(dim=(0, 1))
    return torch.stack([counts, r["probs"].sum(dim=(0, 1))])


def _aux_from_stats(stats, n_tokens: int, top_k: int) -> torch.Tensor:
    """The Switch aux loss from every rank's ``_route_stats`` [..., 2, E]."""
    s = stats.sum(dim=tuple(range(stats.ndim - 2)))
    f_frac = s[0] / (n_tokens * top_k) * top_k
    return s.shape[-1] * torch.sum(f_frac * (s[1] / n_tokens))


def _moe_ep_body(x_l, router, wg, wu, wd, *, top_k: int,
                 capacity_factor: float, e_pad: int, model_axis: str,
                 fsdp: Optional[str]):
    """One rank of the expert-parallel MoE (the reference's ``shard_map``
    body). ``x_l`` [b_l, l_sub, d] is the rank's sub-group of each of its
    sequences; ``wg``/``wu``/``wd`` its ``e_pad / msz`` experts with their
    d_model dim split over ``fsdp``. The FSDP slices are all-gathered back
    (the ZeRO-3 flow), the rank's tokens dispatch locally into [b_l,
    e_pad, C, d] queues, a tiled all-to-all over ``model_axis`` hands each
    rank its experts' queues from every rank, the local experts run, and
    the reverse all-to-all brings the outputs home to be combined. Returns
    (y_l, slot_l, the aux loss's stats)."""
    r = moe_route({"router": router}, x_l, top_k, capacity_factor,
                  e_pad=e_pad)
    if fsdp is not None:
        group = axis_group(fsdp)
        wg, wu = all_gather(wg, 1, group), all_gather(wu, 1, group)
        wd = all_gather(wd, 2, group)
    group = axis_group(model_axis)

    def ffn(x_disp):
        # [b_l, e_pad, C, d] -> [b_l, e_pad / msz, msz * C, d] and back
        ye = _experts(all_to_all(x_disp, 1, 2, group), wg, wu, wd)
        return all_to_all(ye, 2, 1, group)

    y = _dispatch_combine_local(x_l, r["slot"], r["gate"], r["overflow"],
                                e_pad, r["capacity"], ffn)
    stats = _route_stats(r, router.shape[-1])
    return y.to(x_l.dtype), r["slot"], stats[None, None]


def _moe_local_body(x_l, router, wg, wu, wd, *, top_k: int,
                    capacity_factor: float, e_pad: int, buf_spec):
    """One rank of the local MoE branch under a mesh: the rank routes and
    dispatches its whole sequences ([b_l, l, d]). The dispatch buffer
    takes the reference's constraint ``buf_spec`` (group, expert, capacity
    axes): the rank runs only its block of the queues, with its slice of
    the experts (``wg``/``wu``/``wd``, split as ``buf_spec``'s expert
    axis), and the outputs are gathered back over those axes to be
    combined. Returns (y_l, slot_l, the aux loss's stats)."""
    r = moe_route({"router": router}, x_l, top_k, capacity_factor,
                  e_pad=e_pad)
    mesh = abstract_mesh_compat()
    whole = P(buf_spec[0], None, None, None)

    def ffn(x_disp):
        buf = from_local(x_disp, mesh, whole)
        mine = with_sharding_constraint(buf, buf_spec).to_local()
        ye = from_local(_experts(mine, wg, wu, wd), mesh, buf_spec, buf)
        return with_sharding_constraint(ye, whole).to_local()

    y = _dispatch_combine_local(x_l, r["slot"], r["gate"], r["overflow"],
                                e_pad, r["capacity"], ffn)
    stats = _route_stats(r, router.shape[-1])
    return y.to(x_l.dtype), r["slot"], stats[None]


def _device_mesh():
    """The ambient mesh if it is a ``DeviceMesh``: a shape-only mesh (the
    dry run's meta trace) is none."""
    from torch.distributed.device_mesh import DeviceMesh
    am = abstract_mesh_compat()
    return am if isinstance(am, DeviceMesh) else None


def _moe_mesh(expert_axis, cap_axis):
    """(the ambient ``DeviceMesh``, the axis the experts or the capacity
    shard over, its size), or (None, None, 1)."""
    axis = expert_axis or cap_axis
    am = _device_mesh()
    if axis is None or am is None or axis not in am.mesh_dim_names:
        return None, None, 1
    return am, axis, am.size(am.mesh_dim_names.index(axis))


def _tensor_mesh(*ts):
    """The ``DeviceMesh`` of the first DTensor among ``ts``, or None."""
    from torch.distributed.tensor import DTensor
    return next((t.device_mesh for t in ts if isinstance(t, DTensor)), None)


def moe(params: Params, x: torch.Tensor, top_k: int,
        capacity_factor: float = 1.25, group_axes=None, expert_axis=None,
        cap_axis=None):
    """Grouped top-k MoE with per-expert capacity (Switch drops). Returns
    (y, aux_loss). The reference's three branches:
      * **no mesh** (no ambient ``DeviceMesh``, plain tensors): each batch
        row is one ranking group; the dispatch buffer's constraint is the
        identity.
      * **expert parallelism**, under an ambient ``DeviceMesh`` whose
        ``expert_axis`` (or ``cap_axis``) has ``msz`` > 1 ranks dividing
        both the sequence and the padded experts: ``shard_map_compat``
        runs ``_moe_ep_body`` over blocks of (``group_axes``, sequence
        over the axis); each sequence ranks as ``msz`` sub-groups.
      * **local under a mesh** (the ambient one, or the DTensors' own:
        decode's one token, experts that do not divide): ``_moe_local_body``
        per rank on whole sequences, its dispatch buffer constrained to
        ``P(group_axes, expert_axis, cap_axis, None)``.
    Under a mesh, plain arguments are the global values (each rank holds
    them whole) and come back as such; DTensor arguments give DTensors."""
    y, aux, _ = _moe(params, x, top_k, capacity_factor, group_axes,
                     expert_axis, cap_axis)
    return y, aux


def _moe(params, x, top_k, capacity_factor, group_axes=None,
         expert_axis=None, cap_axis=None):
    """``moe`` that also returns each entry's slot [b, l * top_k]."""
    am, model_axis, msz = _moe_mesh(expert_axis, cap_axis)
    mesh = _device_mesh() or _tensor_mesh(x, params["w_gate"])
    if mesh is None:
        r = moe_route(params, x, top_k, capacity_factor)
        buf_spec = P(group_axes, expert_axis, cap_axis, None)

        def ffn(x_disp):
            x_disp = with_sharding_constraint(x_disp, buf_spec)
            return _experts(x_disp, params["w_gate"], params["w_up"],
                            params["w_down"])

        y = _dispatch_combine_local(x, r["slot"], r["gate"], r["overflow"],
                                    r["e_pad"], r["capacity"], ffn)
        return y.to(x.dtype), r["aux"], r["slot"]

    b, l, _ = x.shape
    e_pad = params["w_gate"].shape[0]
    ep = am is not None and msz > 1 and l % msz == 0 and e_pad % msz == 0
    sm = moe_on_mesh(mesh, ep, top_k, capacity_factor, e_pad, group_axes,
                     expert_axis, cap_axis)
    with activate_mesh(mesh):  # plain arguments are global values
        y, slot, stats = sm(x, params["router"], params["w_gate"],
                            params["w_up"], params["w_down"])
    return y, _aux_from_stats(stats, b * l, top_k), slot


def moe_on_mesh(mesh, ep: bool, top_k: int, capacity_factor: float,
                e_pad: int, group_axes=None, expert_axis=None,
                cap_axis=None):
    """One of ``moe``'s two mesh branches as a ``shard_map_compat`` of
    (x, router, w_gate, w_up, w_down) -> (y, slot, aux stats): the
    expert-parallel body over ``expert_axis`` (or ``cap_axis``) when
    ``ep``, else the local body with its constrained dispatch buffer."""
    kw = {"top_k": top_k, "capacity_factor": capacity_factor,
          "e_pad": e_pad}
    if ep:
        model_axis = expert_axis or cap_axis
        fsdp = "data" if "data" in mesh.mesh_dim_names else None
        body = functools.partial(_moe_ep_body, model_axis=model_axis,
                                 fsdp=fsdp, **kw)
        x_spec = P(group_axes, model_axis, None)
        w_specs = (P(model_axis, fsdp, None), P(model_axis, fsdp, None),
                   P(model_axis, None, fsdp))
        out_specs = (x_spec, P(group_axes, model_axis),
                     P(group_axes, model_axis, None, None))
    else:
        buf_spec = P(group_axes, expert_axis, cap_axis, None)
        body = functools.partial(_moe_local_body, buf_spec=buf_spec, **kw)
        x_spec = P(group_axes, None, None)
        w_specs = (P(expert_axis, None, None),) * 3
        out_specs = (x_spec, P(group_axes, None), P(group_axes, None, None))
    return shard_map_compat(body, mesh,
                            in_specs=(x_spec, P(None, None)) + w_specs,
                            out_specs=out_specs)
