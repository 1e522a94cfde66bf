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
  * ``causal_attention`` and ``attention_decode`` split over the "model"
    axis as GSPMD splits the reference's (a ``shard_map_compat`` body a
    rank, over the ambient ``DeviceMesh`` or the DTensors' own). In train
    and prefill a rank all-gathers its FSDP weight slices over "data" and
    either (heads dividing the axis) all-gathers the sequence-parallel
    residual, projects and attends its ``H / N`` heads (and the kv heads
    they read: its own block, or the rule's head_dim slice of every kv
    head all-gathered) and reduce-scatters its out-projection's partial
    sum back over the sequence, or (heads that do not divide) attends its
    own query rows against k and v all-gathered along the sequence, with
    the weights all-gathered over "model". In decode a rank projects with
    its blocks, all-gathers the token's q, k and v, writes the cache block
    it owns, scores its block of the cache (a stripe of the sequence: the
    softmax's max and exp-sum all-reduced, flash-decoding's combine; kv
    heads; or head_dim: the scores all-reduced) and all-reduces the
    out-projection. Every product is 1/N of the whole;
  * ``moe``'s local branch constrains its dispatch buffer through
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
Without a mesh every path is the one-device one, op for op.
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
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import (P, abstract_mesh_compat, activate_mesh,
                                     all_gather, all_to_all, axis_group,
                                     axis_sizes, from_local, reduce_scatter,
                                     shard_map_compat,
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
    first of the group is split; the MLP, the SSM layers and the head take
    their input in this layout and give their output through it, so the
    gradient reaching a last einsum comes back in the layout of that
    einsum's output, not in the residual stream's. A plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, tuple(
        p if p == Shard(0) else Replicate() for p in t.placements))


def _qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
         rope_theta: float):
    q = torch.einsum("bld,dhk->blhk", x, params["wq"])
    k = torch.einsum("bld,dhk->blhk", x, params["wk"])
    v = torch.einsum("bld,dhk->blhk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return apply_rope(q, positions, rope_theta), \
        apply_rope(k, positions, rope_theta), v


def _attend(qg, k, v, q_pos, k_pos, q_chunk: int, dtype):
    """Causal grouped attention: queries ``qg`` [b, lq, kv, rep, hd] at
    positions ``q_pos`` [lq] against ``k``/``v`` [b, lk, kv, hd] at
    ``k_pos`` [lk]; returns [b, lq, kv, rep, hd]. ``q_chunk`` > 0 (dividing
    lq, below it) attends one block of queries at a time."""
    scale = 1.0 / math.sqrt(qg.shape[-1])

    def attend(qi, qpi):
        # qi: [b, qc, kv, rep, hd]; scores [b, kv, rep, qc, lk]
        s = torch.einsum("bqgrk,blgk->bgrql", qi, k) * scale
        mask = qpi[:, None] >= k_pos[None, :]  # [qc, lk]
        s = torch.where(mask, s.float(), -math.inf)
        a = torch.softmax(s, dim=-1).to(dtype)
        return torch.einsum("bgrql,blgk->bqgrk", a, v)

    lq = qg.shape[1]
    if q_chunk and lq > q_chunk and lq % q_chunk == 0:
        return torch.cat([attend(qg[:, i:i + q_chunk], q_pos[i:i + q_chunk])
                          for i in range(0, lq, q_chunk)], dim=1)
    return attend(qg, q_pos)


def causal_attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
                     rope_theta: float = 10000.0,
                     q_chunk: int = 0, batch_axes=None) -> torch.Tensor:
    """Full causal self-attention (prefill). positions: [l] int32.

    GQA in grouped form: q as [b, l, kv, rep, hd] against kv-width k/v,
    never repeated to n_heads. ``q_chunk`` > 0 (dividing l, below it)
    attends one block of queries at a time: O(q_chunk * l) score memory.

    Under a mesh (an ambient ``DeviceMesh``, or DTensor arguments) the
    attention splits over the "model" axis as the reference's does
    (``_attention_body``, one rank of a ``shard_map_compat`` whose x is
    laid out with its batch over ``batch_axes`` and its sequence over
    "model"); the rank's scores are 1/N of the whole there.
    """
    mesh = _device_mesh() or _tensor_mesh(x, params["wq"])
    if mesh is not None:
        return _attention_on_mesh(mesh, params, x, positions, rope_theta,
                                  q_chunk, batch_axes)
    b, l, _ = x.shape
    q, k, v = _qkv(params, x, positions[None, :], rope_theta)
    n_heads, n_kv, hd = q.shape[2], k.shape[2], q.shape[-1]
    qg = q.reshape(b, l, n_kv, n_heads // n_kv, hd)
    o = _attend(qg, k, v, positions, positions, q_chunk, x.dtype)
    return torch.einsum("bqhk,hkd->bqd", o.reshape(b, l, n_heads, hd),
                        params["wo"])


_ATTN_WEIGHTS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _attn_specs(params: Params, mesh, keep) -> Dict[str, Any]:
    """Each attention weight's spec by the sharding rules
    (``distributed.sharding``: d_model over "data", the heads over
    "model", else head_dim): ``_rule_specs`` of the attention's leaves."""
    return _rule_specs("attn", params, tuple(
        n for n in _ATTN_WEIGHTS if n in params), mesh, keep)


def _rule_specs(kind: str, params: Params, names, mesh,
                keep) -> Dict[str, Any]:
    """The spec of each leaf ``params[n]`` of a ``kind`` layer (``attn``,
    ``mamba``, ``mlstm``, ``slstm``) by the sharding rules, with every
    axis that is neither "model" nor in ``keep`` (the axes the batch
    splits over) left whole: a weight's block is gathered inside a body
    only over an axis its output is split over, so the gradient's
    reduce-scatter sums distinct parts."""
    from repro_torch.distributed import sharding as Sh
    keep = set(_axes_of(keep)) | {"model"}
    specs = {}
    for n in names:
        rule = Sh._spec_for(f"{kind}/{n}", tuple(params[n].shape), mesh)
        specs[n] = P(*(e if set(_axes_of(e)) <= keep else None
                       for e in rule))
    return specs


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _fsdp_whole(t: torch.Tensor, spec) -> torch.Tensor:
    """A weight's local block gathered over every axis of ``spec`` but
    "model" (the FSDP slices; inner axis first)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes_of(entry)):
            if a != "model":
                t = all_gather(t, dim, axis_group(a))
    return t


def _model_dim(spec) -> Optional[int]:
    """The dim ``spec`` splits over "model", or None."""
    return next((d for d, e in enumerate(spec) if "model" in _axes_of(e)),
                None)


def _rank_block(t: torch.Tensor, spec, dim: int, lo: int, n: int, group):
    """Rows ``lo:lo + n`` of ``dim`` of a weight, whole over "model" and
    its other dims: the local block as it is where "model" splits ``dim``
    (the block is the rank's), else gathered over "model" and sliced."""
    split = _model_dim(spec)
    if split == dim:
        return t
    if split is not None:
        t = all_gather(t, split, group)
    return t.narrow(dim, lo, n)


def _model_whole(t: torch.Tensor, spec, group) -> torch.Tensor:
    split = _model_dim(spec)
    return t if split is None else all_gather(t, split, group)


def _attention_on_mesh(mesh, params, x, positions, rope_theta, q_chunk,
                       batch_axes):
    """``causal_attention`` split over the "model" axis of ``mesh``: a
    ``shard_map_compat`` of ``_attention_body`` over (x: batch over
    ``batch_axes``, sequence over "model"; positions whole; the weights as
    ``_attn_specs``). Raises where the sequence does not divide the
    axis."""
    msz = axis_sizes(mesh).get("model")
    l = x.shape[1]
    if msz is None or l % msz:
        raise ValueError(f"attention on a mesh of axes {axis_sizes(mesh)}: "
                         f"a sequence of {l} does not split over its "
                         f"'model' axis")
    specs = _attn_specs(params, mesh, batch_axes)
    names = tuple(specs)
    _, n_heads, hd = params["wq"].shape
    body = functools.partial(_attention_body, names=names, specs=specs,
                             n_heads=n_heads, n_kv=params["wk"].shape[1],
                             hd=hd, rope_theta=rope_theta, q_chunk=q_chunk)
    x_spec = P(batch_axes, "model", None)
    sm = shard_map_compat(body, mesh,
                          in_specs=(x_spec, P(None)) + tuple(
                              specs[n] for n in names),
                          out_specs=x_spec)
    with activate_mesh(mesh):  # plain arguments are global values
        return sm(x, positions, *(params[n] for n in names))


def _attention_body(x, positions, *weights, names, specs, n_heads: int,
                    n_kv: int, hd: int, rope_theta: float, q_chunk: int):
    """One rank of the attention on a mesh. ``x`` [b_l, l / N, d] is the
    rank's block of the sequence-parallel residual (N ranks on "model");
    each weight arrives as its sharding rule's block and is all-gathered
    over its FSDP axes (the ZeRO-3 flow, reduce-scattered back in the
    backward). Every product of the layer is 1/N of the whole:

      * **heads** (N divides the heads): x is all-gathered over "model"
        along the sequence; the rank projects its ``H / N`` query heads
        and the kv heads they read (its own block where N divides the kv
        heads; else the rule's head_dim slice of every kv head, all-gathered
        along head_dim, of which it keeps those heads), attends over the
        whole sequence, out-projects with its rows of ``wo`` and
        reduce-scatters the partial sum back to the sequence-parallel
        layout;
      * **query rows** (N does not divide the heads: qwen2's 12, smollm's
        15, llava's 56 and granite's 24 on 16): the rank projects its own
        rows of q, k and v with the weights all-gathered over "model",
        all-gathers k and v along the sequence, and attends its rows
        against every key; its out-projection is its own rows of the
        residual, with no reduction. GSPMD splits the same products over
        the keys instead (the reference's compiled program: each device's
        rows of k and v, every query chunk all-gathered, the softmax's max
        and sum and the weighted sums all-reduced): the same FLOPs a
        device, more bytes between devices.
    Where the heads divide, the split by heads is GSPMD's; the query rows
    would give the same FLOPs and fewer collective bytes in the dry run
    (k and v are narrower than the residual), which cards have yet to
    time (ROADMAP A18).
    Returns the rank's [b_l, l / N, d]."""
    w = {n: _fsdp_whole(t, specs[n]) for n, t in zip(names, weights)}
    group = axis_group("model")
    msz, r = dist.get_world_size(group), dist.get_rank(group)
    b, l_own, _ = x.shape
    n_rep = n_heads // n_kv

    def bias(name, lo, n):
        if "b" + name[1] not in w:
            return 0
        return _rank_block(w["b" + name[1]], specs["b" + name[1]], 0, lo, n,
                           group)

    if n_heads % msz == 0:
        h_own = n_heads // msz
        if h_own % n_rep and n_rep % h_own:
            raise ValueError(f"{h_own} query heads a rank do not group "
                             f"with kv heads of {n_rep}")
        # the kv heads the rank's query heads read
        g_lo, g_hi = r * h_own // n_rep, ((r + 1) * h_own - 1) // n_rep + 1
        x = all_gather(x, 1, group)
        pos = positions[None, :]
        q = torch.einsum("bld,dhk->blhk", x, _rank_block(
            w["wq"], specs["wq"], 1, r * h_own, h_own, group))
        q = q + bias("wq", r * h_own, h_own)

        def kv(name):
            if _model_dim(specs[name]) == 2:  # head_dim split: project it,
                y = all_gather(torch.einsum("bld,dhk->blhk", x, w[name]), 3,
                               group)[:, :, g_lo:g_hi]  # keep the heads read
            else:
                y = torch.einsum("bld,dhk->blhk", x, _rank_block(
                    w[name], specs[name], 1, g_lo, g_hi - g_lo, group))
            return y + bias(name, g_lo, g_hi - g_lo)

        k, v = kv("wk"), kv("wv")
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
        qg = q.reshape(b, -1, g_hi - g_lo, h_own // (g_hi - g_lo), hd)
        o = _attend(qg, k, v, positions, positions, q_chunk, x.dtype)
        wo = _rank_block(w["wo"], specs["wo"], 0, r * h_own, h_own, group)
        out = torch.einsum("bqhk,hkd->bqd", o.reshape(b, -1, h_own, hd), wo)
        return reduce_scatter(out, 1, group)

    rows = positions[r * l_own:(r + 1) * l_own]
    pos = rows[None, :]

    def proj(name):
        y = torch.einsum("bld,dhk->blhk", x,
                         _model_whole(w[name], specs[name], group))
        b_name = "b" + name[1]
        if b_name in w:
            y = y + _model_whole(w[b_name], specs[b_name], group)
        return y

    q = apply_rope(proj("wq"), pos, rope_theta)
    k = all_gather(apply_rope(proj("wk"), pos, rope_theta), 1, group)
    v = all_gather(proj("wv"), 1, group)
    qg = q.reshape(b, l_own, n_kv, n_rep, hd)
    # a chunk of q_chunk / N rows against every key: the score block of a
    # chunk of q_chunk queries against a rank's 1/N of the keys
    o = _attend(qg, k, v, rows, positions, q_chunk // msz, x.dtype)
    return torch.einsum("bqhk,hkd->bqd", o.reshape(b, l_own, n_heads, hd),
                        _model_whole(w["wo"], specs["wo"], group))


def attention_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, rope_theta: float = 10000.0):
    """One-token decode against a KV cache, written in place.

    x: [b, 1, d]; cache_k/v: [b, S, n_kv, hd]; pos: the current position
    (an int or a 0-d integer tensor on x's device). The new key and value
    are written into the caches at ``pos`` (the reference's
    ``dynamic_update_slice`` of a donated buffer) and keys ``<= pos``
    attend. Returns (out [b, 1, d], cache_k, cache_v): the same buffers.

    Under a mesh the caches are DTensors (``cache_shardings``) and the
    step splits over "model" as the cache does (``_decode_body``).
    """
    S = cache_k.shape[1]
    if not isinstance(pos, torch.Tensor) and not 0 <= pos < S:
        raise ValueError(f"decode position {pos} outside a cache of {S}")
    mesh = _device_mesh() or _tensor_mesh(cache_k, x, params["wq"])
    if mesh is not None:
        return _decode_on_mesh(mesh, params, x, cache_k, cache_v, pos,
                               rope_theta)
    b = x.shape[0]
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    positions = pos_t.reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(params, x, positions, rope_theta)
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
    return torch.einsum("bqhk,hkd->bqd", o, params["wo"]), cache_k, cache_v


def _spec_of(t: torch.Tensor, mesh):
    """The partition spec of a DTensor's placements on ``mesh``."""
    from torch.distributed.tensor import Shard
    dims = [[] for _ in range(t.ndim)]
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return P(*(tuple(a) if a else None for a in dims))


def _decode_on_mesh(mesh, params, x, cache_k, cache_v, pos, rope_theta):
    """``attention_decode`` on DTensor caches: a ``shard_map_compat`` of
    ``_decode_body`` over the caches' own layout (x's batch as theirs, the
    weights as ``_attn_specs``). The step reads ``pos`` on the card only."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(cache_k, DTensor) and isinstance(cache_v, DTensor)):
        raise TypeError("decode on a mesh takes DTensor caches "
                        "(distributed.sharding.cache_shardings)")
    c_spec = _spec_of(cache_k, mesh)
    if _spec_of(cache_v, mesh) != c_spec or _model_dim(c_spec) in (None, 0):
        raise ValueError(f"decode on a mesh: caches laid out {c_spec} and "
                         f"{_spec_of(cache_v, mesh)}; the step splits "
                         f"over a 'model' axis on S, kv heads or head_dim")
    specs = _attn_specs(params, mesh, c_spec[0])
    names = tuple(specs)
    x_spec = P(c_spec[0], None, None)
    body = functools.partial(_decode_body, names=names, specs=specs,
                             c_split=_model_dim(c_spec),
                             n_heads=params["wq"].shape[1],
                             rope_theta=rope_theta)
    sm = shard_map_compat(body, mesh, in_specs=(
        x_spec, c_spec, c_spec, P()) + tuple(specs[n] for n in names),
        out_specs=x_spec)
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=cache_k.device)
    with activate_mesh(mesh):
        return sm(x, cache_k, cache_v, pos_t, *(params[n] for n in names)), \
            cache_k, cache_v


def _decode_body(x, ck, cv, pos, *weights, names, specs, c_split: int,
                 n_heads: int, rope_theta: float):
    """One rank of a decode step on its block of the caches, ``c_split``
    the cache dim "model" splits (1: S, 2: kv heads, 3: head_dim). The
    rank projects x with its block of each weight (the rule's heads or
    head_dim) and all-gathers the one-token q, k and v over "model"; it
    writes k and v into the one position of its block that ``pos`` falls
    in (where ``pos`` is another rank's, it reads its own row there and
    writes it back: no pass over the block); then:

      * S: scores over its stripe of the cache; the softmax's row max and
        exp-sum all-reduced over "model" (flash-decoding, and what XLA's
        partitioner emits for a softmax over a split dim), the partial
        weighted sums all-reduced;
      * kv heads: attention of its kv heads' query groups, whole;
      * head_dim: partial scores all-reduced, a whole softmax, the
        rank's head_dim slice of the weighted sum;
    the result all-gathered whole, out-projected with the rank's block of
    ``wo`` and all-reduced. No gradient flows through the step."""
    w = {n: _fsdp_whole(t, specs[n]) for n, t in zip(names, weights)}
    group = axis_group("model")
    r = dist.get_rank(group)
    b = x.shape[0]

    def proj(name):
        y = torch.einsum("bld,dhk->blhk", x, w[name])
        split = _model_dim(specs[name])
        if split is not None:
            y = all_gather(y, split + 1, group)
        b_name = "b" + name[1]
        if b_name in w:
            y = y + _model_whole(w[b_name], specs[b_name], group)
        return y

    positions = pos.reshape(1, 1).expand(b, 1)
    q = apply_rope(proj("wq"), positions, rope_theta)
    k = apply_rope(proj("wk"), positions, rope_theta)
    v = proj("wv")
    n_kv, hd = k.shape[2], k.shape[3]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, 1, n_kv, n_heads // n_kv, hd)
    own = ck.shape[c_split]
    lo = r * own
    if c_split == 1:
        at = (pos - lo).clamp(0, own - 1).reshape(1)
        mine = (pos >= lo) & (pos < lo + own)
        for c, new in ((ck, k), (cv, v)):
            c.index_copy_(1, at, torch.where(mine, new.to(c.dtype),
                                             c.index_select(1, at)))
        s = torch.einsum("bqgrk,bsgk->bgrqs", qg, ck) * scale
        valid = torch.arange(lo, lo + own, device=pos.device) <= pos
        s = torch.where(valid, s.float(), -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
        e = torch.exp(s - m)
        z = e.sum(dim=-1, keepdim=True)
        dist.all_reduce(z, group=group)
        o = torch.einsum("bgrqs,bsgk->bqgrk", (e / z).to(x.dtype), cv)
        dist.all_reduce(o, group=group)
    else:
        at = pos.reshape(1)
        mine = [slice(None)] * 4
        mine[c_split] = slice(lo, lo + own)
        ck.index_copy_(1, at, k[tuple(mine)].to(ck.dtype))
        cv.index_copy_(1, at, v[tuple(mine)].to(cv.dtype))
        if c_split == 2:
            s = torch.einsum("bqgrk,bsgk->bgrqs", qg[:, :, lo:lo + own],
                             ck) * scale
        else:
            s = torch.einsum("bqgrk,bsgk->bgrqs", qg[..., lo:lo + own], ck)
            dist.all_reduce(s, group=group)
            s = s * scale
        valid = torch.arange(ck.shape[1], device=pos.device) <= pos
        s = torch.where(valid, s.float(), -math.inf)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        # o [b, 1, kv, rep, hd]: the rank's kv heads (dim 2) or head_dim
        # slice (dim 4)
        o = all_gather(torch.einsum("bgrqs,bsgk->bqgrk", a, cv),
                       2 if c_split == 2 else 4, group)
    o = o.reshape(b, 1, n_heads, hd)
    split = _model_dim(specs["wo"])
    if split is None:
        return torch.einsum("bqhk,hkd->bqd", o, w["wo"])
    own = w["wo"].shape[split]
    out = torch.einsum("bqhk,hkd->bqd", o.narrow(2 + split, r * own, own),
                       w["wo"])
    dist.all_reduce(out, group=group)
    return out


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
