"""SSM / recurrent blocks of the port: Mamba2 (SSD), mLSTM, sLSTM.

Plain torch functions on the reference's parameter names
(``repro.models.ssm``), op for op: the same einsums, float32 islands and
casts back to the compute dtype. Mamba2 is the SSD chunked-parallel form
(intra-chunk quadratic term + inter-chunk state recurrence) for
train/prefill and the O(1)-state recurrent form for decode; mLSTM has a
parallel (quadratic) form and a recurrent one; sLSTM is a strict per-step
recurrence.

Where the reference leans on XLA, the port takes the nearest eager form:
  * the inter-chunk recurrence, a ``lax.associative_scan`` over the
    ``nc = l / chunk`` chunks (log-depth, for a sharded chunk axis), is a
    sequential float32 loop over the chunks: the same affine recurrence,
    its products rounded in another order (the CPU twins hold it to the
    reference within float32 rounding, ``tests/test_torch_ssm.py``);
  * three-operand einsums are two contractions whose intermediate is at
    most the output's size times the chunk (never ``[b, nc, t, s, h, p]``);
  * sLSTM's ``lax.scan`` over time is a Python loop: one cell a token, so
    its launches grow with the sequence (host-bound on the card).
Masks are applied before ``exp`` (as the reference does): the masked
region becomes ``-inf`` and ``exp`` gives 0 there, so no ``inf`` meets a
zero in the backward pass.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.launch.mesh import (P, shard_map_compat,
                                     with_sharding_constraint)
from repro_torch.models.layers import (_folded, _normal, batch_split,
                                       init_rmsnorm, replicated, rmsnorm,
                                       silu)

Params = Mapping[str, Any]


def _pad_seq(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """``t`` zero-padded along dim 1, as a concatenation (the values of
    ``F.pad``; DTensors take it on any layout)."""
    def zeros(n):
        return t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))

    return torch.cat([zeros(before), t, zeros(after)], dim=1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _fill(shape, value: float, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


def init_mamba2(gen: Optional[torch.Generator], d_model: int, d_state: int,
                head_dim: int = 64, expand: int = 2, conv_width: int = 4,
                dtype=torch.bfloat16, *, device: torch.device,
                stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    n_groups = 1  # B/C shared across heads within a group (GVA-style)
    s = 1.0 / math.sqrt(d_model)
    conv_ch = d_inner + 2 * n_groups * d_state
    proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                     device=device))
    return {
        "in_proj": _normal(gen, stack + (d_model, proj), s, dtype, device),
        "conv_w": _normal(gen, stack + (conv_width, conv_ch),
                          1.0 / math.sqrt(conv_width), dtype, device),
        "conv_b": torch.zeros(stack + (conv_ch,), dtype=dtype, device=device),
        "A_log": a_log.expand(stack + (n_heads,)).clone(),
        "D": torch.ones(stack + (n_heads,), dtype=torch.float32,
                        device=device),
        "dt_bias": torch.zeros(stack + (n_heads,), dtype=torch.float32,
                               device=device),
        "norm": init_rmsnorm(d_inner, dtype, device, stack),
        "out_proj": _normal(gen, stack + (d_inner, d_model),
                            1.0 / math.sqrt(d_inner), dtype, device),
    }


def _mamba2_dims(params: Params):
    d_model, proj = params["in_proj"].shape[-2:]
    n_heads = params["A_log"].shape[-1]
    conv_ch = params["conv_b"].shape[-1]
    # proj = 2*d_inner + 2*g*d_state + n_heads ; conv_ch = d_inner + 2*g*d_state
    d_inner = proj - conv_ch - n_heads
    gd_state = (conv_ch - d_inner) // 2
    head_dim = d_inner // n_heads
    return d_inner, gd_state, n_heads, head_dim


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """Minimal SSD (Mamba2 alg.): x:[b,l,h,p], dt:[b,l,h], A:[h],
    B,C:[b,l,n], l a multiple of ``chunk``. Returns (y [b,l,h,p] float32,
    the final state [b,h,n,p])."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    # discretize
    dA = dt * A[None, None, :]  # [b,l,h] (negative)
    xb = (x * dt[..., None]).reshape(b, nc, chunk, h, p)
    dA = dA.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    xb = xb.float()

    cum = torch.cumsum(dA, dim=2)  # [b,nc,c,h]
    # intra-chunk: L[t,s] = exp(cum[t]-cum[s]) for s<=t; masked BEFORE exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,t,s,h]
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    Lmat = torch.exp(torch.where(tri, diff, -math.inf))
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    y_diag = torch.einsum("bctsh,bcshp->bcthp", scores[..., None] * Lmat, xb)

    # chunk states: S_c = sum_s exp(cum[last]-cum[s]) B_s x_s
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)  # [b,nc,c,h]
    states = torch.einsum("bcsn,bcshp->bchnp", Bc,
                          xb * decay_states[..., None])

    # inter-chunk recurrence S[c] = states[c] + dec[c] * S[c-1], in order
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b,nc,h]
    state = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(state)  # the state entering chunk c
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    prev_states = torch.stack(prev, dim=1)  # [b,nc,h,n,p]

    # inter-chunk output: y_off[t] = C_t . (exp(cum[t]) * prev_state)
    y_off = torch.einsum("bctn,bchnp->bcthp", Cc, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, state


def _ssd(xh, dt, A, B, C, chunk: int, batch_axes, head_axis):
    """``_ssd_chunked``'s output. On DTensors it runs per rank on the
    rank's block of (batch over ``batch_axes``, heads over ``head_axis``),
    where every head and sequence is independent (``shard_map_compat``):
    its einsums fold (batch, chunk, head) into one dim, which DTensor
    cannot do with the heads split."""
    from torch.distributed.tensor import DTensor
    if not isinstance(xh, DTensor):
        return _ssd_chunked(xh, dt, A, B, C, chunk)[0]
    sm = shard_map_compat(
        lambda *a: _ssd_chunked(*a, chunk)[0], xh.device_mesh,
        in_specs=(P(batch_axes, None, head_axis, None),
                  P(batch_axes, None, head_axis), P(head_axis),
                  P(batch_axes, None, None), P(batch_axes, None, None)),
        out_specs=P(batch_axes, None, head_axis, None))
    return sm(xh, dt, A, B, C)


def mamba2(params: Params, x: torch.Tensor, chunk: int = 64,
           batch_axes=None, head_axis=None) -> torch.Tensor:
    """Mamba2 block forward (train/prefill). x: [b,l,d]. Returns [b,l,d].

    ``head_axis`` lays the SSD head dim of ``dt`` and ``xh`` (and so the
    chunked SSD's intermediates) out over that mesh axis, the batch over
    ``batch_axes`` (``launch.mesh.with_sharding_constraint``: DTensors are
    redistributed, plain tensors pass as they are)."""
    x = batch_split(x)
    b, l, d = x.shape
    d_inner, d_state, n_heads, head_dim = _mamba2_dims(params)
    proj = torch.einsum("bld,dp->blp", x, params["in_proj"])
    z, xc, B, C, dt_pre = torch.split(
        proj, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)
    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([xc, B, C], dim=-1)
    w = params["conv_w"]
    cw = w.shape[0]
    pad = _pad_seq(xbc, cw - 1, 0)
    conv = sum(pad[:, i:i + l, :] * w[i][None, None, :] for i in range(cw))
    xbc = silu(conv + params["conv_b"])
    xc, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = _softplus(dt_pre.float() + params["dt_bias"])  # [b,l,h]
    A = -torch.exp(params["A_log"])  # [h] negative
    xh = xc.reshape(b, l, n_heads, head_dim)
    if head_axis is not None:
        dt = with_sharding_constraint(dt, P(batch_axes, None, head_axis))
        xh = with_sharding_constraint(
            xh, P(batch_axes, None, head_axis, None))
    pad_len = (-l) % chunk
    if pad_len:
        xh, dt, B, C = (_pad_seq(t, 0, pad_len) for t in (xh, dt, B, C))
    y = _ssd(xh, dt, A, B, C, chunk, batch_axes, head_axis)
    y = y[:, :l]
    y = y + xc.reshape(b, l, n_heads, head_dim).float() \
        * params["D"][None, None, :, None]
    y = _folded(y, 2, 3).to(x.dtype)
    y = rmsnorm(params["norm"], y) * silu(z)
    return batch_split(torch.einsum("bli,id->bld", y, params["out_proj"]))


def mamba2_init_state(params: Params, batch: int,
                      device: Optional[torch.device] = None
                      ) -> Dict[str, torch.Tensor]:
    """The recurrent state: ``ssm`` float32, the conv window bfloat16
    whatever the model's dtype (as the reference has it)."""
    d_inner, d_state, n_heads, head_dim = _mamba2_dims(params)
    cw = params["conv_w"].shape[-2]
    conv_ch = params["conv_b"].shape[-1]
    device = params["in_proj"].device if device is None else device
    return {
        "ssm": torch.zeros(batch, n_heads, d_state, head_dim,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cw - 1, conv_ch, dtype=torch.bfloat16,
                            device=device),
    }


def mamba2_decode(params: Params, x: torch.Tensor,
                  state: Mapping[str, torch.Tensor]):
    """Single-token recurrent step. x: [b,1,d]. Returns (y [b,1,d], the
    new state: ``conv`` in the given state's dtype)."""
    b = x.shape[0]
    d_inner, d_state, n_heads, head_dim = _mamba2_dims(params)
    proj = torch.einsum("bld,dp->blp", x, params["in_proj"])[:, 0]
    z, xc, B, C, dt_pre = torch.split(
        proj, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)
    xbc = torch.cat([xc, B, C], dim=-1)  # [b, conv_ch]
    window = torch.cat([state["conv"].to(xbc.dtype), xbc[:, None, :]],
                       dim=1)  # [b,cw,ch]
    w = params["conv_w"]
    conv = torch.einsum("bcw,cw->bw", window.float(), w.float())
    xbc_c = silu(conv + params["conv_b"].float())
    xc, B, C = torch.split(xbc_c, [d_inner, d_state, d_state], dim=-1)
    dt = _softplus(dt_pre.float() + params["dt_bias"])  # [b,h]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])  # [b,h]
    xh = xc.reshape(b, n_heads, head_dim)
    dBx = torch.einsum("bn,bhp->bhnp", B, xh * dt[..., None])
    ssm = state["ssm"] * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", C, ssm)
    y = y + xh * params["D"][None, :, None]
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y) * silu(z)
    out = torch.einsum("bi,id->bd", y, params["out_proj"])[:, None, :]
    new_state = {"ssm": ssm,
                 "conv": window[:, 1:, :].to(state["conv"].dtype)}
    return out, new_state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory): parallel form for train, recurrent for decode
# ---------------------------------------------------------------------------


def init_mlstm(gen: Optional[torch.Generator], d_model: int, n_heads: int,
               proj_factor: float = 2.0, dtype=torch.bfloat16, *,
               device: torch.device,
               stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
    d_inner = int(d_model * proj_factor)
    s = 1.0 / math.sqrt(d_model)
    si = 1.0 / math.sqrt(d_inner)
    b_if = torch.cat([torch.zeros(n_heads), torch.full((n_heads,), 3.0)]
                     ).to(device)
    return {
        "up_proj": _normal(gen, stack + (d_model, 2 * d_inner), s, dtype,
                           device),
        "wq": _normal(gen, stack + (d_inner, d_inner), si, dtype, device),
        "wk": _normal(gen, stack + (d_inner, d_inner), si, dtype, device),
        "wv": _normal(gen, stack + (d_inner, d_inner), si, dtype, device),
        "w_if": _normal(gen, stack + (d_inner, 2 * n_heads), si,
                        torch.float32, device),
        "b_if": b_if.expand(stack + (2 * n_heads,)).clone(),
        "norm": init_rmsnorm(d_inner, dtype, device, stack),
        "down_proj": _normal(gen, stack + (d_inner, d_model), si, dtype,
                             device),
    }


def mlstm(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Parallel (quadratic) mLSTM forward. x: [b,l,d] -> [b,l,d]."""
    x = batch_split(x)
    b, l, d = x.shape
    n_heads = params["b_if"].shape[-1] // 2
    up = torch.einsum("bld,di->bli", x, params["up_proj"])
    h_in, z = torch.chunk(up, 2, dim=-1)
    d_inner = h_in.shape[-1]
    head_dim = d_inner // n_heads
    # on DTensors each projection is gathered to the batch layout before
    # its heads are split off: a split (heads, head_dim) dim unfolds only
    # where the heads divide the model axis
    q = batch_split(torch.einsum("bli,ij->blj", h_in, params["wq"])
                    ).reshape(b, l, n_heads, head_dim)
    k = batch_split(torch.einsum("bli,ij->blj", h_in, params["wk"])
                    ).reshape(b, l, n_heads, head_dim)
    v = batch_split(torch.einsum("bli,ij->blj", h_in, params["wv"])
                    ).reshape(b, l, n_heads, head_dim)
    gates = torch.einsum("bli,ig->blg", h_in.float(), params["w_if"]) \
        + params["b_if"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)  # [b,l,h]
    log_f = -_softplus(-f_pre)  # log sigmoid(f)
    cum_f = torch.cumsum(log_f, dim=1)  # [b,l,h]
    # D[t,s] = F[t] - F[s] + i[s], s <= t; masked BEFORE exp
    Dm = cum_f[:, :, None, :] - cum_f[:, None, :, :] + i_pre[:, None, :, :]
    tri = replicated(torch.ones(l, l, dtype=torch.bool,
                                device=x.device).tril(), x)
    Dm = torch.where(tri[None, :, :, None], Dm, -math.inf)
    m = torch.amax(Dm, dim=2, keepdim=True)  # stabilizer [b,l,1,h]
    Dexp = torch.exp(Dm - m)
    scores = torch.einsum("blhk,bshk->blsh", q.float(), k.float()) \
        / math.sqrt(head_dim)
    S = scores * Dexp
    norm = torch.maximum(torch.abs(torch.sum(S, dim=2, keepdim=True)),
                         torch.exp(-m))  # [b,l,1,h]
    y = torch.einsum("blsh,bshk->blhk", S / norm, v.float())
    y = _folded(y, 2, 3).to(x.dtype)
    y = rmsnorm(params["norm"], y) * silu(z)
    return batch_split(torch.einsum("bli,id->bld", y, params["down_proj"]))


def mlstm_init_state(params: Params, batch: int, d_model: int,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    n_heads = params["b_if"].shape[-1] // 2
    d_inner = params["down_proj"].shape[-2]
    head_dim = d_inner // n_heads
    device = params["down_proj"].device if device is None else device
    f32 = torch.float32
    return {
        "C": torch.zeros(batch, n_heads, head_dim, head_dim, dtype=f32,
                         device=device),
        "nvec": torch.zeros(batch, n_heads, head_dim, dtype=f32,
                            device=device),
        "m": _fill((batch, n_heads), -math.inf, f32, device),
    }


def mlstm_decode(params: Params, x: torch.Tensor,
                 state: Mapping[str, torch.Tensor]):
    """Recurrent mLSTM step (stabilized). x: [b,1,d]."""
    b = x.shape[0]
    n_heads = params["b_if"].shape[-1] // 2
    up = torch.einsum("bld,di->bli", x, params["up_proj"])[:, 0]
    h_in, z = torch.chunk(up, 2, dim=-1)
    d_inner = h_in.shape[-1]
    head_dim = d_inner // n_heads
    q = (h_in @ params["wq"]).reshape(b, n_heads, head_dim).float()
    k = (h_in @ params["wk"]).reshape(b, n_heads, head_dim).float()
    v = (h_in @ params["wv"]).reshape(b, n_heads, head_dim).float()
    gates = h_in.float() @ params["w_if"] + params["b_if"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)  # [b,h]
    log_f = -_softplus(-f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    i_sc = torch.exp(i_pre - m_new)
    ks = k / math.sqrt(head_dim)
    C = state["C"] * f_sc[:, :, None, None] + \
        i_sc[:, :, None, None] * torch.einsum("bhk,bhv->bhkv", ks, v)
    nvec = state["nvec"] * f_sc[:, :, None] + i_sc[:, :, None] * ks
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, nvec)),
                        torch.exp(-m_new))
    y = (num / den[:, :, None]).reshape(b, d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y) * silu(z)
    out = torch.einsum("bi,id->bd", y, params["down_proj"])[:, None, :]
    return out, {"C": C, "nvec": nvec, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, strict recurrence)
# ---------------------------------------------------------------------------


def init_slstm(gen: Optional[torch.Generator], d_model: int, n_heads: int,
               dtype=torch.bfloat16, *, device: torch.device,
               stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
    s = 1.0 / math.sqrt(d_model)
    d_up = 4 * d_model // 3
    bias = torch.zeros(4 * d_model, dtype=torch.float32, device=device)
    bias[2 * d_model:3 * d_model] = 1.0
    return {
        # fused input->gates projection: z, i, f, o
        "w_x": _normal(gen, stack + (d_model, 4 * d_model), s, dtype, device),
        "w_h": _normal(gen, stack + (d_model, 4 * d_model), s, dtype, device),
        "b": bias.expand(stack + (4 * d_model,)).clone(),
        "norm": init_rmsnorm(d_model, dtype, device, stack),
        # post-block gated MLP (xLSTM pf=4/3)
        "w_up": _normal(gen, stack + (d_model, 2 * d_up), s, dtype, device),
        "w_down": _normal(gen, stack + (d_up, d_model),
                          1.0 / math.sqrt(d_up), dtype, device),
    }


def slstm_init_state(params: Params, batch: int, d_model: int,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    device = params["w_x"].device if device is None else device
    z = torch.zeros(batch, d_model, dtype=torch.float32, device=device)
    return {"c": z, "nvec": z, "h": z,
            "m": _fill((batch, d_model), -math.inf, torch.float32, device)}


def _slstm_cell(params: Params, state: Mapping[str, torch.Tensor],
                xw: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One sLSTM step with exponential-gate stabilization. xw: [b, 4d]."""
    pre = xw + state["h"].to(xw.dtype) @ params["w_h"].to(xw.dtype)
    pre = pre.float() + params["b"]
    zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
    log_f = -_softplus(-ft)  # sigmoid forget in log space
    m_new = torch.maximum(log_f + state["m"], it)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    i_sc = torch.exp(it - m_new)
    c = f_sc * state["c"] + i_sc * torch.tanh(zt)
    nvec = f_sc * state["nvec"] + i_sc
    h = torch.sigmoid(ot) * c / torch.clamp(nvec, min=1e-6)
    return {"c": c, "nvec": nvec, "h": h, "m": m_new}


def _slstm_out(params: Params, h: torch.Tensor, dtype) -> torch.Tensor:
    y = rmsnorm(params["norm"], h.to(dtype))
    u, g = torch.chunk(torch.einsum("bld,di->bli", y, params["w_up"]), 2,
                       dim=-1)
    return torch.einsum("bli,id->bld", u * silu(g), params["w_down"])


def slstm(params: Params, x: torch.Tensor) -> torch.Tensor:
    """sLSTM over a sequence, one cell a step. x: [b,l,d] -> [b,l,d]."""
    x = batch_split(x)
    b, l, d = x.shape
    xw = torch.einsum("bld,dg->blg", x, params["w_x"])  # [b,l,4d]
    state = {k: replicated(v, x) for k, v in
             slstm_init_state(params, b, d, x.device).items()}
    hs = []
    for t in range(l):
        state = _slstm_cell(params, state, xw[:, t])
        hs.append(state["h"])
    return batch_split(_slstm_out(params, torch.stack(hs, dim=1), x.dtype))


def slstm_decode(params: Params, x: torch.Tensor,
                 state: Mapping[str, torch.Tensor]):
    xw = torch.einsum("bld,dg->blg", x, params["w_x"])[:, 0]
    st2 = _slstm_cell(params, state, xw)
    return _slstm_out(params, st2["h"][:, None, :], x.dtype), st2
