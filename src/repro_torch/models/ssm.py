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
    its launches grow with the sequence (host-bound on the card). Under a
    ``launch.hlo_cost.Trace`` on the meta device (the dry run) one step
    is traced and counted once a token (``_CountedScan``), as the
    reference's cost model counts its scan's body times the trip count.
Masks are applied before ``exp`` (as the reference does): the masked
region becomes ``-inf`` and ``exp`` gives 0 there, so no ``inf`` meets a
zero in the backward pass.

Under a mesh (an ambient ``DeviceMesh``, or DTensor arguments) each layer
runs one rank's share of the work, a ``shard_map_compat`` body a rank as
``models.layers``' attention does: the weights enter as their sharding
rule's blocks and are all-gathered inside over their FSDP axes (their
gradients reduce-scattered back), the activations in the residual
stream's layout (batch over ``batch_axes``, the sequence over "model"):
  * ``mamba2``: the rank's rows (its chunks), the conv's halo of
    ``cw - 1`` rows all-gathered from the rank before it, the state
    entering its first chunk composed from every rank's (product of chunk
    decays, final state) all-gathered; with ``head_axis`` the reference's
    split of the SSD by heads instead (the batch-layout path);
  * ``mlstm``: the rank's query rows against k, v and the gates
    all-gathered along the sequence;
  * ``slstm``: the rank's slice of the state's d, h all-gathered each
    step, the hidden states exchanged to the rank's rows (all-to-all)
    for the norm and the MLP;
  * the decodes: on the state as ``distributed.sharding.cache_shardings``
    lays it out, each rank updating its own block in place (Mamba2: its
    heads and conv channels; mLSTM: its heads or key rows of ``C``;
    sLSTM: its d-slice); the one-token vectors are all-gathered and the
    partial products all-reduced, the state never.
Without a mesh every path is the one-device one, op for op.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import (P, activate_mesh, all_gather,
                                     all_to_all, axis_group, axis_sizes,
                                     shard_map_compat,
                                     with_sharding_constraint)
from repro_torch.models import layers as L
from repro_torch.models.layers import (_folded, _normal, batch_split,
                                       init_rmsnorm, rmsnorm, silu)

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
# One rank's share on a mesh: the plumbing every layer's body shares
# ---------------------------------------------------------------------------


def _mesh_of(*ts):
    """The ambient ``DeviceMesh``, else the first DTensor's, else None."""
    return L._device_mesh() or L._tensor_mesh(*ts)


def _leaves(params: Params, names) -> Dict[str, torch.Tensor]:
    """The layer's weights by name, the norm's scale as ``norm``."""
    return {n: params[n]["scale"] if n == "norm" else params[n]
            for n in names}


def _params_of(w: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``_leaves``' inverse: the layer's parameter mapping."""
    return dict(w, norm={"scale": w["norm"]})


def _whole(t: torch.Tensor, spec, group) -> torch.Tensor:
    """A weight's block all-gathered over its FSDP axes and "model"."""
    return L._model_whole(L._fsdp_whole(t, spec), spec, group)


def _rank():
    group = axis_group("model")
    return group, dist.get_world_size(group), dist.get_rank(group)


def _run_body(mesh, kind: str, params: Params, names, keep, body,
              args, arg_specs, out_spec, **kw):
    """``body(*args, *weights, names=, specs=, **kw)`` as a
    ``shard_map_compat`` over ``mesh``: ``args`` laid out by
    ``arg_specs``, the layer's weights (``names``) by their sharding rules
    (``layers._rule_specs``, ``keep`` the axes the batch splits over), the
    output by ``out_spec``. Plain arguments are the global values."""
    w = _leaves(params, names)
    specs = L._rule_specs(kind, w, names, mesh, keep)
    sm = shard_map_compat(
        functools.partial(body, names=names, specs=specs, **kw), mesh,
        in_specs=tuple(arg_specs) + tuple(specs[n] for n in names),
        out_specs=out_spec)
    with activate_mesh(mesh):
        return sm(*args, *(w[n] for n in names))


def _seq_split(mesh, x: torch.Tensor, what: str) -> int:
    """The rows of the sequence a "model" rank holds; raises where the
    axis does not divide it."""
    msz = axis_sizes(mesh).get("model")
    l = x.shape[1]
    if msz is None or l % msz:
        raise ValueError(f"{what} on a mesh of axes {axis_sizes(mesh)}: a "
                         f"sequence of {l} does not split over its 'model' "
                         f"axis")
    return l // msz


def _decode_on_mesh(mesh, kind: str, params: Params, names, x, state,
                    splits: Mapping[str, Tuple], body, **kw):
    """A decode step on DTensor state leaves as ``_run_body`` of ``body``
    over the state's own layout (x's batch as the state's; ``splits``: the
    dims of each leaf after the batch that "model" may split, None for
    none). Raises on any other layout: the state is never gathered."""
    from torch.distributed.tensor import DTensor
    if not all(isinstance(t, DTensor) for t in state.values()):
        raise TypeError(f"{kind} decode on a mesh takes DTensor state "
                        f"(distributed.sharding.cache_shardings)")
    keys = tuple(splits)  # the body's order
    specs = {k: L._spec_of(state[k], mesh) for k in keys}
    batch = specs[keys[0]][0]
    split = {k: L._model_dim(specs[k]) for k in keys}
    bad = [k for k in keys if specs[k][0] != batch
           or split[k] not in splits[k]]
    if bad:
        raise ValueError(f"{kind} decode on a mesh: state laid out "
                         f"{specs}; the step splits {dict(splits)} over "
                         f"'model' (None: whole) and the batch alike")
    x_spec = P(batch, None, None)
    return _run_body(mesh, kind, params, names, batch, body,
                     (x,) + tuple(state[k] for k in keys),
                     (x_spec,) + tuple(specs[k] for k in keys), x_spec,
                     split=split, **kw)


def _product(prod: Callable, x: torch.Tensor, w: torch.Tensor, spec,
             group, r: int) -> torch.Tensor:
    """``prod(x, w)`` (a product over x's last dim and w's first) with
    ``w`` the rank's block of a weight split over "model" on its last dim
    (the rank's columns of the product, all-gathered), on its first (x's
    slice of the contraction, the partial products all-reduced) or not
    at all. No gradient passes the all-reduce: decode only."""
    split = L._model_dim(spec)
    if split is None:
        return prod(x, w)
    if split == 0:
        own = w.shape[0]
        out = prod(x.narrow(-1, r * own, own), w)
        dist.all_reduce(out, group=group)
        return out
    out = prod(x, w)
    return all_gather(out, out.ndim - 1, group)


def _own(t: torch.Tensor, dim: Optional[int], r: int):
    """The index of the rank's block ``t`` (a state leaf's, [b, ...]) in
    the whole leaf's dims after the batch: block ``r`` of ``dim``."""
    return (slice(None),) + tuple(
        slice(r * n, (r + 1) * n) if d == dim else slice(None)
        for d, n in enumerate(t.shape) if d > 0)


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


_MAMBA = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
          "out_proj")


def _mamba2_dims(params: Params):
    d_model, proj = params["in_proj"].shape[-2:]
    n_heads = params["A_log"].shape[-1]
    conv_ch = params["conv_b"].shape[-1]
    # proj = 2*d_inner + 2*g*d_state + n_heads ; conv_ch = d_inner + 2*g*d_state
    d_inner = proj - conv_ch - n_heads
    gd_state = (conv_ch - d_inner) // 2
    head_dim = d_inner // n_heads
    return d_inner, gd_state, n_heads, head_dim


def _ssd_chunks(x, dt, A, B, C, chunk: int):
    """The chunk-local half of the SSD (Mamba2 alg.): x:[b,l,h,p],
    dt:[b,l,h], A:[h], B,C:[b,l,n], l a multiple of ``chunk``. Returns
    (y_diag [b,nc,c,h,p], each chunk's own state [b,nc,h,n,p], its decay
    [b,nc,h], the in-chunk cumulative decay cum [b,nc,c,h], C [b,nc,c,n]),
    all float32."""
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
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b,nc,h]
    return y_diag, states, chunk_decay, cum, Cc


def _ssd_scan(states, chunk_decay, state):
    """The inter-chunk recurrence S[c] = states[c] + dec[c] * S[c-1] from
    ``state``, in order. Returns (the state entering each chunk
    [b,nc,h,n,p], the last state)."""
    prev = []
    for c in range(states.shape[1]):
        prev.append(state)  # the state entering chunk c
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    return torch.stack(prev, dim=1), state


def _ssd_join(y_diag, Cc, prev_states, cum):
    """y = y_diag + the inter-chunk output y_off[t] = C_t . (exp(cum[t]) *
    prev_state), [b,nc,c,h,p]."""
    y_off = torch.einsum("bctn,bchnp->bcthp", Cc, prev_states) \
        * torch.exp(cum)[..., None]
    return y_diag + y_off


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """Minimal SSD (Mamba2 alg.) over the whole sequence. Returns (y
    [b,l,h,p] float32, the final state [b,h,n,p])."""
    b, l, h, p = x.shape
    y_diag, states, chunk_decay, cum, Cc = _ssd_chunks(x, dt, A, B, C, chunk)
    prev_states, state = _ssd_scan(states, chunk_decay,
                                   torch.zeros_like(states[:, 0]))
    return _ssd_join(y_diag, Cc, prev_states, cum).reshape(b, l, h, p), state


def _ssd_rank(x, dt, A, B, C, chunk: int, group, r: int):
    """``_ssd_chunked``'s y on the rank's block of the sequence, the ranks
    of ``group`` holding consecutive blocks. The state entering its first
    chunk is composed from every rank's (product of chunk decays, final
    state from zero), all-gathered, in the order of the reference's
    ``associative_scan`` combine ((d1, s1), (d2, s2)) -> (d1 d2, s2 + d2
    s1); the rank's recurrence then starts from it."""
    b, l, h, p = x.shape
    y_diag, states, chunk_decay, cum, Cc = _ssd_chunks(x, dt, A, B, C, chunk)
    zero = torch.zeros_like(states[:, 0])
    _, own = _ssd_scan(states, chunk_decay, zero)
    decays = all_gather(torch.prod(chunk_decay, dim=1)[None], 0, group)
    finals = all_gather(own[None], 0, group)
    carries = [zero]
    for j in range(decays.shape[0] - 1):
        carries.append(finals[j] + decays[j][:, :, None, None] * carries[-1])
    # every rank's graph holds the gathered blocks (rank 0's too), so each
    # takes part in their gradient's reduce-scatter
    prev_states, _ = _ssd_scan(states, chunk_decay, torch.stack(carries)[r])
    return _ssd_join(y_diag, Cc, prev_states, cum).reshape(b, l, h, p)


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


def _mamba2_in(params: Params, x: torch.Tensor, halo=None):
    """The block's input half on the rows of ``x``: the in-projection, the
    causal depthwise conv over (x, B, C) and the step sizes. ``halo(xbc)``
    gives the ``cw - 1`` rows before them (zeros where None). Returns (z,
    xc, B, C, dt float32, A)."""
    l = x.shape[1]
    d_inner, d_state, n_heads, head_dim = _mamba2_dims(params)
    proj = torch.einsum("bld,dp->blp", x, params["in_proj"])
    z, xc, B, C, dt_pre = torch.split(
        proj, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)
    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([xc, B, C], dim=-1)
    w = params["conv_w"]
    cw = w.shape[0]
    pad = _pad_seq(xbc, cw - 1, 0) if halo is None else \
        torch.cat([halo(xbc), xbc], dim=1)
    conv = sum(pad[:, i:i + l, :] * w[i][None, None, :] for i in range(cw))
    xbc = silu(conv + params["conv_b"])
    xc, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = _softplus(dt_pre.float() + params["dt_bias"])  # [b,l,h]
    A = -torch.exp(params["A_log"])  # [h] negative
    return z, xc, B, C, dt, A


def _mamba2_out(params: Params, y, xc, z, dtype) -> torch.Tensor:
    """The block's output half: the skip term, the gated norm and the
    out-projection of y [b,l,h,p] float32."""
    b, l, h, p = y.shape
    y = y + xc.reshape(b, l, h, p).float() * params["D"][None, None, :, None]
    y = _folded(y, 2, 3).to(dtype)
    y = rmsnorm(params["norm"], y) * silu(z)
    return torch.einsum("bli,id->bld", y, params["out_proj"])


def mamba2(params: Params, x: torch.Tensor, chunk: int = 64,
           batch_axes=None, head_axis=None) -> torch.Tensor:
    """Mamba2 block forward (train/prefill). x: [b,l,d]. Returns [b,l,d].

    ``head_axis`` lays the SSD head dim of ``dt`` and ``xh`` (and so the
    chunked SSD's intermediates) out over that mesh axis, the batch over
    ``batch_axes`` (``launch.mesh.with_sharding_constraint``: DTensors are
    redistributed, plain tensors pass as they are). Without it, under a
    mesh, each "model" rank runs its own rows (``_mamba2_body``), which
    must be a multiple of ``chunk``."""
    if head_axis is None:
        mesh = _mesh_of(x, params["in_proj"])
        if mesh is not None:
            return _mamba2_on_mesh(mesh, params, x, chunk, batch_axes)
    x = batch_split(x)
    b, l, d = x.shape
    d_inner, d_state, n_heads, head_dim = _mamba2_dims(params)
    z, xc, B, C, dt, A = _mamba2_in(params, x)
    xh = xc.reshape(b, l, n_heads, head_dim)
    if head_axis is not None:
        dt = with_sharding_constraint(dt, P(batch_axes, None, head_axis))
        xh = with_sharding_constraint(
            xh, P(batch_axes, None, head_axis, None))
    pad_len = (-l) % chunk
    if pad_len:
        xh, dt, B, C = (_pad_seq(t, 0, pad_len) for t in (xh, dt, B, C))
    y = _ssd(xh, dt, A, B, C, chunk, batch_axes, head_axis)
    return batch_split(_mamba2_out(params, y[:, :l], xc, z, x.dtype))


def _mamba2_on_mesh(mesh, params, x, chunk, batch_axes):
    l_own = _seq_split(mesh, x, "mamba2")
    cw = params["conv_w"].shape[-2]
    if l_own % chunk or l_own < cw - 1:
        raise ValueError(f"mamba2 on a mesh: a rank's {l_own} rows are not "
                         f"a multiple of the SSD chunk {chunk}")
    x_spec = P(batch_axes, "model", None)
    return _run_body(mesh, "mamba", params, _MAMBA, batch_axes,
                     _mamba2_body, (x,), (x_spec,), x_spec, chunk=chunk)


def _mamba2_body(x, *weights, names, specs, chunk: int):
    """One rank of ``mamba2`` on its rows ``x`` [b_l, l / N, d] of the
    sequence: the in-projection, the conv (its halo, the ``cw - 1`` rows
    before the block, is the previous rank's last rows, all-gathered;
    rank 0's are zeros), the SSD of its chunks (``_ssd_rank``) and the
    out-projection of its own rows, with no reduction."""
    group, _, r = _rank()
    p = _params_of({n: _whole(t, specs[n], group)
                    for n, t in zip(names, weights)})
    b, l, _ = x.shape
    d_inner, d_state, n_heads, head_dim = _mamba2_dims(p)
    cw = p["conv_w"].shape[0]

    def halo(xbc):
        tails = all_gather(xbc[:, l - (cw - 1):], 1, group)
        return _pad_seq(tails, cw - 1, 0)[:, r * (cw - 1):(r + 1) * (cw - 1)]

    z, xc, B, C, dt, A = _mamba2_in(p, x, halo)
    xh = xc.reshape(b, l, n_heads, head_dim)
    y = _ssd_rank(xh, dt, A, B, C, chunk, group, r)
    return _mamba2_out(p, y, xc, z, x.dtype)


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
    new state: ``conv`` in the given state's dtype). On a mesh the state
    is DTensors laid out by ``cache_shardings`` (``ssm``'s heads and
    ``conv``'s channels over "model"), updated in place and returned."""
    mesh = _mesh_of(state["ssm"], x, params["in_proj"])
    if mesh is not None:
        return _decode_on_mesh(
            mesh, "mamba", params, _MAMBA, x, state,
            {"ssm": (1,), "conv": (2,)}, _mamba2_decode_body), state
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


def _mamba2_decode_body(x, ssm, conv, *weights, names, specs, split):
    """One rank of a Mamba2 decode step on its blocks of the state (``ssm``
    [b_l, h / N, n, p], ``conv`` [b_l, cw - 1, conv_ch / N]): the token
    projected with the rank's columns of ``in_proj`` and all-gathered; the
    rank's channels convolved and the conv's output all-gathered; the
    rank's heads of the SSM updated; both blocks written in place; y of
    its heads all-gathered for the norm over d_inner; ``out_proj``'s
    partial products all-reduced."""
    group, msz, r = _rank()
    w = {n: L._fsdp_whole(t, specs[n]) for n, t in zip(names, weights)}
    b = x.shape[0]
    n_heads = w["A_log"].shape[-1]
    proj = _product(functools.partial(torch.einsum, "bld,dp->blp"), x,
                    w["in_proj"], specs["in_proj"], group, r)[:, 0]
    conv_ch = conv.shape[-1] * msz
    d_inner = proj.shape[-1] - conv_ch - n_heads
    d_state = (conv_ch - d_inner) // 2
    head_dim = d_inner // n_heads
    z, xc, B, C, dt_pre = torch.split(
        proj, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)
    xbc = torch.cat([xc, B, C], dim=-1)[:, None, _own(conv, 2, r)[2]]
    window = torch.cat([conv.to(xbc.dtype), xbc], dim=1)  # [b,cw,ch/N]
    cv = torch.einsum("bcw,cw->bw", window.float(),
                      L._rank_block(w["conv_w"], specs["conv_w"], 1,
                                    r * conv.shape[-1], conv.shape[-1],
                                    group).float())
    conv_b = L._rank_block(w["conv_b"], specs["conv_b"], 0,
                           r * conv.shape[-1], conv.shape[-1], group)
    xbc_c = all_gather(silu(cv + conv_b.float()), 1, group)
    conv.copy_(window[:, 1:, :].to(conv.dtype))
    xc, B, C = torch.split(xbc_c, [d_inner, d_state, d_state], dim=-1)
    dt = _softplus(dt_pre.float() + w["dt_bias"])  # [b,h]
    A = -torch.exp(w["A_log"])
    dA = torch.exp(dt * A[None, :])  # [b,h]
    heads = _own(ssm, 1, r)[1]
    xh = xc.reshape(b, n_heads, head_dim)
    dBx = torch.einsum("bn,bhp->bhnp", B, (xh * dt[..., None])[:, heads])
    new = ssm * dA[:, heads, None, None] + dBx
    ssm.copy_(new)
    y = torch.einsum("bn,bhnp->bhp", C, new)
    y = y + xh[:, heads] * w["D"][None, heads, None]
    y = all_gather(y, 1, group).reshape(b, d_inner).to(x.dtype)
    y = rmsnorm({"scale": w["norm"]}, y) * silu(z)
    return _product(functools.partial(torch.einsum, "bi,id->bd"), y,
                    w["out_proj"], specs["out_proj"], group, r)[:, None, :]


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


_MLSTM = ("up_proj", "wq", "wk", "wv", "w_if", "b_if", "norm", "down_proj")


def _mlstm_mix(q, k, v, i_pre, cum_q, cum_k, tri, head_dim: int):
    """The parallel form's mixing: queries ``q`` [b,lq,h,k] at cumulative
    log-forget ``cum_q`` [b,lq,h] against keys and values [b,l,h,k] with
    input gates ``i_pre`` and ``cum_k`` [b,l,h]; ``tri`` [lq, l] the
    causal mask. Returns [b,lq,h,k] float32."""
    # D[t,s] = F[t] - F[s] + i[s], s <= t; masked BEFORE exp
    Dm = cum_q[:, :, None, :] - cum_k[:, None, :, :] + i_pre[:, None, :, :]
    Dm = torch.where(tri[None, :, :, None], Dm, -math.inf)
    m = torch.amax(Dm, dim=2, keepdim=True)  # stabilizer [b,l,1,h]
    Dexp = torch.exp(Dm - m)
    del Dm  # each [b,lq,l,h] block freed once used: a prefill's largest
    S = torch.einsum("blhk,bshk->blsh", q.float(), k.float()) \
        / math.sqrt(head_dim)
    S = S * Dexp
    del Dexp
    norm = torch.maximum(torch.abs(torch.sum(S, dim=2, keepdim=True)),
                         torch.exp(-m))  # [b,l,1,h]
    return torch.einsum("blsh,bshk->blhk", S / norm, v.float())


def _mlstm_out(params: Params, y, z, dtype) -> torch.Tensor:
    y = _folded(y, 2, 3).to(dtype)
    y = rmsnorm(params["norm"], y) * silu(z)
    return torch.einsum("bli,id->bld", y, params["down_proj"])


def mlstm(params: Params, x: torch.Tensor, batch_axes=None) -> torch.Tensor:
    """Parallel (quadratic) mLSTM forward. x: [b,l,d] -> [b,l,d]. Under a
    mesh each "model" rank mixes its own query rows (``_mlstm_body``),
    the batch over ``batch_axes``."""
    mesh = _mesh_of(x, params["up_proj"])
    if mesh is not None:
        _seq_split(mesh, x, "mlstm")
        x_spec = P(batch_axes, "model", None)
        return _run_body(mesh, "mlstm", params, _MLSTM, batch_axes,
                         _mlstm_body, (x,), (x_spec,), x_spec,
                         n_heads=params["b_if"].shape[-1] // 2)
    b, l, d = x.shape
    n_heads = params["b_if"].shape[-1] // 2
    up = torch.einsum("bld,di->bli", x, params["up_proj"])
    h_in, z = torch.chunk(up, 2, dim=-1)
    d_inner = h_in.shape[-1]
    head_dim = d_inner // n_heads
    q = torch.einsum("bli,ij->blj", h_in, params["wq"]
                     ).reshape(b, l, n_heads, head_dim)
    k = torch.einsum("bli,ij->blj", h_in, params["wk"]
                     ).reshape(b, l, n_heads, head_dim)
    v = torch.einsum("bli,ij->blj", h_in, params["wv"]
                     ).reshape(b, l, n_heads, head_dim)
    gates = torch.einsum("bli,ig->blg", h_in.float(), params["w_if"]) \
        + params["b_if"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)  # [b,l,h]
    log_f = -_softplus(-f_pre)  # log sigmoid(f)
    cum_f = torch.cumsum(log_f, dim=1)  # [b,l,h]
    tri = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    y = _mlstm_mix(q, k, v, i_pre, cum_f, cum_f, tri, head_dim)
    return _mlstm_out(params, y, z, x.dtype)


def _mlstm_body(x, *weights, names, specs, n_heads: int):
    """One rank of ``mlstm`` on its query rows ``x`` [b_l, l / N, d], the
    weights all-gathered whole: it projects its rows, all-gathers k, v,
    the input gates and the log-forget gates along the sequence (the
    cumulative sum runs over all of them), mixes its rows against every
    key ([b_l, l / N, l, h] score blocks) and out-projects its own rows,
    with no reduction."""
    group, _, r = _rank()
    p = _params_of({n: _whole(t, specs[n], group)
                    for n, t in zip(names, weights)})
    b, l_own, _ = x.shape
    up = torch.einsum("bld,di->bli", x, p["up_proj"])
    h_in, z = torch.chunk(up, 2, dim=-1)
    head_dim = h_in.shape[-1] // n_heads

    def proj(name):
        return torch.einsum("bli,ij->blj", h_in, p[name]).reshape(
            b, l_own, n_heads, head_dim)

    q = proj("wq")
    k = all_gather(proj("wk"), 1, group)
    v = all_gather(proj("wv"), 1, group)
    gates = torch.einsum("bli,ig->blg", h_in.float(), p["w_if"]) + p["b_if"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)  # [b,l/N,h]
    cum = torch.cumsum(all_gather(-_softplus(-f_pre), 1, group), dim=1)
    l = cum.shape[1]
    rows = torch.arange(r * l_own, (r + 1) * l_own, device=x.device)
    tri = rows[:, None] >= torch.arange(l, device=x.device)[None, :]
    y = _mlstm_mix(q, k, v, all_gather(i_pre, 1, group),
                   cum[:, r * l_own:(r + 1) * l_own], cum, tri, head_dim)
    return _mlstm_out(p, y, z, x.dtype)


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
    """Recurrent mLSTM step (stabilized). x: [b,1,d]. On a mesh the state
    is DTensors laid out by ``cache_shardings`` (``C`` and ``nvec`` over
    "model" by heads or key rows, ``m`` by heads or whole), updated in
    place and returned."""
    mesh = _mesh_of(state["C"], x, params["up_proj"])
    if mesh is not None:
        return _decode_on_mesh(
            mesh, "mlstm", params, _MLSTM, x, state,
            {"C": (1, 2), "nvec": (1, 2), "m": (1, None)},
            _mlstm_decode_body, n_heads=params["b_if"].shape[-1] // 2), state
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


def _mlstm_decode_body(x, C, nvec, m, *weights, names, specs, split,
                       n_heads: int):
    """One rank of an mLSTM decode step on its blocks of the state: the
    token's q, k and v projected with the rank's columns and all-gathered;
    the rank's block of ``C`` (its heads, or its key rows of every head)
    and of ``nvec`` updated and written in place; ``m`` computed alike on
    every rank (a [b, h] vector, all-gathered where it is split), its
    block written; the partial ``q . C`` and ``q . nvec`` of a key-row
    block all-reduced (a heads block's all-gathered); ``down_proj``'s
    partial products all-reduced."""
    group, _, r = _rank()
    w = {n: L._fsdp_whole(t, specs[n]) for n, t in zip(names, weights)}
    b = x.shape[0]

    def prod(h, name, eq=None):  # the plain step's product, einsum or @
        fn = torch.matmul if eq is None else functools.partial(
            torch.einsum, eq)
        return _product(fn, h, w[name], specs[name], group, r)

    up = prod(x, "up_proj", "bld,di->bli")[:, 0]
    h_in, z = torch.chunk(up, 2, dim=-1)
    d_inner = h_in.shape[-1]
    head_dim = d_inner // n_heads
    q, k, v = (prod(h_in, n).reshape(b, n_heads, head_dim).float()
               for n in ("wq", "wk", "wv"))
    gates = prod(h_in.float(), "w_if") + w["b_if"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)  # [b,h]
    log_f = -_softplus(-f_pre)
    m_all = m if split["m"] is None else all_gather(m, 1, group)
    m_new = torch.maximum(log_f + m_all, i_pre)
    f_sc = torch.exp(log_f + m_all - m_new)
    i_sc = torch.exp(i_pre - m_new)
    ks = k / math.sqrt(head_dim)
    _, hc, kc, _ = _own(C, split["C"], r)
    _, hn, kn = _own(nvec, split["nvec"], r)
    c_new = C * f_sc[:, hc, None, None] + i_sc[:, hc, None, None] * \
        torch.einsum("bhk,bhv->bhkv", ks[:, hc, kc], v[:, hc])
    n_new = nvec * f_sc[:, hn, None] + i_sc[:, hn, None] * ks[:, hn, kn]
    C.copy_(c_new)
    nvec.copy_(n_new)
    m.copy_(m_new[_own(m, split["m"], r)])

    def whole(t, dim):  # a heads block gathered, a key-row block summed
        if dim == 1:
            return all_gather(t, 1, group)
        dist.all_reduce(t, group=group)
        return t

    num = whole(torch.einsum("bhk,bhkv->bhv", q[:, hc, kc], c_new),
                split["C"])
    dot = whole(torch.einsum("bhk,bhk->bh", q[:, hn, kn], n_new),
                split["nvec"])
    den = torch.maximum(torch.abs(dot), torch.exp(-m_new))
    y = (num / den[:, :, None]).reshape(b, d_inner).to(x.dtype)
    y = rmsnorm({"scale": w["norm"]}, y) * silu(z)
    return prod(y, "down_proj", "bi,id->bd")[:, None, :]


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


_SLSTM = ("w_x", "w_h", "b", "norm", "w_up", "w_down")
_STATE = ("c", "nvec", "h", "m")


def slstm_init_state(params: Params, batch: int, d_model: int,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    device = params["w_x"].device if device is None else device
    return _slstm_zeros(batch, d_model, device)


def _slstm_zeros(batch: int, d: int, device) -> Dict[str, torch.Tensor]:
    z = torch.zeros(batch, d, dtype=torch.float32, device=device)
    return {"c": z, "nvec": z, "h": z,
            "m": _fill((batch, d), -math.inf, torch.float32, device)}


def _slstm_cell(params: Params, state: Mapping[str, torch.Tensor],
                xw: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One sLSTM step with exponential-gate stabilization. xw: [b, 4d]."""
    pre = xw + state["h"].to(xw.dtype) @ params["w_h"].to(xw.dtype)
    return _slstm_gates(pre.float() + params["b"], state)


def _slstm_gates(pre: torch.Tensor, state: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The step's update from its gate pre-activations [b, 4d] (z, i, f,
    o) float32 and the state's [b, d] vectors."""
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


def slstm(params: Params, x: torch.Tensor, batch_axes=None) -> torch.Tensor:
    """sLSTM over a sequence, one cell a step. x: [b,l,d] -> [b,l,d].
    Under a mesh each "model" rank steps its slice of the state's d
    (``_slstm_body``), the batch over ``batch_axes``."""
    mesh = _mesh_of(x, params["w_x"])
    if mesh is not None:
        _seq_split(mesh, x, "slstm")
        x_spec = P(batch_axes, "model", None)
        return _run_body(mesh, "slstm", params, _SLSTM, batch_axes,
                         _slstm_body, (x,), (x_spec,), x_spec)
    b, l, d = x.shape
    xw = torch.einsum("bld,dg->blg", x, params["w_x"])  # [b,l,4d]
    state = slstm_init_state(params, b, d, x.device)
    hs = []
    for t in range(l):
        state = _slstm_cell(params, state, xw[:, t])
        hs.append(state["h"])
    return _slstm_out(params, torch.stack(hs, dim=1), x.dtype)


def slstm_decode(params: Params, x: torch.Tensor,
                 state: Mapping[str, torch.Tensor]):
    """One sLSTM step. On a mesh the state is DTensors laid out by
    ``cache_shardings`` (d over "model"), updated in place and
    returned."""
    mesh = _mesh_of(state["h"], x, params["w_x"])
    if mesh is not None:
        return _decode_on_mesh(
            mesh, "slstm", params, _SLSTM, x, state,
            dict.fromkeys(_STATE, (1,)), _slstm_decode_body), state
    xw = torch.einsum("bld,dg->blg", x, params["w_x"])[:, 0]
    st2 = _slstm_cell(params, state, xw)
    return _slstm_out(params, st2["h"][:, None, :], x.dtype), st2


def _gate_cols(t: torch.Tensor, r: int, msz: int) -> torch.Tensor:
    """The rank's d-slice of each of the four gates (z, i, f, o) of a
    [..., 4d] weight or bias: [..., 4 d / N]."""
    d = t.shape[-1] // 4
    own = d // msz
    return t.unflatten(-1, (4, d))[..., r * own:(r + 1) * own].flatten(-2)


def _slstm_rank_cell(w_h, b, state, xw, group) -> Dict[str, torch.Tensor]:
    """``_slstm_cell`` on the rank's d-slice of the state ([b, d / N]
    each): h all-gathered, the rank's gate pre-activations [b, 4 d / N]
    from ``xw`` and its gate columns ``w_h`` [d, 4 d / N] and ``b``."""
    h = all_gather(state["h"], 1, group)
    pre = xw + h.to(xw.dtype) @ w_h.to(xw.dtype)
    return _slstm_gates(pre.float() + b, state)


def _slstm_body(x, *weights, names, specs):
    """One rank of ``slstm``: x [b_l, l / N, d] all-gathered along the
    sequence and projected for the rank's d-slice of each gate (``w_x`` and
    ``w_h`` gathered over "model" once, their four column slices kept);
    the time loop on the rank's [b_l, d / N] state (``_slstm_scan``); the
    hidden states [b_l, l, d / N] exchanged to the rank's rows [b_l, l /
    N, d] (all-to-all); the norm and the gated MLP on those rows."""
    group, msz, r = _rank()
    p = _params_of({n: _whole(t, specs[n], group)
                    for n, t in zip(names, weights)})
    xw = torch.einsum("bld,dg->blg", all_gather(x, 1, group),
                      _gate_cols(p["w_x"], r, msz))
    hs = _slstm_scan(_gate_cols(p["w_h"], r, msz),
                     _gate_cols(p["b"], r, msz), xw, group)
    return _slstm_out(p, all_to_all(hs.to(x.dtype), 1, 2, group), x.dtype)


def _slstm_decode_body(x, c, nvec, h, m, *weights, names, specs, split):
    """One rank of an sLSTM decode step: ``_slstm_rank_cell`` once on its
    d-slice of the state, written in place; then the norm and ``w_up`` on
    the rank's d-slice of the new h (the sum of squares and the partial
    products all-reduced), the gate and ``w_down`` whole, as the
    reference's compiled step splits them."""
    group, msz, r = _rank()
    p = _params_of({n: _whole(t, specs[n], group)
                    for n, t in zip(names, weights)})
    xw = torch.einsum("bld,dg->blg", x, _gate_cols(p["w_x"], r, msz))[:, 0]
    state = {"c": c, "nvec": nvec, "h": h, "m": m}
    st2 = _slstm_rank_cell(_gate_cols(p["w_h"], r, msz),
                           _gate_cols(p["b"], r, msz), state, xw, group)
    for k, t in state.items():
        t.copy_(st2[k])
    own = c.shape[-1]
    y = _rmsnorm_split(p["norm"]["scale"].narrow(0, r * own, own),
                       st2["h"][:, None, :].to(x.dtype), own * msz, group)
    ug = torch.einsum("bld,di->bli", y, p["w_up"].narrow(0, r * own, own))
    dist.all_reduce(ug, group=group)
    u, g = torch.chunk(ug, 2, dim=-1)
    return torch.einsum("bli,id->bld", u * silu(g), p["w_down"])


def _rmsnorm_split(scale, x, d: int, group, eps: float = 1e-6):
    """``layers.rmsnorm`` of a rank's slice ``x`` [..., d / N] of rows of
    width ``d``, with its slice of the scale: the float64 sum of squares
    all-reduced over ``group``."""
    x32 = x.float()
    ss = torch.sum(x32.double() ** 2, dim=-1, keepdim=True)
    dist.all_reduce(ss, group=group)
    y = x32 * torch.rsqrt((ss / d).float() + eps)
    return (y * scale.float()).to(x.dtype)


def _slstm_scan(w_h, b, xw, group) -> torch.Tensor:
    """The rank's time loop: its hidden states [b, l, d / N] float32 for
    its gate pre-activations ``xw`` [b, l, 4 d / N], one
    ``_slstm_rank_cell`` a token. On the meta device under a
    ``hlo_cost.Trace`` that folds loops, one step traced and counted ``l``
    times instead (``_CountedScan``)."""
    trace = hlo_cost.active_trace()
    if trace is not None and all(
            t.device.type == "meta" for t in (xw, w_h, b)):
        keep = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw, w_h, b))
        return _CountedScan.apply(xw, w_h, b, group, trace, keep)
    state = _slstm_zeros(xw.shape[0], w_h.shape[-1] // 4, xw.device)
    hs = []
    for xw_t in xw.unbind(1):
        state = _slstm_rank_cell(w_h, b, state, xw_t, group)
        hs.append(state["h"])
    return torch.stack(hs, dim=1)


def _step_leaves(xw, w_h, b, grad: bool):
    """Fresh leaves of one step's shapes (meta): the state's four vectors,
    xw_t, w_h and b."""
    shape = (xw.shape[0], w_h.shape[-1] // 4)
    leaves = [torch.zeros(shape, dtype=torch.float32, device=xw.device)
              for _ in _STATE[:3]] + [
        _fill(shape, -math.inf, torch.float32, xw.device),
        xw[:, 0].detach(), w_h.detach(), b.detach()]
    return [t.requires_grad_(grad) for t in leaves]


def _step(leaves, group) -> Dict[str, torch.Tensor]:
    *state, xw_t, w_h, b = leaves
    return _slstm_rank_cell(w_h, b, dict(zip(_STATE, state)), xw_t, group)


class _CountedScan(torch.autograd.Function):
    """``_slstm_scan``'s loop on the meta device, traced once a kind of
    step and counted by ``Trace.repeat`` (the dry run's form of the
    reference's loop trip-count multiplication):

      * forward: one step in ``repeat(l)``; where ``keep``, the tensors
        that step saves for its backward (found by
        ``saved_tensors_hooks``, by storage, the inputs' excepted)
        allocated ``l`` deep and held to the backward
        (``save_for_backward``, so ``remat`` drops and recomputes them as
        it does the loop's); the hidden states an uninitialised [b, l,
        d / N];
      * backward: the step recomputed in ``repeat(0)`` (the loop keeps its
        saved tensors), then its vector-Jacobian product counted as the
        loop's: the middle ``l - 2`` steps in full, the first without the
        state's gradient (its state is the zeros), the last with only h's
        incoming gradient (from the stacked hidden states); the ``l - 1``
        adds of h's two incoming gradients and of each weight's.
    What the loop runs and this does not, or the reverse, moves bytes and
    no FLOPs: the ``unbind`` / ``stack`` of the per-step tensors and of
    their gradients, the fills of the leaves."""

    @staticmethod
    def forward(ctx, xw, w_h, b, group, trace, keep: bool):
        l = xw.shape[1]
        ctx.group, ctx.trace = group, trace
        ctx.shapes = [(t.shape, t.dtype) for t in (xw, w_h, b)]
        held = {t.untyped_storage()._cdata for t in (xw, w_h, b)}
        saved: Dict[int, int] = {}

        def pack(t):
            key = t.untyped_storage()._cdata
            if key not in held:
                saved[key] = t.untyped_storage().nbytes()
            return t

        leaves = _step_leaves(xw, w_h, b, keep)
        with torch.enable_grad() if keep else torch.no_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                trace.repeat(l):
            _step(leaves, group)
        del leaves
        ctx.save_for_backward(*(
            torch.empty((l, n), dtype=torch.uint8, device=xw.device)
            for n in saved.values()))
        return xw.new_empty((xw.shape[0], l, w_h.shape[-1] // 4),
                            dtype=torch.float32)

    @staticmethod
    def backward(ctx, g_hs):
        ctx.saved_tensors  # the loop's per-step tensors, freed after this
        xw, w_h, b = (torch.empty(s, dtype=d, device=g_hs.device)
                      for s, d in ctx.shapes)
        l, trace = xw.shape[1], ctx.trace
        leaves = _step_leaves(xw, w_h, b, True)
        with torch.enable_grad():
            with trace.repeat(0):
                out = _step(leaves, ctx.group)
            for n, first, last in ((max(l - 2, 0), False, False),
                                   (int(l > 1), True, False),
                                   (int(l > 1), False, True),
                                   (int(l == 1), True, True)):
                if not n:
                    continue
                with trace.repeat(n):
                    g_h = g_hs[:, 0]
                    if not last:  # the next step's gradient of h
                        g_h = g_h + torch.empty_like(g_h)
                    outs = [out["h"]] + ([] if last else [
                        out[k] for k in ("c", "nvec", "m")])
                    gos = [g_h] + [torch.empty_like(o) for o in outs[1:]]
                    ins = leaves[4:] + ([] if first else leaves[:4])
                    g_w, g_b = torch.autograd.grad(
                        outs, ins, gos, retain_graph=True)[1:3]
            with trace.repeat(l - 1):  # the weights' accumulated gradients
                g_w, g_b = g_w + g_w, g_b + g_b
        g_xw = torch.empty_like(xw)
        return tuple(g if need else None for g, need in zip(
            (g_xw, g_w, g_b), ctx.needs_input_grad[:3])) + (None,) * 3
