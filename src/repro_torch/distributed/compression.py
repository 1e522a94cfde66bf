"""Gradient compression with the paper's encodings, in torch.

The paper proposes Index encoding for sparse data and bit-width reduction
with mid-range centering for dense data (§3.2). Both map onto gradient
compression for data-parallel training:

  * ``topk_index``    — the top-k magnitude entries as an Index column
                        (int32 positions + float32 values), the rest zero;
  * ``int8_centered`` — the §3.2 scheme: global mid-range center, linear
                        int8 quantization.

Error feedback keeps the compression unbiased over time: each leaf's
residual (what was dropped or rounded) is added back before the next
compression. ``compress_decompress`` is the projection form: on one
device it carries the numerics of a compressed all-reduce, and
``estimated_wire_bytes`` the bytes one would move per shard.

The reference's ``allreduce_topk`` (an explicit ``shard_map`` collective:
per-shard top-k, ``all_gather`` of positions and values, scatter-add) is
not ported here: it is a collective across devices, and the port's
multi-device layer is still to come (ROADMAP.md A16.4).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.train import pytree


def init_state(params) -> Dict[str, Any]:
    """Error-feedback residuals, one float32 zero tensor per leaf."""
    return {"residual": pytree.map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)}


def _topk_project(g32: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the k largest-|.| entries (the Index-encoded payload), zero the
    rest."""
    flat = g32.reshape(-1)
    n = flat.shape[0]
    k = max(1, int(round(n * frac)))
    if k >= n:
        return g32
    _, pos = torch.topk(torch.abs(flat), k)  # positions: the Index tensor
    kept = torch.zeros_like(flat).index_copy_(0, pos, flat[pos])
    return kept.reshape(g32.shape)


def _int8_centered(g32: torch.Tensor) -> torch.Tensor:
    """Paper §3.2: mid-range centering + linear int8 bit-width reduction."""
    lo = torch.min(g32)
    hi = torch.max(g32)
    center = (lo + hi) * 0.5
    scale = torch.clamp((hi - lo) / 254.0, min=1e-12)
    q = torch.clamp(torch.round((g32 - center) / scale), -127, 127).to(
        torch.int8)
    return q.float() * scale + center


def compress_decompress(grads, state, kind: str, topk_frac: float = 0.01
                        ) -> Tuple[Any, Dict[str, Any]]:
    """Error-feedback compression round trip on a gradient tree. Returns
    (the sent gradients in each leaf's dtype, the new state)."""
    if kind not in ("topk_index", "int8_centered"):
        raise ValueError(kind)

    def one(g, r):
        g32 = g.float() + r
        if g.ndim < 2:  # small leaves ride along uncompressed
            return g32.to(g.dtype), torch.zeros_like(r)
        if kind == "topk_index":
            sent = _topk_project(g32, topk_frac)
        else:
            sent = _int8_centered(g32)
        return sent.to(g.dtype), g32 - sent

    residuals = []

    def send(g, r):
        sent, residual = one(g, r)
        residuals.append(residual)
        return sent

    sent = pytree.map_tree(send, grads, state["residual"])
    it = iter(residuals)
    return sent, {"residual": pytree.map_tree(lambda _: next(it), grads)}


def estimated_wire_bytes(params, kind: str, topk_frac: float) -> int:
    """Bytes one data-parallel all-reduce would move per shard under each
    scheme."""
    total = 0
    for p in pytree.leaves(params):
        n = p.numel() if hasattr(p, "numel") else p.size
        if p.ndim < 2:
            total += n * 4
        elif kind == "topk_index":
            k = max(1, int(round(n * topk_frac)))
            total += k * 8  # int32 position + float32 value
        elif kind == "int8_centered":
            total += n * 1 + 8
        else:
            total += n * 4
    return total
