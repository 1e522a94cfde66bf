"""Carry model parameters between the reference and the port as numpy.

The reference's parameter tree, its leaves as host arrays
(``jax.tree.map(np.asarray, params)``: stacked ``[n_layers, ...]`` layer
leaves, bfloat16 as numpy's extension dtype), becomes the port's
``ParamTree`` with the same names, shapes and dtypes, and back. This is how
both packages compute with the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import ModelConfig, ParamTree, init_params


def _leaf_to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # numpy extension dtype: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _convert(tree: Mapping[str, Any], want: ParamTree, device, path=()):
    if set(tree) != set(want.keys()):
        raise ValueError(f"params{list(path)}: keys {sorted(tree)} != "
                         f"{sorted(want.keys())}")
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _convert(value, want[key], device, path + (key,))
            continue
        t = _leaf_to_tensor(np.asarray(value))
        ref = want[key]
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"params{list(path + (key,))}: {tuple(t.shape)} "
                             f"{t.dtype} != {tuple(ref.shape)} {ref.dtype}")
        out[key] = t.to(device)
    return out


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device: DeviceLike = None) -> ParamTree:
    """The port's parameters of ``cfg`` from the reference's tree of host
    arrays, checked leaf for leaf against ``cfg``'s names, shapes and
    dtypes, placed on ``device`` (the card when None)."""
    device = resolve_device(device)
    want = init_params(cfg, device="meta")
    return ParamTree(_convert(tree, want, device))


def params_to_numpy(params: ParamTree) -> Dict[str, Any]:
    """The leaves as a nested dict of host arrays; bfloat16 leaves widen to
    float32 (exact: a cast back to bfloat16 gives the same bits)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else leaf(v)
                for k, v in tree.items()}

    return walk(params.tree())
