"""Device resolution and the host -> device array canonicalisation.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``cuda`` and raises when no CUDA device is present (there is
no silent CPU path). Tests pass ``device="cpu"`` explicitly.

``as_tensor`` reproduces what ``jnp.asarray`` does with 64-bit mode off,
so the port's buffers carry the reference's dtypes: int64 -> int32,
float64 -> float32, everything narrower unchanged. (The reference maps
uint32/uint64 to uint32; torch has no full uint32 arithmetic, so the
port widens unsigned 32/64-bit input to int64.)
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

_CANONICAL = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.uint64): np.dtype(np.int64),
    np.dtype(np.uint32): np.dtype(np.int64),
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def canonical_dtype(dtype) -> np.dtype:
    """The dtype ``jnp.asarray`` gives a host array of ``dtype`` (x64 off)."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


def as_tensor(x, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A tensor of ``x``: tensors keep their device (cast to ``dtype`` when
    given); host data is canonicalised and placed on ``device``."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(resolve_device(device))
        return t if dtype is None else t.to(dtype)
    a = np.asarray(x)
    a = a.astype(canonical_dtype(a.dtype), copy=False)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, copy=True, order="C")
    t = torch.from_numpy(a).to(resolve_device(device))
    return t if dtype is None else t.to(dtype)


def to_numpy(t) -> np.ndarray:
    """Host copy of a tensor (or pass-through for host data)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (torch dtypes pass through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF_NP[np.dtype(dtype)]
