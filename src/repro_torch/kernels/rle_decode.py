"""``rle_decode`` on the H100: wrapper of ``csrc/rle_decode.cu``.

``rle_to_plain`` / run expansion is the engine's second hot spot
(DESIGN.md §3). Ported from ``repro.kernels.rle_decode.rle_decode_kernel``,
whose rows each bisect the run *ends*; on the card the rows of a
``TILE_ROWS``-row warp tile share the two counts of ends that bound
their runs (``csrc/rle_tile.cuh``): a tile inside one run is a pure
write stream, one that meets several runs stages up to ``STAGE_RUNS`` of
them in shared memory, and only repeated ends send rows to a bisection
through L2. ``rle_decode_packed_kernel`` (``unpack.py``) walks the same
tiles.

The plain version is ``ref.ref_rle_decode``; the wrapper runs it for CPU
tensors. The wrapper checks device, dtype, contiguity and shape, returns
without a launch for zero rows or zero capacity, passes ``fill`` already
cast to the value dtype as a 32-bit pattern, and counts each launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

TILE_ROWS = 256  # rows a warp tile (rle_tile.cuh kTile)
STAGE_RUNS = 256  # runs a warp stages in shared memory (kStage)
_VALUE_DTYPES = (torch.int32, torch.float32)
_SOURCE = "rle_decode.cu"
_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = _build.library(_SOURCE)
        fn = lib.repro_rle_decode
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_uint32, p, ctypes.c_int64, p]
        fn.restype = ctypes.c_int
        _ENTRY = (lib, fn)
    return _ENTRY


_FILL_BITS: Dict[tuple, int] = {}


def fill_bits(fill, dtype: torch.dtype) -> int:
    """``fill`` cast to ``dtype`` (as ``jnp.asarray(fill, dtype)`` does),
    returned as its unsigned 32-bit pattern. Kept per (type, repr, dtype),
    so -0.0 and 0.0 stay apart and a launch builds no host tensor for a
    fill it has seen."""
    key = (type(fill), repr(fill), dtype)
    bits = _FILL_BITS.get(key)
    if bits is None:
        word = torch.tensor(fill).to(dtype).view(torch.int32).item()
        if len(_FILL_BITS) >= 256:
            _FILL_BITS.clear()
        bits = _FILL_BITS[key] = word & 0xFFFFFFFF
    return bits


def _check(values, starts, ends, n, nrows: int) -> None:
    for name, t in (("values", values), ("starts", starts), ("ends", ends)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rle_decode: {name} must be a torch.Tensor")
        if t.dim() != 1:
            raise ValueError(f"rle_decode: {name} must be 1-D, got "
                             f"{t.dim()}-D")
        if not t.is_contiguous():
            raise ValueError(f"rle_decode: {name} must be contiguous")
        if t.device != values.device:
            raise ValueError("rle_decode: buffers on different devices")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"rle_decode: unsupported device {t.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"rle_decode: values dtype {values.dtype} is not "
                        "int32 or float32")
    if starts.dtype != torch.int32 or ends.dtype != torch.int32:
        raise TypeError("rle_decode: starts/ends must be int32")
    if not (values.shape[0] == starts.shape[0] == ends.shape[0]):
        raise ValueError("rle_decode: values/starts/ends capacities differ")
    if not isinstance(n, torch.Tensor) or n.numel() != 1 \
            or n.dtype != torch.int32 or n.device != values.device:
        raise TypeError("rle_decode: n must be a one-element int32 tensor on "
                        "the buffers' device")
    if nrows < 0:
        raise ValueError(f"rle_decode: nrows={nrows} < 0")


def rle_decode_kernel(values: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor, n: torch.Tensor, nrows: int,
                      fill=0, max_blocks: Optional[int] = None
                      ) -> torch.Tensor:
    """Decode an RLE column (capacity buffers + count) to dense [nrows].
    ``max_blocks`` caps the grid; the output does not depend on it."""
    _check(values, starts, ends, n, nrows)
    if values.device.type == "cpu":
        return ref.ref_rle_decode(values, starts, ends, n, nrows, fill)
    cap = values.shape[0]
    if nrows == 0 or cap == 0:  # every row (if any) is a gap
        return torch.full((nrows,), torch.tensor(fill).to(values.dtype).item(),
                          dtype=values.dtype, device=values.device)
    bits = fill_bits(fill, values.dtype)
    out = torch.empty((nrows,), dtype=values.dtype, device=values.device)
    lib, fn = _ENTRY or _entry()
    err = _build.run_on(values.get_device(), fn, values.data_ptr(),
                        starts.data_ptr(), ends.data_ptr(), n.data_ptr(), cap,
                        nrows, bits, out.data_ptr(), int(max_blocks or 0))
    if err:
        _build.check(lib, err, "rle_decode_kernel",
                     "repro_rle_decode_error_string")
    _build.count_launch("rle_decode_kernel", 3 * cap + nrows,
                        f"rows={_build.pow2(nrows)} cap={_build.pow2(cap)}",
                        values=values, starts=starts, ends=ends, n=n,
                        nrows=nrows, fill=fill)
    return out
