"""``topk`` on the H100: wrapper of ``csrc/topk.cu``.

The ordering subsystem's row-level route (``core/order.py``,
DESIGN.md §10) asks for the k best rows of a rank-key tensor. The TPU
kernel (``repro.kernels.topk.topk_kernel``) keeps a K-wide candidate row
per 2048-value slab with a partial bitonic network and reduces the
survivors with ``lax.top_k``. On Hopper one block bitonic-sorts a tile of
2048 (value, index) pairs in shared memory and writes its top ``k_pow2``;
the survivor pass is the same kernel relaunched on the survivors, their
source indices carried in, until one tile is left. Every pass is counted
as one launch of ``topk_kernel``.

The contract is the reference's: ``(vals[k], int32 idx[k])`` descending,
ties to the lowest index, pads (worst value, index past the end) when
fewer than ``k`` values exist, int32 or float32 without NaN. The plain
version is ``ref.topk``, a stable descending sort; the wrapper runs it
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

TILE = 2048  # (value, index) pairs a block sorts in shared memory
MAX_KERNEL_K = 256  # k_pow2 ceiling, as in repro.kernels.topk
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SOURCE = "topk.cu"


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    fn = lib.repro_topk_pass
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def k_pow2_of(k: int) -> int:
    """The candidate width a tile keeps: ``k`` rounded up to a power of
    two, at least 8 (``repro.kernels.topk``)."""
    return max(8, 1 << (int(k) - 1).bit_length())


def passes(n: int, k: int) -> int:
    """Launches one ``topk_kernel`` call makes on ``n`` values."""
    kp, m, count = k_pow2_of(k), int(n), 1
    while m > TILE:
        m = -(-m // TILE) * kp
        count += 1
    return count


def _check(values, k: int) -> int:
    if not isinstance(values, torch.Tensor):
        raise TypeError("topk_kernel: values must be a torch.Tensor")
    if values.dim() != 1:
        raise ValueError(f"topk_kernel: values must be 1-D, got "
                         f"{values.dim()}-D")
    if not values.is_contiguous():
        raise ValueError("topk_kernel: values must be contiguous")
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"topk_kernel: values dtype {values.dtype} is not "
                        "int32 or float32")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_kernel: unsupported device {values.device}")
    if k < 1:
        raise ValueError("topk_kernel: k must be >= 1")
    k_pow2 = k_pow2_of(k)
    if k_pow2 > MAX_KERNEL_K:
        raise ValueError(f"topk_kernel: k={k} beyond kernel limit")
    if values.shape[0] > (1 << 31) - 1 - TILE:
        raise ValueError("topk_kernel: indices must fit int32")
    return k_pow2


def topk_kernel(values: torch.Tensor, k: int):
    """Top-k (descending) of a 1-D int32/float32 tensor: ``(vals[k],
    idx[k])``, equal values at the lowest index first."""
    k = int(k)
    k_pow2 = _check(values, k)
    if values.device.type == "cpu":
        return ref.topk(values, k)
    n = values.shape[0]
    lib = _lib()
    cur_v, cur_i, m = values, None, n
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        while True:
            tiles = max(1, -(-m // TILE))
            out_v = torch.empty((tiles * k_pow2,), dtype=values.dtype,
                                device=values.device)
            out_i = torch.empty((tiles * k_pow2,), dtype=torch.int32,
                                device=values.device)
            err = lib.repro_topk_pass(
                cur_v.data_ptr(), None if cur_i is None else cur_i.data_ptr(),
                m, k_pow2, _DTYPE_CODE[values.dtype], out_v.data_ptr(),
                out_i.data_ptr(), stream)
            _build.check(lib, err, "topk_kernel", "repro_topk_error_string")
            _build.count_launch("topk_kernel", n, values=values, k=k)
            if tiles == 1:
                return out_v[:k], out_i[:k]
            cur_v, cur_i, m = out_v, out_i, tiles * k_pow2
