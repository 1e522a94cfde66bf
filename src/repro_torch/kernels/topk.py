"""``topk`` on the H100: wrapper of ``csrc/topk.cu``.

The ordering subsystem's row-level route (``core/order.py``,
DESIGN.md §10) asks for the k best rows of a rank-key tensor. The TPU
kernel (``repro.kernels.topk.topk_kernel``) keeps a K-wide candidate row
per 2048-value slab with a partial bitonic network and reduces the
survivors with ``lax.top_k``. On Hopper the kernel is a block-select
with a running threshold: in the range pass each block walks one
contiguous range, tests every key against its running top-``k_pow2``
list with one comparison, and sorts only the few keys that beat it; the
survivor pass is the same kernel with one block over the ranges' lists,
their source indices carried in. ``plan`` gives both launches; every
launch is counted as one of ``topk_kernel``.

The contract is the reference's: ``(vals[k], int32 idx[k])`` descending,
ties to the lowest index, pads (worst value, index past the end) when
fewer than ``k`` values exist, int32 or float32 without NaN. The plain
version is ``ref.topk``, a stable descending sort; the wrapper runs it
for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

THREADS = 256  # threads a block
CHUNK = 8 * THREADS  # keys a block tests per step: two 16-byte pieces a thread
BUFFER = 2048  # candidate pairs a block buffers before it sorts them
MIN_RANGE = 16 * CHUNK  # fewest keys a block of a multi-block pass walks
MAX_KERNEL_K = 256  # k_pow2 ceiling, as in repro.kernels.topk
MAX_ROWS = (1 << 31) - 2  # real indices stay below the pads' INT32_MAX
# range-pass blocks an SM takes: the kernel's launch bound
# (``__launch_bounds__(256, 2)``; two blocks of 51 KB of shared memory each
# fit any sm_90 SM). More blocks lengthen the one-block survivor pass more
# than they speed the range pass (PERF.md §6).
BLOCKS_PER_SM = 2
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SOURCE = "topk.cu"
_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None
_SMS: Dict[int, int] = {}


class Launch(NamedTuple):
    """One launch of ``topk_kernel``: block ``b`` of ``grid`` walks rows
    ``[b * range_rows, (b + 1) * range_rows)`` of ``rows``."""
    rows: int
    grid: int
    range_rows: int


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = _build.library(_SOURCE)
        fn = lib.repro_topk_pass
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY = (lib, fn)
    return _ENTRY


def _sm_count(index: int) -> int:
    """The card's SM count, read once per card."""
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def k_pow2_of(k: int) -> int:
    """The candidate width a block keeps: ``k`` rounded up to a power of
    two, at least 8 (``repro.kernels.topk``)."""
    return max(8, 1 << (int(k) - 1).bit_length())


def plan(n: int, k: int, max_blocks: int) -> List[Launch]:
    """The launches of one call on ``n`` values: the range pass over at
    most ``max_blocks`` blocks of at least ``MIN_RANGE`` keys each (ranges
    a multiple of 4 keys, so each starts 16-byte aligned when the input
    does), then, if it took more than one block, the survivor pass of one
    block over their ``grid * k_pow2`` pairs."""
    n, kp = int(n), k_pow2_of(k)
    grid = max(1, min(int(max_blocks), n // MIN_RANGE))
    per_block = -(-n // grid)
    span = -(-per_block // 4) * 4
    grid = max(1, -(-n // span)) if span else 1
    launches = [Launch(n, grid, span)]
    if grid > 1:
        launches.append(Launch(grid * kp, 1, grid * kp))
    return launches


def passes(n: int, k: int, max_blocks: Optional[int] = None) -> int:
    """Launches one ``topk_kernel`` call makes on ``n`` values: 1 when one
    block takes all of them (``n < 2 * MIN_RANGE``, or a cap of one
    block), else 2. Any cap of two or more blocks (every card's) gives the
    same."""
    return len(plan(n, k, 2 if max_blocks is None else max_blocks))


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
    if values.shape[0] > MAX_ROWS:
        raise ValueError("topk_kernel: indices must fit int32")
    return k_pow2


def topk_kernel(values: torch.Tensor, k: int,
                max_blocks: Optional[int] = None):
    """Top-k (descending) of a 1-D int32/float32 tensor: ``(vals[k],
    idx[k])``, equal values at the lowest index first. ``max_blocks``
    caps the range pass's grid (default: the card's SMs times
    ``BLOCKS_PER_SM``); the answer does not depend on it."""
    k = int(k)
    k_pow2 = _check(values, k)
    if values.device.type == "cpu":
        return ref.topk(values, k)
    dev = values.device
    index = values.get_device()
    if max_blocks is None:
        max_blocks = _sm_count(index) * BLOCKS_PER_SM
    lib, fn = _ENTRY or _entry()
    code = _DTYPE_CODE[values.dtype]
    cur_v, cur_i = values, None
    cls = f"{str(values.dtype)[6:]} n={_build.pow2(values.shape[0])} k={k_pow2}"
    for launch in plan(values.shape[0], k, max_blocks):
        out_v = torch.empty((launch.grid * k_pow2,), dtype=values.dtype,
                            device=dev)
        out_i = torch.empty((launch.grid * k_pow2,), dtype=torch.int32,
                            device=dev)
        err = _build.run_on(index, fn, cur_v.data_ptr(),
                            None if cur_i is None else cur_i.data_ptr(),
                            launch.rows, launch.range_rows, launch.grid,
                            k_pow2, code, out_v.data_ptr(), out_i.data_ptr())
        if err:
            _build.check(lib, err, "topk_kernel", "repro_topk_error_string")
        _build.count_launch("topk_kernel", values.shape[0], cls,
                            values=values, k=k)
        cur_v, cur_i = out_v, out_i
    return cur_v[:k], cur_i[:k]
