"""``segment_sum`` on the H100: wrapper of ``csrc/segment_reduce.cu``.

Group-by aggregation (paper §7.2) bottoms out in a scatter-reduce. The
TPU port turned it into a one-hot MXU matmul
(``repro.kernels.segment_reduce.segment_sum_kernel``); on Hopper it is a
deterministic two-pass reduction: fixed row chunks per block, warp-private
shared-memory sums combined in lane order, block partials summed in block
order. No float atomics, so every run gives the same bits.

The plain version is ``ref.ref_segment_reduce`` (``index_add_`` over the
in-range ids); the wrapper runs it for CPU tensors. The wrapper checks
device, dtype, contiguity and shape, returns zeros without a launch for
empty values, allocates the [nblocks, G] scratch, and counts each launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_SEGMENTS = 4096  # eight warp-private [G] float arrays in 128 KiB
ROWS_PER_BLOCK = 1 << 16  # fixed chunk: the sum order depends only on N
_SOURCE = "segment_reduce.cu"


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    fn = lib.repro_segment_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(values, segment_ids, num_segments: int) -> None:
    for name, t in (("values", values), ("segment_ids", segment_ids)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"segment_sum: {name} must be a torch.Tensor")
        if t.dim() != 1:
            raise ValueError(f"segment_sum: {name} must be 1-D, got "
                             f"{t.dim()}-D")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be contiguous")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"segment_sum: unsupported device {t.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"segment_sum: values dtype {values.dtype} is not "
                        "float32")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_sum: segment_ids dtype {segment_ids.dtype} "
                        "is not int32")
    if values.shape != segment_ids.shape:
        raise ValueError("segment_sum: values and segment_ids differ in shape")
    if values.device != segment_ids.device:
        raise ValueError("segment_sum: values and segment_ids on different "
                         "devices")
    if not 0 < num_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_sum: num_segments={num_segments} outside "
                         f"(0, {MAX_SEGMENTS}]")


def segment_sum_kernel(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """float32 sum per segment; ids outside [0, num_segments) contribute 0."""
    _check(values, segment_ids, num_segments)
    if values.device.type == "cpu":
        return ref.ref_segment_reduce(values, segment_ids, num_segments)
    g, n = int(num_segments), values.shape[0]
    if n == 0:
        return torch.zeros((g,), dtype=torch.float32, device=values.device)
    out = torch.empty((g,), dtype=torch.float32, device=values.device)
    nblocks = -(-n // ROWS_PER_BLOCK)
    partial = torch.empty((nblocks, g), dtype=torch.float32,
                          device=values.device)
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.repro_segment_sum(values.data_ptr(), segment_ids.data_ptr(),
                                    n, g, ROWS_PER_BLOCK, partial.data_ptr(),
                                    nblocks, out.data_ptr(), stream)
    _build.check(lib, err, "segment_sum_kernel",
                 "repro_segment_sum_error_string")
    _build.count_launch("segment_sum_kernel", n, values=values,
                        segment_ids=segment_ids, num_segments=g)
    return out
