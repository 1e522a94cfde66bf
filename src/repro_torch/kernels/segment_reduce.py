"""``segment_sum`` on the H100: wrapper of ``csrc/segment_reduce.cu``.

Group-by aggregation (paper §7.2) bottoms out in a scatter-reduce. The
TPU port turned it into a one-hot MXU matmul
(``repro.kernels.segment_reduce.segment_sum_kernel``); on Hopper it is a
deterministic two-pass reduction over fixed row chunks, for float32
values and for int32 values (summed with int32 wrap-around, so integer
COUNTs and presence sums become reductions instead of atomics on one
address). ``plan`` fixes the route and the chunk from G alone: one
register partial a thread at G = 1, thread-private shared-memory columns
up to ``SMALL_GROUPS``, warp-private arrays with ``__match_any_sync``
above. No float atomics, so every run gives the same bits, whatever the
grid.

The plain version is ``ref.ref_segment_reduce`` (``index_add_`` over the
in-range ids); the wrapper runs it for CPU tensors. The wrapper checks
device, dtype, contiguity and shape, returns zeros without a launch for
empty values, allocates the [G, nchunks] scratch, and counts each launch.
The C entry is bound once and the current stream read without entering a
device context.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

MAX_SEGMENTS = 4096  # eight warp-private [G] arrays in 129 KiB
THREADS = 256  # threads a block
PER_THREAD = 4  # rows a thread a step: one 16-byte load when aligned
STEP = THREADS * PER_THREAD  # rows a block takes a step
SMALL_GROUPS = 32  # up to this G: thread-private partials
CHUNK_ROWS = 8192  # rows a chunk on the one and small routes
ONE, SMALL, MATCH = 0, 1, 2  # the C entry's routes
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SOURCE = "segment_reduce.cu"
_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None


def plan(num_segments: int) -> Tuple[int, int]:
    """``(route, chunk_rows)`` for G = ``num_segments``. The chunk is
    fixed by G, so the order of every add depends on N and G only: 8192
    rows, or on the match route 64 G rounded up to a power of two (its
    per-chunk cost is two passes over eight [G] arrays)."""
    g = int(num_segments)
    if g == 1:
        return ONE, CHUNK_ROWS
    if g <= SMALL_GROUPS:
        return SMALL, CHUNK_ROWS
    return MATCH, max(CHUNK_ROWS, 1 << (64 * g - 1).bit_length())


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = _build.library(_SOURCE)
        fn = lib.repro_segment_sum
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, p, i64, i32, i32, i32, i32, i64, i64, i64, p, p, p]
        fn.restype = ctypes.c_int
        _ENTRY = (lib, fn)
    return _ENTRY


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
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_sum: values dtype {values.dtype} is not "
                        "float32 or int32")
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
                       num_segments: int,
                       max_blocks: Optional[int] = None) -> torch.Tensor:
    """Sum per segment in the values' dtype (float32, or int32 with wrap);
    ids outside [0, num_segments) contribute 0. ``max_blocks`` caps the
    grid; the sums do not depend on it."""
    _check(values, segment_ids, num_segments)
    if values.device.type == "cpu":
        return ref.ref_segment_reduce(values, segment_ids, num_segments)
    g, n = int(num_segments), values.shape[0]
    out = torch.empty((g,), dtype=values.dtype, device=values.device)
    if n == 0:
        return out.zero_()
    route, chunk = plan(g)
    nchunks = -(-n // chunk)
    partial = torch.empty((g * nchunks,), dtype=values.dtype,
                          device=values.device)
    lib, fn = _ENTRY or _entry()
    v_ptr, i_ptr = values.data_ptr(), segment_ids.data_ptr()
    vec = int((v_ptr | i_ptr) & 15 == 0)
    err = _build.run_on(values.get_device(), fn, v_ptr, i_ptr, n, g,
                        _DTYPE_CODE[values.dtype], route, vec, chunk, nchunks,
                        int(max_blocks or 0), partial.data_ptr(),
                        out.data_ptr())
    if err:
        _build.check(lib, err, "segment_sum_kernel",
                     "repro_segment_sum_error_string")
    es = values.element_size()
    _build.count_launch("segment_sum_kernel", n,
                        f"{str(values.dtype)[6:]} rows={_build.pow2(n)} G={g}",
                        (es + 4) * n + es * g,
                        values=values, segment_ids=segment_ids,
                        num_segments=g)
    return out
