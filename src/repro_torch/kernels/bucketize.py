"""``bucketize`` (searchsorted) on the H100: wrappers of ``csrc/bucketize.cu``.

bucketize is the engine's dominant primitive — the core of
range_intersect (Alg. 1), idx_in_rle (Alg. 3), idx_in_idx (Alg. 4),
rle_contain_idx (Alg. 5), run expansion and the sort-merge join probe.

Two routes, ported from the two Pallas kernels of
``repro.kernels.bucketize``:

1. ``bucketize_kernel`` — boundaries staged in one block's shared memory
   (up to ``MAX_SMEM_BOUNDARIES`` four-byte entries, the 227 KB a block
   may opt in to on sm_90), four queries a thread (one 16-byte load when
   aligned) through four interleaved window searches; ``launch_plan``
   picks the load width and whether the grid is persistent, and the C
   entry sizes the grid.
2. ``bucketize_count_kernel`` — any boundary count: the same bisection
   through L2. (The TPU kernel of that name tiles an O(Q·B) count because
   VMEM bounds the boundary block; Hopper has no such ceiling, so the
   port computes the same counts in O(Q log B).)

Both return int32 counts equal to ``ref.ref_bucketize``, which is the
plain version the wrappers run for CPU tensors. Wrappers check device,
dtype, contiguity and shape, return without a launch for empty inputs,
and count each launch in ``_build.LAUNCHES``. The host's time is most of
a launch's at the main path's shapes, so the launch path is short: the C
entry is bound once, the checks are one chained test, and the current
card's stream is read without entering a device context.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

MAX_SMEM_BOUNDARIES = 232_448 // 4  # 58,112 int32/float32 boundaries
THREADS = 256  # threads a block of the shared-memory route
PER_THREAD = 4  # queries a thread: one 16-byte load when aligned
TILE = THREADS * PER_THREAD  # queries a block takes per step
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SOURCE = "bucketize.cu"
_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None

# The C entry's flag bits of the shared-memory route's plan. VECTORIZED: a
# thread loads its four queries of a TILE-query tile with one 16-byte load
# and stores four counts with one 16-byte store (both pointers 16-byte
# aligned), else four scalar loads THREADS apart. PERSISTENT: the grid is
# capped at the blocks the card keeps resident (staging more boundaries
# than a tile has queries), else one tile a block.
VECTORIZED = 8
PERSISTENT = 16


def launch_plan(nb: int, queries_ptr: int, out_ptr: int) -> int:
    """The shared-memory route's plan for ``nb`` boundaries and these
    pointers, as the C entry's ``VECTORIZED`` and ``PERSISTENT`` bits."""
    return ((VECTORIZED if (queries_ptr | out_ptr) & 15 == 0 else 0)
            | (PERSISTENT if nb > TILE else 0))


def _entry():
    global _ENTRY
    if _ENTRY is None:
        lib = _build.library(_SOURCE)
        fn = lib.repro_bucketize
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY = (lib, fn)
    return _ENTRY


def _check(boundaries: torch.Tensor, queries: torch.Tensor) -> bool:
    """Raise on what the kernels do not take; True for CUDA tensors, False
    for CPU ones. One chained test on the way to a launch; the messages
    only when it fails."""
    try:
        ok = (queries.dtype in _DTYPE_CODE
              and boundaries.dtype is queries.dtype
              and queries.dim() == 1 and boundaries.dim() == 1
              and queries.is_contiguous() and boundaries.is_contiguous()
              and boundaries.get_device() == queries.get_device())
        if ok and queries.is_cuda:
            return True
        ok = ok and queries.is_cpu
    except AttributeError:
        ok = False
    if not ok:
        _explain(boundaries, queries)
    return False


def _explain(boundaries, queries) -> None:
    """Raise the error that ``_check``'s one test found."""
    for name, t in (("boundaries", boundaries), ("queries", queries)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"bucketize: {name} must be a torch.Tensor")
        if t.dim() != 1:
            raise ValueError(f"bucketize: {name} must be 1-D, got {t.dim()}-D")
        if not t.is_contiguous():
            raise ValueError(f"bucketize: {name} must be contiguous")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"bucketize: {name} dtype {t.dtype} is not "
                            "int32 or float32")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"bucketize: {name} on unsupported device "
                             f"{t.device}")
    if boundaries.dtype != queries.dtype:
        raise TypeError("bucketize: boundaries and queries differ in dtype "
                        f"({boundaries.dtype} vs {queries.dtype})")
    raise ValueError("bucketize: boundaries and queries on different "
                     f"devices ({boundaries.device} vs {queries.device})")


def _launch(name: str, boundaries, queries, right: bool,
            global_route: bool):
    """Allocate the counts and launch on the queries' card, on its current
    stream (a device context is entered only for another card than the
    current one)."""
    nb, nq = boundaries.shape[0], queries.shape[0]
    out = torch.empty_like(queries, dtype=torch.int32)
    if nq == 0:
        return out
    if nb == 0:
        return out.zero_()
    lib, fn = _ENTRY or _entry()
    q_ptr, out_ptr = queries.data_ptr(), out.data_ptr()
    # the C entry's flag bits: float32, right, global or the plan's
    flags = (_DTYPE_CODE[queries.dtype] | (2 if right else 0)
             | (4 if global_route else launch_plan(nb, q_ptr, out_ptr)))
    index = queries.get_device()
    if index == torch._C._cuda_getDevice():
        err = fn(boundaries.data_ptr(), nb, q_ptr, nq, out_ptr, flags,
                 torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(boundaries.data_ptr(), nb, q_ptr, nq, out_ptr, flags,
                     torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check(lib, err, name, "repro_bucketize_error_string")
    _build.count_launch(name, nb + nq, boundaries=boundaries, queries=queries,
                        right=bool(right))
    return out


def bucketize_kernel(boundaries: torch.Tensor, queries: torch.Tensor,
                     right: bool = True) -> torch.Tensor:
    """Shared-memory route: sorted 1-D boundaries (at most
    ``MAX_SMEM_BOUNDARIES``) and 1-D queries of one dtype -> int32 counts."""
    if not _check(boundaries, queries):
        return ref.ref_bucketize(boundaries, queries, right)
    if boundaries.shape[0] > MAX_SMEM_BOUNDARIES:
        raise ValueError(
            f"bucketize_kernel: {boundaries.shape[0]} boundaries exceed one "
            f"block's shared memory ({MAX_SMEM_BOUNDARIES}); use "
            "bucketize_count_kernel")
    return _launch("bucketize_kernel", boundaries, queries, right, False)


def bucketize_count_kernel(boundaries: torch.Tensor, queries: torch.Tensor,
                           right: bool = True) -> torch.Tensor:
    """Global-memory route for any boundary count (no sentinel padding
    needed) -> int32 counts."""
    if not _check(boundaries, queries):
        return ref.ref_bucketize(boundaries, queries, right)
    return _launch("bucketize_count_kernel", boundaries, queries, right, True)
