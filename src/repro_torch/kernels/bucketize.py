"""``bucketize`` (searchsorted) on the H100: wrappers of ``csrc/bucketize.cu``.

bucketize is the engine's dominant primitive — the core of
range_intersect (Alg. 1), idx_in_rle (Alg. 3), idx_in_idx (Alg. 4),
rle_contain_idx (Alg. 5), run expansion and the sort-merge join probe.

Two routes, ported from the two Pallas kernels of
``repro.kernels.bucketize``:

1. ``bucketize_kernel`` — boundaries staged in one block's shared memory
   (up to ``MAX_SMEM_BOUNDARIES`` four-byte entries, the 227 KB a block
   may opt in to on sm_90), one thread per query, branch-free bisection.
2. ``bucketize_count_kernel`` — any boundary count: the same bisection
   through L2. (The TPU kernel of that name tiles an O(Q·B) count because
   VMEM bounds the boundary block; Hopper has no such ceiling, so the
   port computes the same counts in O(Q log B).)

Both return int32 counts equal to ``ref.ref_bucketize``, which is the
plain version the wrappers run for CPU tensors. Wrappers check device,
dtype, contiguity and shape, return without a launch for empty inputs,
and count each launch in ``_build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_SMEM_BOUNDARIES = 232_448 // 4  # 58,112 int32/float32 boundaries
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SOURCE = "bucketize.cu"


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    fn = lib.repro_bucketize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(boundaries: torch.Tensor, queries: torch.Tensor) -> None:
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
    if boundaries.device != queries.device:
        raise ValueError("bucketize: boundaries and queries on different "
                         f"devices ({boundaries.device} vs {queries.device})")


def _launch(name: str, boundaries, queries, right: bool, global_route: bool):
    nb, nq = boundaries.shape[0], queries.shape[0]
    out = torch.empty((nq,), dtype=torch.int32, device=queries.device)
    if nq == 0:
        return out
    if nb == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = lib.repro_bucketize(
            boundaries.data_ptr(), nb, queries.data_ptr(), nq, out.data_ptr(),
            _DTYPE_CODE[queries.dtype], int(bool(right)), int(global_route),
            stream)
    _build.check(lib, err, name, "repro_bucketize_error_string")
    _build.count_launch(name, nb + nq, boundaries=boundaries, queries=queries,
                        right=bool(right))
    return out


def bucketize_kernel(boundaries: torch.Tensor, queries: torch.Tensor,
                     right: bool = True) -> torch.Tensor:
    """Shared-memory route: sorted 1-D boundaries (at most
    ``MAX_SMEM_BOUNDARIES``) and 1-D queries of one dtype -> int32 counts."""
    _check(boundaries, queries)
    if queries.device.type == "cpu":
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
    _check(boundaries, queries)
    if queries.device.type == "cpu":
        return ref.ref_bucketize(boundaries, queries, right)
    return _launch("bucketize_count_kernel", boundaries, queries, right, True)
