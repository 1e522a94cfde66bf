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
2. ``bucketize_count_kernel`` — any boundary count. (The TPU kernel of
   that name tiles an O(Q·B) count because VMEM bounds the boundary
   block; Hopper has no such ceiling, so the port computes the same
   counts in O(Q log B).) Persistent blocks stage every 2^s-th boundary
   (at most ``SPLITTERS``, and 256 for each tile a block takes) in
   shared memory, bound the counts of each
   tile of ``COUNT_TILE`` queries by the counts of its min and max, and
   then either search a window of at most ``WINDOW`` boundaries staged in
   shared memory (the sorted probes of the main path) or finish the last
   s levels of each query through L2 (any other input). ``count_plan``
   gives s.

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
SPLITTERS = 4096  # boundaries the tiled route stages a block, at most
WINDOW = 2048  # boundaries a tile's window may stage
COUNT_TILE = 2 * TILE  # queries a tile of the tiled route: eight a thread
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SOURCE = "bucketize.cu"
_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None
_COUNT_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None

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


def count_plan(nb: int, max_splitters: int = SPLITTERS) -> Tuple[int, int]:
    """``(s, nsplit)`` of the tiled route: the least s for which every
    2^s-th of ``nb`` boundaries fits ``max_splitters`` staged entries,
    and their number. The C entry computes the same, with ``max_splitters``
    lowered to 256 for each tile a block of its grid takes (a launch of
    few tiles a block stages fewer)."""
    s = 0
    while ((nb - 1) >> s) + 1 > max_splitters:
        s += 1
    return s, ((nb - 1) >> s) + 1


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


def _count_entry():
    global _COUNT_ENTRY
    if _COUNT_ENTRY is None:
        lib = _build.library(_SOURCE)
        fn = lib.repro_bucketize_count
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, i64, p, i64, p, i32, i64, i32, p]
        fn.restype = ctypes.c_int
        _COUNT_ENTRY = (lib, fn)
    return _COUNT_ENTRY


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


def _launch(name: str, entry, boundaries, queries, right: bool, plan,
            *extra):
    """Allocate the counts and launch ``name`` through ``entry`` (the
    library and its bound C function) on the queries' card and current
    stream; ``plan(nb, queries_ptr, out_ptr)`` gives the route's flag
    bits, ``extra`` the entry's trailing arguments."""
    nb, nq = boundaries.shape[0], queries.shape[0]
    out = torch.empty_like(queries, dtype=torch.int32)
    if nq == 0:
        return out
    if nb == 0:
        return out.zero_()
    lib, fn = entry
    q_ptr, out_ptr = queries.data_ptr(), out.data_ptr()
    # the C entry's flag bits: float32, right, and the plan's
    flags = (_DTYPE_CODE[queries.dtype] | (2 if right else 0)
             | plan(nb, q_ptr, out_ptr))
    err = _build.run_on(queries.get_device(), fn, boundaries.data_ptr(), nb,
                        q_ptr, nq, out_ptr, flags, *extra)
    if err:
        _build.check(lib, err, name, "repro_bucketize_error_string")
    _build.count_launch(name, nb + nq,
                        f"q={_build.pow2(nq)} nb={_build.pow2(nb)}",
                        boundaries.element_size() * nb
                        + (queries.element_size() + 4) * nq,
                        boundaries=boundaries, queries=queries,
                        right=bool(right))
    return out


def _aligned(nb: int, queries_ptr: int, out_ptr: int) -> int:
    """The tiled route's plan: ``VECTORIZED`` when both are 16-byte
    aligned."""
    return VECTORIZED if (queries_ptr | out_ptr) & 15 == 0 else 0


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
    return _launch("bucketize_kernel", _ENTRY or _entry(), boundaries,
                   queries, right, launch_plan)


def bucketize_count_kernel(boundaries: torch.Tensor, queries: torch.Tensor,
                           right: bool = True,
                           max_blocks: Optional[int] = None,
                           max_splitters: int = SPLITTERS) -> torch.Tensor:
    """Tiled route for any boundary count (no sentinel padding needed) ->
    int32 counts. ``max_blocks`` caps the persistent grid and
    ``max_splitters`` the boundaries a block stages (fewer make the
    searches of longer boundary lists, several L2 rounds, reachable at a
    size a test affords); neither changes a count."""
    if not _check(boundaries, queries):
        return ref.ref_bucketize(boundaries, queries, right)
    return _launch("bucketize_count_kernel", _COUNT_ENTRY or _count_entry(),
                   boundaries, queries, right, _aligned,
                   int(max_blocks or 0), int(max_splitters))
