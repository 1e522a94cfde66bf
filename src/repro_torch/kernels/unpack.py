"""Bit-packed columns on the H100: wrappers of ``csrc/unpack.cu`` and of
``csrc/bucketize.cu``'s packed entry.

A packed stream holds unsigned ``bit_width``-bit codes densely in 32-bit
lanes (value ``i`` in bits ``[i*b, i*b + b)``, little-endian within a
lane); the logical value is ``code + offset`` in int32 (DESIGN.md §11,
``csrc/packed.cuh``). The port keeps the lanes in an int32 tensor holding
the same bit patterns, since torch has no full uint32 arithmetic. Ported
from the three Pallas kernels of ``repro.kernels.unpack``:

  * ``unpack_kernel`` — standalone expansion to int32 (every packed
    buffer read through ``encodings.unpack_values``; inside one query
    program each leaf once, ``dispatch.unpack_once``): a warp expands
    128 values a step from their 4b lanes, staged with 16-byte loads, four
    values a lane with one 16-byte store; the ragged tail and unaligned
    words take one value a thread,
  * ``bucketize_packed_kernel`` — ``bucketize(boundaries, unpack(words))``
    on ``bucketize.cu``'s two routes with the packed query source (four
    consecutive codes a thread, extracted in registers): the shared-memory
    route up to ``MAX_SMEM_BOUNDARIES``, the tiled route above (sorted
    tiles search a window of boundaries, others the splitters and L2),
  * ``rle_decode_packed_kernel`` — RLE expansion whose run value is
    extracted from the packed words at the run id, on the tile walk of
    ``rle_decode_kernel`` (``csrc/rle_tile.cuh``): once a tile inside one
    run, once a run where a tile stages several.

The plain versions are ``ref.ref_unpack``, ``ref.ref_bucketize_packed``
and ``ref.ref_rle_decode_packed``; the wrappers run them for CPU tensors.
Wrappers check device, dtype, contiguity and the word count, return
without a launch for empty outputs, and count each launch. ``max_blocks``
caps a grid; no output depends on it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bucketize import (MAX_SMEM_BOUNDARIES, PERSISTENT,
                                           SPLITTERS, TILE)
from repro_torch.kernels.rle_decode import fill_bits

_SOURCE = "unpack.cu"
_ENTRIES: Optional[Tuple[ctypes.CDLL, object, object]] = None
_PACKED_ENTRY: Optional[Tuple[ctypes.CDLL, object]] = None
# repro_bucketize_packed's flag bits beside bucketize.py's: the tiled route
# (else the boundaries staged in shared memory)
TILED = 32


def _entries():
    """The library and its two C entries, bound once."""
    global _ENTRIES
    if _ENTRIES is None:
        lib = _build.library(_SOURCE)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.repro_unpack.argtypes = [p, i64, ctypes.c_int, i32, i64, p, i64,
                                     p]
        lib.repro_rle_decode_packed.argtypes = [p, i64, ctypes.c_int, i32, p,
                                                p, p, i64, i64, i32, p, i64,
                                                p]
        for fn in (lib.repro_unpack, lib.repro_rle_decode_packed):
            fn.restype = ctypes.c_int
        _ENTRIES = (lib, lib.repro_unpack, lib.repro_rle_decode_packed)
    return _ENTRIES


def _packed_entry():
    """``bucketize.cu``'s library and its packed entry, bound once."""
    global _PACKED_ENTRY
    if _PACKED_ENTRY is None:
        lib = _build.library("bucketize.cu")
        fn = lib.repro_bucketize_packed
        p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, i64, p, i64, c_int, ctypes.c_int32, i64, p, c_int,
                       i64, c_int, p]
        fn.restype = ctypes.c_int
        _PACKED_ENTRY = (lib, fn)
    return _PACKED_ENTRY


def nwords_for(nvals: int, bit_width: int) -> int:
    """Lanes a stream of ``nvals`` ``bit_width``-bit codes occupies."""
    return (int(nvals) * int(bit_width) + 31) // 32


def int32_offset(offset) -> int:
    """``offset`` as the int32 the reference adds (wrapped into range)."""
    return ((int(offset) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _check_words(words: torch.Tensor, bit_width: int, nvals: int,
                 what: str) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"{what}: words must be a torch.Tensor")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError(f"{what}: words must be a contiguous 1-D tensor")
    if words.dtype != torch.int32:
        raise TypeError(f"{what}: words must be int32 lanes (the uint32 bit "
                        f"patterns), got {words.dtype}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {words.device}")
    if not 1 <= int(bit_width) <= 32:
        raise ValueError(f"{what}: bit_width={bit_width} outside 1..32")
    if nvals < 0 or words.shape[0] < nwords_for(nvals, bit_width):
        raise ValueError(f"{what}: {words.shape[0]} words cannot hold {nvals} "
                         f"{bit_width}-bit values")


def unpack_kernel(words: torch.Tensor, bit_width: int, offset,
                  nvals: int, max_blocks: Optional[int] = None
                  ) -> torch.Tensor:
    """Expand a packed stream to int32[nvals]."""
    _check_words(words, bit_width, nvals, "unpack")
    if words.device.type == "cpu":
        return ref.ref_unpack(words, bit_width, offset, nvals)
    out = torch.empty((nvals,), dtype=torch.int32, device=words.device)
    if nvals == 0:
        return out
    lib, fn, _ = _ENTRIES or _entries()
    err = _build.run_on(words.get_device(), fn, words.data_ptr(),
                        words.shape[0], int(bit_width), int32_offset(offset),
                        nvals, out.data_ptr(), int(max_blocks or 0))
    if err:
        _build.check(lib, err, "unpack_kernel", "repro_unpack_error_string")
    _build.count_launch("unpack_kernel", nvals,
                        f"n={_build.pow2(nvals)} bits={int(bit_width)}",
                        4 * (nwords_for(nvals, bit_width) + nvals),
                        words=words, bit_width=int(bit_width),
                        offset=int(offset), nvals=nvals)
    return out


def bucketize_packed_kernel(boundaries: torch.Tensor, words: torch.Tensor,
                            bit_width: int, offset, nvals: int,
                            right: bool = True, tiled: Optional[bool] = None,
                            max_blocks: Optional[int] = None,
                            max_splitters: int = SPLITTERS) -> torch.Tensor:
    """``bucketize(boundaries, unpack(words))`` -> int32 counts, without the
    unpacked queries in device memory. ``tiled`` None takes the
    shared-memory route while the boundaries fit it, the tiled route above;
    ``max_blocks`` and ``max_splitters`` are the tiled route's (as
    ``bucketize_count_kernel``'s) and change no count."""
    _check_words(words, bit_width, nvals, "bucketize_packed")
    if not isinstance(boundaries, torch.Tensor) or boundaries.dim() != 1 \
            or not boundaries.is_contiguous():
        raise ValueError("bucketize_packed: boundaries must be a contiguous "
                         "1-D tensor")
    if boundaries.dtype != torch.int32:
        raise TypeError("bucketize_packed: boundaries must be int32, got "
                        f"{boundaries.dtype}")
    if boundaries.device != words.device:
        raise ValueError("bucketize_packed: boundaries and words on different "
                         f"devices ({boundaries.device} vs {words.device})")
    if words.device.type == "cpu":
        return ref.ref_bucketize_packed(boundaries, words, bit_width, offset,
                                        nvals, right)
    nb = boundaries.shape[0]
    if tiled is None:
        tiled = nb > MAX_SMEM_BOUNDARIES
    if not tiled and nb > MAX_SMEM_BOUNDARIES:
        raise ValueError(f"bucketize_packed: {nb} boundaries exceed one "
                         f"block's shared memory ({MAX_SMEM_BOUNDARIES})")
    out = torch.empty((nvals,), dtype=torch.int32, device=words.device)
    if nvals == 0:
        return out
    if nb == 0:
        return out.zero_()
    flags = ((2 if right else 0)
             | (TILED if tiled else PERSISTENT if nb > TILE else 0))
    lib, fn = _PACKED_ENTRY or _packed_entry()
    err = _build.run_on(words.get_device(), fn, boundaries.data_ptr(), nb,
                        words.data_ptr(), words.shape[0], int(bit_width),
                        int32_offset(offset), nvals, out.data_ptr(), flags,
                        int(max_blocks or 0), int(max_splitters))
    if err:
        _build.check(lib, err, "bucketize_packed_kernel",
                     "repro_bucketize_error_string")
    _build.count_launch("bucketize_packed_kernel", nb + nvals,
                        f"q={_build.pow2(nvals)} nb={_build.pow2(nb)} "
                        f"bits={int(bit_width)}",
                        4 * (nb + nwords_for(nvals, bit_width) + nvals),
                        boundaries=boundaries, words=words,
                        bit_width=int(bit_width), offset=int(offset),
                        nvals=nvals, right=bool(right))
    return out


def rle_decode_packed_kernel(words: torch.Tensor, bit_width: int, offset,
                             cap: int, starts: torch.Tensor,
                             ends: torch.Tensor, n: torch.Tensor, nrows: int,
                             fill=0, max_blocks: Optional[int] = None
                             ) -> torch.Tensor:
    """Decode an RLE column whose ``cap`` run values are packed to a dense
    int32 [nrows]; rows in gaps and in runs at or past ``n`` get ``fill``.
    ``max_blocks`` caps the grid; the output does not depend on it."""
    _check_words(words, bit_width, cap, "rle_decode_packed")
    for name, t in (("starts", starts), ("ends", ends)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or not t.is_contiguous() or t.dtype != torch.int32:
            raise TypeError(f"rle_decode_packed: {name} must be a contiguous "
                            "1-D int32 tensor")
        if t.shape[0] != cap or t.device != words.device:
            raise ValueError(f"rle_decode_packed: {name} must hold {cap} "
                             "slots on the words' device")
    if not isinstance(n, torch.Tensor) or n.numel() != 1 \
            or n.dtype != torch.int32 or n.device != words.device:
        raise TypeError("rle_decode_packed: n must be a one-element int32 "
                        "tensor on the words' device")
    if nrows < 0:
        raise ValueError(f"rle_decode_packed: nrows={nrows} < 0")
    if words.device.type == "cpu":
        return ref.ref_rle_decode_packed(words, bit_width, offset, cap, starts,
                                         ends, n, nrows, fill)
    if nrows == 0 or cap == 0:  # every row (if any) is a gap
        return torch.full((nrows,), torch.tensor(fill).to(torch.int32).item(),
                          dtype=torch.int32, device=words.device)
    bits = fill_bits(fill, torch.int32)
    out = torch.empty((nrows,), dtype=torch.int32, device=words.device)
    lib, _, fn = _ENTRIES or _entries()
    err = _build.run_on(words.get_device(), fn, words.data_ptr(),
                        words.shape[0], int(bit_width), int32_offset(offset),
                        starts.data_ptr(), ends.data_ptr(), n.data_ptr(), cap,
                        nrows, int32_offset(bits), out.data_ptr(),
                        int(max_blocks or 0))
    if err:
        _build.check(lib, err, "rle_decode_packed_kernel",
                     "repro_unpack_error_string")
    _build.count_launch("rle_decode_packed_kernel", 3 * cap + nrows,
                        f"rows={_build.pow2(nrows)} cap={_build.pow2(cap)} "
                        f"bits={int(bit_width)}",
                        # packed run values, starts, ends, n, rows
                        4 * (nwords_for(cap, bit_width) + 2 * cap + 1 + nrows),
                        words=words, bit_width=int(bit_width),
                        offset=int(offset), cap=cap, starts=starts, ends=ends,
                        n=n, nrows=nrows, fill=fill)
    return out
