"""Plain PyTorch versions of the port's kernels (correctness references).

Each CUDA kernel in this package must match its ``ref_<name>`` here
exactly for integer outputs and within tolerance for float reductions.
They are the functions the kernel wrappers run on CPU tensors, what
``chip_smoke.py`` holds each kernel against on the card, and the twins of
``repro.kernels.ref`` that the CPU tests hold against the JAX package.

Packed words travel as int32 tensors holding the uint32 bit patterns
(torch on the CPU has no uint32 shifts or gathers): the packed versions
widen them to int64 with ``& 0xFFFFFFFF`` and shift there.
"""
from __future__ import annotations

import torch


def ref_bucketize(boundaries: torch.Tensor, queries: torch.Tensor,
                  right: bool = True) -> torch.Tensor:
    """torch.bucketize semantics (paper §2.2), as int32:
    right=True  -> #{j : boundaries[j] <= q}  == searchsorted(side='right')
    right=False -> #{j : boundaries[j] <  q}  == searchsorted(side='left')

    Mixed dtypes promote as ``jnp.searchsorted`` does; NaN sorts above
    every number.
    """
    if boundaries.shape[0] == 0:
        return torch.zeros(queries.shape, dtype=torch.int32,
                           device=queries.device)
    dt = torch.promote_types(boundaries.dtype, queries.dtype)
    if dt == torch.bool:
        dt = torch.int32
    return torch.searchsorted(boundaries.to(dt).contiguous(),
                              queries.to(dt).contiguous(), right=right,
                              out_int32=True)


def ref_rle_decode(values: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor, n, nrows: int, fill=0) -> torch.Tensor:
    """Expand RLE runs to a dense [nrows] array; rows in gaps get ``fill``.

    The reference's formula with explicit clamping: the run of a row is the
    first run whose end is >= row, clamped to the last slot."""
    dev = values.device
    cap = ends.shape[0]
    fill_t = torch.tensor(fill).to(values.dtype)
    if cap == 0 or nrows == 0:
        return torch.full((nrows,), fill_t.item(), dtype=values.dtype,
                          device=dev)
    rows = torch.arange(nrows, dtype=torch.int32, device=dev)
    run = torch.searchsorted(ends.contiguous(), rows, right=False,
                             out_int32=True)
    run = torch.clamp(run, max=cap - 1)
    n = torch.as_tensor(n, dtype=torch.int32, device=dev)
    covered = (rows >= starts[run]) & (rows <= ends[run]) & (run < n)
    return torch.where(covered, values[run], fill_t.to(dev))


def ref_segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, reduce: str = "sum") -> torch.Tensor:
    """Segment reduction by id; ids outside [0, num_segments) are dropped.

    The ids need not be sorted. Sums accumulate in ``values.dtype`` with
    ``index_add_`` into a spare slot that takes the dropped rows."""
    g = num_segments
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < g), ids, g)
    if reduce == "sum":
        out = torch.zeros((g + 1,), dtype=values.dtype, device=values.device)
        return out.index_add_(0, ids, values)[:g]
    if reduce in ("max", "min"):
        init = float("-inf") if reduce == "max" else float("inf")
        out = torch.full((g + 1,), init, dtype=values.dtype,
                         device=values.device)
        out.scatter_reduce_(0, ids, values, "amax" if reduce == "max"
                            else "amin", include_self=True)
        return out[:g]
    raise ValueError(reduce)


def _extract(words: torch.Tensor, idx: torch.Tensor,
             bit_width: int) -> torch.Tensor:
    """Unsigned codes (int64) at positions ``idx`` of a packed stream.

    ``words`` holds the uint32 lanes as int32 bit patterns; value ``i``
    occupies bits ``[i*b, i*b + b)`` of the stream, little-endian within
    each lane (``repro.kernels.unpack._extract``). ``i*b`` is an int64
    product. Positions past the stream's end read clamped lanes and return
    garbage; callers slice or mask them away.
    """
    nwords = words.shape[0]
    lanes = words.to(torch.int64) & 0xFFFFFFFF
    bit = idx.to(torch.int64) * bit_width
    w = bit >> 5
    off = bit & 31
    lo = lanes[w.clamp(0, nwords - 1)] >> off
    # the straddle's contribution: the low ``off`` bits of the next lane,
    # placed above the 32 - off bits taken from this one (0 when off == 0)
    hi = lanes[(w + 1).clamp(0, nwords - 1)] & ((1 << off) - 1)
    return (lo | (hi << (32 - off))) & ((1 << bit_width) - 1)


def _to_signed(codes: torch.Tensor, offset) -> torch.Tensor:
    """``code + offset`` as an int32 wrap-add (the reference bitcasts the
    code to int32 and adds ``offset``): width-32 passthrough is exact."""
    v = (codes + int(offset)) & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(torch.int32)


def ref_unpack(words: torch.Tensor, bit_width: int, offset,
               nvals: int) -> torch.Tensor:
    """Expand a bit-packed stream to int32[nvals] (DESIGN.md §11): value i
    is bits [i*b, i*b+b) of the stream, plus ``offset`` with int32 wrap."""
    if nvals == 0:
        return torch.zeros((0,), dtype=torch.int32, device=words.device)
    idx = torch.arange(nvals, dtype=torch.int64, device=words.device)
    return _to_signed(_extract(words, idx, bit_width), offset)


def ref_bucketize_packed(boundaries: torch.Tensor, words: torch.Tensor,
                         bit_width: int, offset, nvals: int,
                         right: bool = True) -> torch.Tensor:
    """``bucketize(boundaries, unpack(words))`` as int32 counts."""
    return ref_bucketize(boundaries,
                         ref_unpack(words, bit_width, offset, nvals), right)


def ref_rle_decode_packed(words: torch.Tensor, bit_width: int, offset,
                          cap: int, starts: torch.Tensor, ends: torch.Tensor,
                          n, nrows: int, fill=0) -> torch.Tensor:
    """``rle_decode`` whose ``cap`` run values are packed in ``words``."""
    values = ref_unpack(words, bit_width, offset, cap)
    return ref_rle_decode(values, starts, ends, n, nrows, fill)


def worst_value(dtype: torch.dtype):
    """The rank a top-k pad slot carries: INT32_MIN or -inf."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def topk(values: torch.Tensor, k: int):
    """Top-k (descending) of a 1-D int32/float32 tensor: ``(vals[k],
    int32 idx[k])``, equal values at the lowest index first (the order of
    ``jax.lax.top_k`` and of ``repro.kernels.topk.topk_kernel``).

    A stable descending sort, not ``torch.topk``, whose tie order is not
    documented. Fewer than ``k`` values are padded, as the reference kernel
    pads its tile: pad slots carry the dtype's worst value and the indices
    past the end, so a real row holding that worst value still ranks
    first. Floats compare as numbers: -0.0 ties +0.0 (the sort key adds
    0.0, which maps -0.0 to +0.0 on every device's sort)."""
    n = values.shape[0]
    if n < k:
        pad = torch.full((k - n,), worst_value(values.dtype),
                         dtype=values.dtype, device=values.device)
        values = torch.cat([values, pad])
    key = values + 0.0 if values.dtype.is_floating_point else values
    order = torch.sort(key, descending=True, stable=True).indices[:k]
    return values[order], order.to(torch.int32)
