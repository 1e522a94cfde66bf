"""Plain PyTorch versions of the port's kernels (correctness references).

Each CUDA kernel in this package must match its ``ref_<name>`` here
exactly for integer outputs and within tolerance for float reductions.
They are the functions the kernel wrappers run on CPU tensors, what
``chip_smoke.py`` holds each kernel against on the card, and the twins of
``repro.kernels.ref`` that the CPU tests hold against the JAX package.
``ref_unpack`` arrives with the packed-column slice.
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
