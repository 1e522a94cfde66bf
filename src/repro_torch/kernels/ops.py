"""Explicit-choice API for the port's kernels (tests, microbenchmarks).

``use_kernel=True`` calls the CUDA kernel wrappers (which run their plain
versions for CPU tensors); ``use_kernel=False`` calls the plain versions
in ``ref.py`` on any device. The query pipeline itself routes through
``repro_torch.kernels.dispatch``.

Inputs may be tensors (their device is kept) or host arrays, which are
placed on ``device`` — ``None`` means the CUDA device, and raises when
there is none. Degenerate shapes (empty boundaries / queries / values,
zero rows or segments) take the plain path, as ``repro.kernels.ops`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import as_tensor
from repro_torch.kernels import ref
from repro_torch.kernels.bucketize import (
    MAX_SMEM_BOUNDARIES,
    bucketize_count_kernel,
    bucketize_kernel,
)
from repro_torch.kernels.rle_decode import rle_decode_kernel
from repro_torch.kernels.segment_reduce import MAX_SEGMENTS, segment_sum_kernel
from repro_torch.kernels.topk import topk_kernel
from repro_torch.kernels.unpack import unpack_kernel


def bucketize(boundaries, queries, right: bool = True, use_kernel: bool = False,
              device=None) -> torch.Tensor:
    b = as_tensor(boundaries, device if not isinstance(boundaries, torch.Tensor)
                  else None)
    q = as_tensor(queries, b.device)
    if not use_kernel or b.shape[0] == 0 or q.shape[0] == 0:
        return ref.ref_bucketize(b, q, right)
    if b.shape[0] <= MAX_SMEM_BOUNDARIES:
        return bucketize_kernel(b, q, right)
    return bucketize_count_kernel(b, q, right)


def rle_decode(values, starts, ends, n, nrows: int, fill=0,
               use_kernel: bool = False, device=None) -> torch.Tensor:
    v = as_tensor(values, device if not isinstance(values, torch.Tensor)
                  else None)
    s = as_tensor(starts, v.device, torch.int32)
    e = as_tensor(ends, v.device, torch.int32)
    n = torch.as_tensor(n, dtype=torch.int32, device=v.device)
    if nrows == 0:
        return torch.zeros((0,), dtype=v.dtype, device=v.device)
    if v.shape[0] == 0:  # no run capacity at all: every row is a gap
        return torch.full((nrows,), torch.tensor(fill).to(v.dtype).item(),
                          dtype=v.dtype, device=v.device)
    if not use_kernel:
        return ref.ref_rle_decode(v, s, e, n, nrows, fill)
    return rle_decode_kernel(v, s, e, n, nrows, fill)


def segment_reduce(values, segment_ids, num_segments: int, reduce: str = "sum",
                   use_kernel: bool = False, device=None) -> torch.Tensor:
    v = as_tensor(values, device if not isinstance(values, torch.Tensor)
                  else None)
    ids = as_tensor(segment_ids, v.device, torch.int32)
    if (not use_kernel or reduce != "sum" or num_segments > MAX_SEGMENTS
            or num_segments == 0 or v.shape[0] == 0):
        return ref.ref_segment_reduce(v, ids, num_segments, reduce)
    return segment_sum_kernel(v.to(torch.float32), ids, num_segments)


def unpack(words, bit_width: int, offset, nvals: int, use_kernel: bool = False,
           device=None) -> torch.Tensor:
    """Expand a packed stream to int32[nvals]. Host words (uint32 lanes, as
    ``compress.pack_array`` gives them) cross as the same bit patterns
    viewed as int32."""
    if isinstance(words, torch.Tensor):
        w = words
    else:
        w = as_tensor(np.ascontiguousarray(words).view(np.int32), device)
    if not use_kernel or nvals == 0:
        return ref.ref_unpack(w, bit_width, offset, nvals)
    return unpack_kernel(w.contiguous(), bit_width, offset, nvals)


def topk(values, k: int, use_kernel: bool = False, device=None):
    """Top-k (descending) of a 1-D int32/float32 array: ``(vals[k],
    int32 idx[k])``, ties to the lowest index."""
    v = as_tensor(values, device if not isinstance(values, torch.Tensor)
                  else None)
    if not use_kernel:
        return ref.topk(v, k)
    return topk_kernel(v.contiguous(), k)
