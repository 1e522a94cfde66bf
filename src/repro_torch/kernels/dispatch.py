"""Encoding-aware kernel dispatch policy (DESIGN.md §5), PyTorch port.

The query engine's three dominant primitives — ``bucketize`` (binary
search, the core of every §4 range algorithm), ``rle_decode`` (run
expansion) and ``segment_sum`` (group-by scatter-reduce) — each have a
hand-written CUDA kernel in this package and a plain PyTorch formulation.
This module is the single place that decides which one a call site gets.
The port runs eagerly, so the decision is made per call from host-side
facts: the policy, the tensors' device, dtypes and static shapes. It
never reads a device value, so routing never synchronises.

Policy resolution, in order:

  1. an explicit ``overrides(...)`` / ``set_policy(...)`` (tests, benches),
  2. environment variables at import (``REPRO_USE_KERNELS`` = ``1``/``0``/
     ``auto``, and the same ``REPRO_*`` size and feature knobs as the JAX
     package — docs/KNOBS.md is the canonical table),
  3. defaults: kernels exactly when the inputs are CUDA tensors.

Differences from ``repro.kernels.dispatch``:

  * ``use_kernels`` replaces ``use_pallas`` / ``interpret``: auto (None)
    means "the input tensors are on CUDA". Forced on, a CPU call still
    reaches the kernel wrapper, which runs its plain version for CPU
    tensors — that is how the CPU tests exercise the kernel route.
  * ``bucketize_min_queries``, ``rle_decode_min_rows``,
    ``unpack_min_vals`` and ``topk_min_rows`` keep their fields and knobs,
    but default to 0: the reference's values were tuned on a TPU, and
    until an H100 measurement says otherwise every eligible call on the
    card launches a kernel.
  * ``bucketize_max_vmem_boundaries`` keeps its name and knob; its default
    means "fits one block's shared memory" (``MAX_SMEM_BOUNDARIES``).
    Longer boundary lists take ``bucketize_count_kernel`` (bisection
    through L2).
  * Calls the kernels cannot take go to a PyTorch formulation that mirrors
    the reference's XLA route: dtypes other than int32/float32 (e.g. the
    int8/int16 centered plain columns), G above the kernel's 4096, integer
    COUNT sums. Each decision is recorded by ``_route``.
  * Packed queries and packed run values (``PackedColumn``) route to the
    fused kernels of ``kernels/unpack.py``. The reference's
    ``MAX_VMEM_WORDS`` ceiling (2M words, a TPU VMEM budget) is gone: the
    H100 kernels read the words through L2.
  * ``topk`` takes ``topk_kernel`` (``kernels/topk.py``) for int32 /
    float32 keys and ``1 <= k <= min(topk_max_k, MAX_KERNEL_K)``; other
    calls take the plain stable sort (``ref.topk``), where the reference
    takes ``lax.top_k``. Both order ties by the lowest index.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch

from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels.bucketize import (
    MAX_SMEM_BOUNDARIES,
    bucketize_count_kernel,
    bucketize_kernel,
)
from repro_torch.kernels.rle_decode import rle_decode_kernel
from repro_torch.kernels.segment_reduce import MAX_SEGMENTS, segment_sum_kernel
from repro_torch.kernels.topk import MAX_KERNEL_K, topk_kernel
from repro_torch.kernels.unpack import (
    bucketize_packed_kernel,
    rle_decode_packed_kernel,
    unpack_kernel,
)

# dtypes the 1-D kernels handle natively (4-byte words)
_KERNEL_DTYPES = (torch.int32, torch.float32)

MAX_MATMUL_SEGMENTS = MAX_SEGMENTS  # the reference's name for the G bound


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """Device + size-threshold routing policy. All fields host-static."""

    use_kernels: Optional[bool] = None  # None = auto: inputs on CUDA
    # bucketize: below this many queries the library searchsorted is used.
    bucketize_min_queries: int = 0
    # boundaries up to this count stage in shared memory; longer lists
    # take the global-memory route
    bucketize_max_vmem_boundaries: int = MAX_SMEM_BOUNDARIES
    # rle_decode: below this many rows the scatter+cumsum sweep is used.
    rle_decode_min_rows: int = 0
    # segment_sum: the kernel keeps eight [G] float arrays in shared memory.
    segment_sum_max_groups: int = MAX_MATMUL_SEGMENTS
    # sort-free grouping (groupby.grouping): scatter over the mixed-radix
    # key domain instead of argsort-unique, when every group key has
    # ingest-recorded domain metadata and the product domain fits.
    enable_sort_free: bool = True
    sort_free_max_domain: int = 1 << 20
    # top-k / entry ordering (core/order.py): below topk_min_rows rows the
    # plain stable sort is used.
    topk_min_rows: int = 0
    topk_max_k: int = MAX_KERNEL_K
    enable_entry_order: bool = True
    # bit packing (DESIGN.md §11)
    enable_pack: bool = True
    pack_max_bits: int = 24
    unpack_min_vals: int = 0
    # streamed out-of-core pipeline (core/stream.py)
    prefetch_depth: int = 2
    # query-serving layer (core/serve.py, a later port slice)
    serve_budget_bytes: Optional[int] = None
    plan_cache_size: int = 32
    serve_max_batch: int = 8
    # telemetry (core/telemetry.py): span/trace recording.
    enable_trace: bool = False
    trace_buffer_events: int = 1 << 16
    # fault tolerance (core/faults.py)
    enable_fault_injection: bool = False
    transfer_retries: int = 3
    transfer_backoff_ms: float = 10.0

    def kernels_enabled(self, *tensors) -> bool:
        """Whether calls on ``tensors`` take the kernel route."""
        if self.use_kernels is not None:
            return self.use_kernels
        return all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


def _env_tristate(env, name: str) -> Optional[bool]:
    raw = env.get(name, "auto").strip().lower()
    if raw in ("1", "true", "yes", "on"):
        return True
    if raw in ("0", "false", "no", "off"):
        return False
    return None  # auto


def _env_int(env, name: str, default: int) -> int:
    raw = env.get(name)
    if raw is None:
        return default
    return int(raw)


def _env_opt_int(env, name: str, default: Optional[int]) -> Optional[int]:
    raw = env.get(name)
    if raw is None or raw.strip().lower() in ("", "none", "auto"):
        return default
    return int(raw)


def _env_float(env, name: str, default: float) -> float:
    raw = env.get(name)
    if raw is None:
        return default
    return float(raw)


def policy_from_env(env=None) -> DispatchPolicy:
    """Build a policy from environment variables (see module docstring)."""
    env = os.environ if env is None else env
    base = DispatchPolicy()
    sort_free = _env_tristate(env, "REPRO_SORT_FREE")
    entry_order = _env_tristate(env, "REPRO_ENTRY_ORDER")
    pack = _env_tristate(env, "REPRO_PACK")
    return DispatchPolicy(
        use_kernels=_env_tristate(env, "REPRO_USE_KERNELS"),
        bucketize_min_queries=_env_int(
            env, "REPRO_BUCKETIZE_MIN_QUERIES", base.bucketize_min_queries),
        bucketize_max_vmem_boundaries=_env_int(
            env, "REPRO_BUCKETIZE_MAX_VMEM_BOUNDARIES",
            base.bucketize_max_vmem_boundaries),
        rle_decode_min_rows=_env_int(
            env, "REPRO_RLE_DECODE_MIN_ROWS", base.rle_decode_min_rows),
        segment_sum_max_groups=_env_int(
            env, "REPRO_SEGSUM_MAX_GROUPS", base.segment_sum_max_groups),
        enable_sort_free=True if sort_free is None else sort_free,
        sort_free_max_domain=_env_int(
            env, "REPRO_SORT_FREE_MAX_DOMAIN", base.sort_free_max_domain),
        topk_min_rows=_env_int(env, "REPRO_TOPK_MIN_ROWS", base.topk_min_rows),
        topk_max_k=_env_int(env, "REPRO_TOPK_MAX_K", base.topk_max_k),
        enable_entry_order=True if entry_order is None else entry_order,
        enable_pack=True if pack is None else pack,
        pack_max_bits=_env_int(env, "REPRO_PACK_MAX_BITS", base.pack_max_bits),
        unpack_min_vals=_env_int(env, "REPRO_UNPACK_MIN_VALS",
                                 base.unpack_min_vals),
        prefetch_depth=_env_int(env, "REPRO_PREFETCH_DEPTH",
                                base.prefetch_depth),
        serve_budget_bytes=_env_opt_int(env, "REPRO_SERVE_BUDGET_BYTES",
                                        base.serve_budget_bytes),
        plan_cache_size=_env_int(env, "REPRO_PLAN_CACHE_SIZE",
                                 base.plan_cache_size),
        serve_max_batch=_env_int(env, "REPRO_SERVE_MAX_BATCH",
                                 base.serve_max_batch),
        enable_trace=bool(_env_tristate(env, "REPRO_TRACE")),
        trace_buffer_events=_env_int(env, "REPRO_TRACE_BUFFER",
                                     base.trace_buffer_events),
        enable_fault_injection=bool(_env_tristate(env, "REPRO_FAULTS")),
        transfer_retries=_env_int(env, "REPRO_TRANSFER_RETRIES",
                                  base.transfer_retries),
        transfer_backoff_ms=_env_float(env, "REPRO_TRANSFER_BACKOFF_MS",
                                       base.transfer_backoff_ms),
    )


_POLICY: DispatchPolicy = policy_from_env()


def policy() -> DispatchPolicy:
    return _POLICY


def set_policy(p: DispatchPolicy) -> None:
    global _POLICY
    _POLICY = p


@contextlib.contextmanager
def overrides(**kw):
    """Temporarily replace policy fields (tests / benchmarks)."""
    old = _POLICY
    set_policy(dataclasses.replace(old, **kw))
    try:
        yield _POLICY
    finally:
        set_policy(old)


# ---------------------------------------------------------------------------
# Routed primitives
# ---------------------------------------------------------------------------


def _route(primitive: str, path: str, reason: str) -> None:
    if not _POLICY.enable_trace:
        return
    from repro_torch.core import telemetry
    telemetry.record_route(primitive, path, reason)


def _kernel_ok(*tensors) -> bool:
    return all(t.dtype in _KERNEL_DTYPES for t in tensors)


def _is_packed(x) -> bool:
    from repro_torch.core.encodings import PackedColumn
    return isinstance(x, PackedColumn)


def _off_reason(pol: DispatchPolicy) -> str:
    return "kernels off" if pol.use_kernels is False else "inputs not on CUDA"


def unpack(packed) -> torch.Tensor:
    """Expand a ``PackedColumn`` buffer leaf to its logical int32 values:
    the CUDA ``unpack_kernel`` when the policy allows, else the plain
    ``ref_unpack``."""
    pol = policy()
    n, words = packed.nrows, packed.words
    on = pol.kernels_enabled(words)
    if on and n >= pol.unpack_min_vals and words.shape[0] > 0:
        _route("unpack", "kernel",
               f"n={n}>=unpack_min_vals={pol.unpack_min_vals}")
        return unpack_kernel(words, packed.bit_width, packed.offset, n)
    _route("unpack", "torch",
           _off_reason(pol) if not on
           else f"n={n}<unpack_min_vals={pol.unpack_min_vals}"
           if n < pol.unpack_min_vals else "empty stream")
    return ref_mod.ref_unpack(words, packed.bit_width, packed.offset, n)


def bucketize(boundaries: torch.Tensor, queries, right: bool = True
              ) -> torch.Tensor:
    """torch.bucketize == searchsorted (right=True -> side='right'), int32.

    ``queries`` may be a ``PackedColumn``: the kernel route then runs the
    fused unpack->bisect kernel (codes extracted in registers, never
    written to device memory); otherwise the queries are unpacked first."""
    pol = policy()
    if _is_packed(queries):
        n_b, n_q = boundaries.shape[0], queries.nrows
        words = queries.words
        on = pol.kernels_enabled(boundaries, words)
        if (on and n_b > 0 and n_q >= pol.bucketize_min_queries
                and words.shape[0] > 0 and boundaries.dtype == torch.int32):
            smem = min(pol.bucketize_max_vmem_boundaries, MAX_SMEM_BOUNDARIES)
            _route("bucketize", "kernel_packed_fused",
                   f"n_q={n_q}>=bucketize_min_queries="
                   f"{pol.bucketize_min_queries}, n_b={n_b} "
                   + ("fits shared memory" if n_b <= smem else "through L2"))
            return bucketize_packed_kernel(
                boundaries.contiguous(), words, queries.bit_width,
                queries.offset, n_q, right, global_route=n_b > smem)
        queries = unpack(queries)
    n_b, n_q = boundaries.shape[0], queries.shape[0]
    on = pol.kernels_enabled(boundaries, queries)
    if (on and n_b > 0 and n_q >= pol.bucketize_min_queries
            and boundaries.dtype == queries.dtype
            and _kernel_ok(boundaries, queries)):
        b, q = boundaries.contiguous(), queries.contiguous()
        if n_b <= min(pol.bucketize_max_vmem_boundaries, MAX_SMEM_BOUNDARIES):
            _route("bucketize", "kernel",
                   f"n_q={n_q}>=bucketize_min_queries="
                   f"{pol.bucketize_min_queries}, n_b={n_b} fits shared "
                   "memory")
            return bucketize_kernel(b, q, right)
        _route("bucketize", "count_kernel",
               f"n_b={n_b}>bucketize_max_vmem_boundaries="
               f"{min(pol.bucketize_max_vmem_boundaries, MAX_SMEM_BOUNDARIES)}")
        return bucketize_count_kernel(b, q, right)
    _route("bucketize", "torch",
           _off_reason(pol) if not on
           else f"n_q={n_q}<bucketize_min_queries={pol.bucketize_min_queries}"
           if n_q < pol.bucketize_min_queries
           else "dtype/empty boundaries")
    return ref_mod.ref_bucketize(boundaries, queries, right)


def maybe_rle_decode(values, starts, ends, n, nrows: int, fill=0):
    """Kernel-decoded dense [nrows] tensor, or None when the policy routes
    to the caller's formulation (the O(n) scatter+cumsum sweep in
    ``encodings.decode_rle_values``).

    ``values`` may be a ``PackedColumn``: the kernel route then extracts
    run values straight from the packed words (no unpacked value buffer
    in device memory)."""
    pol = policy()
    packed = _is_packed(values)
    on = pol.kernels_enabled(values.words if packed else values, starts, ends)
    if not (on and nrows >= pol.rle_decode_min_rows and starts.shape[0] > 0
            and starts.dtype == torch.int32 and ends.dtype == torch.int32):
        _route("rle_decode", "torch",
               _off_reason(pol) if not on
               else f"nrows={nrows}<rle_decode_min_rows="
               f"{pol.rle_decode_min_rows}"
               if nrows < pol.rle_decode_min_rows else "dtype/empty runs")
        return None
    n = torch.as_tensor(n, dtype=torch.int32, device=starts.device)
    if packed:
        _route("rle_decode", "kernel_packed_fused",
               f"nrows={nrows}>=rle_decode_min_rows={pol.rle_decode_min_rows}")
        return rle_decode_packed_kernel(
            values.words, values.bit_width, values.offset, starts.shape[0],
            starts.contiguous(), ends.contiguous(), n, nrows, fill)
    if not _kernel_ok(values):
        _route("rle_decode", "torch", f"value dtype {values.dtype} not routed")
        return None
    _route("rle_decode", "kernel",
           f"nrows={nrows}>=rle_decode_min_rows={pol.rle_decode_min_rows}")
    return rle_decode_kernel(values.contiguous(), starts.contiguous(),
                             ends.contiguous(), n, nrows, fill)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment sum; out-of-range ids (capacity padding) contribute 0.

    The deterministic kernel when the policy allows and G fits its shared
    memory; an ``index_add_`` otherwise. Only float32 routes to the kernel
    (integer callers — COUNT — keep exact integer arithmetic)."""
    pol = policy()
    on = pol.kernels_enabled(values, segment_ids)
    limit = min(pol.segment_sum_max_groups, MAX_SEGMENTS)
    if (on and values.dtype == torch.float32
            and segment_ids.dtype == torch.int32
            and 0 < num_segments <= limit and values.shape[0] > 0):
        _route("segment_sum", "kernel",
               f"G={num_segments}<=segment_sum_max_groups={limit}")
        return segment_sum_kernel(values.contiguous(),
                                  segment_ids.contiguous(), num_segments)
    _route("segment_sum", "torch_scatter",
           _off_reason(pol) if not on
           else f"dtype {values.dtype} keeps exact scatter arithmetic"
           if values.dtype != torch.float32
           else f"G={num_segments} outside (0, segment_sum_max_groups="
           f"{limit}]")
    return ref_mod.ref_segment_reduce(values, segment_ids, num_segments)


def topk(values: torch.Tensor, k: int):
    """Top-k (descending) of a 1-D rank-key tensor: ``(vals[k], idx[k])``.

    Ties resolve to the lowest index on both routes (pandas-stable
    descending order); ascending callers flip the rank key (order.py).
    ``topk_kernel`` when the policy allows and (rows, k) clear the
    thresholds, else the plain stable sort ``ref.topk``."""
    pol = policy()
    rows = values.shape[0]
    on = pol.kernels_enabled(values)
    k_max = min(pol.topk_max_k, MAX_KERNEL_K)
    if (on and rows >= pol.topk_min_rows and 1 <= k <= k_max
            and _kernel_ok(values)):
        _route("topk", "kernel",
               f"rows={rows}>=topk_min_rows={pol.topk_min_rows}, "
               f"k={k}<=topk_max_k={k_max}")
        return topk_kernel(values.contiguous(), k)
    _route("topk", "torch",
           _off_reason(pol) if not on
           else f"rows={rows}<topk_min_rows={pol.topk_min_rows}"
           if rows < pol.topk_min_rows
           else f"k={k} outside kernel range" if not 1 <= k <= k_max
           else f"dtype {values.dtype} not routed")
    return ref_mod.topk(values, k)
