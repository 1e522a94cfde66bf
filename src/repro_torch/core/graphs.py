"""CUDA graphs of the served per-partition programs (DESIGN.md §13).

The shared scan of ``core/serve.py`` runs one program a (query,
partition). Run eagerly, a program is a few hundred launches from
Python, so the drain thread launching them, not the device, sets the pace.
``ProgramGraphs`` captures each program once as a ``torch.cuda.CUDAGraph``
and replays it:

  * The key is (plan entry, partition layout, key-set capacities,
    routes). The layout is every leaf's shape and dtype plus the tree's
    host metadata (encoding types, ``nrows``, bit widths, offsets) and
    the partition's real row count; the routes are the dispatch policy's
    fields that pick a kernel or a plain route (``ROUTE_FIELDS``). A
    captured program bakes all of them in. The graphs hang on the
    server's ``PlanEntry``, whose signature pins the literals.
  * A key's first sighting runs eagerly (the warm-up: kernels built and
    loaded, the allocator's blocks cached), its second captures, later
    ones replay.
  * Fixed input addresses: ONE static slot a server, a byte buffer as
    large as its largest partition's tree. Each layout's leaves are views
    of it at fixed offsets, and the partition's device tree is copied in
    on the compute stream before each replay; a query's join and
    semi-join key sets go into static buffers of their capacities the
    same way. The slot's bytes are part of the server's device budget.
  * A replay's partial lives in the graph's own buffers, which the next
    replay of any graph of the pool may overwrite, so it leaves for
    pinned host memory at once, on the compute stream.
  * Every graph of a server allocates from one private pool; replays run
    one at a time on the compute stream. The pool's reserved bytes are
    device memory beside the budget, reported as ``pool_bytes``.
  * The kernels' launch counts and ``kernel`` instants, and the routing
    records, are booked on every replay, not at capture
    (``kernels._build.tape``): a replay books what its capture held back.
  * Capture runs on a side stream in ``thread_local`` error mode: the
    prefetch ring's worker thread keeps copying on the copy stream
    meanwhile. A capture that fails for any reason (an operation that
    synchronises, an allocation that fails) leaves its key eager for
    good, counted in ``fallbacks``; the program then runs eagerly and the
    query is answered.

Off CUDA nothing is captured: every program runs eagerly. Each program
counts once in ``captures`` (a capture and its first replay),
``replays`` or ``eager``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import telemetry
from repro_torch.core.encodings import map_tensors, tensor_leaves
from repro_torch.kernels import _build, dispatch

SLOT_ALIGN = 512  # bytes: the caching allocator's block alignment
_SEEN = "seen"  # the key's first sighting ran eagerly
_EAGER = "eager"  # the key's capture failed: it runs eagerly for good
# the dispatch policy's fields that pick a kernel or a plain route, or a
# grouping, ordering or unpacking path: a capture bakes the routes in
ROUTE_FIELDS = ("use_kernels", "bucketize_min_queries",
                "bucketize_max_vmem_boundaries", "rle_decode_min_rows",
                "segment_sum_max_groups", "enable_sort_free",
                "sort_free_max_domain", "topk_min_rows", "topk_max_k",
                "enable_entry_order", "enable_pack", "pack_max_bits",
                "unpack_min_vals")


def layout_key(tree) -> str:
    """Everything in ``tree`` that a captured program bakes in: its repr
    with each tensor replaced by its shape and dtype. A dataclass's repr
    names its type and every field, and ``5`` and ``5.0`` (which promote
    differently) print apart."""
    return repr(map_tensors(lambda t: (tuple(t.shape), t.dtype), tree))


def route_key(pol: dispatch.DispatchPolicy) -> tuple:
    return tuple(getattr(pol, f) for f in ROUTE_FIELDS)


def _span(t: torch.Tensor) -> int:
    """Bytes a leaf takes in the slot, rounded up to ``SLOT_ALIGN``."""
    nbytes = t.numel() * t.element_size()
    return -(-nbytes // SLOT_ALIGN) * SLOT_ALIGN


def slot_nbytes(tree) -> int:
    """Bytes of ``tree``'s leaves laid out in a slot."""
    return sum(_span(t) for t in tensor_leaves(tree))


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])`` on the current stream, one ``_foreach_copy_``
    a dtype."""
    groups: Dict[torch.dtype, Tuple[list, list]] = {}
    for d, s in zip(dst, src):
        if d.numel():
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


@dataclasses.dataclass(eq=False)
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    keys: tuple  # the capture's static key-set buffers
    outputs: object  # the partial, in the pool's memory
    # the launch and route records the capture held back, booked on
    # every replay
    taped: list = dataclasses.field(default_factory=list)


class ProgramGraphs:
    """The CUDA graphs of one server's per-partition programs, their static
    input slot and their memory pool (see the module's docstring)."""

    def __init__(self, table, device: torch.device):
        self.device = device
        self.enabled = device.type == "cuda"
        parts = table.partitions
        self._layouts = [layout_key((p.table.columns, p.rows)) for p in parts]
        self.slot_nbytes = (max((slot_nbytes(p.table.columns) for p in parts),
                                default=0) if self.enabled else 0)
        self._slot: Optional[torch.Tensor] = None
        self._views: Dict[str, tuple] = {}  # layout -> (tree, leaves)
        self._pool = None
        self._pools: List[tuple] = []  # every pool this server made
        self._live = weakref.WeakSet()  # the pool's graphs still alive
        self._stream = None
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.fallbacks = 0
        self.last_error: Optional[str] = None  # the last failed capture's

    def stats(self) -> Dict[str, int]:
        return {"captures": self.captures, "replays": self.replays,
                "eager": self.eager, "fallbacks": self.fallbacks,
                "slot_bytes": self.slot_nbytes,
                "pool_bytes": self.pool_bytes()}

    def pool_bytes(self) -> int:
        """Device bytes the allocator holds reserved for this server's
        graph pools, free blocks included."""
        if not self._pools:
            return 0
        pools = set(self._pools)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)

    def release(self) -> None:
        """Drop the slot (the graphs go with their plan entries)."""
        self._slot = None
        self._views.clear()

    def run(self, entry, pid: int, cols, key_sets, rows: int):
        """``entry.program(cols, key_sets, rows)`` as the key's sighting
        decides; returns ``(partial, mode)``, ``mode`` one of ``replay``,
        ``capture`` or ``eager``. A graph's partial is already on its way
        to pinned host memory."""
        if not self.enabled:
            self.eager += 1
            return entry.program(cols, key_sets, rows), "eager"
        key = (self._layouts[pid], layout_key(key_sets),
               route_key(dispatch.policy()))
        state = entry.graphs.get(key)
        if state is None or state is _EAGER:
            entry.graphs.setdefault(key, _SEEN)
            self.eager += 1
            return entry.program(cols, key_sets, rows), "eager"
        if state is _SEEN:
            try:
                with _build.tape() as taped:
                    state = self._capture(entry.program, key[0], cols,
                                          key_sets, rows)
                state.taped = taped
            except Exception as exc:  # noqa: BLE001 - eager for good
                entry.graphs[key] = _EAGER
                self.fallbacks += 1
                self.last_error = f"{type(exc).__name__}: {exc}"
                telemetry.record_fault("graph_capture", part=pid,
                                       error=type(exc).__name__)
                self.eager += 1
                return entry.program(cols, key_sets, rows), "eager"
            entry.graphs[key] = state
            self.captures += 1
            mode = "capture"
        else:
            self._fill(key[0], cols, state.keys, key_sets)
            self.replays += 1
            mode = "replay"
        state.graph.replay()
        _build.play(state.taped)
        return map_tensors(lambda t: t.to("cpu", non_blocking=True),
                           state.outputs), mode

    def _slot_tree(self, layout: str, cols):
        """The views of the slot that stand for a tree of ``layout``."""
        got = self._views.get(layout)
        if got is None:
            views, off = [], 0
            for t in tensor_leaves(cols):
                nbytes = t.numel() * t.element_size()
                views.append(self._slot[off:off + nbytes].view(t.dtype)
                             .view(t.shape))
                off += _span(t)
            it = iter(views)
            got = self._views[layout] = (map_tensors(lambda t: next(it), cols),
                                         views)
        return got

    def _fill(self, layout: str, cols, keys, key_sets) -> None:
        """Copy a partition's tree into the slot and a query's key sets into
        the graph's key buffers, on the current (compute) stream."""
        _, views = self._slot_tree(layout, cols)
        _copy_into(views + tensor_leaves(keys),
                   tensor_leaves(cols) + tensor_leaves(key_sets))

    def _capture(self, program, layout: str, cols, key_sets, rows: int
                 ) -> _Graph:
        dev = self.device
        if self._slot is None:
            self._slot = torch.empty((self.slot_nbytes,), dtype=torch.uint8,
                                     device=dev)
            self._stream = torch.cuda.Stream(dev)
        if not self._live:
            # a pool whose graphs have all gone (their plan entries were
            # evicted) takes no new capture: the allocator refuses to share
            # a pool nothing holds any more
            self._pool = torch.cuda.graph_pool_handle()
            self._pools.append(tuple(self._pool))
        tree, _ = self._slot_tree(layout, cols)
        keys = map_tensors(torch.empty_like, key_sets)
        self._fill(layout, cols, keys, key_sets)
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = program(tree, keys, rows)
            except Exception:
                with contextlib.suppress(Exception):  # ends a failed capture
                    graph.capture_end()
                raise
            graph.capture_end()
        cur.wait_stream(self._stream)
        made = _Graph(graph, keys, outputs)
        self._live.add(made)
        return made
