"""Cost model of the port's own program: FLOPs, bytes and collective
traffic of the aten ops it runs.

The reference parses XLA's compiled HLO text for the three roofline
inputs, per device of the mesh it compiled for. The port has no compiled
program: it runs eagerly, one aten op at a time. Its nearest meaning is
the ops themselves, recorded by a ``TorchDispatchMode`` (``Trace``) while
the port runs, on real or meta tensors alike, and costed by the
reference's accounting rules (``analyze``). On DTensors the trace records
one rank's program: the local ops on its blocks, with their local shapes,
and the collectives that move data between ranks (a DTensor
redistribution's ``_c10d_functional`` / ``_dtensor`` ops, and the
``c10d`` ops of ``launch.mesh``'s own ``all_gather`` / ``all_to_all``),
each once per call. What DTensor runs to work out a result's global shape
(its sharding propagation, on fake tensors) is no rank's work and is not
recorded.

  * **flops**: dots (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``dot``; ``einsum`` and ``matmul`` reach these) count 2 · result
    elements · K; pointwise ops 1 per result element; reductions their
    operand's elements; a softmax, the reference's lowering of it
    (max-reduce, subtract, exp, sum-reduce, divide), 5 per element.
  * **bytes**: operands (each distinct tensor once) plus result per op.
    An eager op is one HBM round trip, as a fusion is for XLA; so a chain
    of pointwise ops costs a round trip each, where XLA fuses it into one.
    A view (``view``, ``slice``, ``select``, ``transpose``, ``expand``, …)
    moves no bytes, as the reference's ``bitcast``; its consumer reads the
    sliced bytes, which is what the reference's stacked-operand rule bills
    per loop iteration. A gather (``index_select``, ``index``, ``gather``,
    ``embedding``) is twice its result plus its indices; a scatter
    (``index_add_``, ``index_copy_``, ``index_put_``, ``scatter``) twice
    its update; ``copy_`` reads its source and writes its destination; a
    fill writes its result; ``empty`` moves nothing.
  * **collectives**: the operand bytes of each c10d op, under the
    reference's names (``all-gather``, ``all-reduce``, …). A handle on a
    collective's result (``wait_tensor``, ``_wrap_tensor_autograd``)
    moves nothing, as a view.

Eager execution records every iteration of a layer loop as ops of its
own. The one loop whose iterations are too many to trace one by one is
sLSTM's time loop (one step a token: 4,096 or 32,768 a layer): under a
``Trace`` on the meta device, ``models.ssm`` runs one step inside
``Trace.repeat(n)`` with ``n`` the trip count, and every op recorded
there (FLOPs, bytes, collectives and their counts) counts ``n`` times in
``analyze``, the reference's loop trip-count multiplication
(``repro.launch.hlo_cost``'s ``while`` bodies).
"""
from __future__ import annotations

import contextlib
import functools
import math
import weakref
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

# c10d ops (process-group and functional forms) -> the reference's names
_COLLECTIVE_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-broadcast", "broadcast": "collective-broadcast",
    "shard_dim_alltoall": "all-to-all",  # DTensor's Shard(i) -> Shard(j)
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")
_DOTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
         "addmv": 1}  # -> index of the operand whose last dim is K
_SOFTMAX = {"_softmax": 5, "_log_softmax": 5}
_GATHERS = {"index_select", "index", "gather", "embedding"}
_SCATTERS = {"index_add", "index_add_", "index_copy", "index_copy_",
             "index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "slice_scatter", "select_scatter",
             "masked_scatter", "masked_scatter_"}
_FILLS = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "fill_", "zero_", "arange", "scalar_tensor", "new_zeros",
          "new_ones", "new_full"}
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}
# schemas that say a fresh tensor, where the result aliases its operand
_VIEWS = {"_unsafe_view", "wait_tensor", "_wrap_tensor_autograd"}


class Op(NamedTuple):
    """One recorded aten op: its packet name, kind, and the (shape,
    itemsize) of its distinct tensor operands and of its results."""
    name: str
    kind: str  # dot | pointwise | reduction | softmax | view | gather |
    #            scatter | copy | fill | alloc | collective | other
    ins: Tuple[Tuple[Tuple[int, ...], int], ...]
    outs: Tuple[Tuple[Tuple[int, ...], int], ...]
    times: int = 1  # how many times it runs (``Trace.repeat``)


@functools.lru_cache(maxsize=None)
def _op_info(func) -> Tuple[str, str, bool, Tuple[bool, ...]]:
    """(name, kind, whether its results are fresh storage, which of its
    positional arguments are operands) of an op, once an op."""
    name = func.overloadpacket.__name__
    kind = _kind(func, name)
    fresh = kind != "view" and not any(
        r.alias_info is not None and r.alias_info.is_write
        for r in func._schema.returns)
    # a collective's operands: what it sends, not the buffers it receives
    # into (``output*``; c10d's schemas carry no alias marks)
    sends = tuple(not (kind == "collective" and a.name.startswith("output"))
                  for a in func._schema.arguments)
    return name, kind, fresh, sends


def _kind(func, name: str) -> str:
    if func.namespace in _COLLECTIVE_NAMESPACES:
        if name in _COLLECTIVE_OF:
            return "collective"
        return "view" if name in _VIEWS else "other"
    if name in _DOTS:
        return "dot"
    if name in _VIEWS or any(r.alias_info is not None
                             and not r.alias_info.is_write
                             for r in func._schema.returns):
        return "view"
    if name in _SOFTMAX:
        return "softmax"
    if name in _GATHERS:
        return "gather"
    if name in _SCATTERS:
        return "scatter"
    if name in ("copy_", "copy"):
        return "copy"
    if name in _FILLS:
        return "fill"
    if name in _ALLOCS:
        return "alloc"
    if torch.Tag.pointwise in func.tags:
        return "pointwise"
    if torch.Tag.reduction in func.tags:
        return "reduction"
    return "other"


def _tensors(tree, out: list) -> list:
    """The tensors in an op's arguments or results (nested tuples, lists
    and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _sig(t: torch.Tensor) -> Tuple[Tuple[int, ...], int]:
    return tuple(t.shape), t.element_size()


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _in_fake_mode() -> bool:
    """A ``FakeTensorMode`` is active: DTensor's sharding propagation runs
    the op on global-shape fake tensors to learn its result's shape."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class Trace(TorchDispatchMode):
    """Records every aten op run inside it (``ops``), and the bytes of the
    storages its ops allocate that are alive at once: ``peak_live_bytes``
    is their most, over what was alive when the trace began (arguments are
    not counted). An op on DTensors is left to DTensor, whose local ops
    and collectives come back here: the trace is one rank's.

    ``repeat(n)`` scopes ops that run ``n`` times (a loop body traced
    once: ``models.ssm``'s sLSTM time loop)."""

    def __init__(self):
        super().__init__()
        self.times = 1
        self.ops: List[Op] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._refs: Dict[int, List[int]] = {}  # storage -> [refs, bytes]
        # id(weak reference to a result) -> (the reference, its storage)
        self._holders: Dict[int, Tuple[weakref.ref, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = _dtensor_type()
        if any(issubclass(t, dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_fake_mode():
            return out
        name, kind, fresh, sends = _op_info(func)
        operands = _tensors([a for a, s in zip(args, sends) if s], [])
        if kind != "collective":
            _tensors(kwargs, operands)
        seen, ins = set(), []
        for t in operands:
            if id(t) not in seen:
                seen.add(id(t))
                ins.append(_sig(t))
        outs = _tensors(out, [])
        self.ops.append(Op(name, kind, tuple(ins),
                           tuple(_sig(t) for t in outs), self.times))
        for t in outs:
            self._hold(t, fresh)
        return out

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Ops recorded inside count ``n`` times (nested scopes
        multiply); their allocations count once toward the peak."""
        outer = self.times
        self.times = outer * n
        try:
            yield self
        finally:
            self.times = outer

    def _hold(self, t: torch.Tensor, fresh: bool) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if fresh and key not in self._refs:
            self._refs[key] = [0, storage.nbytes()]
            self.live_bytes += storage.nbytes()
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        if key in self._refs:
            self._refs[key][0] += 1
            holder = weakref.ref(t, self._release)
            self._holders[id(holder)] = (holder, key)

    def _release(self, holder: weakref.ref) -> None:
        _, key = self._holders.pop(id(holder))
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live_bytes -= ref[1]
            del self._refs[key]


def active_trace():
    """The innermost ``Trace`` on this thread's dispatch-mode stack, or
    None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, Trace)), None)


def _nelems(shape) -> int:
    return math.prod(shape)


def _bytes(sigs) -> int:
    return sum(_nelems(s) * b for s, b in sigs)


def analyze(trace) -> Dict[str, Any]:
    """FLOPs, bytes and collective traffic of a ``Trace`` (or a list of
    its ``Op``s), under the reference's keys."""
    ops = trace.ops if isinstance(trace, Trace) else trace
    totals: Dict[str, Any] = {
        "flops": 0.0, "bytes": 0.0,
        "collective_bytes_by_type": {c: 0.0 for c in COLLECTIVES},
        "collective_count_by_type": {c: 0 for c in COLLECTIVES}}
    for op in ops:
        n = op.times
        res_b = _bytes(op.outs)
        if op.kind == "dot":
            k = op.ins[_DOTS[op.name]][0][-1]
            totals["flops"] += n * 2.0 * sum(_nelems(s) for s, _ in op.outs) * k
        elif op.kind == "pointwise":
            totals["flops"] += n * sum(_nelems(s) for s, _ in op.outs)
        elif op.kind == "reduction":
            totals["flops"] += n * (_nelems(op.ins[0][0]) if op.ins else 0)
        elif op.kind == "softmax":
            totals["flops"] += n * _SOFTMAX[op.name] * _nelems(op.ins[0][0])

        if op.kind in ("view", "alloc"):
            continue
        if op.kind == "gather":
            idx_b = _bytes(op.ins[1:])
            totals["bytes"] += n * (2 * res_b + idx_b)
        elif op.kind == "scatter":
            totals["bytes"] += n * 2 * _bytes(op.ins[-1:])
        elif op.kind == "copy":
            totals["bytes"] += n * (_bytes(op.ins[1:]) + res_b)
        elif op.kind == "fill":
            totals["bytes"] += n * res_b
        else:
            totals["bytes"] += n * (_bytes(op.ins) + res_b)

        if op.kind == "collective":
            ctype = _COLLECTIVE_OF[op.name]
            totals["collective_bytes_by_type"][ctype] += n * float(
                _bytes(op.ins) or res_b)
            totals["collective_count_by_type"][ctype] += n
    totals["collective_bytes_total"] = sum(
        totals["collective_bytes_by_type"].values())
    return totals
