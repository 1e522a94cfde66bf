"""Meshes of the port: the production topologies as shapes, and real
``torch.distributed`` device meshes for the sharded code paths.

The reference builds ``jax`` meshes of the production topology (TPU v5e):

  single-pod : (16, 16)      axes ("data", "model")         — 256 chips
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")  — 512 chips

Batch shards over ("pod", "data"); model-parallel dims over "model".
The sharding rules (``distributed/sharding.py``) read only a mesh's axis
names and sizes, so ``make_production_mesh`` returns a ``ShapeMesh``,
that shape and nothing more, as the reference's tests duck-type one.
``fake_device_mesh`` turns it into a ``DeviceMesh`` of that many ranks on
PyTorch's ``fake`` backend, in this one process: rank 0 of it runs the
program on its own local blocks (meta tensors), and every collective is
issued and answered without moving data. That is the dry run's view of
one device of the production mesh (``launch/dryrun.py``).

A real mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group (``make_mesh_compat``).
``make_host_mesh`` is the (1, 1) mesh of one device: on the card unless the
caller asks for the CPU, in a world of one that it sets up itself when no
process group exists, through an in-process ``HashStore`` (no address, no
network): NCCL on the card, gloo only on the CPU.

``activate_mesh`` / ``abstract_mesh_compat`` set and read an ambient mesh
(a context variable). ``shard_map_compat`` runs a function on each rank's
local block with the mesh ambient, so ``axis_group(name)`` inside it gives
the process group of a mesh axis: torch's SPMD form of the reference's
``shard_map`` with named axes, gradients included; ``all_gather``,
``reduce_scatter`` and ``all_to_all`` are the tiled ``lax`` collectives
inside it, with their gradients (an all-gather's is a reduce-scatter and
the reverse, as in the reference). ``with_sharding_constraint`` is
``jax.lax``'s: a DTensor is redistributed, a plain tensor passes. The
reference's jax-version shims (``AxisType.Auto``, ``set_mesh`` against
the legacy ``with mesh:``, ``jax.shard_map`` against
``jax.experimental``) have no torch meaning and are not kept; the names
are.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of them, or None.
    A one-name tuple becomes the bare name, as jax's spec stores it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class ShapeMesh:
    """A mesh as its axis names and sizes only: what the sharding rules
    read (``axis_names``, ``shape[axis]``, ``size``)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} has {len(shape)} "
                             f"dims, axes {tuple(axes)} {len(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``ShapeMesh``, a ``DeviceMesh`` or any mesh
    with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # DeviceMesh: shape is a tuple
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _ensure_world(device: torch.device) -> None:
    """A world of one through an in-process store when no process group
    exists: NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str],
                     device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the ranks
    of the default process group (set up as a world of one when there is
    none), on the card unless ``device`` is the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    _ensure_world(device)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the world has {dist.get_world_size()}")
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_device_mesh(mesh: ShapeMesh):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over a world of
    ``mesh.size`` ranks on the ``fake`` backend, this process being rank 0,
    for the ``with`` body; the world is destroyed on exit, so a real world
    (NCCL, gloo) can be set up afterwards in the same process. A world of
    ``mesh.size`` that already exists is used as it is and kept.

    The mesh's device type is ``cpu``, with or without a card: DTensor
    works out a result's shape on fake tensors of the mesh's device type,
    and a CPU build of PyTorch cannot run that for a backward on ``cuda``
    ones. On a ``cpu``
    mesh DTensor moves a block from one split dim to another
    (``Shard(i)`` -> ``Shard(j)``) as an all-gather and a slice, where a
    card mesh issues an all-to-all of the same operand. The fake backend
    and its ``FakeStore`` come from PyTorch's private module
    ``torch.testing._internal.distributed.fake_pg``, which registers the
    backend (torch 2.11 and 2.13 alike)."""
    from torch.distributed.device_mesh import init_device_mesh
    own = not dist.is_initialized()
    if own:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=mesh.size)
    elif dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"a {tuple(mesh.shape.values())} mesh needs a world of "
            f"{mesh.size} ranks; a process group of "
            f"{dist.get_world_size()} exists")
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=mesh.axis_names)
    finally:
        if own:
            dist.destroy_process_group()


def make_host_mesh(device: DeviceLike = None):
    """The (1, 1) ("data", "model") mesh of one device."""
    return make_mesh_compat((1, 1), ("data", "model"), device)


@contextlib.contextmanager
def activate_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the ``with`` body."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def abstract_mesh_compat():
    """The ambient mesh, or None."""
    return _AMBIENT.get()


def axis_group(name: str):
    """The process group of axis ``name`` of the ambient ``DeviceMesh``."""
    mesh = abstract_mesh_compat()
    if mesh is None or not hasattr(mesh, "get_group"):
        raise RuntimeError(f"axis {name!r}: no DeviceMesh is active")
    return mesh.get_group(name)


def placements(spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of a partition spec on ``mesh``: mesh dim ``a``
    is ``Shard(d)`` where the spec names ``a`` at tensor dim ``d`` (alone
    or in a tuple of axes), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_names(mesh))


def _gather(x, dim, group):
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank order
    (one ``all_gather`` of the block)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _scatter(x, dim, group):
    """The sum over the ranks of ``x``'s block ``rank`` along ``dim`` (one
    ``reduce_scatter_tensor`` of the whole)."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """Every rank used the whole: each keeps the sum of the gradients of
    its own block, a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Each rank's block of the summed partials: the gradient of a block
    is wanted by every rank that contributed, an all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of the blocks of dim 0: block j goes to rank
    j, block i of the result came from rank i. Its own inverse, so the
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)`` over ``group``:
    the ranks' blocks concatenated along ``dim`` in rank order. The
    gradient is reduce-scattered back."""
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``
    over ``group``: the ranks' ``x`` summed, rank i keeping block i along
    ``dim``. The gradient is all-gathered back."""
    return _ReduceScatter.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`` over
    ``group``: ``x`` split into one block a rank along ``split_dim``, block
    j sent to rank j, the blocks received concatenated along
    ``concat_dim`` in rank order. The gradient takes the reverse
    exchange."""
    n = dist.get_world_size(group)
    blocks = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    got = _AllToAll.apply(blocks.movedim(split_dim, 0), group)
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def with_sharding_constraint(x, spec):
    """The port's ``jax.lax.with_sharding_constraint``: a DTensor is
    redistributed to ``spec``'s placements on its own mesh (differentiable:
    the gradient is redistributed back); a plain tensor is returned as it
    is, the reference's meaning on a one-device mesh."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def from_local(local, mesh, spec, like=None):
    """A DTensor of ``local`` blocks laid out by ``spec``; ``like`` (a
    global tensor) gives the shape of an uneven layout."""
    from torch.distributed.tensor import DTensor
    kw = {} if like is None else {"shape": like.shape,
                                  "stride": like.stride()}
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, **kw)


def shard_map_compat(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """``f`` run on each rank's local block, with ``mesh`` ambient inside
    it (``axis_group``). Every conversion passes gradients.

    A DTensor argument is redistributed to its in-spec and passed as its
    local block. A plain tensor under an ambient mesh is the global value,
    replicated on every rank (GSPMD's meaning): it is sliced to the rank's
    block by its in-spec. With no ambient mesh a plain tensor is taken as
    the rank's block already (``allreduce_topk``'s callers).

    Outputs are DTensors laid out by ``out_specs``; when every tensor
    argument was plain and a mesh was ambient, they come back as plain
    global tensors (gathered on every rank)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    single_in = not isinstance(in_specs, (list, tuple)) or _is_spec(in_specs)
    single_out = _is_spec(out_specs)
    # a mesh dim some output is split over: there the ranks compute
    # different parts, so the gradient of an input replicated over it is
    # each rank's partial sum (shard_map's transpose psums it)
    split = [any(isinstance(p[i], Shard) for p in
                 (placements(s, mesh) for s in
                  ((out_specs,) if single_out else out_specs)))
             for i in range(len(axis_names(mesh)))]

    def run(*args):
        specs = (in_specs,) * len(args) if single_in else tuple(in_specs)
        sliced = abstract_mesh_compat() is not None
        gather = sliced and not any(isinstance(a, DTensor) for a in args)

        def local(arg, spec):
            if sliced and not isinstance(arg, DTensor) and isinstance(
                    arg, torch.Tensor):
                arg = from_local(arg, mesh, ())
            if not isinstance(arg, DTensor):
                return arg
            pl = placements(spec, mesh)
            grad = tuple(Partial() if s and not isinstance(p, Shard) else p
                         for s, p in zip(split, pl))
            return arg.redistribute(mesh, pl).to_local(grad_placements=grad)

        def wrap(out, spec):
            out = from_local(out, mesh, spec)
            return out.full_tensor() if gather else out

        with activate_mesh(mesh):
            out = f(*(local(a, s) for a, s in zip(args, specs)))
        if single_out:
            return wrap(out, out_specs)
        return tuple(wrap(o, s) for o, s in zip(out, out_specs))

    return run


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def data_axes(mesh) -> tuple:
    """The axes a global batch shards over."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
