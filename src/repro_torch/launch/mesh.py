"""Meshes of the port: the production topologies as shapes, and real
``torch.distributed`` device meshes for the sharded code paths.

The reference builds ``jax`` meshes of the production topology (TPU v5e):

  single-pod : (16, 16)      axes ("data", "model")         — 256 chips
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")  — 512 chips

Batch shards over ("pod", "data"); model-parallel dims over "model".
One H100 cannot hold a 256-device mesh, and nothing on it needs one: the
sharding rules (``distributed/sharding.py``) read only a mesh's axis names
and sizes. So ``make_production_mesh`` returns a ``ShapeMesh``, that
shape and nothing more, as the reference's tests duck-type one.

A real mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group (``make_mesh_compat``).
``make_host_mesh`` is the (1, 1) mesh of one device: on the card unless the
caller asks for the CPU, in a world of one that it sets up itself when no
process group exists, through an in-process ``HashStore`` (no address, no
network): NCCL on the card, gloo only on the CPU.

``activate_mesh`` / ``abstract_mesh_compat`` set and read an ambient mesh
(a context variable). ``shard_map_compat`` runs a function on each rank's
local shard with that rank's mesh ambient, so ``axis_group(name)`` inside
it gives the process group of a mesh axis: torch's SPMD form of the
reference's ``shard_map`` with named axes. The reference's jax-version
shims (``AxisType.Auto``, ``set_mesh`` against the legacy ``with mesh:``,
``jax.shard_map`` against ``jax.experimental``) have no torch meaning and
are not kept; the names are.
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


def shard_map_compat(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """``f`` run on each rank's local shard. DTensor arguments are laid out
    by ``in_specs`` and passed as their local shards; plain tensors are
    taken as the rank's shard already. ``mesh`` is ambient inside ``f``
    (``axis_group``). Outputs become DTensors laid out by ``out_specs``."""
    from torch.distributed.tensor import DTensor

    def local(arg, spec):
        if isinstance(arg, DTensor):
            return arg.redistribute(mesh, placements(spec, mesh)).to_local()
        return arg

    def wrap(out, spec):
        return DTensor.from_local(out, mesh, placements(spec, mesh),
                                  run_check=False)

    single_in = not isinstance(in_specs, (list, tuple)) or _is_spec(in_specs)
    single_out = _is_spec(out_specs)

    def run(*args):
        specs = (in_specs,) * len(args) if single_in else tuple(in_specs)
        with activate_mesh(mesh):
            out = f(*(local(a, s) for a, s in zip(args, specs)))
        if single_out:
            return wrap(out, out_specs)
        return tuple(wrap(o, s) for o, s in zip(out, out_specs))

    return run


def _is_spec(x) -> bool:
    from repro_torch.distributed.sharding import PartitionSpec
    return isinstance(x, PartitionSpec)


def data_axes(mesh) -> tuple:
    """The axes a global batch shards over."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
