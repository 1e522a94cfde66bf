"""Logical-axis sharding rules with divisibility fallback, in torch.

The reference's rules, kept table for table: every parameter leaf gets a
partition spec derived from its tree path and shape. A dim is sharded on
an axis only if the axis size divides it; otherwise the rule falls through
its chain, ending at replication. That is what absorbs the awkward
published configs (15 heads, 40 experts, 49155 vocab). Stacked-layer
leading dims are never sharded. Batch and cache specs keep the
reference's fallback order.

A spec is the port's ``PartitionSpec``, a tuple with one entry per tensor
dim (an axis name, a tuple of axis names, or None), equal entry for entry
to ``tuple(jax.sharding.PartitionSpec(...))``. The rules read a mesh's
axis names and sizes only (``launch.mesh.axis_sizes``), so they run on the
production topologies as shapes (``launch.mesh.ShapeMesh``). On a real
``DeviceMesh``, ``named_shardings`` gives each leaf its DTensor placements
(``Shard(dim)`` / ``Replicate()``) and ``distribute`` lays a tree out as
DTensors.

Paths are the reference's ``jax.tree_util`` key paths as its
``_path_str`` prints them: dict keys joined by ``/``, a dataclass field
(``TrainState.params``) adding nothing.
"""
from __future__ import annotations

import logging
import math
import re
from typing import Any, List, Optional, Tuple

from repro_torch.launch.mesh import axis_sizes, placements
from repro_torch.train import pytree

log = logging.getLogger(__name__)


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


class NamedSharding:
    """A leaf's layout on a ``DeviceMesh``: its spec and DTensor
    placements."""

    __slots__ = ("mesh", "spec", "placements")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec
        self.placements = placements(spec, mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements})"


# How many leading dims of a leaf are layer-stack dims, by path regex.
_STACK_DIMS = (
    (re.compile(r"mamba_main"), 2),
    (re.compile(r"mamba_tail|pairs|layers"), 1),
)

# Rule table: (path regex, [per-dim fallback chains]) applied to the
# *unstacked* trailing shape. Each chain lists mesh-axis names tried in
# order; None = replicate. Chains shorter than ndim pad with None.
# TP over "model" (heads / d_ff / experts / vocab) + FSDP over "data" (the
# d_model dim of every matrix). An axis is used at most once per leaf.
_RULES: List[Tuple[re.Pattern, List[List[Optional[str]]]]] = [
    # embeddings / output heads: vocab over model, d_model over data (fsdp)
    (re.compile(r"(^|/)embed$"), [["model"], ["data"]]),
    (re.compile(r"lm_head$"), [["model"], ["data"]]),
    (re.compile(r"lm_heads$"), [[None], ["model"], ["data"]]),
    # attention: d_model -> fsdp; heads -> model (fallback head_dim)
    (re.compile(r"attn/wq$"), [["data"], ["model"], ["model"]]),
    (re.compile(r"attn/wk$"), [["data"], ["model"], ["model"]]),
    (re.compile(r"attn/wv$"), [["data"], ["model"], ["model"]]),
    (re.compile(r"attn/wo$"), [["model"], ["model"], ["data"]]),
    (re.compile(r"attn/b[qkv]$"), [["model"], [None]]),
    # dense MLP
    (re.compile(r"mlp/w_(gate|up)$"), [["data"], ["model"]]),
    (re.compile(r"mlp/w_down$"), [["model"], ["data"]]),
    # MoE: EP on experts when divisible, fallback expert-TP on d_ff
    (re.compile(r"moe/router$"), [["data"], [None]]),
    (re.compile(r"moe/w_(gate|up)$"), [["model", None], ["data"], [None, "model"]]),
    (re.compile(r"moe/w_down$"), [["model", None], [None, "model"], ["data"]]),
    # Mamba2
    (re.compile(r"mamba/in_proj$"), [["data"], ["model"]]),
    (re.compile(r"mamba/conv_w$"), [[None], ["model"]]),
    (re.compile(r"mamba/conv_b$"), [["model"]]),
    (re.compile(r"mamba/out_proj$"), [["model"], ["data"]]),
    # xLSTM
    (re.compile(r"mlstm/(up_proj|wq|wk|wv|w_if)$"), [["data"], ["model"]]),
    (re.compile(r"mlstm/down_proj$"), [["model"], ["data"]]),
    (re.compile(r"slstm/w_[xh]$"), [["data"], ["model"]]),
    (re.compile(r"slstm/w_up$"), [["data"], ["model"]]),
    (re.compile(r"slstm/w_down$"), [["model"], ["data"]]),
    (re.compile(r"img_proj$"), [["data"], ["model"]]),
]


def _path_str(name: str) -> str:
    """The reference's path string of a ``pytree.named_leaves`` name: a
    dataclass field (``.params``) adds nothing."""
    return "/".join(p for p in name.split("/") if not p.startswith("."))


def _axis_size(sizes, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _spec_for(path: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    sizes = axis_sizes(mesh)
    n_stack = 0
    for rx, k in _STACK_DIMS:
        if rx.search(path):
            n_stack = k
            break
    body = shape[n_stack:]
    for rx, chains in _RULES:
        if rx.search(path):
            dims: List[Optional[str]] = []
            used: set = set()
            for d in range(len(body)):
                chain = chains[d] if d < len(chains) else [None]
                pick = None
                for axis in chain:
                    if axis is None:
                        continue
                    if (axis in sizes and axis not in used
                            and body[d] % _axis_size(sizes, axis) == 0):
                        pick = axis
                        used.add(axis)
                        break
                dims.append(pick)
            if all(d is None for d in dims):
                log.debug("replicated (no divisible dim): %s %s", path, shape)
            return P(*([None] * n_stack + dims))
    return P()  # norms, scalars, gates -> replicated


def _map_named(fn, tree):
    """``fn(name, leaf)`` over a tree's leaves, keeping its structure."""
    names = iter(n for n, _ in pytree.named_leaves(tree))
    return pytree.map_tree(lambda leaf: fn(next(names), leaf), tree)


def param_shardings(params_shape, mesh):
    """A ``PartitionSpec`` tree for a params (or train state) tree; its
    leaves may be meta tensors."""
    return _map_named(
        lambda name, leaf: _spec_for(_path_str(name), tuple(leaf.shape), mesh),
        params_shape)


def named_shardings(params_shape, mesh):
    """A ``NamedSharding`` tree (spec + DTensor placements) on a
    ``DeviceMesh``."""
    return _map_named(
        lambda name, leaf: NamedSharding(
            mesh, _spec_for(_path_str(name), tuple(leaf.shape), mesh)),
        params_shape)


def distribute(tree, shardings):
    """Each leaf of ``tree`` as a DTensor laid out by the matching
    ``NamedSharding`` (``torch.distributed.tensor.distribute_tensor``)."""
    from torch.distributed.tensor import distribute_tensor
    flat = dict(pytree.named_leaves(shardings, leaf_types=(NamedSharding,)))
    return _map_named(
        lambda name, leaf: distribute_tensor(
            leaf.detach(), flat[name].mesh, flat[name].placements), tree)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def _data_prefix(sizes, batch_size: int):
    """The data axes a batch of ``batch_size`` shards over: ("pod",
    "data"), dropping leading axes until their product divides it."""
    axes = [a for a in ("pod", "data") if a in sizes]
    while axes and batch_size % _axis_size(sizes, tuple(axes)) != 0:
        axes.pop(0)
    return tuple(axes) if axes else None


def batch_spec(mesh, batch_size: int, extra_dims: int = 1) -> PartitionSpec:
    """Shard dim 0 of batch inputs over the data axes (with divisibility
    fallback to a suffix of the axes)."""
    return P(_data_prefix(axis_sizes(mesh), batch_size),
             *([None] * extra_dims))


def batch_shardings(batch_specs_tree, mesh, batch_size: int):
    """Per-input specs: dim 0 = batch over data axes, rest replicated."""
    return pytree.map_tree(
        lambda leaf: batch_spec(mesh, batch_size, len(leaf.shape) - 1),
        batch_specs_tree)


def cache_shardings(cache_shape_tree, mesh, batch_size: int):
    """KV-cache / SSM-state specs for decode.

    Layout conventions (``models/model.py``):
      attention KV   [L, b, S, kv, hd]   -> b over data axes; S over model
                     (fallback kv heads, then hd: split-KV stripes)
      mamba ssm      [L(,g), b, h, n, p] -> b over data; h over model
      mlstm C        [pairs, b, h, d, d] -> b over data; h else d over model
      slstm vectors  [pairs, b, d]       -> b over data; d over model
    """
    sizes = axis_sizes(mesh)
    dp = _data_prefix(sizes, batch_size)
    msize = _axis_size(sizes, "model")

    def spec(leaf):
        shape = tuple(leaf.shape)
        dims: List[Any] = [None] * len(shape)
        # the batch dim: the first dim equal to batch_size at index <= 2
        b_idx = next((i for i, s in enumerate(shape)
                      if s == batch_size and i <= 2), -1)
        if b_idx >= 0 and dp is not None:
            dims[b_idx] = dp
        ndim = len(shape)
        if ndim >= 4 and b_idx >= 0 and b_idx == ndim - 4:
            order = [ndim - 3, ndim - 2, ndim - 1]
        else:
            order = list(range(ndim - 1, b_idx, -1))
        for d in order:
            if d != b_idx and shape[d] % msize == 0 and shape[d] >= msize:
                dims[d] = "model"
                break
        return P(*dims)

    return pytree.map_tree(spec, cache_shape_tree)
