"""Nested trees of tensors in the reference's pytree order.

The reference's training code walks parameter, gradient and optimizer
trees with ``jax.tree``: dict keys sorted, a registered dataclass's fields
in order (named ``.field``), ``None`` holding no leaf. These helpers give
the port's trees (``ParamTree``, nested dicts, ``TrainState``) the same
leaf order and the same ``a/b/c`` names, which the checkpoint format
(``train.checkpoint``) and the optimizer's float32 norm sum rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.model import ParamTree


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray))


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, ParamTree):
        node = node.tree()
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("." + f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, Mapping):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    raise TypeError(f"not a tree node: {type(node).__name__}")


def named_leaves(tree, leaf_types: Tuple[type, ...] = ()
                 ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's flatten order; instances of
    ``leaf_types`` count as leaves too (a tree of shardings)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if _is_leaf(node) or isinstance(node, leaf_types):
            out.append(("/".join(path), node))
            return
        for key, child in _children(node):
            walk(child, path + (key,))

    walk(tree, ())
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), called in ``named_leaves`` order: nested dicts keep their
    keys (sorted, as ``jax.tree.map`` rebuilds them), a ``ParamTree``
    becomes a nested dict, a dataclass its own type, ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, ParamTree):
        tree = tree.tree()
        rest = tuple(r.tree() if isinstance(r, ParamTree) else r
                     for r in rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    raise TypeError(f"not a tree node: {type(tree).__name__}")
