"""Nested-dict trees of tensors (params, gradients, optimizer state).

The port keeps params as nested ``nn.ParameterDict``s and everything
derived from them as nested dicts.  Leaves are visited in sorted key
order, as ``jax.tree`` visits a dict, and named by their keys joined with
``/``, as the reference's checkpoints name them.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch import nn

NODES = (dict, nn.ParameterDict)


def leaves_with_paths(tree, prefix: str = '') -> List[Tuple[str, object]]:
    """[(``'a/b/c'``, leaf), ...] in sorted key order."""
    if not isinstance(tree, NODES):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree.keys()):
        out += leaves_with_paths(tree[k], f'{prefix}/{k}' if prefix else k)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``, in
    :func:`leaves` order, as nested plain dicts."""
    if not isinstance(tree, NODES):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree.keys())}


def unflatten(tree, flat):
    """``flat`` (in :func:`leaves` order) as nested dicts shaped like
    ``tree``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def zeros_f32(tree):
    """f32 zeros shaped like every leaf, on its device."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)
