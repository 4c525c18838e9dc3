"""Minimal pytree helpers over the port's parameter trees.

A tree is nested ``dict`` / ``tuple`` / ``list`` containers with tensor
leaves — the same containers ``jax.tree`` walks in the reference, so key
paths match between the two packages. As in JAX, ``None`` is an empty
subtree: it holds no leaf and maps to ``None``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in container order."""
    return tree_flatten(tree)[0]


def tree_flatten(tree, *, sort_keys: bool = False) -> Tuple[List[Any],
                                                             Callable]:
    """(leaves, unflatten): ``unflatten(new_leaves)`` rebuilds the tree's
    structure around new leaves. ``sort_keys=True`` walks dict keys in
    sorted order, which is the leaf order of ``jax.tree`` and of
    ``ravel_pytree``; the default keeps container order."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return lambda it: None
        if isinstance(t, dict):
            order = list(t)
            keys = sorted(order) if sort_keys else order
            subs = {k: walk(t[k]) for k in keys}

            def build_dict(it):
                vals = {k: subs[k](it) for k in keys}    # walk order
                return {k: vals[k] for k in order}       # container order
            return build_dict
        if isinstance(t, (tuple, list)):
            kind, subs = type(t), [walk(x) for x in t]
            return lambda it: kind(s(it) for s in subs)
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    # walk refers to itself through its closure: break that cycle, or the
    # leaves it holds would live on until the cyclic collector runs; the
    # closures that rebuild the tree keep its structure, never a leaf
    walk = None
    return leaves, lambda new: build(iter(new))


def to_device(batch, device):
    """A batch of numpy arrays or tensors -> tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x).to(device), batch)


def tree_to(tree, device):
    """Tensor leaves of ``tree`` on ``device`` (no copy for those already
    there); other leaves (a learning rate, a loader) as they are."""
    return tree_map(lambda x: x.to(device)
                    if isinstance(x, torch.Tensor) else x, tree)
