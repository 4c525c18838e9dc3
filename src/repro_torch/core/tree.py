"""Minimal pytree helpers over the port's parameter trees.

A tree is nested ``dict`` / ``tuple`` / ``list`` containers with tensor
leaves — the same containers ``jax.tree`` walks in the reference, so key
paths match between the two packages. As in JAX, ``None`` is an empty
subtree: it holds no leaf and maps to ``None``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


class Group:
    """One data position's model group under a 2D placement: ``shards[j]``
    is model position j's part of a tree, on ``devices[j]``. ``dims``
    maps each leaf's normalized path (``sharding.rules``) to the dim,
    counted from the end, that the model axis splits, or None for a
    replicated leaf (whole at every position); None when the group was
    made by model code and is never joined. The tree helpers walk a Group
    as a container of its shards and keep ``dims`` and ``devices``."""

    __slots__ = ("shards", "dims", "devices")

    def __init__(self, shards: Sequence, dims: Optional[Dict] = None,
                 devices: Optional[Sequence] = None):
        self.shards = tuple(shards)
        self.dims = dims
        if devices is None:
            devices = [tree_leaves(s)[0].device for s in self.shards]
        self.devices = tuple(torch.device(d) for d in devices)

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    def __getitem__(self, j: int):
        return self.shards[j]

    def __repr__(self) -> str:
        return f"Group(m={len(self.shards)}, devices={list(self.devices)})"

    def like(self, shards) -> "Group":
        """A group of ``shards`` with this one's dims; each position's
        device is its new shard's (this one's for a shard without a
        tensor)."""
        return _regroup(shards, self.dims, self.devices)


def _regroup(shards, dims, devices) -> Group:
    shards = tuple(shards)
    where = []
    for s, d in zip(shards, devices):
        t = next((x for x in tree_leaves(s) if isinstance(x, torch.Tensor)),
                 None)
        where.append(d if t is None else t.device)
    return Group(shards, dims, where)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, Group):
        return tree.like(tree_map(fn, s, *(r.shards[j] for r in rest))
                         for j, s in enumerate(tree.shards))
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
        if isinstance(t, Group):
            gsubs = [walk(x) for x in t.shards]
            dims, devices = t.dims, t.devices
            return lambda it: _regroup([s(it) for s in gsubs], dims, devices)
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
