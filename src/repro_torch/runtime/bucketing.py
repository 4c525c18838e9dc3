"""Power-of-two bucketing, shared with the serving layer: prompts are
padded up to the next bucket so admission shapes stay few."""
from __future__ import annotations

import torch

from ..core.tree import tree_leaves, tree_map


def bucket_size(m: int) -> int:
    """Next power of two >= m."""
    if m < 1:
        raise ValueError("batch must be non-empty")
    b = 1
    while b < m:
        b <<= 1
    return b


def pad_rows(tree, target: int):
    """Pad every leaf's leading axis to `target` by repeating the last
    row (repeat, not zeros: padding must stay in-distribution for
    normalization layers; padded rows are sliced off after the call)."""
    m = tree_leaves(tree)[0].shape[0]
    if m == target:
        return tree
    return tree_map(
        lambda x: torch.cat([x, x[-1:].expand(target - m, *x.shape[1:])]),
        tree)
