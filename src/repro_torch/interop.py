"""Carrying weights across from the JAX package.

``params_from_numpy(tree)`` takes the reference's parameter tree given as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
tree at the same key paths: dicts stay dicts, tuples stay tuples (the
stacked ``"units"`` leaves keep their leading ``n_units`` axis), and every
weight keeps the reference's ``(d_in, d_out)`` layout, so the map is the
identity on values.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tree import tree_map


def _to_tensor(x, device):
    a = np.asarray(x)
    if not a.flags.writeable:             # e.g. np.asarray of a jax array
        a = a.copy()
    # ascontiguousarray turns a 0-d array into shape (1,): reshape it back
    a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy<->torch map
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def params_from_numpy(tree, device=None):
    """numpy tree -> torch tree at the same key paths, on ``device`` (on
    the host when None, sharing memory with writable inputs)."""
    return tree_map(lambda x: None if x is None else _to_tensor(x, device),
                    tree)
