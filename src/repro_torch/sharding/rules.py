"""Parameter-sharding rules: path patterns -> partition-spec tails
(counterpart of ``repro.sharding.rules``).

A rule maps the *trailing* dims of a parameter (the dims the layer math
sees); leading stacking dims (the unit axis, the particle axis) are
padded with None / the particle axis. Specs are plain tuples of axis
names (None: not split), the reference's ``PartitionSpec`` entries.

Two modes:
  "tp"      tensor-parallel only (the ``data`` axis carries particles,
            so within-particle sharding uses only ``model``)
  "fsdp_tp" fully-sharded + tensor-parallel (weights over ``data`` and
            ``model``; the port places "tp" plans only)

``model_dims`` turns the specs into what the store splits by: each
leaf's ``model`` dim, counted from the end, or None for a replicated
leaf (no rule, or the axis dropped because it does not divide the dim).
``split_leaf`` cuts a leaf into its ``m`` model shards and ``join_leaf``
puts them back; a replicated leaf is whole at every model position.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# (regex on normalized path, tp tail, fsdp_tp tail)
_RULES = [
    (r"embed$",                      ("model", None),        ("model", "data")),
    (r"lm_head/w$",                  (None, "model"),        ("data", "model")),
    (r"(attn|xattn)/(wq|wk|wv)/w$",  (None, "model"),        ("data", "model")),
    (r"(attn|xattn)/(wq|wk|wv)/b$",  ("model",),             ("model",)),
    (r"(attn|xattn)/wo/w$",          ("model", None),        ("model", "data")),
    (r"mlp/(wi|wg|w1)/w$",           (None, "model"),        ("data", "model")),
    (r"mlp/w1/b$",                   ("model",),             ("model",)),
    (r"mlp/(wo|w2)/w$",              ("model", None),        ("model", "data")),
    (r"moe/router/w$",               (None, None),           (None, None)),
    (r"moe/(wi|wg)$",                ("model", None, None),  ("model", "data", None)),
    (r"moe/wo$",                     ("model", None, None),  ("model", None, "data")),
    (r"moe/shared/(wi|wg)/w$",       (None, "model"),        ("data", "model")),
    (r"moe/shared/wo/w$",            ("model", None),        ("model", "data")),
    (r"time_mix/(wr|wk|wv|wg)/w$",   (None, "model"),        ("data", "model")),
    (r"time_mix/wo/w$",              ("model", None),        ("model", "data")),
    (r"channel_mix/wk/w$",           (None, "model"),        ("data", "model")),
    (r"channel_mix/wv/w$",           ("model", None),        ("model", "data")),
    (r"channel_mix/wr/w$",           (None, None),           ("data", None)),
    (r"in_proj/w$",                  (None, "model"),        ("data", "model")),
    (r"out_proj/w$",                 (None, None),           (None, "data")),
    (r"patch/w$",                    (None, None),           (None, None)),
    (r"head/w$",                     (None, None),           (None, None)),
    # KV caches / paged KV pools (store keys "kv", "kv_pages"): leaves are
    # literally "k" / "v" (param leaves end in /w, /b — no collision) with
    # trailing dims (..., seq-or-page, n_kv_heads, head_dim). Heads ride
    # the model axis alongside the wk/wv column split, so the paged-decode
    # block-table gathers never cross the model axis.
    (r"(^|/)(k|v)$",                 (None, None, "model", None),
     (None, None, "model", None)),
]
_COMPILED = [(re.compile(pat), tp, ftp) for pat, tp, ftp in _RULES]


def normalize_path(path: Sequence) -> str:
    """A key path (dict keys and sequence indices, root first) ->
    'units/0/attn/wq/w', the reference's string for the same leaf."""
    return "/".join(str(k) for k in path)


def named_leaves(tree, *, sort_keys: bool = False) -> List[Tuple[str, object]]:
    """(normalized path, leaf) of every leaf, in ``tree_flatten``'s order
    (container order, or sorted dict keys with ``sort_keys``)."""
    out: List[Tuple[str, object]] = []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in (sorted(t) if sort_keys else t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, x in enumerate(t):
                walk(x, path + (i,))
        else:
            out.append((normalize_path(path), t))

    walk(tree, ())
    return out


# int8 serve copies (core.precision.quantize_int8) expand a weight leaf
# ".../w" into a {"q", "s"} pack — paths ".../w/q" and ".../w/s". Both
# carry the weight's rule: q has the weight's shape exactly; s is the
# keepdims per-channel scale (same ndim, inner dims 1 — param_spec's
# divisibility drop nulls the collapsed axes, the channel axis shards).
_QUANT_SUFFIX = re.compile(r"/(q|s)$")


def spec_tail(path_str: str, mode: str) -> Optional[Tuple]:
    for rx, tp, ftp in _COMPILED:
        if rx.search(path_str):
            return tp if mode == "tp" else ftp
    base = _QUANT_SUFFIX.sub("", path_str)
    if base != path_str:
        return spec_tail(base, mode)
    return None


def _remap_tail(tail: Tuple, model_axis: Optional[str]) -> Tuple:
    """Rule tails name the within-particle axis literally ``"model"``;
    remap to the placement's actual model-axis name (or drop to None
    when the plan has no model axis at all)."""
    if model_axis == "model":
        return tail
    return tuple(model_axis if a == "model" else a for a in tail)


def param_spec(path: str, ndim: int, mode: str,
               particle_axis: Optional[str], shape=None, mesh_shape=None,
               model_axis: Optional[str] = "model") -> Tuple:
    """The full spec (a tuple of ``ndim`` axis names or None) of one leaf
    at normalized ``path``. When ``shape`` / ``mesh_shape`` are given, an
    axis whose dim its mesh-axis size does not divide is dropped to None
    (e.g. a vocab of 51865 on a 16-way model axis)."""
    tail = spec_tail(path, mode)
    if tail is None or len(tail) > ndim:
        tail = ()
    tail = _remap_tail(tail, model_axis)
    lead_n = ndim - len(tail)
    lead = [None] * lead_n
    if particle_axis is not None and lead_n >= 1:
        lead[0] = particle_axis
    spec = list(lead) + list(tail)
    if shape is not None and mesh_shape is not None:
        for i, ax in enumerate(spec):
            if ax is not None and shape[i] % mesh_shape.get(ax, 1) != 0:
                spec[i] = None
    return tuple(spec)


def tree_param_specs(tree, mode: str, particle_axis: Optional[str] = None,
                     mesh_shape: Optional[Dict[str, int]] = None,
                     model_axis: Optional[str] = "model"):
    """A tree of specs matching ``tree`` (tensors, or anything with a
    ``shape``); ``mesh_shape`` ({axis: size}) turns the divisibility drop
    on, as the reference's ``mesh=`` does."""
    from ..core.tree import tree_flatten
    leaves, unflatten = tree_flatten(tree)
    paths = [p for p, _ in named_leaves(tree)]
    return unflatten([param_spec(p, len(x.shape), mode, particle_axis,
                                 shape=tuple(x.shape) if mesh_shape else None,
                                 mesh_shape=mesh_shape,
                                 model_axis=model_axis)
                      for p, x in zip(paths, leaves)])


def model_dims(tree, m: int, *, lead: int = 0, mode: str = "tp",
               model_axis: str = "model") -> Dict[str, Optional[int]]:
    """{normalized path: the dim, counted from the end, that the model
    axis of size ``m`` splits, or None (replicated)} for every leaf of
    ``tree``. ``lead`` leading axes (the particle axis of a stacked tree)
    are left out of the rule's divisibility check, so a row and its stack
    give the same dims."""
    out: Dict[str, Optional[int]] = {}
    for path, x in named_leaves(tree):
        shape = tuple(x.shape)[lead:]
        spec = param_spec(path, len(shape), mode, None, shape=shape,
                          mesh_shape={model_axis: m}, model_axis=model_axis)
        dim = None
        if m > 1 and model_axis in spec:
            dim = spec.index(model_axis) - len(spec)
        out[path] = dim
    return out


def split_leaf(x: torch.Tensor, dim: Optional[int], m: int, j: int):
    """Model shard ``j`` of ``m`` of leaf ``x`` (a view): its ``j``-th
    slice along ``dim``, or ``x`` itself when ``dim`` is None."""
    if dim is None:
        return x
    k = x.shape[dim] // m
    return x.narrow(dim, j * k, k)


def join_leaf(parts: Sequence[torch.Tensor], dim: Optional[int],
              device=None) -> torch.Tensor:
    """The whole leaf from its model shards, on ``device`` (the first
    shard's by default): their concatenation along ``dim`` in position
    order, or the first shard itself (a replicated leaf)."""
    device = parts[0].device if device is None else torch.device(device)
    if dim is None:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim)
