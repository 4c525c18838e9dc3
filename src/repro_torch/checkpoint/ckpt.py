"""Step-versioned tree checkpoints and the store handoff (counterpart of
``repro.checkpoint.ckpt``). The files are the reference's: each package
reads what the other writes.

``save(dir, step, tree)`` writes ``<dir>/ckpt_<step:08d>.npz``: a
``__manifest__`` (``paths``, ``step``) and ``leaf_<i>`` arrays, the leaves
in ``jax.tree``'s order (dict keys sorted) under the reference's
``jax.tree_util.keystr`` paths (``['a']['b']``, ``[0]``; ``leaf_paths`` here).
``restore(dir, step=None, like=None)`` returns ``(step, tree)``: with
``like`` the leaves go into its structure, each on its ``like`` leaf's
device and dtype; without, a ``{path: tensor}`` dict on ``device``. Writes
are atomic (a temporary file renamed).

``save_store`` writes a whole ParticleStore into one
``store_<step:08d>.npz``: per key the live rows, dense in slot order, as
``k<ki>_l<i>`` arrays beside a ``__store_manifest__`` of self-describing
structure records (``_skeleton``: dict / tuple / list / None nodes, leaf
indices), which pids hold the key (``_pids``) and each leaf's dtype
(``_dtypes``), with the pid registry, capacity, free slots, active mask,
placement plan, precision policy and dtype surface. ``restore_store``
rebuilds a store ready to serve from it (no inference replayed): at
another ``capacity`` (rounded up to a power of two, never below the live
count), under another ``precision`` (the masters re-cast, ``kv*`` keys
following the policy's ``kv_dtype``), on ``device`` (the card by
default). The manifest records the mesh's shape and axes; restore
revives the saved plan over the visible CUDA devices when they allow it
and otherwise restores onto ``mesh=None``, as the reference's does where
the saved mesh does not fit; an explicit ``placement=`` wins.

numpy has no bfloat16 that npz keeps without pickling: bf16 leaves are
widened to fp32 on disk and recorded as ``"bfloat16"``, and restore casts
them back, exactly.

With tracing on, ``save_store`` records a ``store.d2h`` span (cat
``store``) around each key's copy to the host and ``restore_store`` a
``store.h2d`` span around each key's copy to the device, so the file's
share of a save or a restore is the rest of its time.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.precision import Precision, cast_floats, dtype_name
from ..core.precision import get as _resolve_precision
from ..core.store import ParticleStore, Placement
from ..launch.mesh import make_mesh
from ..core.tree import tree_flatten, tree_map
from ..obs import trace as _trace


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree``'s order: dict keys
    sorted, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree)
                for pair in _paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaf_paths(tree) -> List[str]:
    """Each leaf's path as ``jax.tree_util.keystr`` writes it, in
    ``jax.tree``'s leaf order."""
    return [p for p, _ in _paths(tree)]


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds (bf16 widened to fp32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """An array read from the file as a tensor on ``device``, cast to
    ``dtype`` there (bf16 comes back from its fp32 copy exactly)."""
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _write(ckpt_dir: str, name: str, **arrays) -> str:
    path = os.path.join(ckpt_dir, name)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp.npz")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _latest(ckpt_dir: str, prefix: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(prefix + r"_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    pairs = _paths(tree)
    manifest = {"paths": [p for p, _ in pairs], "step": step}
    return _write(ckpt_dir, f"ckpt_{step:08d}.npz",
                  __manifest__=json.dumps(manifest),
                  **{f"leaf_{i}": _host(v) for i, (_, v) in enumerate(pairs)})


def latest_step(ckpt_dir: str) -> Optional[int]:
    return _latest(ckpt_dir, "ckpt")


def restore(ckpt_dir: str, step: Optional[int] = None, like: Any = None,
            device=None) -> Tuple[int, Any]:
    """(step, tree): with ``like``, the leaves in its structure (paths must
    match), each on its ``like`` leaf's device and in its dtype; else a
    ``{path: tensor}`` dict on ``device`` (the card by default)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    data = np.load(os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz"),
                   allow_pickle=False)
    manifest = json.loads(str(data["__manifest__"]))
    by_path = {p: data[f"leaf_{i}"] for i, p in enumerate(manifest["paths"])}
    if like is None:
        device = torch.device("cuda" if device is None else device)
        return step, {p: _tensor(a, device) for p, a in by_path.items()}
    leaves, unflatten = tree_flatten(like, sort_keys=True)
    out = []
    for path, leaf in zip(leaf_paths(like), leaves):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        a = by_path[path]
        out.append(_tensor(a, leaf.device, leaf.dtype)
                   if isinstance(leaf, torch.Tensor)
                   else np.asarray(a, dtype=np.asarray(leaf).dtype))
    return step, unflatten(out)


# ---------------------------------------------------------------------------
# the store handoff
# ---------------------------------------------------------------------------

def _skeleton(tree, leaves: List[Any]):
    """Self-describing structure record: dict / tuple / list / None nodes
    plus leaf indices into ``leaves`` (empty containers survive)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("store checkpoint requires str dict keys")
        return {"t": "dict", "k": {k: _skeleton(v, leaves)
                                   for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "tuple" if isinstance(tree, tuple) else "list",
                "c": [_skeleton(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"t": "leaf", "i": len(leaves) - 1}


def _rebuild(skel, arrays):
    t = skel["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _rebuild(v, arrays) for k, v in skel["k"].items()}
    if t in ("tuple", "list"):
        out = [_rebuild(v, arrays) for v in skel["c"]]
        return tuple(out) if t == "tuple" else out
    return arrays[skel["i"]]


def save_store(ckpt_dir: str, step: int, store: ParticleStore,
               keys: Optional[List[str]] = None) -> str:
    """Write ``store`` (every key's live rows, dense in slot order, the
    pid / slot registry, capacity, free slots, active mask, placement and
    precision) as ``<dir>/store_<step:08d>.npz``. Without ``keys``, keys
    that cannot stack (``grads`` before a step) are skipped; an explicit
    key that cannot raises. A key held by some particles only records
    which."""
    os.makedirs(ckpt_dir, exist_ok=True)
    explicit = keys is not None
    keys = list(keys) if explicit else store.keys()
    live = store.pids
    arrays: Dict[str, np.ndarray] = {}
    skels: Dict[str, Any] = {}
    for ki, key in enumerate(keys):
        pids_k = [p for p in live if store.has(key, p)]
        try:
            if not pids_k:
                raise KeyError(key)
            st = store.dense(key, pids_k)
        except (KeyError, TypeError, ValueError):
            if explicit:
                raise
            continue
        flat: List[Any] = []
        skels[key] = _skeleton(st, flat)
        with _trace.span("store.d2h", "store", key=key, leaves=len(flat)):
            for i, leaf in enumerate(flat):
                arrays[f"k{ki}_l{i}"] = _host(leaf)
        skels[key]["_slot"] = ki
        skels[key]["_pids"] = pids_k
        skels[key]["_dtypes"] = [dtype_name(x.dtype) for x in flat]
    pl = store.placement
    slots = {p: store.slot_of(p) for p in live}
    occupied = set(slots.values())
    manifest = {
        "step": step,
        "pids": live,
        "capacity": store.capacity,
        "slots": {str(p): s for p, s in slots.items()},
        "free": sorted(set(range(store.capacity)) - occupied),
        "active_mask": [int(s in occupied) for s in range(store.capacity)],
        "placement": {"particle_axis": pl.particle_axis,
                      "model_axis": pl.model_axis, "mode": pl.mode,
                      "mesh_shape": (None if pl.mesh is None else
                                     [int(pl.mesh.shape[a])
                                      for a in pl.mesh.axis_names]),
                      "mesh_axes": (None if pl.mesh is None
                                    else list(pl.mesh.axis_names))},
        "precision": store.precision.describe(),
        "dtypes": {k: store.key_dtypes(k) for k in skels},
        "keys": skels,
    }
    return _write(ckpt_dir, f"store_{step:08d}.npz",
                  __store_manifest__=json.dumps(manifest), **arrays)


def _saved_placement(meta) -> Placement:
    """The saved plan, revived over the visible CUDA devices when they
    allow it (as many as the mesh, or a multiple), else on ``mesh=None``
    (the reference's rule, with the CUDA device count)."""
    mesh = None
    if meta.get("mesh_shape") is not None:
        n_want = int(np.prod(meta["mesh_shape"]))
        n_have = torch.cuda.device_count()
        if n_want <= n_have and n_have % n_want == 0:
            mesh = make_mesh(tuple(meta["mesh_shape"]),
                             tuple(meta["mesh_axes"]))
    return Placement(mesh=mesh, particle_axis=meta["particle_axis"],
                     mode=meta["mode"],
                     model_axis=meta.get("model_axis", "model"))


def latest_store_step(ckpt_dir: str) -> Optional[int]:
    return _latest(ckpt_dir, "store")


def restore_store(ckpt_dir: str, step: Optional[int] = None,
                  placement: Optional[Placement] = None,
                  capacity: Optional[int] = None, precision=None,
                  device=None) -> Tuple[int, ParticleStore]:
    """(step, store) from ``save_store`` output (module doc): the pids
    registered again in their saved slot order, every saved key written
    back as its live rows and flushed to the capacity-padded canonical
    form on ``device``, ready to serve."""
    if step is None:
        step = latest_store_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no store checkpoints under {ckpt_dir}")
    data = np.load(os.path.join(ckpt_dir, f"store_{step:08d}.npz"),
                   allow_pickle=False)
    manifest = json.loads(str(data["__store_manifest__"]))
    if placement is None:
        placement = _saved_placement(manifest["placement"])
    saved = manifest.get("precision")
    if precision is None and saved is not None:
        precision = Precision(master_dtype=saved["master"],
                              compute_dtype=saved["compute"],
                              serve_dtype=saved["serve"],
                              serve_quant=saved.get("serve_quant"),
                              kv_dtype=saved.get("kv"))
    prec = _resolve_precision(precision)
    pids = manifest["pids"]
    want = capacity if capacity is not None \
        else manifest.get("capacity", len(pids))
    store = ParticleStore(capacity=max(want, len(pids)), precision=prec,
                          device=device, placement=placement)
    for pid in pids:              # saved slot order: the same layout
        store.register(pid)
    for key, skel in manifest["keys"].items():
        ki = skel["_slot"]
        arrays = []
        while f"k{ki}_l{len(arrays)}" in data:
            arrays.append(data[f"k{ki}_l{len(arrays)}"])
        dtypes = skel.get("_dtypes") or [None] * len(arrays)
        with _trace.span("store.h2d", "store", key=key):
            arrays = [_tensor(a, store.device, dt and getattr(torch, dt))
                      for a, dt in zip(arrays, dtypes)]
        tree = _rebuild(skel, arrays)
        if tree is None:
            continue
        if key.startswith("kv"):
            if prec.kv is not None:
                tree = cast_floats(tree, prec.kv)
        else:
            tree = cast_floats(tree, prec.master)
        for j, p in enumerate(skel.get("_pids", pids)):
            store.write(key, p, tree_map(lambda x, j=j: x[j], tree))
        store.stacked(key)
    return step, store
