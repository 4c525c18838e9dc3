"""Activation-sharding policy: a context-scoped map name -> spec
(counterpart of ``repro.sharding.policy``).

Model code calls ``maybe_shard(x, "residual")`` at the reference's call
sites. In the reference the policy turns each call into a GSPMD sharding
constraint. In the port the layout follows from the split weights and
the explicit reductions (``models.tp``), so nothing is constrained: the
hook hands ``x`` back. Under an active policy it records each named
tensor's per-position shape, so a test can hold the layout the split
weights give to the policy's specs (``recorded``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

_tls = threading.local()


def current_policy() -> Optional[Dict]:
    return getattr(_tls, "policy", None)


@contextmanager
def activation_policy(policy: Dict):
    prev, prev_rec = current_policy(), getattr(_tls, "recorded", None)
    _tls.policy = policy
    _tls.recorded = []
    try:
        yield
    finally:
        _tls.policy, _tls.recorded = prev, prev_rec


def recorded() -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, per-position shape without the particle axis) of every
    ``maybe_shard`` call under the active policy, in call order."""
    return list(getattr(_tls, "recorded", None) or ())


def tp_activation_policy(mesh_shape: Dict[str, int],
                         model_axis: str = "model") -> Dict:
    """The Megatron-TP activation layout over a 2D (particle x model)
    placement: attention/MLP intermediates stay split over the model axis
    between the column-parallel (wq/wk/wv, wi/wg) and row-parallel (wo,
    w2) products; residuals are replicated, so the row-parallel sum
    happens at the block boundary, once.

    Specs are per-particle ranks (the port's tensors lead with the
    particle axis, which ``maybe_shard`` leaves out). ``__mesh__`` gives
    the divisibility drop: a head count the model axis does not divide
    is replicated."""
    m = model_axis
    return {
        "attn_heads": (None, None, m, None),   # (B, S, H, hd)
        "attn_kv":    (None, None, m, None),   # (B, S, KVH, hd)
        "ssm_heads":  (None, None, m, None),   # (B, S, H, hd)
        "mlp_hidden": (None, None, m),         # (B, S, F)
        "logits":     (None, None, m),         # (B, S, V)
        "moe_buffer": (m, None, None),         # (E, C, D)
        "residual":   (None, None, None),      # (B, S, D)
        "__mesh__":   dict(mesh_shape),
    }


def expected_shape(policy: Dict, name: str, full_shape) -> Tuple[int, ...]:
    """The per-position shape a tensor of ``full_shape`` (per particle)
    takes under ``policy``'s spec for ``name``, after the divisibility
    drop."""
    spec = policy[name]
    mesh = policy.get("__mesh__", {})
    out = []
    for dim, ax in zip(full_shape, spec):
        size = mesh.get(ax, 1) if ax else 1
        out.append(dim // size if size > 1 and dim % size == 0 else dim)
    return tuple(out)


def maybe_shard(x, name: str):
    """``x`` itself; under an active policy that names ``name`` with
    ``x``'s rank (the particle axis left out), ``x``'s per-position shape
    is recorded."""
    pol = current_policy()
    if pol is None or name not in pol:
        return x
    shape = tuple(x.shape[1:])
    if len(pol[name]) == len(shape):
        _tls.recorded.append((name, shape))
    return x
