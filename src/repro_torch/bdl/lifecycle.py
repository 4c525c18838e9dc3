"""Particle lifecycle policies: resample / grow / prune over a live PD
(counterpart of ``repro.bdl.lifecycle``).

The paper's pitch — "Push enables easy creation of particles so that an
input NN can be replicated" — pays off only if churn is cheap and
principled. The capacity-padded ParticleStore (DESIGN.md §9) makes
clone/kill within capacity free of new captures (``store.clone_slot``
copies inside the stacked tensors, a kill flips the mask); this module
supplies the policies that decide which particles live:

  * ``resample`` — SMC-style systematic resampling on per-particle
    weights: zero-weight lineages die, heavy lineages clone with jitter.
    The live count is preserved, so kills free exactly the slots the
    clones reuse: capacity, addresses and every captured step survive.
  * ``grow`` — warm-started progressive deep ensembles: new members are
    jittered clones of the current best member, trained on from there.
  * ``prune`` — drop the lowest-weight members.
  * ``ensemble_weights`` — the default weights: softmax(-loss) per live
    particle on one evaluation batch.

All policies run on ``PushDistribution``'s lifecycle API (``p_clone`` /
``p_kill``) and under either backend. ``systematic_counts`` draws from a
numpy ``Generator``, so for a given seed its counts equal the
reference's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.tree import to_device


def _resolve_pd(obj):
    return getattr(obj, "push_dist", obj)


def ensemble_weights(obj, batch) -> Dict[int, float]:
    """softmax(-loss) over the live particles: one loss evaluation per
    particle (``ParticleModule._loss_value``, no grads, no optimizer
    step) on ``batch`` moved to the store's device once, normalized into
    sampling weights. Lower loss -> heavier lineage."""
    pd = _resolve_pd(obj)
    batch = to_device(batch, pd.device)
    losses = {}
    for pid in pd.particle_ids():
        p = pd.particles[pid]
        losses[pid] = float(pd.module._loss_value(p.parameters(), batch))
    xs = np.asarray(list(losses.values()), np.float64)
    xs = np.exp(-(xs - xs.min()))
    xs = xs / xs.sum()
    return dict(zip(losses, xs))


def systematic_counts(weights: Sequence[float], n: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> List[int]:
    """Systematic resampling (one uniform draw, n evenly spaced positions
    against the weight CDF) -> offspring count per input. Counts sum to
    n. Without ``rng`` the offset comes from fresh entropy, so repeated
    rounds draw independent offsets."""
    w = np.asarray(weights, np.float64)
    if w.sum() <= 0:
        raise ValueError("weights must have positive mass")
    w = w / w.sum()
    if rng is None:
        rng = np.random.default_rng()
    positions = (rng.random() + np.arange(n)) / n
    cum = np.cumsum(w)
    cum[-1] = 1.0                       # float-sum guard
    counts = np.zeros(len(w), np.int64)
    j = 0
    for pos in positions:
        while cum[j] < pos:
            j += 1
        counts[j] += 1
    return counts.tolist()


def resample(obj, weights: Optional[Dict[int, float]] = None, *,
             batch=None, jitter: float = 0.0,
             rng: Optional[np.random.Generator] = None) -> List[int]:
    """SMC-style birth/death over the live particle set.

    ``weights`` maps pid -> weight (default: ``ensemble_weights`` on
    ``batch``). A particle with offspring count 0 is killed, count k
    spawns k-1 jittered clones. Kills run first, so every clone lands in
    a just-freed slot: the live count is preserved and capacity never
    grows. Returns the new live pid list."""
    pd = _resolve_pd(obj)
    if weights is None:
        if batch is None:
            raise ValueError("pass weights= or batch= to resample")
        weights = ensemble_weights(pd, batch)
    pids = list(weights)
    counts = systematic_counts([weights[p] for p in pids], len(pids), rng)
    for pid, c in zip(pids, counts):
        if c == 0:
            pd.p_kill(pid)
    for pid, c in zip(pids, counts):
        for _ in range(c - 1):
            pd.p_clone(pid, jitter=jitter)
    return pd.particle_ids()


def grow(obj, n_new: int, *, jitter: float = 0.01,
         weights: Optional[Dict[int, float]] = None, batch=None,
         optimizer=None) -> List[int]:
    """Progressive ensemble growth: ``n_new`` members warm-started as
    jittered clones of the best current member (by ``weights`` /
    ``batch``; the first live particle when neither is given). With
    ``optimizer=`` the new members get fresh optimizer state (cold
    optimizer, warm params), written in place into their slots. Growth
    past capacity doubles the store (one generation bump, new addresses):
    preallocate with ``capacity=`` to avoid it. Returns the new pids."""
    pd = _resolve_pd(obj)
    if weights is None and batch is not None:
        weights = ensemble_weights(pd, batch)
    if weights:
        src = max(weights, key=weights.get)
    else:
        src = pd.particle_ids()[0]
    new = [pd.p_clone(src, jitter=jitter) for _ in range(n_new)]
    if optimizer is not None:
        for pid in new:
            p = pd.particles[pid]
            p.optimizer = optimizer
            p.state["opt_state"] = optimizer.init(p.parameters())
    return new


def prune(obj, keep: int, *, weights: Optional[Dict[int, float]] = None,
          batch=None) -> List[int]:
    """Kill all but the ``keep`` heaviest members (lowest loss under the
    default weights). Freed slots go on the free list for later clones.
    Returns the surviving pid list."""
    pd = _resolve_pd(obj)
    if keep < 1:
        raise ValueError("keep must be >= 1")
    if weights is None:
        if batch is None:
            raise ValueError("pass weights= or batch= to prune")
        weights = ensemble_weights(pd, batch)
    ranked = sorted(weights, key=weights.get, reverse=True)
    for pid in ranked[keep:]:
        pd.p_kill(pid)
    return pd.particle_ids()
