"""The NN a particle wraps (counterpart of ``repro.core.particle``).

The port has ``ParticleModule`` only: particles live as slots of the
PushDistribution's ParticleStore, and actor messaging (``Particle.send`` /
``get``, the NEL) waits for a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


class ParticleModule:
    """Bundle of functions defining the NN a particle wraps.

    ``init(generator) -> params`` draws one particle's parameter tree on
    ``generator.device``. ``loss(stacked_params, batch) -> (losses (P,),
    metrics)`` and ``forward(stacked_params, batch) -> outputs (P, ...)``
    take the store's stacked tree with its leading particle axis (the
    reference's take one particle and are vmapped). ``cfg`` is the model
    config serving reads."""

    def __init__(self, init: Callable, loss: Optional[Callable] = None,
                 forward: Optional[Callable] = None, cfg: Any = None):
        self.init = init
        self.loss = loss
        self.forward = forward
        self.cfg = cfg
