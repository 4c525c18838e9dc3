"""Particles, the Push distribution, the ParticleStore, the executor and
the NEL (counterpart of ``repro.core``)."""
from .executor import Executor
from .messages import ParticleView, PFuture
from .nel import NodeEventLoop
from .particle import Particle, ParticleModule
from .pd import PushDistribution
from .store import ParticleStore, StoreState

__all__ = ["Executor", "NodeEventLoop", "Particle", "ParticleModule",
           "ParticleStore", "ParticleView", "PFuture", "PushDistribution",
           "StoreState"]
