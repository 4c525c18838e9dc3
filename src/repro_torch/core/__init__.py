"""Particles, the Push distribution, the ParticleStore and the executor."""
from .particle import ParticleModule
from .pd import PushDistribution
from .store import ParticleStore

__all__ = ["ParticleModule", "PushDistribution", "ParticleStore"]
