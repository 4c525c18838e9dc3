"""Sharding rules and the activation policy of the model axis
(counterpart of ``repro.sharding``)."""
from . import policy, rules
from .policy import activation_policy, maybe_shard

__all__ = ["activation_policy", "maybe_shard", "policy", "rules"]
