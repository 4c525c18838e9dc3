"""Bayesian deep learning on particles: deep ensembles, MultiSWAG, SVGD,
and the lifecycle policies (``bdl.lifecycle``)."""
from .ensemble import DeepEnsemble
from .infer import Infer
from .svgd import SteinVGD, fused_svgd_step, svgd_force, svgd_step_spec
from . import lifecycle
from .swag import (MultiSWAG, swag_collect, swag_sample, swag_sample_stacked,
                   swag_state_init)

__all__ = ["DeepEnsemble", "Infer", "SteinVGD", "fused_svgd_step", "lifecycle",
           "svgd_force", "svgd_step_spec", "MultiSWAG", "swag_collect",
           "swag_sample", "swag_sample_stacked", "swag_state_init"]
