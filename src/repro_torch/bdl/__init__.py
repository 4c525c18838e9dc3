"""Bayesian deep learning on particles: deep ensembles, MultiSWAG, SVGD,
the lifecycle policies (``bdl.lifecycle``) and the paper's sequential
baselines (``bdl.baselines``)."""
from .ensemble import DeepEnsemble
from .infer import Infer
from .svgd import SteinVGD, fused_svgd_step, svgd_force, svgd_step_spec
from . import baselines, lifecycle
from .swag import (MultiSWAG, swag_collect, swag_sample, swag_sample_stacked,
                   swag_state_init)

__all__ = ["DeepEnsemble", "Infer", "SteinVGD", "baselines", "fused_svgd_step",
           "lifecycle", "svgd_force", "svgd_step_spec", "MultiSWAG",
           "swag_collect", "swag_sample", "swag_sample_stacked",
           "swag_state_init"]
