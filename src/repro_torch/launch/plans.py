"""Run plans: how each (arch x input shape) maps onto the production mesh
(counterpart of ``repro.launch.plans``: the same policy, the same numbers).

  * particle-parallel archs (P=16): particle axis -> ``data``, tensor
    parallelism within a particle over ``model``, batch replicated.
  * P=1 giants (llama3-405b, qwen3-moe-235b): FSDP over ``data`` + TP over
    ``model`` (mode "fsdp_tp"; the port's steps refuse it, ROADMAP item
    29).
  * decode shapes: the batch over ``data``, a small replicated serve
    ensemble (P_serve).
  * microbatching (gradient accumulation) bounds the activation memory on
    train_4k.

The plans are the reference's policy, not a fact of its hardware, so the
port keeps its own copy of them unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# particle counts used in the dry run
PARTICLES = {
    "deepseek-moe-16b": 16, "llama3-8b": 16, "rwkv6-7b": 16,
    "whisper-medium": 16, "gemma3-4b": 16, "paligemma-3b": 16,
    "zamba2-1.2b": 16, "qwen1.5-0.5b": 16,
    "llama3-405b": 1, "qwen3-moe-235b-a22b": 1,
    "vit-mnist": 16, "unet-advection": 16,
}
# gradient-accumulation microbatches for train_4k (activation memory bound)
MICROBATCHES = {
    "llama3-405b": 32, "qwen3-moe-235b-a22b": 32, "deepseek-moe-16b": 32,
    "llama3-8b": 16, "rwkv6-7b": 32, "gemma3-4b": 16, "paligemma-3b": 16,
    "whisper-medium": 16, "zamba2-1.2b": 32, "qwen1.5-0.5b": 8,
}
# replicated serve-ensemble size for prefill/decode shapes (small models
# serve a 4-way posterior-predictive ensemble; giants serve P=1)
SERVE_PARTICLES = {
    "qwen1.5-0.5b": 4, "zamba2-1.2b": 2, "whisper-medium": 4,
    "gemma3-4b": 2, "paligemma-3b": 2, "rwkv6-7b": 2, "llama3-8b": 2,
    "deepseek-moe-16b": 1, "llama3-405b": 1, "qwen3-moe-235b-a22b": 1,
}
# bf16 parameters in the dry run for the largest models (memory budget)
BF16_PARAMS = {"llama3-405b", "qwen3-moe-235b-a22b", "deepseek-moe-16b",
               "llama3-8b", "rwkv6-7b", "gemma3-4b", "paligemma-3b"}


@dataclass(frozen=True)
class RunPlan:
    arch: str
    shape: str
    particles: int            # particle axis length (1 = squeezed)
    serve_particles: int      # replicated serve ensemble for decode shapes
    microbatches: int
    mode: str                 # "tp" (particle-parallel) | "fsdp_tp"
    particle_axis: Optional[str]  # mesh axis carrying particles
    param_dtype: str


def plan_for(cfg, shape) -> RunPlan:
    """The plan of ``cfg`` (a ``configs.ModelConfig``) at ``shape`` (a
    ``configs.InputShape``)."""
    P = PARTICLES.get(cfg.name, cfg.default_particles)
    mode = "fsdp_tp" if P == 1 else "tp"
    particle_axis = "data" if P > 1 else None
    serve_p = SERVE_PARTICLES.get(cfg.name, 1)
    if shape.name == "long_500k":
        serve_p = 1
    micro = MICROBATCHES.get(cfg.name, 1) if shape.kind == "train" else 1
    pdt = "bfloat16" if (cfg.name in BF16_PARAMS or getattr(
        cfg, "param_dtype", "float32") == "bfloat16") else "float32"
    if shape.kind in ("decode", "prefill"):
        # serving: a small replicated posterior-predictive ensemble; the
        # batch (not the particle axis) shards over `data`
        P, particle_axis = serve_p, None
    return RunPlan(cfg.name, shape.name, P, serve_p, micro, mode,
                   particle_axis, pdt)
