"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

38L d_model=2048 32H (kv=32) d_ff=8192, ssm_state=64. The backbone is
Mamba2 blocks; a single *shared* transformer block (one parameter copy,
applied at multiple depths — zamba2's core trick) is interleaved every
6th position: pattern unit = 5 mamba + 1 shared_attn (x6) + 2 mamba tail
= 38 blocks. We share the full block parameters across invocations
(zamba2's per-invocation LoRA deltas are omitted, as in the reference).
Hybrid (SSM-dominant) decode -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    d_model=2048,
    vocab_size=32_000,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    n_units=6,
    tail_layers=("mamba", "mamba"),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    max_seq_len=1_048_576,
    default_particles=8,
)
