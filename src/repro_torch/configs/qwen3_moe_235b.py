"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family]

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
MoE 128e top-8, no shared experts. head_dim=128. P=1; expert-parallel over
the model axis. Adafactor in the dry run (optimizer-state HBM).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    d_model=4096,
    vocab_size=151_936,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    pattern=("attn_moe",),
    n_units=94,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    n_shared_experts=0,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    optimizer="adafactor",
    default_particles=1,
)
