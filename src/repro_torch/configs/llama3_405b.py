"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

P=1 (a single particle sharded across devices — the paper's "single
particle across devices" future-work item). Uses adafactor in the dry-run
so optimizer state fits v5e HBM at 256 chips.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    d_model=16_384,
    vocab_size=128_256,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53_248,
    pattern=("attn_mlp",),
    n_units=126,
    rope_theta=500_000.0,
    max_seq_len=131_072,
    optimizer="adafactor",
    default_particles=1,
)
