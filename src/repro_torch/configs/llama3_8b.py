"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    d_model=4096,
    vocab_size=128_256,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    pattern=("attn_mlp",),
    n_units=32,
    rope_theta=500_000.0,
    max_seq_len=131_072,
    default_particles=2,
)
