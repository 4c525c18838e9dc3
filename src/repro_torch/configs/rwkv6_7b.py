"""rwkv6-7b [ssm] — Finch, data-dependent decay. [arXiv:2404.05892]

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.
Linear-time decode (O(1) state) -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    d_model=4096,
    vocab_size=65_536,
    n_heads=0,
    d_ff=14_336,
    pattern=("rwkv",),
    n_units=32,
    rwkv_head_dim=64,
    act="relu_sq",               # RWKV channel-mix uses squared relu
    max_seq_len=1_048_576,
    default_particles=2,
)
