"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
The sweet spot of the paper's technique: many particles of a small model
(default 16 particles in the dry run).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    d_model=1024,
    vocab_size=151_936,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    qkv_bias=True,
    pattern=("attn_mlp",),
    n_units=24,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=32_768,
    default_particles=16,
)
