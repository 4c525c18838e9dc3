"""gemma3-4b [dense] — 5:1 local:global sliding window, 128k, 262k vocab.
[hf:google/gemma-3-1b-pt family]

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256.
Pattern unit = 5 sliding-window (W=1024) layers + 1 global layer;
34 = 5*6 + 4 trailing local layers. Sliding-window local layers give
sub-quadratic prefill blocks and a bounded (W) local KV cache, so gemma3
runs long_500k: local layers use a W-token ring cache, the 1-in-6 global
layers decode against the full (linear-per-step) cache.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    d_model=2560,
    vocab_size=262_144,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    pattern=("local", "local", "local", "local", "local", "attn_mlp"),
    n_units=5,
    tail_layers=("local", "local", "local", "local"),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    logit_softcap=0.0,
    max_seq_len=1_048_576,
    default_particles=4,
)
