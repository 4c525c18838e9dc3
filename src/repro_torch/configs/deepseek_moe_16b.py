"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6.
[arXiv:2401.06066] Layer 0 is a dense MLP (DeepSeekMoE keeps the first
layer dense); remaining 27 layers are attn+MoE. The per-expert hidden dim
is the fine-grained d_ff=1408; the two shared experts form a dense
2*1408-wide MLP applied to every token.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    d_model=2048,
    vocab_size=102_400,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408 * 8,               # dense layer-0 MLP width (8x fine-grained)
    head_layers=("attn_mlp",),
    pattern=("attn_moe",),
    n_units=27,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    shared_d_ff=1408 * 2,
    rope_theta=10_000.0,
    max_seq_len=32_768,
    default_particles=2,
)
