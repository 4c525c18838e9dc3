"""paligemma-3b [vlm] — SigLIP + gemma decoder. [arXiv:2407.07726]

18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216.
The SigLIP vision encoder + projector are a stub:
data.synthetic.make_batch provides stub patch embeddings (B, 256, d_model),
prepended to the text embeddings with a PaliGemma-style prefix-LM mask
(bidirectional attention over the image prefix, causal over text).
long_500k skipped (full attention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    d_model=2048,
    vocab_size=257_216,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    pattern=("attn_mlp",),
    n_units=18,
    n_prefix_tokens=256,
    prefix_lm=True,
    rope_theta=10_000.0,
    max_seq_len=32_768 + 256,
    default_particles=4,
)
