"""whisper-medium [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. The mel-spectrogram +
conv feature extractor is a stub: data.synthetic.make_batch provides frame
embeddings (B, n_frames=1500, d_model). The transformer backbone (24-layer
encoder + 24-layer decoder with cross-attention) is fully implemented.
long_500k is skipped (audio-context-bounded decode; see DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    d_model=1024,
    vocab_size=51_865,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    act="gelu",
    norm="layer",
    pattern=("dec_attn_mlp",),
    n_units=24,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    n_frames=1500,
    max_seq_len=32_768,
    default_particles=8,
)
