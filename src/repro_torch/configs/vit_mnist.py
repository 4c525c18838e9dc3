"""Paper-faithful workload: the b16 vision transformer of Push Fig. 4.

"image size of 28, patch size of 14, 10 classes, 8 heads, 16 layers,
MLP dimension of 1280, and hidden dimension of 320" (Appendix C.1).
Counterpart of ``repro.configs.vit_mnist.CONFIG``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="vit-mnist",
    family="vision",
    d_model=320,
    vocab_size=10,            # n_classes
    n_heads=8,
    n_kv_heads=8,
    d_ff=1280,
    act="gelu",
    norm="layer",
    pattern=("enc_attn_mlp",),
    n_units=16,
    max_seq_len=8,            # 4 patches + cls
    default_particles=8,
)
