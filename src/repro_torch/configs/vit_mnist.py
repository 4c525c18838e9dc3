"""Paper-faithful workload: the b16 vision transformer of Push Fig. 4.

"image size of 28, patch size of 14, 10 classes, 8 heads, 16 layers,
MLP dimension of 1280, and hidden dimension of 320" (Appendix C.1).
Counterpart of ``repro.configs.vit_mnist``: ``CONFIG`` and the Table-1
variant (12 heads, MLP 3072, hidden 768, varying layers).
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


def table1_variant(depth: int) -> ModelConfig:
    """The Table-1 depth-vs-particles ViT: default b16 dims, varying layers."""
    return CONFIG.replace(
        name=f"vit-mnist-d{depth}", d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, n_units=depth)
