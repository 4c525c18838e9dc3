"""Registry of the configs the port runs (``get(name)``)."""
from .base import ModelConfig
from . import llama3_8b, qwen1p5_0p5b, unet_advection, vit_mnist

ALL = {
    "llama3-8b": llama3_8b.CONFIG,
    "qwen1.5-0.5b": qwen1p5_0p5b.CONFIG,
    "vit-mnist": vit_mnist.CONFIG,
    "unet-advection": unet_advection.CONFIG,
}


def get(name: str) -> ModelConfig:
    if name not in ALL:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"ported: {sorted(ALL)}")
    return ALL[name]
