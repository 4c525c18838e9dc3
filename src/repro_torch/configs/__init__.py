"""Registry of the configs the port runs (``get(name)``)."""
from .base import ModelConfig
from . import (deepseek_moe_16b, gemma3_4b, llama3_405b, llama3_8b,
               qwen1p5_0p5b, qwen3_moe_235b, rwkv6_7b, unet_advection,
               vit_mnist, zamba2_1p2b)

ALL = {
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "qwen1.5-0.5b": qwen1p5_0p5b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "zamba2-1.2b": zamba2_1p2b.CONFIG,
    "vit-mnist": vit_mnist.CONFIG,
    "unet-advection": unet_advection.CONFIG,
}


def get(name: str) -> ModelConfig:
    if name not in ALL:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"ported: {sorted(ALL)}")
    return ALL[name]
