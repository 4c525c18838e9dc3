"""Registry of every architecture config (``get(name)``), the
counterpart of ``repro.configs``: the ten assigned architectures, the
paper's own two workloads, and the (arch, shape) pairs a dry run skips."""
from .base import (ModelConfig, InputShape, INPUT_SHAPES,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

from . import (deepseek_moe_16b, llama3_8b, llama3_405b, rwkv6_7b,
               whisper_medium, gemma3_4b, paligemma_3b, zamba2_1p2b,
               qwen1p5_0p5b, qwen3_moe_235b, vit_mnist, unet_advection)

# The 10 assigned architectures (plus the paper's own two workloads).
ARCHS = {
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "zamba2-1.2b": zamba2_1p2b.CONFIG,
    "qwen1.5-0.5b": qwen1p5_0p5b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
}
PAPER_WORKLOADS = {
    "vit-mnist": vit_mnist.CONFIG,
    "unet-advection": unet_advection.CONFIG,
}
ALL = {**ARCHS, **PAPER_WORKLOADS}

# (arch, shape) pairs skipped in the dry run, with the reason.
SKIPS = {
    ("llama3-8b", "long_500k"): "pure full-attention decode",
    ("llama3-405b", "long_500k"): "pure full-attention decode",
    ("qwen1.5-0.5b", "long_500k"): "pure full-attention decode",
    ("qwen3-moe-235b-a22b", "long_500k"): "pure full-attention decode",
    ("deepseek-moe-16b", "long_500k"): "pure full-attention decode",
    ("paligemma-3b", "long_500k"): "pure full-attention decode",
    ("whisper-medium", "long_500k"): "audio-context-bounded decode",
}


def get(name: str) -> ModelConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL)}")
    return ALL[name]


def is_skipped(arch: str, shape: str) -> str | None:
    return SKIPS.get((arch, shape))
