"""Model configs for the port (counterpart of ``repro.configs.base``).

A ``ModelConfig`` describes one architecture. The port runs every
family of the reference: the decoder-only LMs ("dense" and "moe":
``attn_mlp``, ``attn_moe`` and sliding-window ``local`` layers; "ssm":
RWKV6's ``rwkv`` layers; "hybrid": Mamba2's ``mamba`` layers with
zamba2's ``shared_attn``, one attention block whose one parameter copy
serves every occurrence), the encoder-decoder "audio" (whisper: an
``enc_attn_mlp`` encoder of ``n_encoder_layers`` over ``n_frames`` stub
frames, ``dec_attn_mlp`` decoder layers with cross-attention), the
prefix-LM "vlm" (paligemma: ``n_prefix_tokens`` stub patches in front of
the text, seen bidirectionally under ``prefix_lm``), the ViT's family
"vision" and the 1-D conv UNet (family "pde": ``d_model`` is its base
channel count, ``n_units`` its depth, ``max_seq_len`` its grid). Field
names and defaults match the reference, so one set of ``replace(...)``
keywords builds the same model in both packages. ``InputShape`` and the
four workload shapes are copies of the reference's.

The layer stack is ``head_layers + pattern * n_units + tail_layers``; the
repeated pattern units are stored stacked on a leading ``n_units`` axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str          # dense | moe | ssm | hybrid | audio | vlm | vision | pde
    d_model: int
    vocab_size: int

    # --- layer stack -----------------------------------------------------
    pattern: Tuple[str, ...] = ("attn_mlp",)
    n_units: int = 1
    head_layers: Tuple[str, ...] = ()
    tail_layers: Tuple[str, ...] = ()

    # --- attention -------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # for 'local' layers
    logit_softcap: float = 0.0

    # --- mlp ---------------------------------------------------------------
    d_ff: int = 0
    act: str = "swiglu"
    norm: str = "rms"                # rms | layer

    # --- moe ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    n_shared_experts: int = 0
    shared_d_ff: int = 0             # hidden dim of the shared-expert MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- ssm / hybrid ------------------------------------------------------
    ssm_state: int = 0               # Mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv_head_dim: int = 64

    # --- encoder-decoder (audio) -------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500             # stubbed conv-frontend output length

    # --- vlm ----------------------------------------------------------------
    n_prefix_tokens: int = 0         # stubbed SigLIP patch embeddings
    prefix_lm: bool = False          # bidirectional attention over the prefix

    # --- misc ----------------------------------------------------------------
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    dtype: str = "float32"           # compute dtype
    remat: bool = False              # alias of remat_policy="nothing_saveable"
    # named checkpoint policy for each unit of the LM stack
    # (core.precision.checkpoint_policy menu); overrides `remat`
    remat_policy: Optional[str] = None
    precision: Optional[str] = None  # store precision preset; None -> fp32
    optimizer: str = "adam"          # adam | adafactor | sgd: make_optimizer(cfg)
    default_particles: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_layers(self) -> int:
        return (len(self.head_layers) + self.n_units * len(self.pattern)
                + len(self.tail_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced variant for CPU tests: same layer kinds, tiny dims (the
        reference's ``smoke()``)."""
        nh = min(self.n_heads, 4) if self.n_heads else 0
        return self.replace(
            name=self.name + "-smoke",
            d_model=min(self.d_model, 128),
            n_heads=nh,
            n_kv_heads=max(1, min(self.n_kv_heads, nh)) if nh else 0,
            head_dim=32 if nh else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_units=min(self.n_units, 2 if len(self.pattern) == 1 else 1),
            head_layers=self.head_layers[:1],
            tail_layers=self.tail_layers[:1],
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            shared_d_ff=min(self.shared_d_ff, 128) if self.shared_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            rwkv_head_dim=32,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_frames=min(self.n_frames, 16),
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else 0),
            max_seq_len=256,
            default_particles=1,
        )


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}
