"""Model and DVI configuration: the port's own copy of ``repro.configs.base``.

The port may not import the JAX package (its config module imports
``jax.numpy`` for the dtype), so the dataclasses are copied here with
``torch_dtype`` in place of ``jnp_dtype``.  Field names and defaults match
the reference exactly (``tests/test_torch_model.py`` compares them); the
sub-configs of the architectures this slice does not run (MoE, MLA, SSM,
RG-LRU, encoder, vision) are kept as opaque ``Optional`` fields so a config
that sets one is rejected by ``build_model`` instead of being misread.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class DVIConfig:
    """Draft, Verify, & Improve (the paper's technique)."""
    split_layer: int = 2          # draft path = layers [0, split_layer)
    k_spec: int = 4               # proposal depth
    lora_rank: int = 64
    lora_alpha: float = 128.0     # gamma_s = alpha / rank
    # loss weights (L_fast)
    lambda_kl0: float = 1.0
    lambda_kl_min: float = 0.1
    lambda_pg_max: float = 1.0
    w_ce: float = 0.5
    w_ent: float = 0.001
    kd_temperature: float = 2.0
    # on-policy correction (L_policy)
    w_rl: float = 0.5
    beta0: float = 0.3
    beta_min: float = 0.03
    beta_decay_steps: int = 1000
    baseline_ema: float = 0.95
    # schedule
    warmup_steps: int = 200
    ramp_steps: int = 400
    # buffer
    buffer_slots: int = 4096
    batch_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    qk_norm: bool = False          # per-head RMSNorm on q,k (Qwen3)
    qkv_bias: bool = False         # (Qwen2.5)
    rope_theta: float = 10000.0
    sliding_window: int = 0
    global_attn_every: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU / plain)
    glu: bool = True
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    rglru: Optional[Any] = None
    encoder: Optional[Any] = None
    vision: Optional[Any] = None
    dvi: DVIConfig = field(default_factory=DVIConfig)
    mtp_depth: int = 0
    kv_quant: bool = False
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Repeating per-layer block pattern (dense stacks: attention only,
        or local/global interleaves when a sliding window is set)."""
        if self.arch_type == "ssm":
            return ("ssm",)
        if self.rglru is not None:
            return tuple(self.rglru.block_pattern)
        if self.global_attn_every and self.sliding_window:
            pat = ["local"] * self.global_attn_every
            pat[-1] = "attn"
            return tuple(pat)
        if self.sliding_window:
            return ("local",)
        return ("attn",)

    def validate(self) -> None:
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.arch_type != "ssm" and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if not 0 < self.dvi.split_layer < self.num_layers:
            raise ValueError("split_layer must lie inside the stack")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
