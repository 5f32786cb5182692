"""Model and DVI configuration: the port's own copy of ``repro.configs.base``.

The port may not import the JAX package (its config module imports
``jax.numpy`` for the dtype), so the dataclasses are copied here with
``torch_dtype`` in place of ``jnp_dtype``.  Field names and defaults match
the reference exactly (``tests/test_torch_model.py`` compares them).
``SSMConfig`` (Mamba-2), ``RGLRUConfig`` (RecurrentGemma), ``MoEConfig``,
``MLAConfig`` (DeepSeek-V3's multi-head latent attention), ``EncoderConfig``
(Whisper's encoder over stub frame embeddings) and ``VisionStubConfig``
(PaliGemma's stub patch embeddings) are copied too, and so are the input
shapes assigned to the paper (``InputShape``, ``INPUT_SHAPES``), which the
dry run (``launch.dryrun``) and the roofline (``roofline``) read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25   # full-sequence dispatch; decode is dropless
    # layers 0..first_dense_layers-1 use a dense FFN instead of MoE
    first_dense_layers: int = 0
    d_ff_dense: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block [arXiv:2402.19427]."""
    lru_width: int = 0          # 0 => d_model
    d_conv: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "local")  # 1:2 attn:recurrent
    local_window: int = 2048


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block [arXiv:2405.21060]."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128
    ngroups: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """Audio/vision encoder backbone (frontend stubbed to embeddings)."""
    num_layers: int
    num_frames: int            # precomputed frame/patch positions fed by the caller
    d_model: int = 0           # 0 => same as decoder d_model
    num_heads: int = 0


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM prefix: precomputed patch embeddings prepended to the text tokens."""
    num_patches: int
    d_embed: int               # dim of incoming patch embeddings (pre-projector)


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
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
        """Repeating per-layer block pattern: ("ssm",) for Mamba-2, the
        RG-LRU block pattern, local/global interleaves when a sliding
        window is set, else attention only.  Its period need not divide
        num_layers (recurrentgemma-9b: 38 = 12 (r, r, l) + (r, r))."""
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
        if self.moe is not None and (self.moe.top_k > self.moe.num_experts
                                     or self.moe.first_dense_layers >= self.num_layers):
            raise ValueError("moe: top_k > num_experts or every layer dense")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings, blocks, head and, for an
        encoder, its layers and the decoder's cross-attention), the
        reference's formula."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        n = V * d
        if not self.tie_embeddings:
            n += V * d
        if self.mla is not None:
            m = self.mla
            per_layer_attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * d)
        elif self.arch_type == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per_layer_attn = (d * (2 * d_in + 2 * s.ngroups * s.d_state + d_in // s.head_dim)
                              + d_in * d)
        else:
            per_layer_attn = (d * (self.num_heads + 2 * self.num_kv_heads) * hd
                              + self.num_heads * hd * d)
        glu_mult = 3 if self.glu else 2
        if self.moe is not None:
            mo = self.moe
            moe_layers = L - mo.first_dense_layers
            ffn = mo.first_dense_layers * glu_mult * d * (mo.d_ff_dense or self.d_ff)
            ffn += moe_layers * (
                mo.num_experts * glu_mult * d * mo.d_ff_expert
                + mo.num_shared_experts * glu_mult * d * (mo.d_ff_shared or mo.d_ff_expert)
                + d * mo.num_experts)
        elif self.arch_type == "ssm":
            ffn = 0
        else:
            ffn = L * glu_mult * d * self.d_ff
        n += L * per_layer_attn + ffn + 2 * L * d
        if self.encoder is not None:
            e = self.encoder
            ed = e.d_model or d
            # encoder self-attention and FFN, and the decoder's cross-attention
            n += e.num_layers * (4 * ed * ed + glu_mult * ed * self.d_ff)
            n += L * 4 * d * ed
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d, L = self.d_model, self.num_layers
        glu_mult = 3 if self.glu else 2
        moe_layers = L - mo.first_dense_layers
        dense_total = self.param_count() - moe_layers * (
            mo.num_experts * glu_mult * d * mo.d_ff_expert)
        return dense_total + moe_layers * mo.top_k * glu_mult * d * mo.d_ff_expert

    @property
    def local_window(self) -> int:
        """The window of the "local" layers: the RG-LRU config's, else
        ``sliding_window``."""
        return self.rglru.local_window if self.rglru is not None else self.sliding_window

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (the reference's, copied).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
