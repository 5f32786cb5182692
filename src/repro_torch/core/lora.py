"""LoRA-parameterised draft head (paper §3.1), port of ``repro.core.lora``.

    p_theta(. | h_k) = softmax((W_S + gamma_s * A_s B_s) h_k)

W_S is the frozen verifier head; only (A_s, B_s) train.  The draft path
reuses the backbone's frozen final RMSNorm on h_k, then the fused
``lora_logits`` kernel computes the logits in one pass over W_S.  The kernel's
wrapper is differentiable in (A_s, B_s), so the online loss trains them
through it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import Model


def init_draft_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """A ~ N(0, 1/d), B = 0 (the drafter starts as the verifier head read at
    layer k), both float32 on the generator's device."""
    r, d, V = cfg.dvi.lora_rank, cfg.d_model, cfg.vocab_size
    a = torch.randn((d, r), generator=gen, dtype=torch.float32, device=gen.device)
    return {"A": a / math.sqrt(d),
            "B": torch.zeros((r, V), dtype=torch.float32, device=gen.device)}


def draft_logits(model: Model, params: dict, dvi_params: dict,
                 h_k: torch.Tensor) -> torch.Tensor:
    """h_k (T, d) -> float32 logits (T, V).

    The normed h_k is cast to W's dtype, as the kernel takes them in one
    dtype: a no-op on the serving path, where h_k is in the model dtype; the
    replay buffer's float32 rows are rounded to bf16 in a bf16 model, where
    the reference multiplies float32 by bf16 (ROADMAP §3)."""
    cfg = model.cfg
    gamma = cfg.dvi.lora_alpha / cfg.dvi.lora_rank
    w = model.head_matrix(params)
    hn = rms_norm(h_k, params["final_norm"], cfg.norm_eps).to(w.dtype)
    return ops.lora_logits(hn, w, dvi_params["A"], dvi_params["B"], gamma)


def num_trainable(dvi_params: dict) -> int:
    return sum(p.numel() for p in dvi_params.values())
