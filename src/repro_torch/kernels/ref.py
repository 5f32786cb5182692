"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, materialising what the
kernel keeps on chip.  ``ops`` runs them for CPU tensors (the tests), and
``chip_smoke.py`` holds each kernel against them on the card.  They mirror
``repro.kernels.ref`` (``tests/test_torch_kernels.py`` checks that).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import attend


def verify_argmax(h: torch.Tensor, w: torch.Tensor):
    """h (T, d), w (d, V) -> (argmax (T,) int32, max (T,) f32) of h @ w with
    float32 accumulation; ties go to the lowest index."""
    logits = h.float() @ w.float()
    mx, arg = logits.max(dim=-1)
    return arg.to(torch.int32), mx


def lora_logits(h: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                gamma: float) -> torch.Tensor:
    """Draft-head logits h@w + gamma*(h@a)@b, float32 out."""
    hf = h.float()
    return hf @ w.float() + gamma * ((hf @ a.float()) @ b.float())


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a contiguous cache.

    q (B, H, hd): one query per lane attending slots j < lengths[b].
    q (B, Tq, H, hd): a block of Tq queries; ``lengths`` is the cache length
    AFTER the block's own write, and query t attends j < lengths[b]-(Tq-1-t).
    k/v (B, S, KV, hd).  Returns q's shape in q's dtype."""
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    Tq, S = q4.shape[1], k.shape[1]
    t = torch.arange(Tq, device=q.device)
    lim = lengths.long()[:, None] - (Tq - 1 - t)[None, :]              # (B, Tq)
    mask = torch.arange(S, device=q.device)[None, None, :] < lim[:, :, None]
    out = attend(q4, k, v, mask)
    return out[:, 0] if single else out
