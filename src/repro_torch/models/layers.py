"""Shared layer primitives: RMSNorm, RoPE, GQA attention, GLU MLPs, the
causal depthwise convolution of the Mamba-2 block.

Port of ``repro.models.layers`` with the same conventions:

* activations (B, T, d); attention heads laid out (B, T, H, hd);
* norms and softmax run in float32 whatever the model dtype, and the norm
  gain is ``1 + w`` with ``w`` initialised to zeros (not ``nn.RMSNorm``);
* RoPE is half-split (first half / second half), not interleaved;
* masks use the finite ``NEG_INF = -1e30``, never ``-inf``: a row with no
  allowed key gives finite garbage instead of NaN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def head_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head qk RMSNorm (Qwen3): x (..., H, hd), w (hd,)."""
    return rms_norm(x, w, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) integer.  Half-split convention."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
           scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Tq,H,hd), k/v (B,Tk,KV,hd), mask (B,Tq,Tk) or (Tq,Tk) bool.

    GQA: H must be a multiple of KV; query heads are grouped onto kv heads.
    The probabilities are cast to ``v.dtype`` before the PV product, as in
    the reference.  Returns (B, Tq, H, hd_v)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Tq, KV, G, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k).float() * scale
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, Tq, KV * G, v.shape[-1])


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Declarative attention mask: causal [+ window] [+ bidirectional prefix]
    or fully bidirectional, so the blockwise path never builds a quadratic
    mask."""
    window: int = 0
    prefix_len: int = 0
    bidirectional: bool = False

    def allowed(self, qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
        """qpos (..., Tq, 1), kpos (..., 1, Tk) -> bool."""
        if self.bidirectional:
            return torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                              dtype=torch.bool, device=qpos.device)
        m = kpos <= qpos
        if self.window:
            m &= kpos > qpos - self.window
        if self.prefix_len:
            m |= (qpos < self.prefix_len) & (kpos < self.prefix_len)
        return m


# blockwise path kicks in above this many score elements (per example pair)
_FLASH_THRESHOLD = 1024 * 1024


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: MaskSpec,
                q_chunk: int = 256, k_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence self-attention with a declarative mask.

    Small T: materialise the mask and use ``attend``.  Large T: blockwise
    online softmax over (q-chunk, k-chunk) pairs, memory O(T * k_chunk)
    instead of O(T^2).  Plain PyTorch on purpose: the reference computes
    this in jnp, not in a Pallas kernel."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    if Tq * Tk <= _FLASH_THRESHOLD:
        mask = (causal_mask(Tq, Tk, window=spec.window, prefix_len=spec.prefix_len,
                            device=q.device)
                if not spec.bidirectional
                else torch.ones((Tq, Tk), dtype=torch.bool, device=q.device))
        return attend(q, k, v, mask)

    KV = k.shape[2]
    hdv = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qc = min(q_chunk, Tq)
    kc = min(k_chunk, Tk)
    pad_q = (-Tq) % qc
    pad_k = (-Tk) % kc
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = qp.shape[1] // qc, kp.shape[1] // kc
    qb = qp.reshape(B, nq, qc, KV, G, hd)
    kb = kp.reshape(B, nk, kc, KV, hd)
    vb = vp.reshape(B, nk, kc, KV, hdv)
    outs = []
    for qi in range(nq):
        qblk = qb[:, qi]                                          # (B,qc,KV,G,hd)
        qpos = qi * qc + torch.arange(qc, device=q.device)
        m_run = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, hdv), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kblk, vblk = kb[:, kj], vb[:, kj]
            kpos = kj * kc + torch.arange(kc, device=q.device)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk).float() * scale
            allowed = spec.allowed(qpos[:, None], kpos[None, :]) & (kpos[None, :] < Tk)
            s = torch.where(allowed[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vblk.dtype), vblk).float()
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, qc, KV * G, hdv).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Tq]


def causal_mask(Tq: int, Tk: int, offset: int = 0, window: int = 0,
                prefix_len: int = 0, device=None) -> torch.Tensor:
    """(Tq, Tk) bool.  Query i sits at absolute position offset+i; key j at j."""
    qpos = offset + torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    if prefix_len:
        m |= (qpos < prefix_len) & (kpos < prefix_len)
    return m


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    fn = F.silu if act == "silu" else (lambda u: F.gelu(u, approximate="tanh"))
    h = x @ p["wi"]
    h = fn(h) * (x @ p["wg"]) if glu else fn(h)
    return h @ p["wo_ff"]


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B, T, C), w (cw, C); ``state`` (B, cw-1, C)
    holds the trailing inputs of the previous block (zeros if None).  Sums in
    float32, returns (y in x's dtype, the last cw-1 inputs as the new state)."""
    cw = w.shape[0]
    B, T, C = x.shape
    if state is None:
        state = torch.zeros((B, cw - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, T+cw-1, C)
    y = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + T].float() * w[i].float()
    return y.to(x.dtype), xp[:, T:]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), drawn in float32 on the
    generator's device, then cast.  The numbers differ from ``jax.random``;
    parity tests copy weights across instead of re-drawing them."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)
