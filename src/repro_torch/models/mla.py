"""DeepSeek-V3 multi-head latent attention [arXiv:2412.19437]: port of
``repro.models.mla``.

The cache holds only the compressed latent ``c_kv`` (kv_lora_rank) and the
shared RoPE key (qk_rope_head_dim) of each token.  The full-sequence path
(prefill, training) decompresses them into per-head keys and values and
attends through ``layers.attend_full``; the block-decode path uses the
*absorbed* form: ``W_uk`` folded into the query, scores over the latent and
RoPE caches, ``W_uv`` applied to the attention-weighted latents.

Plain PyTorch on purpose, as the reference attends MLA in ``jnp`` outside
any Pallas kernel.  Every shape depends on the block and the cache
capacity alone, so a block-step replays as one CUDA graph.  The reference's
roundings in a bf16 model are kept: the two score products are summed in
the model dtype before the float32 softmax, and the probabilities are cast
back to the model dtype before the latent product.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.launch.hints import hint
from repro_torch.models.layers import (NEG_INF, MaskSpec, apply_rope, attend_full, dense_init,
                                       rms_norm)


def init_mla(gen: torch.Generator, n: int, d: int, H: int, m: MLAConfig,
             dtype: torch.dtype) -> dict:
    """`n` stacked MLA layers in the reference's layout, on the generator's
    device; the two latent norms' gains (``q_ln``, ``kv_ln``) float32."""
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    def gain(width):
        return torch.zeros((n, width), dtype=torch.float32, device=gen.device)

    return {
        "w_dq": dense_init(gen, (n, d, m.q_lora_rank), dtype),
        "q_ln": gain(m.q_lora_rank),
        "w_uq": dense_init(gen, (n, m.q_lora_rank, H * (dn + dr)), dtype),
        "w_dkv": dense_init(gen, (n, d, m.kv_lora_rank), dtype),
        "kv_ln": gain(m.kv_lora_rank),
        "w_kr": dense_init(gen, (n, d, dr), dtype),
        "w_uk": dense_init(gen, (n, m.kv_lora_rank, H * dn), dtype),
        "w_uv": dense_init(gen, (n, m.kv_lora_rank, H * dv), dtype),
        "w_o": dense_init(gen, (n, H * dv, d), dtype),
    }


def _queries(p, xn, H: int, m: MLAConfig, positions, rope_theta: float):
    """(q_nope (B, T, H, dn), q_rope (B, T, H, dr)), the RoPE part rotated."""
    B, T = xn.shape[:2]
    dn = m.qk_nope_head_dim
    q = (rms_norm(xn @ p["w_dq"], p["q_ln"]) @ p["w_uq"]).reshape(B, T, H, -1)
    return q[..., :dn], apply_rope(q[..., dn:], positions, rope_theta)


def _latents(p, xn, positions, rope_theta: float):
    """(c_kv (B, T, r_kv), the shared RoPE key (B, T, dr)) of the tokens."""
    ckv = rms_norm(xn @ p["w_dkv"], p["kv_ln"])
    krope = apply_rope((xn @ p["w_kr"])[:, :, None, :], positions, rope_theta)[:, :, 0]
    return ckv, krope


def mla_full(p: dict, xn: torch.Tensor, H: int, m: MLAConfig, positions, spec: MaskSpec,
             rope_theta: float):
    """Decompressed attention over the whole sequence: the shared RoPE key
    is broadcast into per-head keys of width dn + dr against values of
    width dv, so standard attention computes q_nope.k_nope + q_rope.k_rope.
    xn: the pre-normed input (B, T, d).  Returns (out (B, T, d), the cache
    contributions {"ckv", "krope"})."""
    B, T = xn.shape[:2]
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope = _queries(p, xn, H, m, positions, rope_theta)
    ckv, krope = _latents(p, xn, positions, rope_theta)
    k_nope = (ckv @ p["w_uk"]).reshape(B, T, H, dn)
    v = (ckv @ p["w_uv"]).reshape(B, T, H, dv)
    q_cat = hint(torch.cat([q_nope, q_rope], dim=-1), "data", None, "model", None)
    k_cat = hint(torch.cat([k_nope, krope[:, :, None, :].expand(B, T, H, dr)], dim=-1),
                 "data", None, "model", None)
    v = hint(v, "data", None, "model", None)
    out = attend_full(q_cat, k_cat, v, spec).reshape(B, T, H * dv)
    return out @ p["w_o"], {"ckv": ckv, "krope": krope}


def mla_step(p: dict, xn: torch.Tensor, cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
             lengths: torch.Tensor, H: int, m: MLAConfig, positions,
             rope_theta: float) -> torch.Tensor:
    """Absorbed-form block decode against the latent caches cache_ckv
    (B, S, r_kv) and cache_krope (B, S, dr).  The block's latents are
    written into them IN PLACE at slots lengths .. lengths + T - 1
    (``transformer.spread_write``: writes past S are dropped) before the
    scores read them; slot s is visible to query t iff s <= lengths + t, so
    rollback is length truncation.  Returns the attention output
    (B, T, d)."""
    from repro_torch.models.transformer import spread_write
    B, T = xn.shape[:2]
    S = cache_ckv.shape[1]
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r_kv = m.kv_lora_rank
    q_nope, q_rope = _queries(p, xn, H, m, positions, rope_theta)
    ckv, krope = _latents(p, xn, positions, rope_theta)
    spread_write(cache_ckv, ckv, lengths)
    spread_write(cache_krope, krope, lengths)
    # W_uk folded into the query: q_eff[b, t, h] = q_nope[b, t, h] . W_uk_h
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope, p["w_uk"].reshape(r_kv, H, dn))
    # both products in the model dtype, summed there, then float32
    scores = (torch.einsum("bthr,bsr->bhts", q_eff, cache_ckv)
              + torch.einsum("bthd,bsd->bhts", q_rope, cache_krope)).float()
    scores = scores * (1.0 / math.sqrt(dn + dr))
    qpos = lengths[:, None].long() + torch.arange(T, device=xn.device)[None, :]    # (B, T)
    mask = torch.arange(S, device=xn.device)[None, None, :] <= qpos[:, :, None]   # (B, T, S)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(xn.dtype)
    o_lat = torch.einsum("bhts,bsr->bthr", probs, cache_ckv)                  # (B, T, H, r)
    out = torch.einsum("bthr,rhd->bthd", o_lat, p["w_uv"].reshape(r_kv, H, dv))
    return out.reshape(B, T, H * dv) @ p["w_o"]
