"""Segmented decoder stack with a speculative-decoding cache.

Port of ``repro.models.transformer`` for these stacks: dense attention +
dense FFN; attention-free Mamba-2 (``models.ssm``, SSD blocks with no FFN);
the RecurrentGemma hybrid of RG-LRU blocks (``models.rglru``) and
sliding-window ("local") attention; local/global attention interleaves
with a mixture-of-experts FFN (``models.moe``, Llama-4 Scout); and
DeepSeek-V3's multi-head latent attention (``models.mla``) over dense and
MoE FFNs; Whisper's decoder, whose layers cross-attend the encoder's
output after their self-attention (``Segment.cross``, no RoPE), and its
bidirectional encoder; PaliGemma's decoder, whose first P positions (the
projected patches) attend each other bidirectionally.  Layers are grouped
into *segments* (runs of layers of one (mixer, FFN) kind), each with its
parameters stacked on a leading layer axis, and segments are cut at
``cfg.dvi.split_layer`` so the draft path (layers [0, k)) and the target
path ([k, L)) run as separate segment ranges over one parameter tree.

Two execution modes:

* ``forward_full`` — a whole sequence without a cache (prefill and
  training); optionally returns each layer's K/V so prefill can fill the
  decode cache.
* ``forward_step`` — a block of T tokens (K+1 during speculation, 1 for AR)
  against the cache.  K/V are written into the cache in place at slots
  ``lengths + i`` before attention reads it; rollback is length truncation
  (``commit_cache``), so a rejected token's slot is simply overwritten by
  the next block.  SSM segments return *candidates* instead: the conv
  window and SSD state after every token of the block, leaving the cache's
  state untouched; ``commit_cache`` selects each lane's candidate at its
  accepted length.  Attention over the cache goes through the
  ``decode_attention`` kernel with the cache length after the block's write,
  which on a contiguous full cache is the reference's step mask
  ``pos <= qpos`` (every slot below the length is filled, stale speculative
  slots lie above ``qpos``); the port therefore keeps no ``pos`` array for
  full caches.  A sliding-window layer keeps a *ring* of C = W +
  ``RING_SLACK`` slots instead, position p at slot p % C, with a per-lane
  ``pos`` (B, C) int32 (the position each slot holds, -1 empty) shared by
  the segment's layers and written in place with the block's K/V; the ring
  form of ``decode_attention`` reads it with the window mask.  RG-LRU
  segments return candidates as SSM segments do.  An MLA segment caches
  each token's latent ``ckv`` (n, B, C, kv_lora_rank) and shared RoPE key
  ``krope`` (n, B, C, qk_rope_head_dim), slot index = position as in a
  full cache, written in place like K/V and read by the absorbed form in
  plain PyTorch (no kernel: the reference attends MLA in ``jnp``); its
  ``pos`` (B, C) is the reference's bookkeeping (the prefill's positions,
  -1 empty), which no read consults: it is not a ring.  A cross segment
(Whisper) also caches each layer's cross K/V of the encoder's output,
``xk`` / ``xv`` (n, B, F, H, hd), written once by the prefill, and the
cache holds ``xlen`` (B,) int32, all F, the length the non-causal form of
``decode_attention`` reads them with.

The int8 KV cache (``cfg.kv_quant``, the reference's): every attention K/V
leaf (contiguous, ring, paged) holds int8 values with one float32 scale a
(slot, kv head) beside it, ``ks`` / ``vs`` (n, B, C, KV) or ``ksp`` /
``vsp`` (n, P+1, ps, KV) (``layers.kv_quantize``).  A block's K/V and a
prefill's are quantised once, as they are written; the attention kernels
read the int8 values and the scales themselves.  The prefill's own
attention stays in full precision, as in the reference.  Cross K/V, MLA
latents and SSM / RG-LRU states are never quantised.

Two cache layouts (``forward_step`` reads which from the cache):

* contiguous (``init_cache``): per-lane K/V (n, B, C, KV, hd); SSM
  segments hold per-lane constant-size state, the conv window (n, B, cw-1,
  conv_dim) and the SSD state (n, B, H, hd, ds) float32, in both layouts,
  as RG-LRU segments hold their window (n, B, cw-1, w) and state (n, B, w)
  and local segments their rings;
* paged (``init_paged_cache``): K/V pooled into shared pages
  (n, P+1, ps, KV, hd), physical page 0 the null page, read and written
  through the per-lane block table ``cache["tbl"]`` (B, MPS) with the
  addressing rule ``serving.kv_pool.logical_to_physical``; attention goes
  through the ``paged_decode_attention`` kernel.  Page ownership lives on
  the host (``serving.kv_pool.KVPool``).  MLA latent caches and
  cross-attention caches have no paged layout (as in the reference).

Continuous batching edits one lane of a live cache in place:
``insert_slot`` splices a prefilled lane in (or, with ``src=None``, the
prefix cache's shared pages through the table alone), ``reset_slot``
empties one, ``map_slot_pages``/``set_block_tables`` edit the block table
and ``copy_page`` copies one page on write, scales with their values.  All
of it runs on PyTorch's current stream, so it is ordered after any step
still running on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.hints import gathered, hint
from repro_torch.models import loops
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MaskSpec, apply_rope, attend_full, dense_init,
                                       head_rms_norm, kv_quantize, mlp, rms_norm)
from repro_torch.serving.kv_pool import logical_to_physical

# Extra ring slots past the window, so eager writes (rejected speculative
# tokens, a prefill chunk's padding) never evict a slot some query still
# sees; also the spare capacity of full caches past a generation's worst
# case, and the bound of a prefill chunk.
RING_SLACK = 128


@dataclass(frozen=True)
class Segment:
    idx: int
    kind: str          # attn | local | ssm | rglru
    ffn: str           # dense | moe | none
    start: int
    n: int
    d_ff: int
    cross: bool = False  # cross-attends the encoder's output (every decoder layer of "audio")

    @property
    def name(self) -> str:
        return f"s{self.idx}"


def layer_kinds(cfg: ModelConfig):
    """(mixer kind, ffn kind) per layer: Mamba-2 blocks have no FFN, MoE
    configs a dense FFN below ``first_dense_layers`` and experts above."""
    pat = cfg.layer_pattern
    kinds = []
    for layer in range(cfg.num_layers):
        if cfg.ssm is not None:
            ffn = "none"
        elif cfg.moe is not None and layer >= cfg.moe.first_dense_layers:
            ffn = "moe"
        else:
            ffn = "dense"
        kinds.append((pat[layer % len(pat)], ffn))
    return kinds


def build_segments(cfg: ModelConfig, boundaries=()):
    """Group layers into stacked segments; force cuts at `boundaries`."""
    kinds = layer_kinds(cfg)
    cuts = set(boundaries) | {0, cfg.num_layers}
    segs, start = [], 0
    for layer in range(1, cfg.num_layers + 1):
        if layer in cuts or kinds[layer] != kinds[start]:
            kind, ffn = kinds[start]
            d_ff = cfg.d_ff
            if ffn == "dense" and cfg.moe is not None and cfg.moe.first_dense_layers:
                d_ff = cfg.moe.d_ff_dense or cfg.d_ff
            segs.append(Segment(len(segs), kind, ffn, start, layer - start, d_ff,
                                cross=cfg.arch_type == "audio"))
            start = layer
    return segs


def model_segments(cfg: ModelConfig):
    return build_segments(cfg, boundaries=(cfg.dvi.split_layer,))


def segments_in_range(cfg: ModelConfig, lo: int, hi: int):
    return [s for s in model_segments(cfg) if s.start >= lo and s.start + s.n <= hi]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: Segment,
                 dtype: torch.dtype) -> dict:
    """A segment's parameters stacked on a leading layer axis: Mamba-2
    blocks, or a mixer (attention, local attention, MLA or RG-LRU) with its
    FFN (dense, or the experts under "moe")."""
    if seg.kind == "ssm":
        return ssm_mod.init_ssm(gen, seg.n, cfg.d_model, cfg.ssm, dtype)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n, f, dev = seg.n, seg.d_ff, gen.device

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=dev)

    p = {"ln1": zeros(n, d), "ln2": zeros(n, d)}
    if seg.kind == "rglru":
        p.update(rglru_mod.init_rglru(gen, n, d, cfg.rglru, dtype))
    elif cfg.mla is not None:
        p.update(mla_mod.init_mla(gen, n, d, H, cfg.mla, dtype))
    else:
        p.update(wq=dense_init(gen, (n, d, H * hd), dtype),
                 wk=dense_init(gen, (n, d, KV * hd), dtype),
                 wv=dense_init(gen, (n, d, KV * hd), dtype),
                 wo=dense_init(gen, (n, H * hd, d), dtype))
        if cfg.qkv_bias:
            p.update(bq=zeros(n, H * hd, dt=dtype), bk=zeros(n, KV * hd, dt=dtype),
                     bv=zeros(n, KV * hd, dt=dtype))
        if cfg.qk_norm:
            p.update(qn=zeros(n, hd), kn=zeros(n, hd))
    if seg.cross and seg.kind in ("attn", "local"):
        p.update(ln_x=zeros(n, d), wq_x=dense_init(gen, (n, d, H * hd), dtype),
                 wk_x=dense_init(gen, (n, d, H * hd), dtype),
                 wv_x=dense_init(gen, (n, d, H * hd), dtype),
                 wo_x=dense_init(gen, (n, H * hd, d), dtype))
    if seg.ffn == "moe":
        p["moe"] = moe_mod.init_moe(gen, n, d, cfg.moe, cfg.glu, dtype)
    else:
        p["wi"] = dense_init(gen, (n, d, f), dtype)
        if cfg.glu:
            p["wg"] = dense_init(gen, (n, d, f), dtype)
        p["wo_ff"] = dense_init(gen, (n, f, d), dtype)
    return p


# ---------------------------------------------------------------------------
# Single-layer bodies (p holds one layer's parameters)
# ---------------------------------------------------------------------------

def _layer(sp: dict, i: int) -> dict:
    """Layer i of a stacked parameter tree (the experts nest under "moe")."""
    return {name: _layer(w, i) if isinstance(w, dict) else w[i] for name, w in sp.items()}


def _qkv(p, xn, cfg):
    B, T = xn.shape[:2]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = xn @ p["wq"], xn @ p["wk"], xn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["qn"], cfg.norm_eps)
        k = head_rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _ffn(p, x, cfg, seg: Optional[Segment] = None, dropless: bool = False):
    """The layer's FFN with its residual: the dense MLP (also without a
    `seg`), or the experts (``dropless`` on the block-decode path).  Returns
    (x, aux) with aux the MoE load-balance loss (a float32 zero for a dense
    FFN).  On the block-decode path the normed input's d_model dim is
    hinted onto "data": the products against (d / data, f / model) weights
    then run weight-stationary, partial sums and small activation
    reductions instead of gathering the weights every layer."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if dropless:
        xn = hint(xn, None, None, "data")
    if seg is not None and seg.ffn == "moe":
        y, aux = moe_mod.moe_ffn(p["moe"], xn, cfg.moe, cfg.act, cfg.glu, dropless)
        return x + y, aux
    return x + mlp(p, xn, cfg.act, cfg.glu), torch.zeros((), device=x.device)


def _cross_attn(p, x, xk, xv, cfg: ModelConfig, xlen=None):
    """Cross-attention with its residual: the queries of x (B, T, d) over
    every frame of the encoder's K/V xk / xv (B, F, H, hd).  Without `xlen`
    (the full pass) plain ``attend_full`` with no mask, as the reference
    computes it; with `xlen` (B,) int32, all F (the step path), the
    non-causal form of the ``decode_attention`` kernel."""
    B, T = x.shape[:2]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    xn = rms_norm(x, p["ln_x"], cfg.norm_eps)
    q = (xn @ p["wq_x"]).reshape(B, T, H, hd)
    if xlen is None:
        out = attend_full(q, xk, xv, MaskSpec(bidirectional=True))
    else:
        out = ops.decode_attention(q.contiguous(), xk, xv, xlen, causal=False)
    return x + out.reshape(B, T, H * hd) @ p["wo_x"]


def attn_layer_full(p, x, cfg: ModelConfig, seg: Segment, positions, spec: MaskSpec,
                    enc_out=None, use_rope: bool = True):
    """Full-sequence attention layer.  Returns (x, contrib, aux) with
    contrib the layer's cache contribution: {"k", "v"} (B, T, KV, hd), or
    an MLA layer's latents {"ckv", "krope"} (B, T, r_kv) / (B, T, dr); a
    cross layer also attends every frame of `enc_out` (B, F, d) after its
    self-attention and adds its cross K/V {"xk", "xv"} (B, F, H, hd)."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        out, lat = mla_mod.mla_full(p, xn, cfg.num_heads, cfg.mla, positions, spec,
                                    cfg.rope_theta)
        x = x + out
        # the prefill's contributions become the decode cache: sequence-sharded
        contrib = {"ckv": hint(lat["ckv"], "data", "model", None),
                   "krope": hint(lat["krope"], "data", "model", None)}
    else:
        q, k, v = _qkv(p, xn, cfg)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        out = attend_full(q, k, v, spec)
        B, T = x.shape[:2]
        x = x + out.reshape(B, T, -1) @ p["wo"]
        contrib = {"k": hint(k, "data", "model", None, None),
                   "v": hint(v, "data", "model", None, None)}
    if seg.cross:
        B, F = enc_out.shape[:2]
        H, hd = cfg.num_heads, cfg.resolved_head_dim
        xk = (enc_out @ p["wk_x"]).reshape(B, F, H, hd)
        xv = (enc_out @ p["wv_x"]).reshape(B, F, H, hd)
        x = _cross_attn(p, x, xk, xv, cfg)
        contrib = dict(contrib, xk=xk, xv=xv)
    x, aux = _ffn(p, x, cfg, seg)
    return x, contrib, aux


def spread_write(cache: torch.Tensor, blk: torch.Tensor, lengths: torch.Tensor,
                 wrap: bool = False) -> None:
    """Write blk (B,T,...) into cache (B,C,...) at slots lengths + i, IN PLACE.

    ``wrap=True`` (ring caches): slots (lengths + i) mod C, T <= C.
    ``wrap=False`` (full caches): slot index is the absolute position and a
    write past capacity C is dropped, since only an eager speculative write
    can land there and rollback discards it.  The drop is done without a
    host sync: an out-of-range write is redirected to slot C-1 carrying the
    value that slot must hold anyway (the block's own token for it, or its
    old content), so duplicate indices always write equal values."""
    B, C = cache.shape[:2]
    T = blk.shape[1]
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    if wrap:
        slots = (lengths[:, None].long() + torch.arange(T, device=cache.device)[None, :]) % C
        cache[bidx, slots] = blk.to(cache.dtype)
        return
    slots = torch.clamp(lengths[:, None].long()
                        + torch.arange(T, device=cache.device)[None, :], max=C - 1)
    rel = slots - lengths[:, None].long()              # < T; < 0 iff lengths >= C
    src = blk[bidx, rel.clamp(min=0)].to(cache.dtype)
    keep = (rel >= 0).reshape(B, T, *([1] * (cache.ndim - 2)))
    cache[bidx, slots] = torch.where(keep, src, cache[bidx, slots])


def attn_layer_step(p, x, kcache, vcache, lengths, cfg: ModelConfig,
                    seg: Optional[Segment] = None, pos=None, cross=None, kscale=None,
                    vscale=None):
    """Block-decode attention layer against the cache.

    kcache/vcache: (B, C, KV, hd), updated in place with this block's K/V at
    slots ``lengths + i`` (mod C on a ring) before the attention kernel
    reads them; with `kscale` / `vscale` (B, C, KV) float32 (``kv_quant``)
    they are int8 and the block is quantised first, values and scales
    written at the same slots.  `pos` (B, C): a ring's slot positions,
    already holding the block's (``run_segment_step``); the kernel then
    masks by position and the segment's window.  `cross` (xk, xv, xlen): a cross layer's cached
    encoder K/V (B, F, H, hd) and their length (B,), attended after the
    self-attention through the kernel's non-causal form.  An "audio"
    config has no RoPE (its positions are added at the embedding)."""
    B, T = x.shape[:2]
    xn = hint(rms_norm(x, p["ln1"], cfg.norm_eps), None, None, "data")   # weight-stationary
    q, k, v = _qkv(p, xn, cfg)
    # cache I/O is batch-sharded: the block's (small) q/k/v move, not the cache
    q = hint(q, "data", None, None, None)
    k = hint(k, "data", None, None, None)
    v = hint(v, "data", None, None, None)
    if cfg.arch_type != "audio":
        qpos = lengths[:, None] + torch.arange(T, device=x.device)[None, :]
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
    ring = pos is not None
    for cache, scales, blk in ((kcache, kscale, k), (vcache, vscale, v)):
        if scales is not None:
            blk, blk_scales = kv_quantize(blk)
            spread_write(scales, blk_scales, lengths, wrap=ring)
        spread_write(cache, blk, lengths, wrap=ring)
    # flash-decode layout: the cache's sequence dim on "model"
    out = ops.decode_attention(q.contiguous(), hint(kcache, "data", "model", None, None),
                               hint(vcache, "data", "model", None, None),
                               (lengths + T).to(torch.int32),
                               pos=pos, window=cfg.local_window if ring else 0,
                               k_scale=kscale, v_scale=vscale)
    x = x + out.reshape(B, T, -1) @ p["wo"]
    if cross is not None:
        x = _cross_attn(p, x, *cross[:2], cfg, xlen=cross[2])
    return _ffn(p, x, cfg, seg, dropless=True)[0]


def mla_layer_step(p, x, ckv_cache, krope_cache, lengths, cfg: ModelConfig,
                   seg: Optional[Segment] = None):
    """Block-decode MLA layer: the absorbed form (``mla.mla_step``) against
    the latent caches (B, C, r_kv) / (B, C, dr), the block's latents written
    in place at slots ``lengths + i`` first, then the FFN (dropless)."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    qpos = lengths[:, None] + torch.arange(x.shape[1], device=x.device)[None, :]
    x = x + mla_mod.mla_step(p, xn, ckv_cache, krope_cache, lengths, cfg.num_heads, cfg.mla,
                             qpos, cfg.rope_theta)
    return _ffn(p, x, cfg, seg, dropless=True)[0]


def paged_write(pages: torch.Tensor, blk: torch.Tensor, phys: torch.Tensor) -> None:
    """Write blk (B, T, ...) into pages (P, ps, ...) at flat physical
    slots phys (B, T), IN PLACE.  Lanes own disjoint pages, so indices
    collide only on the null page (unmapped or past-the-table positions),
    whose contents are never read."""
    P, ps = pages.shape[:2]
    pages.view(P * ps, *pages.shape[2:]).index_put_(
        (phys.reshape(-1),), blk.reshape(-1, *blk.shape[2:]).to(pages.dtype))


def attn_layer_step_paged(p, x, kpages, vpages, tbl, lengths, cfg: ModelConfig,
                          seg: Optional[Segment] = None, kscale=None, vscale=None):
    """Block-decode attention layer against the pooled paged cache.

    kpages/vpages: (P, ps, KV, hd) physical pages shared by every lane
    (page 0 = null page); int8 under ``kv_quant``, with their scales
    `kscale` / `vscale` (P, ps, KV) float32 written at the same slots.
    tbl: (B, MPS) int32 block table; logical position t of lane b lives at
    physical slot
    ``tbl[b, t // ps] * ps + t % ps``, and -1 entries clamp onto the null
    page, so eager writes from idle lanes are harmless.  The block's K/V
    are written in place at positions ``lengths + i`` before the
    ``paged_decode_attention`` kernel reads them with the post-write
    lengths.  Rollback is the contiguous path's: lengths do not advance
    past the accepted prefix and the stale slots are overwritten later."""
    B, T = x.shape[:2]
    ps = kpages.shape[1]
    xn = hint(rms_norm(x, p["ln1"], cfg.norm_eps), None, None, "data")   # weight-stationary
    qpos = lengths[:, None].long() + torch.arange(T, device=x.device)[None, :]
    q, k, v = _qkv(p, xn, cfg)
    q = hint(q, "data", None, None, None)
    k = hint(k, "data", None, None, None)
    v = hint(v, "data", None, None, None)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    _, wphys = logical_to_physical(tbl, qpos, ps)
    for pages, scales, blk in ((kpages, kscale, k), (vpages, vscale, v)):
        if scales is not None:
            blk, blk_scales = kv_quantize(blk)
            paged_write(scales, blk_scales, wphys)
        paged_write(pages, blk, wphys)
    out = ops.paged_decode_attention(q.contiguous(), kpages, vpages,
                                     (lengths + T).to(torch.int32), tbl,
                                     k_scale=kscale, v_scale=vscale)
    x = x + out.reshape(B, T, -1) @ p["wo"]
    return _ffn(p, x, cfg, seg, dropless=True)[0]


# ---------------------------------------------------------------------------
# Segment execution (loop over stacked layers)
# ---------------------------------------------------------------------------

def run_segment_full(sp, x, cfg: ModelConfig, seg: Segment, positions,
                     collect: bool = False, remat: bool = False, prefix_len: int = 0,
                     enc_out=None):
    """The segment over the whole sequence.  Returns (x, contribs, aux) with
    contribs, when `collect` (else {}), stacked on the layer axis: {"k", "v"}
    (n, B, T, KV, hd) for attention (local layers too), {"ckv", "krope"}
    (n, B, T, r_kv) / (n, B, T, dr) for MLA, {"conv", "state"}
    for SSM segments ((n, B, cw-1, conv_dim) / (n, B, H, hd, ds) float32)
    and RG-LRU segments ((n, B, cw-1, w) / (n, B, w) float32), and a cross
    segment's {"xk", "xv"} (n, B, F, H, hd) besides; aux is the segment's
    summed MoE load-balance loss.  Local layers mask to their sliding
    window; the first `prefix_len` positions (a VLM's patches) attend each
    other bidirectionally; an "audio" config's attention segment without
    `enc_out` (Whisper's encoder) is bidirectional throughout, and "audio"
    uses no RoPE.

    Nothing here writes in place, so autograd can differentiate the whole
    segment.  With `remat` each layer's body runs under non-reentrant
    ``torch.utils.checkpoint`` (the reference wraps its scan body in
    ``jax.checkpoint``): the backward recomputes a layer's activations from
    its input instead of keeping them."""
    zero = torch.zeros((), device=x.device)
    if seg.kind == "ssm":
        def body(lp, x):
            x, con = ssm_mod.ssm_forward_full(lp, x, cfg.ssm, cfg.norm_eps)
            return x, con, zero
        names = ("conv", "state")
    elif seg.kind == "rglru":
        def body(lp, x):
            x, con = rglru_mod.rglru_forward_full(lp, x, cfg.rglru, cfg.norm_eps)
            x, aux = _ffn(lp, x, cfg, seg)
            return x, con, aux
        names = ("conv", "state")
    else:
        if seg.kind == "local":
            spec = MaskSpec(window=cfg.local_window, prefix_len=prefix_len)
        elif cfg.arch_type == "audio" and seg.kind == "attn" and enc_out is None:
            spec = MaskSpec(bidirectional=True)          # the encoder's self-attention
        else:
            spec = MaskSpec(prefix_len=prefix_len)
        use_rope = cfg.arch_type != "audio"

        def body(lp, x):
            return attn_layer_full(lp, x, cfg, seg, positions, spec, enc_out, use_rope)
        names = (("ckv", "krope") if cfg.mla is not None else ("k", "v")) + (
            ("xk", "xv") if seg.cross else ())
    if remat:
        plain = body

        def body(lp, x):
            return checkpoint(plain, lp, x, use_reentrant=False)

    def layer(x, i):
        # batch-sharded activations (both axes when the batch divides: the
        # training layout), so the weights are gathered, not the activations
        x = hint(x, ("data", "model"), None, None)
        x, con, a = body(gathered(_layer(sp, i), x), x)
        return hint(x, "data", None, None), (con, a)
    x, outs = loops.scan(layer, x, seg.n)
    aux = zero
    for _, a in outs:
        aux = aux + a
    if not collect:
        return x, {}, aux
    return x, {name: torch.stack([con[name] for con, _ in outs]) for name in names}, aux


def ring_positions(pos: torch.Tensor, lengths: torch.Tensor, T: int) -> None:
    """Mark a ring's slots for the block at positions lengths .. lengths+T-1,
    in place: slot (lengths + i) mod C holds position lengths + i (the
    reference's ``new_pos``); every other slot keeps its position."""
    C = pos.shape[1]
    rel = (torch.arange(C, device=pos.device)[None, :] - lengths[:, None].long()) % C
    pos.copy_(torch.where(rel < T, lengths[:, None].long() + rel, pos.long()).to(pos.dtype))


def _stateful_step(step_fn, sp, x, seg_cache, n: int, take):
    """The layers of an SSM or RG-LRU segment over a block: candidates
    {"conv", "state"} stacked (n, B, T, ...), or with `take` each layer's
    selected window and state written in place and no candidates."""
    def layer(x, i):
        x, cand = step_fn(_layer(sp, i), x,
                          {"conv": seg_cache["conv"][i], "state": seg_cache["state"][i]}, take)
        if take is None:
            return x, cand
        seg_cache["conv"][i].copy_(cand["conv"])
        seg_cache["state"][i].copy_(cand["state"])
        return x, None
    x, cands = loops.scan(layer, x, n)
    if take is not None:
        return x, {}
    return x, {name: torch.stack([c[name] for c in cands]) for name in ("conv", "state")}


def run_segment_step(sp, x, seg_cache, lengths, cfg: ModelConfig, seg: Segment,
                     tbl=None, take=None, xlen=None):
    """Returns (x, cands).  Attention segments write their K/V cache (MLA
    segments their latents) in place and have no candidates ({}); `tbl` is
    the block table (B, MPS) when the cache is paged (seg_cache then holds
    pooled "kp"/"vp" pages instead of per-lane "k"/"v", and under
    ``kv_quant`` their scales "ksp"/"vsp", else "ks"/"vs"); a local segment's
    ring first takes the block's positions in its ``pos``.  SSM and RG-LRU
    segments leave their state untouched and return the candidates
    {"conv", "state"} stacked (n, B, T, ...); with `take` (B,), a prefill
    chunk's commit, they carry instead: each layer's window and state after
    token take-1 (kept where take == 0) are written in place and there are
    no candidates.  A cross segment's layers attend their cached ``xk`` /
    ``xv`` with the lengths `xlen` (B,) after their self-attention."""
    if seg.kind == "ssm":
        def ssm_fn(lp, x, c, take):
            return ssm_mod.ssm_step(lp, x, c, cfg.ssm, cfg.norm_eps, take=take)
        return _stateful_step(ssm_fn, sp, x, seg_cache, seg.n, take)
    if seg.kind == "rglru":
        def rglru_fn(lp, x, c, take):
            x, cand = rglru_mod.rglru_step(lp, x, c, cfg.rglru, cfg.norm_eps, take=take)
            return _ffn(lp, x, cfg, seg, dropless=True)[0], cand
        return _stateful_step(rglru_fn, sp, x, seg_cache, seg.n, take)
    if "ckv" in seg_cache:          # MLA: slot = position, its "pos" is no ring's
        def layer(x, i):
            return mla_layer_step(_layer(sp, i), x, seg_cache["ckv"][i], seg_cache["krope"][i],
                                  lengths, cfg, seg), None
    elif "kp" in seg_cache:
        ksp, vsp = seg_cache.get("ksp"), seg_cache.get("vsp")

        def layer(x, i):
            return attn_layer_step_paged(_layer(sp, i), x, seg_cache["kp"][i],
                                         seg_cache["vp"][i], tbl, lengths, cfg, seg,
                                         kscale=None if ksp is None else ksp[i],
                                         vscale=None if vsp is None else vsp[i]), None
    else:
        pos = seg_cache.get("pos")
        if pos is not None:
            ring_positions(pos, lengths, x.shape[1])
        ks, vs = seg_cache.get("ks"), seg_cache.get("vs")

        def layer(x, i):
            cross = (seg_cache["xk"][i], seg_cache["xv"][i], xlen) if seg.cross else None
            return attn_layer_step(_layer(sp, i), x, seg_cache["k"][i], seg_cache["v"][i],
                                   lengths, cfg, seg, pos=pos, cross=cross,
                                   kscale=None if ks is None else ks[i],
                                   vscale=None if vs is None else vs[i]), None
    return loops.scan(layer, x, seg.n)[0], {}


# ---------------------------------------------------------------------------
# Cache construction / commit
# ---------------------------------------------------------------------------

def _kv_leaves(cfg: ModelConfig, shape: tuple, device, names=("k", "v", "ks", "vs")) -> dict:
    """Zeroed K and V of `shape` (..., KV, hd) in the model dtype, or under
    ``kv_quant`` int8 with their float32 scales (..., KV) beside them
    (named by `names`: values, then scales)."""
    if not cfg.kv_quant:
        return {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                for name in names[:2]}
    out = {name: torch.zeros(shape, dtype=torch.int8, device=device) for name in names[:2]}
    out.update({name: torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                for name in names[2:]})
    return out


def _lane_cache(cfg: ModelConfig, seg: Segment, B: int, device) -> Optional[dict]:
    """The per-lane constant-size cache of a segment whatever the layout: an
    SSM or RG-LRU segment's window and state, a local segment's ring (K, V
    of (n, B, W + RING_SLACK, KV, hd), int8 with scales under ``kv_quant``,
    and ``pos`` (B, W + RING_SLACK), all -1); None for full attention."""
    dtype = cfg.torch_dtype
    if seg.kind == "ssm":
        return ssm_mod.init_ssm_cache(seg.n, B, cfg.d_model, cfg.ssm, dtype, device)
    if seg.kind == "rglru":
        return rglru_mod.init_rglru_cache(seg.n, B, cfg.d_model, cfg.rglru, dtype, device)
    if seg.kind == "local":
        C = cfg.local_window + RING_SLACK
        c = _kv_leaves(cfg, (seg.n, B, C, cfg.num_kv_heads, cfg.resolved_head_dim), device)
        c["pos"] = torch.full((B, C), -1, dtype=torch.int32, device=device)
        return c
    return None


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None) -> dict:
    """Contiguous cache for the full stack: per attention segment K and V of
    shape (n, B, max_len, KV, hd) in the model dtype, or int8 with ``ks`` /
    ``vs`` (n, B, max_len, KV) float32 under ``kv_quant`` (MLA: the latents
    ``ckv`` (n, B, max_len, r_kv) and ``krope`` (n, B, max_len, dr), and
    ``pos`` (B, max_len) int32, -1 empty), per SSM or RG-LRU segment the
    conv window and state, per local segment its ring (``_lane_cache``),
    per cross segment its ``xk`` / ``xv`` (n, B, F, H, hd), plus per-lane
    committed ``lengths`` (B,) and, with cross segments, ``xlen`` (B,)
    int32 all F (the encoder's frames)."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    segs = {}
    for seg in model_segments(cfg):
        c = _lane_cache(cfg, seg, B, device)
        if c is None and cfg.mla is not None:
            m = cfg.mla
            c = {"ckv": torch.zeros((seg.n, B, max_len, m.kv_lora_rank), dtype=dtype,
                                    device=device),
                 "krope": torch.zeros((seg.n, B, max_len, m.qk_rope_head_dim), dtype=dtype,
                                      device=device),
                 "pos": torch.full((B, max_len), -1, dtype=torch.int32, device=device)}
        elif c is None:
            c = _kv_leaves(cfg, (seg.n, B, max_len, KV, hd), device)
        if seg.cross:
            shape = (seg.n, B, cfg.encoder.num_frames, cfg.num_heads, hd)
            c.update(xk=torch.zeros(shape, dtype=dtype, device=device),
                     xv=torch.zeros(shape, dtype=dtype, device=device))
        segs[seg.name] = c
    cache = {"lengths": torch.zeros((B,), dtype=torch.int32, device=device), "segs": segs}
    if any(seg.cross for seg in model_segments(cfg)):
        cache["xlen"] = torch.full((B,), cfg.encoder.num_frames, dtype=torch.int32,
                                   device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, B: int, num_pages: int, page_size: int,
                     max_pages_per_slot: int, device=None) -> dict:
    """Paged cache: per full-attention segment K and V pooled into
    ``num_pages`` shared pages plus the physical null page 0, (n, num_pages
    + 1, page_size, KV, hd) in the model dtype (under ``kv_quant`` int8,
    with ``ksp`` / ``vsp`` (n, num_pages + 1, page_size, KV) float32); SSM and RG-LRU segments keep
    their per-lane constant-size state and local segments their per-lane
    rings, as in ``init_cache`` (they gain nothing from paging); per-lane
    ``lengths`` (B,) and the block table ``tbl`` (B, max_pages_per_slot)
    int32, all -1 (unmapped).  MLA latent caches and cross-attention caches
    have no paged layout (``NotImplementedError``, as in the reference)."""
    if cfg.mla is not None:
        raise NotImplementedError("paged KV: MLA latent caches not supported")
    if cfg.encoder is not None:
        raise NotImplementedError("paged KV: cross-attention caches not supported")
    device = resolve_device(device)
    shape = (num_pages + 1, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    segs = {}
    for seg in model_segments(cfg):
        c = _lane_cache(cfg, seg, B, device)
        if c is None:
            c = _kv_leaves(cfg, (seg.n, *shape), device, names=("kp", "vp", "ksp", "vsp"))
        segs[seg.name] = c
    return {"lengths": torch.zeros((B,), dtype=torch.int32, device=device),
            "tbl": torch.full((B, max_pages_per_slot), -1, dtype=torch.int32, device=device),
            "segs": segs}


def map_slot_pages(cache: dict, slot: int, row: torch.Tensor) -> dict:
    """Point lane `slot`'s block-table row at physical pages `row` (MPS,)
    int32, -1-padded, in place.  Pure table write: no KV moves."""
    cache["tbl"][slot] = row.to(torch.int32)
    return cache


def set_block_tables(cache: dict, tbl: torch.Tensor) -> dict:
    """Replace the whole block table (B, MPS) with `tbl`, one device op for
    every row the engine's host mirror changed in a tick.  No KV moves."""
    return dict(cache, tbl=tbl.to(torch.int32))


def _insert_paged_seg(seg_c: dict, src_c: dict, tbl: torch.Tensor, slot: int,
                      src_slot: int = 0) -> None:
    """Splice a contiguous prefill lane into the slot's mapped pages, in
    place: a block-table-indexed scatter of the source K/V (and under
    ``kv_quant`` their scales) into the pool.  Source positions past the
    mapped region land on the null page."""
    n, Pp, ps = seg_c["kp"].shape[:3]
    C_src = src_c["k"].shape[2]
    pos = torch.arange(C_src, device=tbl.device)[None, :]
    _, phys = logical_to_physical(tbl[slot:slot + 1], pos, ps)
    for dst, src_key in (("kp", "k"), ("vp", "v"), ("ksp", "ks"), ("vsp", "vs")):
        if dst not in seg_c:
            continue
        pooled, src = seg_c[dst], src_c[src_key]
        flat = pooled.view(n, Pp * ps, *pooled.shape[3:])
        flat[:, phys[0]] = src[:, src_slot].to(pooled.dtype)


def copy_page(cache: dict, src_page: int, dst_page: int) -> dict:
    """Copy on write, in place: physical page `src_page`'s K/V (and under
    ``kv_quant`` their scales) onto page `dst_page` in every layer of every
    paged segment, one indexed copy a leaf.  Prefix-cache admission uses
    it when a cached prefix ends mid-page: the partly matching page is
    copied into the lane's first own page, and the lane then appends
    through its own table without touching the shared original.  Slots past the matched prefix carry the
    donor's K/V, overwritten by the lane's tail before any read."""
    for seg_c in cache["segs"].values():
        if "kp" not in seg_c:
            continue
        for key in ("kp", "vp", "ksp", "vsp"):
            leaf = seg_c.get(key)
            if leaf is not None:
                leaf[:, dst_page].copy_(leaf[:, src_page])
    return cache


def insert_slot(cfg: ModelConfig, cache: dict, src: Optional[dict], slot: int,
                src_slot: int = 0, shared_len=None) -> dict:
    """Continuous-batching cache surgery, in place: copy lane `src_slot` of
    `src` (a freshly prefilled B = 1 contiguous cache, which may be sized to
    the prompt alone) into lane `slot` of the live cache, and set its
    length.  Contiguous segments take the source K/V and their int8 scales
    (MLA: its latents and its ``pos`` row, a (B, C) leaf with the lane on
    axis 0) in the lane's prefix, so the source may be partly built (a
    chunk-sized or prompt-sized scratch);
    paged segments scatter it through the slot's block-table row (map the
    pages with ``map_slot_pages`` first); SSM and RG-LRU segments copy the
    lane's constant-size conv window and state whole, and local segments
    their ring and its ``pos`` row whole (a ring's capacity is the same in
    every cache).  The destination lane must have been reset.

    ``src=None`` is the prefix cache's table-only splice: the lane's first
    `shared_len` tokens already live in shared pages that
    ``map_slot_pages`` put in its row, so only the lane's length is set
    (in place; `shared_len` an int or a 0-d tensor) and no K/V moves.
    Only a paged cache of attention segments qualifies: other segments
    hold per-lane state that content cannot share."""
    if src is None:
        if shared_len is None:
            raise ValueError("insert_slot(src=None) needs shared_len")
        if "tbl" not in cache or any("kp" not in c for c in cache["segs"].values()):
            raise NotImplementedError(
                "table-splice admission (src=None) requires a pure paged "
                "full-attention cache: per-lane segment state cannot be "
                "prefix-shared")
        # fill_ on a view: item assignment of a Python number would stage it
        # through a host tensor and block the host on the copy
        cache["lengths"][slot].fill_(shared_len)
        return cache
    tbl = cache.get("tbl")
    for name, seg_c in cache["segs"].items():
        src_c = src["segs"][name]
        if "kp" in seg_c:
            _insert_paged_seg(seg_c, src_c, tbl, slot, src_slot)
            continue
        for key, leaf in seg_c.items():
            if key == "pos":             # a ring's whole row, or an MLA prefix
                row = src_c[key][src_slot]
                leaf[slot, :row.shape[0]] = row
                continue
            piece = src_c[key][:, src_slot]
            if key in ("k", "v", "ks", "vs", "ckv", "krope"):
                leaf[:, slot, :piece.shape[1]] = piece.to(leaf.dtype)
            else:
                leaf[:, slot] = piece.to(leaf.dtype)
    cache["lengths"][slot] = src["lengths"][src_slot]
    return cache


def reset_slot(cfg: ModelConfig, cache: dict, slot: int) -> dict:
    """Evict lane `slot`, in place: length 0 and, for contiguous, ring, MLA,
    SSM and RG-LRU segments, its K/V and their int8 scales, latents, or
    conv window and state zeroed and a ring's or an MLA segment's slot positions emptied (-1).
    Paged segments need no KV work: the lane's block-table row is unmapped
    (-1) and its pages go back to the host-side pool.  Other lanes are
    untouched."""
    # fill_ on views: item assignment of a Python number would stage it
    # through a host tensor and block the host on the copy
    for seg_c in cache["segs"].values():
        if "kp" in seg_c:
            continue
        for key, leaf in seg_c.items():
            if key == "pos":             # (B, C): the lane on axis 0
                leaf[slot].fill_(-1)
            else:
                leaf[:, slot].zero_()
    cache["lengths"][slot].zero_()
    if "tbl" in cache:
        cache["tbl"][slot].fill_(-1)
    return cache


def fill_cache_from_full(cfg: ModelConfig, cache: dict, contribs: dict, T: int) -> dict:
    """Copy prefill contributions into the cache, in place: K/V (stacked
    (n,B,T,...)) into slots [0, T), SSM and RG-LRU conv windows and states
    whole, MLA latents ((n,B,T,...)) into slots [0, T) with ``pos`` [0, T)
    there (the rest of ``pos`` kept, as the reference keeps it).  A ring
    takes positions [0, T) at slots [0, T), or, when T exceeds its C slots,
    the last C positions p at slots p mod C; its ``pos`` is set to match
    and -1 elsewhere.  Under ``kv_quant`` the prefill's K/V are quantised
    once, and values and scales go to the same slots.  A cross segment's
    ``xk`` / ``xv`` take the prefill's whole, in place (the block-step
    graphs hold their addresses).  All sequences are fully packed (length
    T)."""
    for seg in model_segments(cfg):
        con = contribs.get(seg.name)
        if not con:
            continue
        c = cache["segs"][seg.name]
        if seg.cross:
            c["xk"].copy_(con["xk"])
            c["xv"].copy_(con["xv"])
        if seg.kind in ("ssm", "rglru"):
            c["conv"].copy_(con["conv"])
            c["state"].copy_(con["state"])
            continue
        if "ckv" in c:                   # MLA: not a ring, whatever its "pos"
            c["ckv"][:, :, :T] = con["ckv"].to(c["ckv"].dtype)
            c["krope"][:, :, :T] = con["krope"].to(c["krope"].dtype)
            c["pos"][:, :T] = torch.arange(T, dtype=torch.int32, device=c["pos"].device)
            continue
        new = {"k": con["k"], "v": con["v"]}
        if "ks" in c:        # a layer at a time: the float32 temporaries hold one layer
            for key in ("k", "v"):
                vals, scales = zip(*(kv_quantize(layer) for layer in con[key]))
                new[key], new[key[0] + "s"] = torch.stack(vals), torch.stack(scales)
        if "pos" in c:
            Cap = c["k"].shape[2]
            keep = min(T, Cap)
            p = torch.arange(T - keep, T, device=c["pos"].device)
            sl = p % Cap
            c["pos"].fill_(-1)
            c["pos"][:, sl] = p.to(torch.int32)[None, :]
            for key, val in new.items():
                c[key][:, :, sl] = val[:, :, T - keep:].to(c[key].dtype)
            continue
        for key, val in new.items():
            c[key][:, :, :T] = val.to(c[key].dtype)
    B = cache["lengths"].shape[0]
    return dict(cache, lengths=torch.full((B,), T, dtype=torch.int32,
                                          device=cache["lengths"].device))


def commit_cache(cfg: ModelConfig, cache: dict, cands: dict, accept: torch.Tensor) -> dict:
    """Advance the cache by `accept` (B,) committed tokens.  Rollback of the
    unaccepted tail of attention K/V is pure length truncation: its eager
    writes lie past the new length, outside every later query's mask, and
    are overwritten by the next block.  Each SSM segment in `cands` takes,
    in place, its candidate at index accept-1 per lane ((n, B, T, ...) ->
    (n, B, ...)), and keeps its state where accept == 0.  The selection is
    a gather and a select on the device: no host sync."""
    B = accept.shape[0]
    idx = torch.clamp(accept.long() - 1, min=0)
    keep_old = accept == 0
    lanes = torch.arange(B, device=accept.device)
    for name, cand in cands.items():
        c = cache["segs"][name]
        for key in ("conv", "state"):
            sel = cand[key][:, lanes, idx]                       # (n, B, ...)
            keep = keep_old.reshape((1, B) + (1,) * (sel.ndim - 2))
            c[key].copy_(torch.where(keep, c[key], sel.to(c[key].dtype)))
    return dict(cache, lengths=(cache["lengths"] + accept).to(torch.int32))


# ---------------------------------------------------------------------------
# Stack-level entry points
# ---------------------------------------------------------------------------

def forward_full(params_segs: dict, x: torch.Tensor, cfg: ModelConfig, lo: int,
                 hi: int, collect: bool = False, remat: bool = False,
                 with_aux: bool = False, prefix_len: int = 0, enc_out=None):
    """Run layers [lo, hi) over a full sequence at positions 0..T-1, each
    layer under ``torch.utils.checkpoint`` when `remat`, the first
    `prefix_len` positions bidirectional among themselves, cross layers
    attending `enc_out` (B, F, d).  Returns (x, contribs), or (x, contribs,
    aux) with `with_aux`: the summed MoE load-balance loss, a float32
    scalar."""
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    contribs, aux = {}, torch.zeros((), device=x.device)
    for seg in segments_in_range(cfg, lo, hi):
        x, contribs[seg.name], a = run_segment_full(params_segs[seg.name], x, cfg, seg,
                                                    positions, collect, remat, prefix_len,
                                                    enc_out)
        aux = aux + a
    return (x, contribs, aux) if with_aux else (x, contribs)


def forward_step(params_segs: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                 lo: int, hi: int, take=None):
    """Run layers [lo, hi) on a T-token block against the cache.  Returns
    (x, cache, cands): the same cache, its K/V written in place, lengths and
    SSM states unchanged, and the SSM segments' candidates by segment name
    (``commit_cache`` advances the lengths and selects the states).  With
    `take` (B,), a commit known before the block runs (a prefill chunk),
    SSM segments write the states at take-1 in place and return no
    candidates (``run_segment_step``); ``commit_cache`` then only advances
    the lengths."""
    cands = {}
    for seg in segments_in_range(cfg, lo, hi):
        x, cand = run_segment_step(params_segs[seg.name], x, cache["segs"][seg.name],
                                   cache["lengths"], cfg, seg, cache.get("tbl"), take,
                                   cache.get("xlen"))
        if cand:
            cands[seg.name] = cand
    return x, cache, cands
