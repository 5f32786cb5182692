"""Segmented decoder stack with a speculative-decoding KV cache (dense slice).

Port of ``repro.models.transformer`` for dense attention + dense FFN stacks.
Layers are grouped into *segments* (runs of layers of one kind), each with
its parameters stacked on a leading layer axis, and segments are cut at
``cfg.dvi.split_layer`` so the draft path (layers [0, k)) and the target path
([k, L)) run as separate segment ranges over one parameter tree.

Two execution modes:

* ``forward_full`` — a whole sequence without a cache (prefill); optionally
  returns each layer's K/V so prefill can fill the decode cache.
* ``forward_step`` — a block of T tokens (K+1 during speculation, 1 for AR)
  against the cache.  K/V are written into the cache in place at slots
  ``lengths + i`` before attention reads it; rollback is length truncation
  (``commit_cache``), so a rejected token's slot is simply overwritten by
  the next block.  Attention over the cache goes through the
  ``decode_attention`` kernel with the cache length after the block's write,
  which on a contiguous full cache is the reference's step mask
  ``pos <= qpos`` (every slot below the length is filled, stale speculative
  slots lie above ``qpos``); the port therefore keeps no ``pos`` array.

Not in this slice (they raise ``NotImplementedError``): MoE, MLA, SSM,
RG-LRU, local/ring caches, cross-attention, ``kv_quant``, paged caches.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (MaskSpec, apply_rope, attend_full, dense_init,
                                       head_rms_norm, mlp, rms_norm)

# Spare capacity the reference reserves past a generation's worst case; kept
# so caches are sized the same on both sides.
RING_SLACK = 128


@dataclass(frozen=True)
class Segment:
    idx: int
    kind: str          # attn (the only kind this slice runs)
    ffn: str           # dense
    start: int
    n: int
    d_ff: int

    @property
    def name(self) -> str:
        return f"s{self.idx}"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    missing = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("ssm", cfg.ssm is not None or cfg.arch_type == "ssm"),
        ("rglru", cfg.rglru is not None),
        ("local/ring caches", bool(cfg.sliding_window)),
        ("cross-attention", cfg.encoder is not None),
        ("vision prefix", cfg.vision is not None),
        ("kv_quant", cfg.kv_quant), ("mtp", bool(cfg.mtp_depth))) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(missing)}")


def layer_kinds(cfg: ModelConfig):
    """(mixer kind, ffn kind) per layer.  Configs with other kinds (MoE,
    SSM, RG-LRU, local attention) are rejected by ``check_supported``."""
    pat = cfg.layer_pattern
    return [(pat[layer % len(pat)], "dense") for layer in range(cfg.num_layers)]


def build_segments(cfg: ModelConfig, boundaries=()):
    """Group layers into stacked segments; force cuts at `boundaries`."""
    kinds = layer_kinds(cfg)
    cuts = set(boundaries) | {0, cfg.num_layers}
    segs, start = [], 0
    for layer in range(1, cfg.num_layers + 1):
        if layer in cuts or kinds[layer] != kinds[start]:
            kind, ffn = kinds[start]
            segs.append(Segment(len(segs), kind, ffn, start, layer - start, cfg.d_ff))
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
    """Dense attention + dense FFN segment, stacked on a leading layer axis."""
    if seg.kind != "attn" or seg.ffn != "dense":
        raise NotImplementedError(f"segment kind {seg.kind}/{seg.ffn} not ported yet")
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n, f, dev = seg.n, seg.d_ff, gen.device

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=dev)

    p = {"ln1": zeros(n, d), "ln2": zeros(n, d),
         "wq": dense_init(gen, (n, d, H * hd), dtype),
         "wk": dense_init(gen, (n, d, KV * hd), dtype),
         "wv": dense_init(gen, (n, d, KV * hd), dtype),
         "wo": dense_init(gen, (n, H * hd, d), dtype)}
    if cfg.qkv_bias:
        p.update(bq=zeros(n, H * hd, dt=dtype), bk=zeros(n, KV * hd, dt=dtype),
                 bv=zeros(n, KV * hd, dt=dtype))
    if cfg.qk_norm:
        p.update(qn=zeros(n, hd), kn=zeros(n, hd))
    p["wi"] = dense_init(gen, (n, d, f), dtype)
    if cfg.glu:
        p["wg"] = dense_init(gen, (n, d, f), dtype)
    p["wo_ff"] = dense_init(gen, (n, f, d), dtype)
    return p


# ---------------------------------------------------------------------------
# Single-layer bodies (p holds one layer's parameters)
# ---------------------------------------------------------------------------

def _layer(sp: dict, i: int) -> dict:
    return {name: w[i] for name, w in sp.items()}


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


def _ffn(p, x, cfg):
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p, xn, cfg.act, cfg.glu)


def attn_layer_full(p, x, cfg: ModelConfig, positions, spec: MaskSpec):
    """Full-sequence attention layer.  Returns (x, k, v) with k/v the
    layer's cache contribution (B, T, KV, hd)."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attend_full(q, k, v, spec)
    B, T = x.shape[:2]
    x = x + out.reshape(B, T, -1) @ p["wo"]
    return _ffn(p, x, cfg), k, v


def spread_write(cache: torch.Tensor, blk: torch.Tensor, lengths: torch.Tensor) -> None:
    """Write blk (B,T,...) into cache (B,C,...) at slots lengths + i, IN PLACE.

    Full caches only (the reference's ``wrap=False``): slot index is the
    absolute position and a write past capacity C is dropped, since only an
    eager speculative write can land there and rollback discards it.  The
    drop is done without a host sync: an out-of-range write is redirected
    to slot C-1 carrying the value that slot must hold anyway (the block's
    own token for it, or its old content), so duplicate indices always
    write equal values."""
    B, C = cache.shape[:2]
    T = blk.shape[1]
    slots = torch.clamp(lengths[:, None].long()
                        + torch.arange(T, device=cache.device)[None, :], max=C - 1)
    rel = slots - lengths[:, None].long()              # < T; < 0 iff lengths >= C
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    src = blk[bidx, rel.clamp(min=0)].to(cache.dtype)
    keep = (rel >= 0).reshape(B, T, *([1] * (cache.ndim - 2)))
    cache[bidx, slots] = torch.where(keep, src, cache[bidx, slots])


def attn_layer_step(p, x, kcache, vcache, lengths, cfg: ModelConfig):
    """Block-decode attention layer against the cache.

    kcache/vcache: (B, C, KV, hd), updated in place with this block's K/V at
    slots ``lengths + i`` before the attention kernel reads them."""
    B, T = x.shape[:2]
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    qpos = lengths[:, None] + torch.arange(T, device=x.device)[None, :]
    q, k, v = _qkv(p, xn, cfg)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    spread_write(kcache, k, lengths)
    spread_write(vcache, v, lengths)
    out = ops.decode_attention(q.contiguous(), kcache, vcache,
                               (lengths + T).to(torch.int32))
    x = x + out.reshape(B, T, -1) @ p["wo"]
    return _ffn(p, x, cfg)


# ---------------------------------------------------------------------------
# Segment execution (loop over stacked layers)
# ---------------------------------------------------------------------------

def run_segment_full(sp, x, cfg: ModelConfig, seg: Segment, positions,
                     collect: bool = False):
    """Causal attention over the whole sequence.  Returns (x, contribs) with
    contribs {"k", "v"} stacked (n, B, T, KV, hd) when `collect`, else {}."""
    spec = MaskSpec()
    ks, vs = [], []
    for i in range(seg.n):
        x, k, v = attn_layer_full(_layer(sp, i), x, cfg, positions, spec)
        if collect:
            ks.append(k)
            vs.append(v)
    return x, ({"k": torch.stack(ks), "v": torch.stack(vs)} if collect else {})


def run_segment_step(sp, x, seg_cache, lengths, cfg: ModelConfig, seg: Segment):
    """Returns x; the segment's K/V cache is updated in place."""
    for i in range(seg.n):
        x = attn_layer_step(_layer(sp, i), x, seg_cache["k"][i], seg_cache["v"][i],
                            lengths, cfg)
    return x


# ---------------------------------------------------------------------------
# Cache construction / commit
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None) -> dict:
    """Contiguous cache for the full stack: per segment K and V of shape
    (n, B, max_len, KV, hd) in the model dtype, plus per-lane committed
    ``lengths`` (B,)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    segs = {seg.name: {"k": torch.zeros((seg.n, B, max_len, KV, hd), dtype=dtype, device=device),
                       "v": torch.zeros((seg.n, B, max_len, KV, hd), dtype=dtype, device=device)}
            for seg in model_segments(cfg)}
    return {"lengths": torch.zeros((B,), dtype=torch.int32, device=device), "segs": segs}


def fill_cache_from_full(cfg: ModelConfig, cache: dict, contribs: dict, T: int) -> dict:
    """Copy prefill contributions (stacked (n,B,T,...)) into slots [0, T) of
    the cache, in place.  All sequences are fully packed (length T)."""
    for seg in model_segments(cfg):
        con = contribs.get(seg.name)
        if not con:
            continue
        c = cache["segs"][seg.name]
        c["k"][:, :, :T] = con["k"].to(c["k"].dtype)
        c["v"][:, :, :T] = con["v"].to(c["v"].dtype)
    B = cache["lengths"].shape[0]
    return {"lengths": torch.full((B,), T, dtype=torch.int32,
                                  device=cache["lengths"].device),
            "segs": cache["segs"]}


def commit_cache(cfg: ModelConfig, cache: dict, accept: torch.Tensor) -> dict:
    """Advance the cache by `accept` (B,) committed tokens.  Rollback of the
    unaccepted tail is pure length truncation: its eager writes lie past
    the new length, outside every later query's mask, and are overwritten
    by the next block."""
    return {"lengths": (cache["lengths"] + accept).to(torch.int32),
            "segs": cache["segs"]}


# ---------------------------------------------------------------------------
# Stack-level entry points
# ---------------------------------------------------------------------------

def forward_full(params_segs: dict, x: torch.Tensor, cfg: ModelConfig, lo: int,
                 hi: int, collect: bool = False):
    """Run layers [lo, hi) over a full sequence at positions 0..T-1.
    Returns (x, contribs)."""
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    contribs = {}
    for seg in segments_in_range(cfg, lo, hi):
        x, contribs[seg.name] = run_segment_full(params_segs[seg.name], x, cfg, seg,
                                                 positions, collect)
    return x, contribs


def forward_step(params_segs: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                 lo: int, hi: int):
    """Run layers [lo, hi) on a T-token block against the cache.  Returns
    (x, cache): the same cache, its K/V written in place, lengths unchanged
    (``commit_cache`` advances them)."""
    for seg in segments_in_range(cfg, lo, hi):
        x = run_segment_step(params_segs[seg.name], x, cache["segs"][seg.name],
                             cache["lengths"], cfg, seg)
    return x, cache
