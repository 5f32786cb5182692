"""Segmented decoder stack with a speculative-decoding cache.

Port of ``repro.models.transformer`` for two kinds of stack: dense attention
+ dense FFN, and attention-free Mamba-2 (``models.ssm``, SSD blocks with no
FFN).  Layers are grouped into *segments* (runs of layers of one kind), each with
its parameters stacked on a leading layer axis, and segments are cut at
``cfg.dvi.split_layer`` so the draft path (layers [0, k)) and the target path
([k, L)) run as separate segment ranges over one parameter tree.

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
  slots lie above ``qpos``); the port therefore keeps no ``pos`` array.

Two cache layouts (``forward_step`` reads which from the cache):

* contiguous (``init_cache``): per-lane K/V (n, B, C, KV, hd); SSM
  segments hold per-lane constant-size state, the conv window (n, B, cw-1,
  conv_dim) and the SSD state (n, B, H, hd, ds) float32, in both layouts;
* paged (``init_paged_cache``): K/V pooled into shared pages
  (n, P+1, ps, KV, hd), physical page 0 the null page, read and written
  through the per-lane block table ``cache["tbl"]`` (B, MPS) with the
  addressing rule ``serving.kv_pool.logical_to_physical``; attention goes
  through the ``paged_decode_attention`` kernel.  Page ownership lives on
  the host (``serving.kv_pool.KVPool``).

Continuous batching edits one lane of a live cache in place:
``insert_slot`` splices a prefilled lane in, ``reset_slot`` empties one,
``map_slot_pages``/``set_block_tables`` edit the block table.  All of it
runs on PyTorch's current stream, so it is ordered after any step still
running on the device.

Not ported yet (they raise ``NotImplementedError``): MoE, MLA, RG-LRU,
local/ring caches, cross-attention, ``kv_quant``, the prefix cache's
table-only splice (``insert_slot(src=None)``, ``copy_page``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MaskSpec, apply_rope, attend_full, dense_init,
                                       head_rms_norm, mlp, rms_norm)
from repro_torch.serving.kv_pool import logical_to_physical

# Spare capacity the reference reserves past a generation's worst case; kept
# so caches are sized the same on both sides.
RING_SLACK = 128


@dataclass(frozen=True)
class Segment:
    idx: int
    kind: str          # attn | ssm
    ffn: str           # dense | none
    start: int
    n: int
    d_ff: int

    @property
    def name(self) -> str:
        return f"s{self.idx}"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    missing = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("rglru", cfg.rglru is not None),
        ("local/ring caches", bool(cfg.sliding_window)),
        ("cross-attention", cfg.encoder is not None),
        ("vision prefix", cfg.vision is not None),
        ("kv_quant", cfg.kv_quant), ("mtp", bool(cfg.mtp_depth))) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(missing)}")


def layer_kinds(cfg: ModelConfig):
    """(mixer kind, ffn kind) per layer: Mamba-2 blocks have no FFN.
    Configs with other kinds (MoE, RG-LRU, local attention) are rejected by
    ``check_supported``."""
    pat = cfg.layer_pattern
    ffn = "none" if cfg.ssm is not None else "dense"
    return [(pat[layer % len(pat)], ffn) for layer in range(cfg.num_layers)]


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
    """A segment's parameters stacked on a leading layer axis: Mamba-2
    blocks, or dense attention + dense FFN."""
    if seg.kind == "ssm":
        return ssm_mod.init_ssm(gen, seg.n, cfg.d_model, cfg.ssm, dtype)
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


def paged_write(pages: torch.Tensor, blk: torch.Tensor, phys: torch.Tensor) -> None:
    """Write blk (B, T, KV, hd) into pages (P, ps, KV, hd) at flat physical
    slots phys (B, T), IN PLACE.  Lanes own disjoint pages, so indices
    collide only on the null page (unmapped or past-the-table positions),
    whose contents are never read."""
    P, ps = pages.shape[:2]
    pages.view(P * ps, *pages.shape[2:]).index_put_(
        (phys.reshape(-1),), blk.reshape(-1, *blk.shape[2:]).to(pages.dtype))


def attn_layer_step_paged(p, x, kpages, vpages, tbl, lengths, cfg: ModelConfig):
    """Block-decode attention layer against the pooled paged cache.

    kpages/vpages: (P, ps, KV, hd) physical pages shared by every lane
    (page 0 = null page).  tbl: (B, MPS) int32 block table; logical
    position t of lane b lives at physical slot
    ``tbl[b, t // ps] * ps + t % ps``, and -1 entries clamp onto the null
    page, so eager writes from idle lanes are harmless.  The block's K/V
    are written in place at positions ``lengths + i`` before the
    ``paged_decode_attention`` kernel reads them with the post-write
    lengths.  Rollback is the contiguous path's: lengths do not advance
    past the accepted prefix and the stale slots are overwritten later."""
    B, T = x.shape[:2]
    ps = kpages.shape[1]
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    qpos = lengths[:, None].long() + torch.arange(T, device=x.device)[None, :]
    q, k, v = _qkv(p, xn, cfg)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    _, wphys = logical_to_physical(tbl, qpos, ps)
    paged_write(kpages, k, wphys)
    paged_write(vpages, v, wphys)
    out = ops.paged_decode_attention(q.contiguous(), kpages, vpages,
                                     (lengths + T).to(torch.int32), tbl)
    x = x + out.reshape(B, T, -1) @ p["wo"]
    return _ffn(p, x, cfg)


# ---------------------------------------------------------------------------
# Segment execution (loop over stacked layers)
# ---------------------------------------------------------------------------

def run_segment_full(sp, x, cfg: ModelConfig, seg: Segment, positions,
                     collect: bool = False, remat: bool = False):
    """The segment over the whole sequence.  Returns (x, contribs) with
    contribs, when `collect` (else {}), stacked on the layer axis: {"k", "v"}
    (n, B, T, KV, hd) for attention, {"conv", "state"} (n, B, cw-1,
    conv_dim) / (n, B, H, hd, ds) float32 for SSM segments.

    Nothing here writes in place, so autograd can differentiate the whole
    segment.  With `remat` each layer's body runs under non-reentrant
    ``torch.utils.checkpoint`` (the reference wraps its scan body in
    ``jax.checkpoint``): the backward recomputes a layer's activations from
    its input instead of keeping them."""
    if seg.kind == "ssm":
        def body(lp, x):
            return ssm_mod.ssm_forward_full(lp, x, cfg.ssm, cfg.norm_eps)
        names = ("conv", "state")
    else:
        spec = MaskSpec()

        def body(lp, x):
            x, k, v = attn_layer_full(lp, x, cfg, positions, spec)
            return x, {"k": k, "v": v}
        names = ("k", "v")
    if remat:
        plain = body

        def body(lp, x):
            return checkpoint(plain, lp, x, use_reentrant=False)
    got = {name: [] for name in names}
    for i in range(seg.n):
        x, con = body(_layer(sp, i), x)
        if collect:
            for name in names:
                got[name].append(con[name])
    return x, ({name: torch.stack(v) for name, v in got.items()} if collect else {})


def run_segment_step(sp, x, seg_cache, lengths, cfg: ModelConfig, seg: Segment,
                     tbl=None, take=None):
    """Returns (x, cands).  Attention segments write their K/V cache in
    place and have no candidates ({}); `tbl` is the block table (B, MPS)
    when the cache is paged (seg_cache then holds pooled "kp"/"vp" pages
    instead of per-lane "k"/"v").  SSM segments leave their state untouched
    and return the candidates {"conv", "state"} stacked (n, B, T, ...); with
    `take` (B,), a prefill chunk's commit, they carry instead: each layer's
    window and state after token take-1 (kept where take == 0) are written
    in place and there are no candidates."""
    if seg.kind == "ssm":
        convs, states = [], []
        for i in range(seg.n):
            x, cand = ssm_mod.ssm_step(_layer(sp, i), x,
                                       {"conv": seg_cache["conv"][i],
                                        "state": seg_cache["state"][i]},
                                       cfg.ssm, cfg.norm_eps, take=take)
            if take is not None:
                seg_cache["conv"][i].copy_(cand["conv"])
                seg_cache["state"][i].copy_(cand["state"])
                continue
            convs.append(cand["conv"])
            states.append(cand["state"])
        if take is not None:
            return x, {}
        return x, {"conv": torch.stack(convs), "state": torch.stack(states)}
    if "kp" in seg_cache:
        for i in range(seg.n):
            x = attn_layer_step_paged(_layer(sp, i), x, seg_cache["kp"][i],
                                      seg_cache["vp"][i], tbl, lengths, cfg)
        return x, {}
    for i in range(seg.n):
        x = attn_layer_step(_layer(sp, i), x, seg_cache["k"][i], seg_cache["v"][i],
                            lengths, cfg)
    return x, {}


# ---------------------------------------------------------------------------
# Cache construction / commit
# ---------------------------------------------------------------------------

def _ssm_cache(cfg: ModelConfig, seg: Segment, B: int, device) -> dict:
    return ssm_mod.init_ssm_cache(seg.n, B, cfg.d_model, cfg.ssm, cfg.torch_dtype, device)


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None) -> dict:
    """Contiguous cache for the full stack: per attention segment K and V of
    shape (n, B, max_len, KV, hd) in the model dtype, per SSM segment the
    conv window and SSD state (``ssm.init_ssm_cache``), plus per-lane
    committed ``lengths`` (B,)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    segs = {seg.name: (_ssm_cache(cfg, seg, B, device) if seg.kind == "ssm" else
                       {"k": torch.zeros((seg.n, B, max_len, KV, hd), dtype=dtype,
                                         device=device),
                        "v": torch.zeros((seg.n, B, max_len, KV, hd), dtype=dtype,
                                         device=device)})
            for seg in model_segments(cfg)}
    return {"lengths": torch.zeros((B,), dtype=torch.int32, device=device), "segs": segs}


def init_paged_cache(cfg: ModelConfig, B: int, num_pages: int, page_size: int,
                     max_pages_per_slot: int, device=None) -> dict:
    """Paged cache: per attention segment K and V pooled into ``num_pages``
    shared pages plus the physical null page 0, (n, num_pages + 1,
    page_size, KV, hd) in the model dtype; SSM segments keep their per-lane
    constant-size state, as in ``init_cache``; per-lane ``lengths`` (B,) and
    the block table ``tbl`` (B, max_pages_per_slot) int32, all -1
    (unmapped)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (num_pages + 1, page_size, KV, hd)
    segs = {seg.name: (_ssm_cache(cfg, seg, B, device) if seg.kind == "ssm" else
                       {"kp": torch.zeros((seg.n, *shape), dtype=dtype, device=device),
                        "vp": torch.zeros((seg.n, *shape), dtype=dtype, device=device)})
            for seg in model_segments(cfg)}
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
    place: a block-table-indexed scatter of the source K/V into the pool.
    Source positions past the mapped region land on the null page."""
    n, Pp, ps = seg_c["kp"].shape[:3]
    C_src = src_c["k"].shape[2]
    pos = torch.arange(C_src, device=tbl.device)[None, :]
    _, phys = logical_to_physical(tbl[slot:slot + 1], pos, ps)
    for pooled, src in ((seg_c["kp"], src_c["k"]), (seg_c["vp"], src_c["v"])):
        flat = pooled.view(n, Pp * ps, *pooled.shape[3:])
        flat[:, phys[0]] = src[:, src_slot].to(pooled.dtype)


def insert_slot(cfg: ModelConfig, cache: dict, src: Optional[dict], slot: int,
                src_slot: int = 0) -> dict:
    """Continuous-batching cache surgery, in place: copy lane `src_slot` of
    `src` (a freshly prefilled B = 1 contiguous cache, which may be sized to
    the prompt alone) into lane `slot` of the live cache, and set its
    length.  Contiguous segments take the source K/V in the lane's prefix;
    paged segments scatter it through the slot's block-table row (map the
    pages with ``map_slot_pages`` first); SSM segments copy the lane's
    constant-size conv window and state whole.  The destination lane must
    have been reset.  ``src=None``, the prefix cache's table-only splice, is
    not ported yet."""
    if src is None:
        raise NotImplementedError("insert_slot(src=None), the prefix cache's table "
                                  "splice, is a later slice of the port")
    tbl = cache.get("tbl")
    for name, seg_c in cache["segs"].items():
        src_c = src["segs"][name]
        if "kp" in seg_c:
            _insert_paged_seg(seg_c, src_c, tbl, slot, src_slot)
            continue
        for key, leaf in seg_c.items():
            piece = src_c[key][:, src_slot]
            if key in ("k", "v"):
                leaf[:, slot, :piece.shape[1]] = piece.to(leaf.dtype)
            else:
                leaf[:, slot] = piece.to(leaf.dtype)
    cache["lengths"][slot] = src["lengths"][src_slot]
    return cache


def reset_slot(cfg: ModelConfig, cache: dict, slot: int) -> dict:
    """Evict lane `slot`, in place: length 0 and, for contiguous and SSM
    segments, its K/V or its conv window and state zeroed.  Paged segments
    need no KV work: the lane's block-table row is unmapped (-1) and its
    pages go back to the host-side pool.  Other lanes are untouched."""
    # fill_ on views: item assignment of a Python number would stage it
    # through a host tensor and block the host on the copy
    for seg_c in cache["segs"].values():
        if "kp" in seg_c:
            continue
        for leaf in seg_c.values():
            leaf[:, slot].zero_()
    cache["lengths"][slot].zero_()
    if "tbl" in cache:
        cache["tbl"][slot].fill_(-1)
    return cache


def fill_cache_from_full(cfg: ModelConfig, cache: dict, contribs: dict, T: int) -> dict:
    """Copy prefill contributions into the cache, in place: K/V (stacked
    (n,B,T,...)) into slots [0, T), SSM conv windows and states whole.  All
    sequences are fully packed (length T)."""
    for seg in model_segments(cfg):
        con = contribs.get(seg.name)
        if not con:
            continue
        c = cache["segs"][seg.name]
        if seg.kind == "ssm":
            c["conv"].copy_(con["conv"])
            c["state"].copy_(con["state"])
            continue
        c["k"][:, :, :T] = con["k"].to(c["k"].dtype)
        c["v"][:, :, :T] = con["v"].to(c["v"].dtype)
    B = cache["lengths"].shape[0]
    return {"lengths": torch.full((B,), T, dtype=torch.int32,
                                  device=cache["lengths"].device),
            "segs": cache["segs"]}


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
                 hi: int, collect: bool = False, remat: bool = False):
    """Run layers [lo, hi) over a full sequence at positions 0..T-1, each
    layer under ``torch.utils.checkpoint`` when `remat`.  Returns
    (x, contribs)."""
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    contribs = {}
    for seg in segments_in_range(cfg, lo, hi):
        x, contribs[seg.name] = run_segment_full(params_segs[seg.name], x, cfg, seg,
                                                 positions, collect, remat)
    return x, contribs


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
                                   cache["lengths"], cfg, seg, cache.get("tbl"), take)
        if cand:
            cands[seg.name] = cand
    return x, cache, cands
