"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, materialising what the
kernel keeps on chip.  ``ops`` runs them for CPU tensors (the tests), and
``chip_smoke.py`` holds each kernel against them on the card.  They mirror
``repro.kernels.ref`` (``tests/test_torch_kernels.py`` and
``tests/test_torch_ssm.py`` check that).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import attend, kv_dequantize
from repro_torch.serving.kv_pool import logical_to_physical


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
                     lengths: torch.Tensor, pos=None, window: int = 0,
                     causal: bool = True, k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention over a contiguous cache.

    q (B, H, hd): one query per lane attending slots j < lengths[b].
    q (B, Tq, H, hd): a block of Tq queries; ``lengths`` is the cache length
    AFTER the block's own write, and query t attends j < lengths[b]-(Tq-1-t).
    k/v (B, S, KV, hd).  Returns q's shape in q's dtype.

    The ring form, `pos` (B, S) int32 the position each slot holds (-1:
    empty): query t, at qpos = lengths[b] - Tq + t, attends slot j iff
    0 <= pos[b, j] <= qpos and, with `window` > 0, pos[b, j] > qpos -
    window (the reference's ring step mask).

    ``causal=False`` (cross-attention over an encoder's K/V): every query of
    the block attends the slots j < lengths[b]; the ring form is causal.

    int8 k/v with `k_scale` / `v_scale` (B, S, KV) float32 (the int8 KV
    cache): dequantised to q's dtype first (``kv_dequantize``), as the
    reference dequantises before it attends."""
    if not causal and pos is not None:
        raise ValueError("decode_attention: the ring form is causal")
    k, v = _dequantized(q, k, v, k_scale, v_scale)
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    Tq, S = q4.shape[1], k.shape[1]
    if pos is None:
        lim = _block_limits(lengths, Tq) if causal else lengths.long()[:, None, None]
        mask = torch.arange(S, device=q.device)[None, None, :] < lim
    else:
        qend = _block_limits(lengths, Tq)                       # qpos + 1, (B, Tq, 1)
        p = pos.long()[:, None, :]
        mask = (p >= 0) & (p < qend)
        if window:
            mask &= p >= qend - window
    out = attend(q4, k, v, mask)
    return out[:, 0] if single else out


def _dequantized(q, k, v, k_scale, v_scale):
    """k and v as attend reads them: themselves, or int8 values with their
    scales dequantised to q's dtype."""
    if k_scale is None:
        return k, v
    return kv_dequantize(k, k_scale, q.dtype), kv_dequantize(v, v_scale, q.dtype)


def _block_limits(lengths: torch.Tensor, Tq: int) -> torch.Tensor:
    """(B, Tq, 1): query t of a block sees slots j < lengths - (Tq-1-t)."""
    t = torch.arange(Tq, device=lengths.device)
    return (lengths.long()[:, None] - (Tq - 1 - t)[None, :])[:, :, None]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           lengths: torch.Tensor, block_tables: torch.Tensor,
                           page_counts=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention over pooled pages read through per-lane block tables.

    k_pages/v_pages (P, ps, KV, hd), physical page 0 the null page;
    block_tables (B, MPS) int32, -1 = unmapped.  Gathers each lane's
    logical view (MPS * ps slots) through ``logical_to_physical`` and
    attends the mapped slots below the block limits of ``decode_attention``
    (q (B, H, hd) or (B, Tq, H, hd), ``lengths`` counting the block's own
    write).  ``page_counts`` (B,) int32, clipped to [1, MPS], masks logical
    pages at or past it for every query of the lane, as the reference's
    ``ref_paged_decode_attention`` does; None leaves ceil(lengths / ps),
    which the length mask already implies.  A query with no live slot gets
    the reference's uniform average over the masked view (the kernel gives
    0); only idle lanes have one.  int8 pages with `k_scale` / `v_scale`
    (P, ps, KV) float32: dequantised to q's dtype first."""
    k_pages, v_pages = _dequantized(q, k_pages, v_pages, k_scale, v_scale)
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    B, Tq = q4.shape[:2]
    P, ps, KV, hd = k_pages.shape
    L = block_tables.shape[1] * ps
    j = torch.arange(L, device=q.device)
    page, phys = logical_to_physical(block_tables, j[None, :].expand(B, L), ps)
    kf = k_pages.reshape(P * ps, KV, hd)[phys]                         # (B, L, KV, hd)
    vf = v_pages.reshape(P * ps, KV, hd)[phys]
    mask = (page >= 0)[:, None, :] & (j[None, None, :] < _block_limits(lengths, Tq))
    if page_counts is not None:
        pc = page_counts.long().clamp(1, block_tables.shape[1])
        mask = mask & ((j // ps)[None, :] < pc[:, None])[:, None, :]
    out = attend(q4, kf, vf, mask)
    return out[:, 0] if single else out


def ssd_scan(xh: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, chunk: int, h0=None):
    """Mamba-2 chunked SSD scan, a line-for-line copy of
    ``repro.models.ssm.ssd_chunked`` (one chunk in flight at a time), its
    values bit for bit; differentiable, with a finite gradient where the
    reference's is NaN (the intra-chunk decay, below).

    xh (B,T,H,hd), Bc/Cc (B,T,G,ds), dt (B,T,H) after softplus, A (H,) < 0,
    h0 (B,H,hd,ds) or None; T % chunk == 0.  Returns (y (B,T,H,hd) float32,
    final state (B,H,hd,ds) float32)."""
    B_, T, H, hd = xh.shape
    G, ds = Bc.shape[2], Bc.shape[3]
    nc = T // chunk
    rep = H // G
    f32 = torch.float32

    xc = xh.reshape(B_, nc, chunk, H, hd).movedim(1, 0).to(f32)
    Bcc = Bc.reshape(B_, nc, chunk, G, ds).repeat_interleave(rep, dim=3).movedim(1, 0).to(f32)
    Ccc = Cc.reshape(B_, nc, chunk, G, ds).repeat_interleave(rep, dim=3).movedim(1, 0).to(f32)
    dtc = dt.reshape(B_, nc, chunk, H).movedim(1, 0).to(f32)
    A = A.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))

    h = (torch.zeros((B_, H, hd, ds), dtype=f32, device=xh.device) if h0 is None
         else h0.to(f32))
    ys = []
    for c in range(nc):
        x_, B__, C__, dt_ = xc[c], Bcc[c], Ccc[c], dtc[c]            # (B,Q,H,hd) etc.
        dA = dt_ * A[None, None, :]                                  # (B,Q,H)
        cum = torch.cumsum(dA, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]                # (B,Q,Q,H)
        # the mask goes inside the exp: seg overflows exp above the diagonal,
        # and the reference's where(tri, exp(seg), 0) gives the same values
        # but a NaN gradient there (0 * inf; ROADMAP §3)
        decay = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
        cb = torch.einsum("bihs,bjhs->bijh", C__, B__)
        att = cb * decay * dt_[:, None, :, :]
        y = torch.einsum("bijh,bjhd->bihd", att, x_)
        y = y + torch.einsum("bihs,bhds,bih->bihd", C__, h, torch.exp(cum))
        dec_out = torch.exp(cum[:, -1:, :] - cum) * dt_              # (B,Q,H)
        chunk_state = torch.einsum("bjh,bjhs,bjhd->bhds", dec_out, B__, x_)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + chunk_state
        ys.append(y)
    y = torch.stack(ys, dim=0).movedim(0, 1).reshape(B_, T, H, hd)
    return y, h
