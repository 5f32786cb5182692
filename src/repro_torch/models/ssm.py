"""Mamba-2 SSD block [arXiv:2405.21060]: port of ``repro.models.ssm``.

The full-sequence path (prefill) runs the chunked state-space-duality scan
through the ``ssd_scan`` kernel (``kernels.ops.ssd_scan``): per chunk the
decay-masked intra-chunk term, the inter-chunk term from the carried
float32 state, and the state update.  The block-decode path (``ssm_step``)
is the per-token recurrence ``h_t = exp(dt*A) h_{t-1} + dt * B_t (x) x_t``
in plain PyTorch, and returns the conv window and the SSD state after
EVERY token of the block, so the speculative commit can select the state at
the accepted length: an SSM state cannot be rolled back by masking the way
a KV cache can.

Every dtype cast follows the reference: the conv output is in the model
dtype and silu runs on it in the full path, while the step path runs silu
in float32 and then casts; the scan's ``y`` stays float32 until after the
gate; the conv state is in the model dtype and the SSD state in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import conv1d_causal, dense_init, rms_norm


def ssm_dims(d_model: int, s: SSMConfig):
    d_in = s.expand * d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.ngroups * s.d_state
    proj_dim = 2 * d_in + 2 * s.ngroups * s.d_state + H
    return d_in, H, conv_dim, proj_dim


def init_ssm(gen: torch.Generator, n: int, d: int, s: SSMConfig, dtype: torch.dtype) -> dict:
    """Random parameters of `n` stacked Mamba-2 blocks, on the generator's
    device, with the reference's shapes, dtypes and deterministic leaves."""
    d_in, H, conv_dim, proj_dim = ssm_dims(d, s)
    dev = gen.device
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=dev))
    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, H, dtype=f32, device=dev)))
    return {
        "ln1": torch.zeros((n, d), dtype=f32, device=dev),
        "in_proj": dense_init(gen, (n, d, proj_dim), dtype),
        "conv_w": dense_init(gen, (n, s.d_conv, conv_dim), f32, scale=0.5),
        "A_log": a_log.repeat(n, 1),
        "D": torch.ones((n, H), dtype=f32, device=dev),
        "dt_bias": dt_bias.repeat(n, 1),
        "norm_w": torch.zeros((n, d_in), dtype=f32, device=dev),
        "out_proj": dense_init(gen, (n, d_in, d), dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, d_in: int, G: int, ds: int, H: int):
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * G * ds]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _split_xbc(xBC: torch.Tensor, d_in: int, G: int, ds: int, H: int, hd: int):
    """Views of the conv output: xh (B,T,H,hd), Bc/Cc (B,T,G,ds), strided."""
    B_, T = xBC.shape[0], xBC.shape[1]
    xh = xBC[..., :d_in].reshape(B_, T, H, hd)
    Bc = xBC[..., d_in:d_in + G * ds].reshape(B_, T, G, ds)
    Cc = xBC[..., d_in + G * ds:].reshape(B_, T, G, ds)
    return xh, Bc, Cc


def ssm_forward_full(p: dict, x: torch.Tensor, s: SSMConfig, norm_eps: float,
                     conv_state=None, h0=None):
    """Full-sequence Mamba-2 block.  x (B,T,d).  Returns (x + out, contrib)
    with contrib {"conv": (B, cw-1, conv_dim), "state": (B,H,hd,ds) f32}.

    The scan is chunked at ``min(chunk_size, T)`` with T zero-padded to a
    multiple of it (dt = 0 on padded rows leaves the state unchanged), as
    the reference chunks it, so the kernel sees any chunk length 1..128."""
    B_, T, d = x.shape
    d_in, H, _, _ = ssm_dims(d, s)
    G, ds, hd = s.ngroups, s.d_state, s.head_dim
    xn = rms_norm(x, p["ln1"], norm_eps)
    zxbcdt = xn @ p["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, d_in, G, ds, H)
    xBC, conv_state = conv1d_causal(xBC, p["conv_w"], conv_state)
    xBC = F.silu(xBC)
    xh, Bc, Cc = _split_xbc(xBC, d_in, G, ds, H, hd)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    chunk = min(s.chunk_size, T)
    pad = (-T) % chunk
    if pad:
        def padf(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        xh, Bc, Cc, dtp = padf(xh), padf(Bc), padf(Cc), padf(dtp)
    y, h_final = ops.ssd_scan(xh, Bc, Cc, dtp, A, chunk, h0=h0)
    y = y[:, :T]
    y = y + xh[:, :T].float() * p["D"][None, None, :, None]
    y = y.reshape(B_, T, d_in)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm_w"], norm_eps)
    out = y @ p["out_proj"]
    return x + out, {"conv": conv_state, "state": h_final}


def _ssm_token(p: dict, x: torch.Tensor, conv_st: torch.Tensor, h: torch.Tensor,
               s: SSMConfig, norm_eps: float, A: torch.Tensor):
    """One token through the block: x (B, 1, d), the conv window conv_st
    (B, cw-1, conv_dim) and the state h (B, H, hd, ds) float32 before it.
    Returns (x + out, the window after it, the state after it)."""
    B_, _, d = x.shape
    d_in, H, _, _ = ssm_dims(d, s)
    G, ds, hd = s.ngroups, s.d_state, s.head_dim
    rep = H // G
    xn = rms_norm(x, p["ln1"], norm_eps)
    z, xBC, dt = _split_proj(xn @ p["in_proj"], d_in, G, ds, H)          # (B, 1, ...)
    win = torch.cat([conv_st, xBC.to(conv_st.dtype)], dim=1)              # (B, cw, conv_dim)
    y = F.silu((win.float() * p["conv_w"][None]).sum(dim=1)).to(x.dtype)
    # heads grouped (G, rep): head g*rep + r reads group g's B and C
    xf = y[:, :d_in].float().reshape(B_, G, rep, hd)
    Bc = y[:, d_in:d_in + G * ds].float().reshape(B_, G, 1, 1, ds)
    Cc = y[:, d_in + G * ds:].float().reshape(B_, G, 1, ds, 1)
    dtp = F.softplus(dt[:, 0].float() + p["dt_bias"]).reshape(B_, G, rep)
    da = torch.exp(dtp * A.reshape(1, G, rep))
    hg = (h.reshape(B_, G, rep, hd, ds) * da[..., None, None]
          + (dtp[..., None] * xf)[..., None] * Bc)
    yt = (hg @ Cc)[..., 0] + xf * p["D"].reshape(1, G, rep, 1)           # (B, G, rep, hd)
    yt = rms_norm((yt.reshape(B_, 1, d_in) * F.silu(z.float())).to(x.dtype),
                  p["norm_w"], norm_eps)
    return x + yt @ p["out_proj"], win[:, 1:], hg.reshape(B_, H, hd, ds)


def ssm_step(p: dict, x: torch.Tensor, cache: dict, s: SSMConfig, norm_eps: float,
             take=None):
    """Block decode: x (B,T,d) with T small (K+1 in the verify pass, 1 in a
    draft feed), against cache {"conv", "state"} of one layer, which is
    left untouched.  Returns (x + out, candidates) with candidates
    {"conv": (B,T,cw-1,conv_dim), "state": (B,T,H,hd,ds) f32}: the conv
    window and SSD state after each of the T tokens.

    With `take` (B,) int (a prefill chunk, whose commit is known before the
    block runs) it returns instead the one candidate the commit would
    select, {"conv": (B,cw-1,conv_dim), "state": (B,H,hd,ds)}: the window
    and state after token take-1, the cache's own where take == 0.  The
    values are the same; the T candidates are never held at once.

    The whole block runs one token at a time (``_ssm_token``), its
    projections included, where the reference projects the T tokens in one
    product.  A token's arithmetic then does not depend on T: in bf16 a
    matrix product rounds differently at different row counts, and through
    48 recurrent layers such differences grow until a verify pass of K+1
    tokens and a one-token AR step pick different greedy tokens.  Token by
    token, the speculative stream equals the AR stream bit for bit."""
    A = -torch.exp(p["A_log"])
    conv_st, h = cache["conv"], cache["state"]
    sel_conv, sel_h = conv_st, h
    outs, convs, hs = [], [], []
    for t in range(x.shape[1]):
        out, conv_st, h = _ssm_token(p, x[:, t:t + 1], conv_st, h, s, norm_eps, A)
        outs.append(out)
        if take is None:
            convs.append(conv_st)
            hs.append(h)
        else:                            # token t is committed where t < take
            kept = t < take
            sel_conv = torch.where(kept[:, None, None], conv_st, sel_conv)
            sel_h = torch.where(kept[:, None, None, None], h, sel_h)
    if take is not None:
        return torch.cat(outs, dim=1), {"conv": sel_conv, "state": sel_h}
    return (torch.cat(outs, dim=1),
            {"conv": torch.stack(convs, dim=1), "state": torch.stack(hs, dim=1)})


def init_ssm_cache(n: int, B: int, d: int, s: SSMConfig, dtype: torch.dtype,
                   device: torch.device) -> dict:
    """Per-lane constant-size state of `n` stacked blocks: the conv window
    (n, B, cw-1, conv_dim) in the model dtype, the SSD state (n, B, H, hd,
    ds) in float32."""
    d_in, H, conv_dim, _ = ssm_dims(d, s)
    return {"conv": torch.zeros((n, B, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
            "state": torch.zeros((n, B, H, s.head_dim, s.d_state), dtype=torch.float32,
                                 device=device)}
