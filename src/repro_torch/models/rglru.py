"""Griffin / RecurrentGemma recurrent block [arXiv:2402.19427]: port of
``repro.models.rglru``.

Block: x -> RMSNorm -> two branches:
  (a) gate branch: GeLU(W_gate x)
  (b) recurrent branch: causal conv1d(W_x x) -> RG-LRU
merged multiplicatively, then the output projection.  RG-LRU recurrence:
  r_t = sigmoid(W_a u_t),  i_t = sigmoid(W_i u_t)
  log a_t = -c * softplus(Lambda) * r_t           (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full-sequence path (prefill, training) computes the recurrence in
float32 in a form that is parallel over T where the reference uses
``jax.lax.associative_scan``: within chunks of ``SCAN_CHUNK`` steps the decay
matrix exp(L_t - L_s) from the cumulative log a, and across chunks the same
scan once more over the chunks' end states (``linear_scan``).  The
block-decode path (``rglru_step``) runs the projections, the conv and the
gates over the block and the recurrence token by token, and returns the conv
window and the state after every token, so the speculative commit can
select the state at the accepted length (``transformer.commit_cache``,
shared with the Mamba-2 path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.layers import conv1d_causal, dense_init, rms_norm

_C = 8.0
# steps of a chunk of the parallel scan: its decay matrix holds SCAN_CHUNK
# times the (B, T, w) gates, and the float32 rounding of exp(L_t - L_s)
# grows with the chunk's cumulative log a
SCAN_CHUNK = 16


def init_rglru(gen: torch.Generator, n: int, d: int, r: RGLRUConfig,
               dtype: torch.dtype) -> dict:
    """Random parameters of `n` stacked recurrent blocks, on the generator's
    device, with the reference's shapes and dtypes (``conv_w`` and ``lam``
    float32; ``lam`` is the reference's deterministic linspace)."""
    w = r.lru_width or d
    dev = gen.device
    lam = torch.linspace(0.5, 4.0, w, dtype=torch.float32, device=dev)
    return {
        "ln1": torch.zeros((n, d), dtype=torch.float32, device=dev),
        "w_gate": dense_init(gen, (n, d, w), dtype),
        "w_x": dense_init(gen, (n, d, w), dtype),
        "conv_w": dense_init(gen, (n, r.d_conv, w), torch.float32, scale=0.5),
        "w_a": dense_init(gen, (n, w, w), dtype),
        "w_i": dense_init(gen, (n, w, w), dtype),
        "lam": lam.repeat(n, 1),
        "w_o": dense_init(gen, (n, w, d), dtype),
    }


def _gates(p: dict, u: torch.Tensor):
    """(log a, b) in float32 for the conv output u (B, T, w): the decay's log
    and the gated input sqrt(1 - a^2) * i * u."""
    rf = torch.sigmoid((u @ p["w_a"]).float())
    it = torch.sigmoid((u @ p["w_i"]).float())
    log_a = -_C * F.softplus(p["lam"])[None, None, :] * rf
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * it * u.float()
    return log_a, b


def linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t from h_0 = 0, for (B, T, w) float32,
    parallel over T.  Chunks of Q = ``SCAN_CHUNK`` steps: with L the
    cumulative log a inside a chunk, h_t = sum_{s <= t} exp(L_t - L_s) b_s
    from the chunk's start, plus exp(L_t) times the state entering the
    chunk; those states are the same scan over the chunks (their summed log
    a and their local end states), done recursively.  The difference L_t -
    L_s is masked inside the exp (above the diagonal it may overflow)."""
    B, T, w = b.shape
    Q = min(SCAN_CHUNK, T)
    pad = (-T) % Q
    if pad:                              # a = 1, b = 0: the state passes through
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    nc = (T + pad) // Q
    la = log_a.reshape(B, nc, Q, w)
    L = torch.cumsum(la, dim=2)                                      # (B, nc, Q, w)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=b.device))
    seg = L[:, :, :, None, :] - L[:, :, None, :, :]                  # (B, nc, t, s, w)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg, -torch.inf))
    h = (decay * b.reshape(B, nc, 1, Q, w)).sum(dim=3)               # (B, nc, Q, w)
    if nc > 1:
        ends = linear_scan(L[:, :, -1], h[:, :, -1])                 # (B, nc, w)
        carry = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
        h = h + torch.exp(L) * carry[:, :, None, :]
    return h.reshape(B, nc * Q, w)[:, :T]


def rglru_forward_full(p: dict, x: torch.Tensor, r: RGLRUConfig, norm_eps: float,
                       conv_state=None, h0=None):
    """x (B, T, d).  Returns (x + y, contrib) with contrib {"conv": (B, cw-1,
    w) in x's dtype, "state": (B, w) float32}: the conv window and the
    recurrent state after the last token.  `conv_state` and `h0` continue an
    earlier pass (the reference folds h0 into the first step's input)."""
    xn = rms_norm(x, p["ln1"], norm_eps)
    gate = F.gelu((xn @ p["w_gate"]).float(), approximate="tanh")
    u, conv_state = conv1d_causal(xn @ p["w_x"], p["conv_w"], conv_state)
    log_a, b = _gates(p, u)                                          # (B, T, w) f32
    if h0 is not None:
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(log_a, b)
    y = (h * gate).to(x.dtype) @ p["w_o"]
    return x + y, {"conv": conv_state, "state": h[:, -1]}


def rglru_step(p: dict, x: torch.Tensor, cache: dict, r: RGLRUConfig, norm_eps: float,
               take=None):
    """Block decode: x (B, T, d) against one layer's cache {"conv", "state"},
    which is left untouched.  Returns (x + y, candidates) with candidates
    {"conv": (B, T, cw-1, w), "state": (B, T, w) float32}: the window and
    the state after each of the T tokens.

    With `take` (B,) int (a prefill chunk, whose commit is known before the
    block runs) it returns instead the one candidate the commit would
    select, {"conv": (B, cw-1, w), "state": (B, w)}: after token take-1,
    the cache's own where take == 0.

    The projections run over the whole block, as in the reference; so do
    the conv and the gates, which read no state (the reference scans them
    with h); only the recurrence steps token by token."""
    conv_st, h = cache["conv"], cache["state"].float()
    cw = p["conv_w"].shape[0]
    xn = rms_norm(x, p["ln1"], norm_eps)
    gate = F.gelu((xn @ p["w_gate"]).float(), approximate="tanh")     # (B, T, w)
    ux = xn @ p["w_x"]
    u, _ = conv1d_causal(ux, p["conv_w"], conv_st)
    log_a, b = _gates(p, u)                                          # (B, T, w) f32
    a = torch.exp(log_a)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1)                                      # (B, T, w)
    y = (hs * gate).to(x.dtype) @ p["w_o"]
    # the window after token t: inputs t+1 .. t+cw-1 of [conv_st, W_x xn]
    full = torch.cat([conv_st, ux.to(conv_st.dtype)], dim=1)
    convs = full.unfold(1, cw - 1, 1)[:, 1:].transpose(2, 3)         # (B, T, cw-1, w)
    if take is None:
        return x + y, {"conv": convs, "state": hs}
    idx = (take.long() - 1).clamp(min=0)
    rows = torch.arange(x.shape[0], device=x.device)
    kept = take > 0
    return x + y, {"conv": torch.where(kept[:, None, None], convs[rows, idx], conv_st),
                   "state": torch.where(kept[:, None], hs[rows, idx], cache["state"].float())}


def init_rglru_cache(n: int, B: int, d: int, r: RGLRUConfig, dtype: torch.dtype,
                     device: torch.device) -> dict:
    """Per-lane constant-size state of `n` stacked blocks: the conv window
    (n, B, cw-1, w) in the model dtype and the state (n, B, w) float32."""
    w = r.lru_width or d
    return {"conv": torch.zeros((n, B, r.d_conv - 1, w), dtype=dtype, device=device),
            "state": torch.zeros((n, B, w), dtype=torch.float32, device=device)}
