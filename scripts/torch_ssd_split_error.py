#!/usr/bin/env python3
"""How many bf16 terms the ssd_scan kernel's float32 operands need: an
emulation, on the CPU, of the kernel's arithmetic (products of bf16 terms
summed in float32) held against the plain version at the tolerance the
kernel must meet on the card (atol 1e-4, rtol 1e-4).

    PYTHONPATH=src python3 scripts/torch_ssd_split_error.py

A float32 operand v enters as terms v0 + v1 (+ v2), each the bf16 rounding
of what the earlier ones leave, and a product a.b as the sum of a_u.b_v
with u + v <= 2.  For each split of W (the decay-weighted C.B^T), h (the
carried state) and u x (the state update), and of x, B and C for float32
inputs, it prints the worst ratio |y - y_ref| / (atol + rtol |y_ref|) over
every output, and the same for the final state; a ratio above 1 misses the
tolerance.  The inputs are those of tests/test_torch_cuda.py (randn, the
harder case) and of chip_smoke.py.  Emulation only: the card's accumulation
order and exp differ, so the kernel keeps a margin.  Takes about a minute.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.kernels import ref  # noqa: E402

ATOL = RTOL = 1e-4
BF = torch.bfloat16


def terms(v: torch.Tensor, n: int) -> list:
    out = []
    for _ in range(n):
        t = v.to(BF).float()
        out.append(t)
        v = v - t
    return out


def prod(a, b, na: int, nb: int) -> torch.Tensor:
    ta, tb = terms(a, na), terms(b, nb)
    return sum(ta[u] @ tb[v] for u in range(na) for v in range(nb) if u + v <= 2)


def emulate(xh, Bc, Cc, dt, A, Q, h0, nw, nh, nx, ni):
    """The kernel's scan with W, h and u x in nw, nh and nx terms and x, B,
    C in ni terms, chunk by chunk, head by head, in float32."""
    Bn, T, H, hd = xh.shape
    x, Bm, Cm = xh.float(), Bc[:, :, 0].float(), Cc[:, :, 0].float()
    h = torch.zeros(Bn, H, hd, Bc.shape[3]) if h0 is None else h0.clone()
    y = torch.empty(Bn, T, H, hd)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    for b in range(Bn):
        for c in range(T // Q):
            rows = slice(c * Q, (c + 1) * Q)
            C_, B_ = Cm[b, rows], Bm[b, rows]
            S = prod(C_, B_.T, ni, ni)
            for hh in range(H):
                d = dt[b, rows, hh]
                cum = torch.cumsum(d * A[hh], 0)
                W = torch.where(tri, S * torch.exp(cum[:, None] - cum[None, :]) * d[None, :],
                                torch.zeros(()))
                xx = x[b, rows, hh]
                yy = prod(W, xx, nw, ni)
                if c > 0 or h0 is not None:
                    yy = yy + torch.exp(cum)[:, None] * prod(C_, h[b, hh].T, ni, nh)
                y[b, rows, hh] = yy
                u = torch.exp(cum[-1] - cum) * d
                h[b, hh] = h[b, hh] * torch.exp(cum[-1]) + prod(B_.T, u[:, None] * xx, ni, nx).T
    return y, h


def inputs(kind, dtype, B, T, H, hd, ds, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "test":                  # tests/test_torch_cuda.py::_ssd_inputs
        xbc = torch.randn((B, T, H * hd + 2 * ds), generator=g).to(dtype)
        Bc = (xbc[..., H * hd:H * hd + ds] * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g))
        A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    else:                               # chip_smoke.py::ssd_inputs
        xbc = torch.nn.functional.silu(torch.randn((B, T, H * hd + 2 * ds),
                                                   generator=g)).to(dtype)
        Bc = xbc[..., H * hd:H * hd + ds]
        dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g) - 2.0)
        A = -torch.linspace(1.0, 16.0, H)
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    return xh, Bc.reshape(B, T, 1, ds), xbc[..., H * hd + ds:].reshape(B, T, 1, ds), dt, A


def worst(a, r) -> float:
    return float(((a - r).abs() / (ATOL + RTOL * r.abs())).max())


def main() -> int:
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    # (label, kind, B, T, Q, with h0): one and two chunks of 127, 128 with h0
    cases = [("test, 2 chunks of 127", "test", 1, 254, 127, False),
             ("test, 128 with h0", "test", 1, 128, 128, True),
             ("chip_smoke, 127", "smoke", 1, 127, 127, False)]
    splits = {torch.bfloat16: [(2, 2, 2, 1), (3, 2, 2, 1), (3, 3, 2, 1), (3, 3, 3, 1)],
              torch.float32: [(2, 2, 2, 2), (3, 3, 3, 3)]}
    print("inputs | dtype | terms of W, h, u x, (x, B, C) | worst y / tol | worst h / tol")
    for dtype, options in splits.items():
        for label, kind, B, T, Q, with_h0 in cases:
            xh, Bc, Cc, dt, A = inputs(kind, dtype, B, T, 8, 64, 128, seed=T + Q)
            h0 = (torch.randn((B, 8, 64, 128), generator=torch.Generator().manual_seed(1))
                  if with_h0 else None)
            y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
            for nw, nh, nx, ni in options:
                y, h = emulate(xh, Bc, Cc, dt, A, Q, h0, nw, nh, nx, ni)
                print(f"{label} | {str(dtype)[6:]} | {nw}, {nh}, {nx}, ({ni}) | "
                      f"{worst(y, y_r):.3f} | {worst(h, h_r):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
