#!/usr/bin/env python3
"""The ssd_scan kernel's launch choices, timed on the card: each slice
width of the hd split (P CTAs a (head, lane)) at the mamba2-370m prefill
shapes of both schedulers, each checked against the plain version first.

    python3 scripts/torch_ssd_variants.py

Each variant is timed twice, in turns, by ``chip_smoke.time_ms`` (device
time, L2 flushed, enqueue hidden).  Prints the card's name and power limit,
one line a variant and a JSON line {"ssd_variants": [...]}.  Needs one card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (label, B, T, Q): the sync path's bucket-128 prefill and continuous
# admissions of 96, 64 and 128 tokens
SHAPES = [("sync prefill", 8, 127, 127), ("admission 96", 1, 95, 95),
          ("admission 64", 1, 63, 63), ("admission 128", 1, 127, 127)]
SPLITS = (2, 4, 8)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ssd_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    build.build_all()
    print(cs.card_line(), flush=True)
    mcfg = get_config(cs.M_NAME)
    H, hd, ds = (mcfg.ssm.expand * mcfg.d_model) // mcfg.ssm.head_dim, mcfg.ssm.head_dim, \
        mcfg.ssm.d_state
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    plan = ops.ssd_plan
    rows = []
    try:
        for label, B, T, Q in SHAPES:
            xh, Bc, Cc, dt, A = cs.ssd_inputs(gen, B, T, H, hd, ds)
            y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q)
            for p in SPLITS:
                ops.ssd_plan = lambda *a, p=p: p
                y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q)
                ok = cs.close("ssd_scan", y, y_r)[2] and cs.close("ssd_scan", h, h_r)[2]
                cs.check(ok, f"ssd_scan {label} P={p} disagrees")
            times = {p: [] for p in SPLITS}
            for order in (SPLITS, SPLITS[::-1]):
                for p in order:
                    ops.ssd_plan = lambda *a, p=p: p
                    times[p].append(cs.time_ms(lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, Q))[0])
            for p, ms in times.items():
                row = dict(shape=label, B=B, T=T, Q=Q, splits=p, ms=ms,
                           planned=p == plan(B, H, hd, ds, T, Q))
                rows.append(row)
                print(f"ssd_scan {label}: B={B} T={T} Q={Q} P={p} (slices of {hd // p}): "
                      f"{ms[0]:.4f} / {ms[1]:.4f} ms"
                      f"{'  <- ssd_plan' if row['planned'] else ''}", flush=True)
    finally:
        ops.ssd_plan = plan
    print(json.dumps({"ssd_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
