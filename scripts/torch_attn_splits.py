#!/usr/bin/env python3
"""Time the port's two attention kernels at every cluster size C on the
card, to set the capacity thresholds of ``ops.attn_splits``.

    python3 scripts/torch_attn_splits.py

At vicuna-7b's attention widths (H = KV = 32, hd 128, bf16) for the paths'
8 lanes and for 2 lanes, for lane capacities from 64 to 1216 slots with
lengths drawn between half the capacity and all of it, at the verify pass
(Tq 5) and a draft feed (Tq 1):
each kernel's device time (``chip_smoke.time_ms``: L2 flushed, host enqueue
hidden behind a spin) with C forced to 1, 2, 4 and 8, checked against its
plain version at each C, beside the C the wrapper picks.  Prints one line
per case and a JSON line with all of them.  Needs one card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CAPS = (64, 128, 294, 608, 1216)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_attn_splits: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    build.build_all()
    print(cs.card_line(), flush=True)
    choose = ops.attn_splits
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    rng = np.random.RandomState(cs.SEED)
    H, KV, hd, ps = 32, 32, 128, cs.C_PAGE
    results = []
    try:
        for B, cap in [(B, cap) for B in (8, 2) for cap in CAPS]:
            mps = -(-cap // ps)
            lens = list(rng.randint(cap // 2, cap + 1, size=B))
            for Tq in (5, 1):
                att, _ = cs.check_attention(ops, ref, gen, B, Tq, H, KV, hd, cap, lens,
                                            f"cap {cap}")
                pag, _ = cs.check_paged(ops, ref, gen, rng, B, Tq, H, KV, hd, ps, mps, lens,
                                        f"cap {mps * ps}")
                for splits in ops.ATTN_SPLITS:
                    ops.attn_splits = lambda _cap, _pairs, c=splits: c
                    q, k, v, ln = att
                    qp, kp, vp, lnp, tbl_t, _ = pag
                    check = (cs.close("decode_attention", ops.decode_attention(q, k, v, ln),
                                      ref.decode_attention(q, k, v, ln))[2]
                             and cs.close("paged_decode_attention",
                                          ops.paged_decode_attention(qp, kp, vp, lnp, tbl_t),
                                          ref.paged_decode_attention(qp, kp, vp, lnp,
                                                                     tbl_t))[2])
                    cs.check(check, f"C={splits} disagrees with the plain version")
                    ms, _ = cs.time_ms(lambda: ops.decode_attention(q, k, v, ln))
                    pms, _ = cs.time_ms(lambda: ops.paged_decode_attention(qp, kp, vp, lnp,
                                                                           tbl_t))
                    ops.attn_splits = choose
                    pick = choose(cap, B * KV)
                    results.append(dict(B=B, cap=cap, Tq=Tq, splits=splits, chosen=pick, ms=ms,
                                        paged_ms=pms, lens=[int(n) for n in lens]))
                    print(f"B {B} cap {cap:5d} Tq {Tq} C {splits}: contiguous {ms:.4f} ms, paged "
                          f"{pms:.4f} ms (wrapper picks C {pick})", flush=True)
    finally:
        ops.attn_splits = choose
    print(json.dumps({"splits": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
