#!/usr/bin/env python3
"""How far two valid greedy decodings of mamba2-370m drift apart on the card.

    python3 scripts/torch_mamba_bf16_drift.py

mamba2-370m at full width and depth (48 layers), random weights from seed 0,
the 8 bucket-padded prompts of ``chip_smoke.py``'s sync path (128 tokens), 32
new tokens.  In bf16 and in float32 it decodes the prompts four ways and
prints, per lane, where two streams first differ and the relative top-2 gap
of the AR logits there (``pos:gap``; ``eq`` where they agree):

* speculative (K = 4) against AR, both at B = 8, with the port's SSM block
  (one token at a time, ``models.ssm.ssm_step``);
* the same with the block's projections over all T tokens at once, as the
  reference computes them (``ssm_step_block_proj`` below, for comparison
  only);
* AR at B = 1 against AR at B = 8, for the first four prompts.

A bf16 matrix product rounds differently at different row counts, and the
recurrent state carries such differences forward; the runs show how far.
It imports torch, numpy and the port only, and needs one card.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lora, spec  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

DEV = "cuda"
MAX_NEW = 32


def ssm_step_block_proj(p, x, cache, s, norm_eps):
    """``ssm_step`` with the norms and projections taken over the T tokens
    of the block at once (the reference's order of work); the recurrence is
    the same per-token loop."""
    B_, T, d = x.shape
    d_in, H, _, _ = ssm_mod.ssm_dims(d, s)
    G, ds, hd = s.ngroups, s.d_state, s.head_dim
    rep = H // G
    z, xBC, dt = ssm_mod._split_proj(rms_norm(x, p["ln1"], norm_eps) @ p["in_proj"],
                                     d_in, G, ds, H)
    A = -torch.exp(p["A_log"])
    conv_st, h = cache["conv"], cache["state"]
    ys, convs, hs = [], [], []
    for t in range(T):
        win = torch.cat([conv_st, xBC[:, t, None].to(conv_st.dtype)], dim=1)
        y = F.silu((win.float() * p["conv_w"][None]).sum(dim=1)).to(x.dtype)
        xf = y[:, :d_in].float().reshape(B_, G, rep, hd)
        Bc = y[:, d_in:d_in + G * ds].float().reshape(B_, G, 1, 1, ds)
        Cc = y[:, d_in + G * ds:].float().reshape(B_, G, 1, ds, 1)
        dtp = F.softplus(dt[:, t].float() + p["dt_bias"]).reshape(B_, G, rep)
        da = torch.exp(dtp * A.reshape(1, G, rep))
        hg = (h.reshape(B_, G, rep, hd, ds) * da[..., None, None]
              + (dtp[..., None] * xf)[..., None] * Bc)
        ys.append((hg @ Cc)[..., 0] + xf * p["D"].reshape(1, G, rep, 1))
        conv_st = win[:, 1:]
        h = hg.reshape(B_, H, hd, ds)
        convs.append(conv_st)
        hs.append(h)
    ys = torch.stack(ys, dim=1).reshape(B_, T, d_in)
    y = rms_norm((ys * F.silu(z.float())).to(x.dtype), p["norm_w"], norm_eps)
    return x + y @ p["out_proj"], {"conv": torch.stack(convs, 1), "state": torch.stack(hs, 1)}


def prompts() -> torch.Tensor:
    """chip_smoke.make_requests' prompts, left-padded to bucket 128 as the
    sync engine pads them."""
    rng = np.random.RandomState(1)
    out = []
    for _ in range(8):
        p = rng.randint(2, 50280, size=int(rng.randint(64, 129))).astype(np.int32)
        out.append(np.concatenate([np.full(128 - len(p), p[0], np.int32), p]))
    return torch.as_tensor(np.stack(out), device=DEV)


def first_differences(model, params, a, b, lanes, tp) -> list:
    res = []
    for i, j in lanes:
        n = min(int(a.lengths[i]), int(b.lengths[j]), tp + MAX_NEW)
        diff = (a.tokens[i, :n] != b.tokens[j, :n]).nonzero()
        if len(diff) == 0:
            res.append("eq")
            continue
        p = int(diff[0])
        h, _ = model.prefill(params, b.tokens[j:j + 1, :p])
        top = model.logits(params, h[:, -1]).float().topk(2, dim=-1).values[0]
        res.append(f"{p - tp}:{float(top[0] - top[1]) / max(abs(float(top[0])), 1.0):.3f}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    P = prompts()
    tp = P.shape[1]
    token_step = ssm_mod.ssm_step
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        cfg = get_config("mamba2-370m").replace(dtype=dtype)
        model = build_model(cfg, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = model.init(gen)
        dvi = lora.init_draft_params(gen, cfg)
        dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
        same = [(i, i) for i in range(8)]
        for label, step in (("token by token", token_step),
                            ("projections over the block", ssm_step_block_proj)):
            ssm_mod.ssm_step = step
            ar = spec.ar_generate(model, params, P, MAX_NEW)
            sd = spec.speculative_generate(model, params, dvi, P, MAX_NEW)
            print(f"{dtype}, SSM block {label}: speculative vs AR at B=8: "
                  f"{first_differences(model, params, sd, ar, same, tp)}", flush=True)
        ssm_mod.ssm_step = token_step
        ar8 = spec.ar_generate(model, params, P, MAX_NEW)
        ones = [spec.ar_generate(model, params, P[i:i + 1], MAX_NEW) for i in range(4)]
        res = [first_differences(model, params, ones[i], ar8, [(0, i)], tp)[0] for i in range(4)]
        print(f"{dtype}: AR at B=1 vs AR at B=8, lanes 0-3: {res} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
