#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: greedy DVI serving of vicuna-7b on
one NVIDIA GPU through the port's four hand-written CUDA kernels, on the
batch-synchronous path and on the continuous-batching path over a paged KV
pool.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of the kernels from ``src/repro_torch/csrc`` (nvcc, in parallel);
3. each kernel against its plain PyTorch version on the card, at the paths'
   vicuna-7b shapes in bf16 (attention at both the verify pass's Tq = K+1
   and the draft feeds' Tq = 1), plus a ragged GQA attention case (Tq = 1
   and 5), an r = 1 LoRA case, an exact argmax tie case, and paged cases
   over a shuffled page assignment (a -1 entry mid-row, an all -1 lane, a
   lane past the table, GQA G = 4, ps = 4), with each kernel's time, its
   plain version's, a library call's where one computes the same function,
   and the least time the card could take;
4. the sync path: vicuna-7b at full width and depth in bf16, random weights
   drawn on the card from a seed, a sync ``ServingEngine`` answering 8
   requests (prompts of 64-128 tokens, 32 new tokens each), then the same
   requests once more under torch.profiler for the device's busy share;
5. the kernels' launch counts over phase 4 against the per-block formula;
6. greedy losslessness on the card: speculative streams against
   ``ar_generate`` streams;
8. the continuous path: a continuous ``ServingEngine`` over a paged pool
   (8 lanes, pages of 16 tokens, supersteps of 4 blocks) answering 16
   requests submitted at once (prompts of 64, 96 or 128 tokens, 16 or 32
   new tokens), once over an ample pool and once over a pool tight enough
   to preempt, then the ample traffic under torch.profiler.  It checks
   every completion against ``ar_generate`` on its exact prompt, an empty
   pool at the end, the per-block launch formula, and that no dispatch
   synchronises with the device (sync debug mode "error"); it reports the
   synchronising operations per tick;
7. a ``{"kernels": [...]}`` JSON line, then the ``{"ok": true, ...}`` line.

It imports torch, numpy and the port; nothing of JAX.  It needs one card and
exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12           # float32 outside the tensor cores

DEV = "cuda"
SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
# bf16 tolerances (ROADMAP parity rules): logits against a float32 plain
# version differ only by float32 summation order; attention outputs differ
# by the plain version's bf16 rounding of the probabilities
TOL = {"verify_argmax": (2e-3, 1e-3), "lora_logits": (2e-3, 1e-3),
       "decode_attention": (2e-2, 2e-2), "paged_decode_attention": (2e-2, 2e-2)}
GAP_RTOL = 2e-2                  # bf16 top-2 logit gap treated as a tie
# the continuous path (phase 8)
C_SLOTS, C_PAGE, C_SYNC, C_REQUESTS = 8, 16, 4, 16
C_PROMPTS, C_NEW = (64, 96, 128), (16, 32)
C_PAGES_AMPLE, C_PAGES_TIGHT = 152, 48


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, with the 50 MB L2 flushed before each
    call (the model path finds these operands cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, op_seconds: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds) * 1e3,
            "bytes" if t_bytes >= op_seconds else "operations")


def max_err(x: torch.Tensor, y: torch.Tensor) -> tuple:
    d = (x.float() - y.float()).abs()
    return float(d.max()), float((d / y.float().abs().clamp(min=1e-3)).max())


def close(name: str, x, y) -> tuple:
    atol, rtol = TOL[name]
    err, rel = max_err(x, y)
    ok = bool(((x.float() - y.float()).abs() <= atol + rtol * y.float().abs()).all())
    return err, rel, ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_verify(ops, ref, gen, T, d, V, label):
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    arg, mx = ops.verify_argmax(h, w)
    logits = h.float() @ w.float()
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    arg_ref, mx_ref = ref.verify_argmax(h, w)
    err, rel, ok = close("verify_argmax", mx, mx_ref)
    atol, rtol = TOL["verify_argmax"]
    near_tie = gap <= atol + rtol * top2[:, 0].abs()
    bad = (arg != arg_ref) & ~near_tie
    phase(3, f"verify_argmax {label}: T={T} d={d} V={V} bf16 max abs err {err:.3e} "
             f"rel {rel:.3e} (atol {atol} rtol {rtol}); index mismatches "
             f"{int((arg != arg_ref).sum())} of {T}, all at near-ties: {not bool(bad.any())}")
    check(ok and not bool(bad.any()), f"verify_argmax {label} disagrees with its plain version")
    # exact tie rule: w repeated across vocab tiles gives bit-equal logits, and
    # the lowest index must win — the same answer as on the first copy alone
    w_tie = w[:, :1000].repeat(1, 32).contiguous()
    arg_t, mx_t = ops.verify_argmax(h, w_tie)
    arg_1, mx_1 = ops.verify_argmax(h, w[:, :1000].contiguous())
    check(torch.equal(arg_t, arg_1) and torch.equal(mx_t, mx_1) and bool((arg_t < 1000).all()),
          "verify_argmax tie rule: the lowest index must win")
    phase(3, f"verify_argmax tie rule: w repeated 32x across the vocab -> lowest index, exact: True")
    return h, w, err


def check_lora(ops, ref, gen, T, d, V, r, label):
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    a = torch.randn((d, r), generator=gen, device=DEV) / d ** 0.5
    b = torch.randn((r, V), generator=gen, device=DEV) * 0.05
    gamma = 2.0
    out = ops.lora_logits(h, w, a, b, gamma)
    err, rel, ok = close("lora_logits", out, ref.lora_logits(h, w, a, b, gamma))
    atol, rtol = TOL["lora_logits"]
    phase(3, f"lora_logits {label}: T={T} d={d} V={V} r={r} max abs err {err:.3e} "
             f"rel {rel:.3e} (atol {atol} rtol {rtol}) ok={ok}")
    check(ok, f"lora_logits {label} disagrees with its plain version")
    return (h, w, a, b, gamma), err


def check_attention(ops, ref, gen, B, Tq, H, KV, hd, S, lengths, label):
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.decode_attention(q_in, k, v, lens)
    err, rel, ok = close("decode_attention", out, ref.decode_attention(q_in, k, v, lens))
    atol, rtol = TOL["decode_attention"]
    phase(3, f"decode_attention {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} S={S} "
             f"lengths {min(lengths)}..{max(lengths)} max abs err {err:.3e} "
             f"(atol {atol} rtol {rtol}) ok={ok}")
    check(ok, f"decode_attention {label} disagrees with its plain version")
    return (q_in, k, v, lens), err


def sdpa_inputs(q, k, v, lens):
    """The same attention for torch's scaled_dot_product_attention: heads
    first, K/V heads repeated for GQA, the length mask as a boolean mask."""
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    t = torch.arange(Tq, device=DEV)
    lim = lens.long()[:, None] - (Tq - 1 - t)[None, :]
    mask = torch.arange(S, device=DEV)[None, None, :] < lim[:, :, None]
    rep = H // KV
    return (q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
            v.repeat_interleave(rep, 2).transpose(1, 2), mask[:, None])


def paged_tables(rng, lengths, ps, mps, holes=(), unmapped=()):
    """Block tables over a shuffled, non-contiguous page assignment: each
    lane maps the pages covering its length plus one (at most mps), from a
    pool with a few spare pages; `holes` (lane, page) entries and whole
    `unmapped` lanes are -1.  Returns (tbl int32 numpy, physical pages)."""
    mapped = [min(-(-int(n) // ps) + 1, mps) for n in lengths]
    P = sum(mapped) + 1 + 8
    perm = rng.permutation(np.arange(1, P))
    tbl = np.full((len(lengths), mps), -1, np.int32)
    i = 0
    for b, m in enumerate(mapped):
        tbl[b, :m] = perm[i:i + m]
        i += m
    for b, pg in holes:
        tbl[b, pg] = -1
    for b in unmapped:
        tbl[b] = -1
    return tbl, P


def paged_live_slots(tbl, lengths, ps, Tq):
    """Per lane and query, the mapped slots the query sees (the data the
    kernel must read and the dot products it must take)."""
    mps = tbl.shape[1]
    out = []
    for b, n in enumerate(lengths):
        page = tbl[b, np.arange(mps * ps) // ps]
        out.append([int(((page >= 0) & (np.arange(mps * ps) < min(int(n) - (Tq - 1 - t),
                                                                   mps * ps))).sum())
                    for t in range(Tq)])
    return out


def check_paged(ops, ref, gen, rng, B, Tq, H, KV, hd, ps, mps, lengths, label,
                holes=(), unmapped=()):
    tbl, P = paged_tables(rng, lengths, ps, mps, holes, unmapped)
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    kp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    vp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    tbl_t = torch.as_tensor(tbl, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t)
    plain = ref.paged_decode_attention(q_in, kp, vp, lens, tbl_t)
    live = [b for b in range(B) if b not in unmapped and int(lengths[b]) > 0]
    err, rel, ok = close("paged_decode_attention", out[live], plain[live])
    idle_ok = all(bool((out[b] == 0).all()) and bool(torch.isfinite(plain[b]).all())
                  for b in range(B) if b not in live)
    atol, rtol = TOL["paged_decode_attention"]
    phase(3, f"paged_decode_attention {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} ps={ps} "
             f"MPS={mps} P={P} lengths {list(map(int, lengths))} max abs err {err:.3e} on "
             f"{len(live)} live lanes (atol {atol} rtol {rtol}) ok={ok}; lanes with no "
             f"mapped slot give 0 (plain: finite): {idle_ok}")
    check(ok and idle_ok, f"paged_decode_attention {label} disagrees with its plain version")
    return (q_in, kp, vp, lens, tbl_t, tbl), err


def kernels_phase(cfg):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, V, H, KV, hd = (cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim)
    K, B = cfg.dvi.k_spec, N_REQUESTS
    T_verify = B * (K + 1)
    cap = 128 + MAX_NEW + K + 2 + 128       # the engine's cache capacity
    rng = np.random.RandomState(SEED)
    main_lens = list(rng.randint(64 + K + 1, 128 + MAX_NEW + K + 1, size=B))
    e = 2                                    # bf16 bytes

    h, w, err_v = check_verify(ops, ref, gen, T_verify, d, V, "main")
    check_verify(ops, ref, gen, 67, 320, 1000, "ragged (T>48, odd tiles)")
    lora_args, err_l = check_lora(ops, ref, gen, B, d, V, cfg.dvi.lora_rank, "main")
    check_lora(ops, ref, gen, B, d, V, 1, "r=1 (ar_generate)")
    att_args, err_a = check_attention(ops, ref, gen, B, K + 1, H, KV, hd, cap,
                                      main_lens, "main (verify pass)")
    # a draft feed: one query per lane; its post-write length is the
    # committed length + 1, K below the verify pass's
    check_attention(ops, ref, gen, B, 1, H, KV, hd, cap, [n - K for n in main_lens],
                    "draft feed")
    ragged = list(rng.randint(5, 301, size=3))
    check_attention(ops, ref, gen, 3, 1, 32, 8, 128, 300, ragged, "GQA G=4 Tq=1")
    check_attention(ops, ref, gen, 3, 5, 32, 8, 128, 300, ragged, "GQA G=4 Tq=5")
    # the continuous path's pool: pages of C_PAGE tokens, a table row covers
    # the engine's capacity; post-write lengths of its verify pass
    mps = -(-cap // C_PAGE)
    paged_lens = list(rng.randint(min(C_PROMPTS) + K + 1, max(C_PROMPTS) + MAX_NEW + K + 1,
                                  size=B))
    paged_args, err_p = check_paged(ops, ref, gen, rng, B, K + 1, H, KV, hd, C_PAGE, mps,
                                    paged_lens, "main (verify pass)")
    check_paged(ops, ref, gen, rng, B, 1, H, KV, hd, C_PAGE, mps,
                [n - K for n in paged_lens], "draft feed")
    check_paged(ops, ref, gen, rng, 4, K + 1, 32, 8, 128, C_PAGE, mps,
                [mps * C_PAGE + 3, 100, 60, 0],
                "GQA G=4, lane past the table, -1 mid-row, all -1 lanes",
                holes=((1, 2),), unmapped=(2, 3))
    check_paged(ops, ref, gen, rng, 3, 1, H, KV, hd, 4, -(-cap // 4),
                list(rng.randint(5, cap + 1, size=3)), "ps=4, -1 mid-row", holes=((0, 1),))

    rows = []
    # verify_argmax
    T = T_verify
    b_ms, b_by = bound(T * d * e + d * V * e + T * 8, 2 * T * d * V / BF16_FLOP_PER_S)
    rows.append(dict(name="verify_argmax", route="cuda",
                     source="src/repro_torch/csrc/verify_argmax.cu",
                     replaces="src/repro/kernels/verify_argmax.py:62",
                     max_abs_err=err_v, ms=time_ms(lambda: ops.verify_argmax(h, w)),
                     plain_ms=time_ms(lambda: ref.verify_argmax(h, w)),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # lora_logits
    hl, wl, a, b, gamma = lora_args
    r = a.shape[1]
    b_ms, b_by = bound(B * d * e + d * V * e + d * r * 4 + r * V * 4 + B * V * 4,
                       2 * B * d * V / BF16_FLOP_PER_S
                       + (2 * B * d * r + 2 * B * r * V) / F32_FLOP_PER_S)
    rows.append(dict(name="lora_logits", route="cuda",
                     source="src/repro_torch/csrc/lora_logits.cu",
                     replaces="src/repro/kernels/lora_logits.py:53",
                     max_abs_err=err_l,
                     ms=time_ms(lambda: ops.lora_logits(hl, wl, a, b, gamma)),
                     plain_ms=time_ms(lambda: ref.lora_logits(hl, wl, a, b, gamma)),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # decode_attention: live slots of this run's lengths
    q, k, v, lens = att_args
    Tq = q.shape[1]
    live = np.minimum(np.asarray(main_lens), cap)
    row_live = sum(max(0, min(int(n) - (Tq - 1 - t), cap)) for n in main_lens
                   for t in range(Tq)) * H
    b_ms, b_by = bound(q.numel() * e * 2 + int(live.sum()) * KV * hd * e * 2 + B * 4,
                       4 * hd * row_live / BF16_FLOP_PER_S)
    sq, sk, sv, smask = sdpa_inputs(q, k, v, lens)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention.py:83",
                     max_abs_err=err_a,
                     ms=time_ms(lambda: ops.decode_attention(q, k, v, lens)),
                     plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, lens)),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: sdpa(sq, sk, sv, attn_mask=smask))))
    # paged_decode_attention: the live mapped slots of this run's tables
    q, kp, vp, lens, tbl_t, tbl = paged_args
    Tq, P = q.shape[1], kp.shape[0]
    seen = paged_live_slots(tbl, paged_lens, C_PAGE, Tq)
    kv_bytes = sum(max(row) for row in seen) * KV * hd * e * 2
    n_pages = sum(min(-(-int(n) // C_PAGE), mps) for n in paged_lens)
    b_ms, b_by = bound(q.numel() * e * 2 + kv_bytes + B * 4 + n_pages * 4,
                       4 * hd * H * sum(sum(row) for row in seen) / BF16_FLOP_PER_S)
    L = mps * C_PAGE
    jj = torch.arange(L, device=DEV)
    phys = (tbl_t.long().clamp(min=0)[:, jj // C_PAGE] * C_PAGE + jj % C_PAGE)
    kf = kp.reshape(P * C_PAGE, KV, hd)[phys]
    vf = vp.reshape(P * C_PAGE, KV, hd)[phys]
    sq, sk, sv, smask = sdpa_inputs(q, kf, vf, lens)
    smask = smask & (tbl_t[:, jj // C_PAGE] >= 0)[:, None, None, :]
    rows.append(dict(name="paged_decode_attention", route="cuda",
                     source="src/repro_torch/csrc/paged_decode_attention.cu",
                     replaces="src/repro/kernels/paged_decode_attention.py:127",
                     max_abs_err=err_p,
                     ms=time_ms(lambda: ops.paged_decode_attention(q, kp, vp, lens, tbl_t)),
                     plain_ms=time_ms(lambda: ref.paged_decode_attention(q, kp, vp, lens,
                                                                         tbl_t)),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: sdpa(sq, sk, sv, attn_mask=smask)),
                     library_note="SDPA over the pre-gathered contiguous view; gather not timed"))
    for row in rows:
        phase(3, f"{row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"library {row['library_ms']} ms, bound {row['bound_ms']:.4f} ms "
                 f"({row['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def make_requests(cfg):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(SEED + 1)
    return [Request(uid=i, prompt=rng.randint(2, cfg.vocab_size,
                                              size=int(rng.randint(64, 129))).astype(np.int32),
                    max_new=MAX_NEW) for i in range(N_REQUESTS)]


def profile_batch(eng, reqs, wall_ms: float, n: int = 4) -> float:
    """The same requests once more under torch.profiler (device activity
    only): device time by kernel and in all.  The run repeats the timed
    run's work, so the device's busy share is its device time over the
    timed run's (unprofiled) wall time `wall_ms`.  Returns the share."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    steps0 = eng.stats["steps"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, k + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0.0:
        phase(n, "profile: the profiler saw no device time")
        return float("nan")
    ours = sum(ms for name, (ms, _) in by_name.items()
               if any(k in name for k in ("verify_", "lora_", "decode_attn")))
    gemm = sum(ms for name, (ms, _) in by_name.items()
               if any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")))
    steps = eng.stats["steps"] - steps0
    launches = sum(k for _, k in by_name.values())
    phase(n, f"profile of the same requests again ({steps} block-steps): device busy "
             f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}% of the timed run's wall "
             f"{wall_ms:.1f} ms; port kernels {ours:.1f} ms, GEMMs {gemm:.1f} ms, other "
             f"{busy - ours - gemm:.1f} ms; {launches} device launches "
             f"({launches / max(steps, 1):.0f} per block-step)")
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        phase(n, f"  {ms:9.3f} ms {k:6d}x  {name[:90]}")
    return busy / wall_ms


def top2_gap(model, params, prefix: torch.Tensor) -> tuple:
    """The AR verifier's top-2 logits for the token after `prefix` (1, p)."""
    h, _ = model.prefill(params, prefix)
    top = model.logits(params, h[:, -1]).float().topk(2, dim=-1).values[0]
    return float(top[0]), float(top[1])


# ---------------------------------------------------------------------------
# phase 8: the continuous path over a paged pool
# ---------------------------------------------------------------------------

def continuous_requests(cfg):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(SEED + 2)
    return [Request(uid=i, prompt=rng.randint(2, cfg.vocab_size,
                                              size=int(rng.choice(C_PROMPTS))).astype(np.int32),
                    max_new=int(rng.choice(C_NEW))) for i in range(C_REQUESTS)]


def serve_checked(eng, reqs):
    """Serve `reqs` submitted at once.  Every dispatch runs under sync debug
    mode "error" (a synchronising operation inside it raises); the rest of
    each tick runs under "warn", and its synchronising operations are
    counted per tick.  Returns (completions, wall s, blocks the supersteps
    ran, syncs per tick)."""
    import warnings
    inner = eng._dispatch_superstep
    iters = []

    def dispatch():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner()
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        iters.append(eng._inflight[0].iters)

    eng._dispatch_superstep = dispatch
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    comps, per_tick = [], []
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("warn")
        while eng.busy:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                comps.extend(eng.step())
            per_tick.append(sum("synchroniz" in str(w.message) for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        eng._dispatch_superstep = inner
    torch.cuda.synchronize()
    return comps, time.perf_counter() - t0, sum(iters), per_tick


def check_against_ar(model, params, spec, reqs, comps, label):
    """Each completion against ar_generate on its exact prompt (one AR run
    per prompt length), EOS 1 and its budget applied; a first difference
    passes only at a bf16 near-tie of the AR top-2 logits."""
    by_uid = {c.uid: c for c in comps}
    check(sorted(by_uid) == sorted(r.uid for r in reqs), f"{label}: missing completions")
    equal, tied = 0, 0
    for n in sorted({len(r.prompt) for r in reqs}):
        group = [r for r in reqs if len(r.prompt) == n]
        prompts = torch.as_tensor(np.stack([r.prompt for r in group]), device=DEV)
        ar = spec.ar_generate(model, params, prompts, max(r.max_new for r in group))
        for i, r in enumerate(group):
            stream = ar.tokens[i, n:int(ar.lengths[i])].tolist()[:r.max_new]
            if 1 in stream:
                stream = stream[:stream.index(1) + 1]
            got = by_uid[r.uid].gen_tokens.tolist()
            if got == stream:
                equal += 1
                continue
            p = next((j for j, (a, b) in enumerate(zip(got, stream)) if a != b),
                     min(len(got), len(stream)))
            check(p < min(len(got), len(stream)),
                  f"{label}: request {r.uid} stops at {len(got)}, AR at {len(stream)}")
            prefix = torch.as_tensor(np.concatenate([r.prompt, stream[:p]]).astype(np.int64),
                                     device=DEV)[None]
            t1, t2 = top2_gap(model, params, prefix)
            phase(8, f"{label}: request {r.uid} first differs from AR at generated token "
                     f"{p}, AR top-2 logits {t1:.4f} / {t2:.4f}, gap {t1 - t2:.4e}")
            check(t1 - t2 <= GAP_RTOL * max(abs(t1), 1.0),
                  f"{label}: request {r.uid} differs from AR outside a bf16 near-tie")
            tied += 1
    phase(8, f"{label}: {equal} of {len(reqs)} completions equal their AR stream; {tied} "
             f"differ only at a bf16 near-tie (rtol {GAP_RTOL})")


def continuous_phase(cfg, model, params, dvi):
    from repro_torch.core import spec
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)

    def engine(pages):
        return ServingEngine(model, params, dvi, scheduler="continuous", num_slots=C_SLOTS,
                             max_new=MAX_NEW, kv_pages=pages, kv_page_size=C_PAGE,
                             sync_every=C_SYNC)

    eng = engine(C_PAGES_AMPLE)
    eng.submit_request(reqs[0])                  # warm-up, not counted
    eng.run()
    eng.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    comps, wall, blocks_run, per_tick = serve_checked(eng, reqs)
    launches = dict(ops.launches)
    st, kv = eng.stats, eng.kv_stats()
    mat = st["committed"] / max(st["blocks"], 1)
    phase(8, f"ample pool ({C_PAGES_AMPLE} pages of {C_PAGE}, MPS {eng._mps}): "
             f"{len(comps)} requests in {wall:.3f} s, {st['committed'] / wall:.1f} committed "
             f"tokens/s, MAT {mat:.4f}, {st['dispatches']} dispatches, {st['host_syncs']} host "
             f"syncs, {blocks_run} blocks run ({st['steps']} with a live lane), peak "
             f"{kv['peak_used_pages']} pages, {kv['preemptions']} preemptions, used pages at "
             f"the end {kv['used_pages']}, peak memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase(8, f"synchronising operations per tick: {per_tick} (0 inside every dispatch: "
             f"sync debug mode 'error')")
    check(kv["used_pages"] == 0, "pages left in use after the ample run")
    check(st["host_syncs"] == st["dispatches"], "host syncs != dispatches")
    want = {"paged_decode_attention": ((K + 1) * k + (L - k)) * blocks_run,
            "lora_logits": (K + 1) * blocks_run, "verify_argmax": blocks_run,
            "decode_attention": 0}
    phase(8, f"launches over {blocks_run} blocks: {launches}; expected {want}")
    check(launches == want, "the continuous path did not run the kernels as the formula says")
    check_against_ar(model, params, spec, reqs, comps, "ample pool")
    busy = profile_batch(eng, reqs, wall * 1e3, n=8)
    del eng

    pages = C_PAGES_TIGHT
    while True:
        eng = engine(pages)
        comps_t, wall_t, _, per_tick_t = serve_checked(eng, reqs)
        kv_t = eng.kv_stats()
        phase(8, f"tight pool of {pages} pages: {len(comps_t)} requests in {wall_t:.3f} s, "
                 f"{kv_t['preemptions']} preemptions, peak {kv_t['peak_used_pages']} pages, "
                 f"used pages at the end {kv_t['used_pages']}, syncs per tick max "
                 f"{max(per_tick_t)}")
        check(kv_t["used_pages"] == 0, "pages left in use after the tight run")
        if kv_t["preemptions"] >= 1 or pages <= eng._mps:
            break
        # halve while that stays at 24 or more, then one page at a time: the
        # pre-admission reserve makes preemption need a pool that holds two
        # lanes only just (about 20-24 pages of 16 here at MAT 1)
        pages = pages // 2 if pages // 2 >= 24 else pages - 1
        del eng
    check(kv_t["preemptions"] >= 1, "the tight pool never preempted")
    phase(8, f"tight pool used: kv_pages={pages}")
    check_against_ar(model, params, spec, reqs, comps_t, f"tight pool ({pages} pages)")
    return launches, busy


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    card = card_line()
    phase(1, f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    info = build.build_all()
    phase(2, f"kernels built in {time.perf_counter() - t0:.1f} s: "
             + ", ".join(f"{n} ({i['seconds']:.1f} s)" for n, i in info.items()))
    for name, i in info.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", i["log"])]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", i["log"]))
        phase(2, f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
                 f"registers a thread, {spills} bytes of spill stores")

    cfg = get_config("vicuna-7b")
    rows = kernels_phase(cfg)

    # ---- phase 4: the main path ----
    model = build_model(cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
    torch.cuda.synchronize()
    phase(4, f"vicuna-7b bf16 params drawn on the card in {time.perf_counter() - t0:.1f} s "
             f"({sum(p.numel() for s in params['segments'].values() for p in s.values()) / 1e9:.2f}"
             f"B in segments)")
    reqs = make_requests(cfg)
    eng = ServingEngine(model, params, dvi, batch_size=N_REQUESTS, max_new=MAX_NEW)
    eng.submit_request(reqs[0])                  # warm-up batch, not counted
    eng.run()
    eng.reset_stats()
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    comps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = eng.stats
    n = st["steps"]                    # spec_block_step calls of this run
    check(len(comps) == N_REQUESTS, f"{len(comps)} completions for {N_REQUESTS} requests")
    for c in comps:
        check(1 <= len(c.gen_tokens) <= MAX_NEW and bool((c.gen_tokens >= 0).all())
              and bool((c.gen_tokens < cfg.vocab_size).all()),
              f"request {c.uid}: bad generation {c.gen_tokens}")
    mat = st["committed"] / max(st["blocks"], 1)
    phase(4, f"served {len(comps)} requests in {n} block-steps, wall {wall:.3f} s: "
             f"MAT {mat:.4f}, acceptance {eng.acceptance:.4f}, "
             f"{st['committed'] / wall:.1f} committed tokens/s, "
             f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    profile_batch(eng, reqs, wall * 1e3)

    # ---- phase 5: launch counts ----
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    want = {"decode_attention": ((K + 1) * k + (L - k)) * n, "lora_logits": (K + 1) * n,
            "verify_argmax": n}
    phase(5, f"launches over {n} block-steps: {launches}; expected {want}")
    want["paged_decode_attention"] = 0
    check(launches == want, "the sync path did not run the kernels as the formula says")

    # ---- phase 6: greedy losslessness on the card ----
    prompts = torch.as_tensor(np.stack([eng._pad(r, 128) for r in reqs]), device=DEV)
    r_sd = spec.speculative_generate(model, params, dvi, prompts, MAX_NEW)
    r_ar = spec.ar_generate(model, params, prompts, MAX_NEW)
    Tp = prompts.shape[1]
    equal, tied = 0, 0
    for b in range(N_REQUESTS):
        nb = min(int(r_sd.lengths[b]), int(r_ar.lengths[b]), Tp + MAX_NEW)
        diff = (r_sd.tokens[b, :nb] != r_ar.tokens[b, :nb]).nonzero()
        if len(diff) == 0:
            equal += 1
            continue
        p = int(diff[0])
        t1, t2 = top2_gap(model, params, r_ar.tokens[b:b + 1, :p])
        phase(6, f"lane {b}: first difference at position {p}, AR top-2 logits "
                 f"{t1:.4f} / {t2:.4f}, gap {t1 - t2:.4e}")
        check(t1 - t2 <= GAP_RTOL * max(abs(t1), 1.0),
              f"lane {b}: speculative stream differs from AR outside a bf16 near-tie")
        tied += 1
    phase(6, f"speculative == AR greedy up to Tp+max_new on {equal} of {N_REQUESTS} lanes; "
             f"{tied} differ only at a bf16 near-tie (rtol {GAP_RTOL})")

    # ---- phase 8: the continuous path over a paged pool ----
    del eng, r_sd, r_ar
    torch.cuda.empty_cache()
    c_launches, _ = continuous_phase(cfg, model, params, dvi)

    # ---- phase 7: result lines ----
    for row in rows:
        by_path = {"sync": launches.get(row["name"], 0),
                   "continuous": c_launches.get(row["name"], 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
