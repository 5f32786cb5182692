#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: greedy DVI serving on one NVIDIA
GPU through the port's five hand-written CUDA kernels: vicuna-7b on the
batch-synchronous path and on the continuous-batching path over a paged KV
pool, and mamba2-370m (attention-free, its prefill on the ``ssd_scan``
kernel) through both schedulers; then the training path (mamba2-370m
pretraining, vicuna-7b's teacher-forced DVI step, the quickstart),
vicuna-7b's speculative sampling and per-lane adaptive depth, and chunked
prefill on both models' continuous paths.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of the kernels from ``src/repro_torch/csrc`` (nvcc, in parallel);
3. each kernel against its plain PyTorch version on the card, at the paths'
   vicuna-7b shapes in bf16 (attention at both the verify pass's Tq = K+1
   and the draft feeds' Tq = 1), plus a ragged GQA attention case (Tq = 1
   and 5), an r = 1 LoRA case, an exact argmax tie case, and paged cases
   over a shuffled page assignment (a -1 entry mid-row, an all -1 lane, a
   lane past the table, GQA G = 4, ps = 4); the attention kernels' split
   of a lane over C CTAs at its edges, at the main shapes and both Tq (a
   lane of length 1, one shorter than a CTA's share, lanes at the capacity
   and one past it, an idle lane, -1 entries on both sides of a share
   border), every query that sees no slot exactly 0; paged cases with
   ``page_counts`` (below ceil(len/ps), 0 and past MPS, both clipped; None
   bit-identical to the call without it); ``ssd_scan`` at the mamba2
   paths' prefill shapes (B 8, T = Q = 127 from strided views of a conv
   output; B = 1 admissions, T = Q = 95 and 63; a padded T = 256, Q = 128
   with dt = 0 on the last 56 rows; a carried h0), checking y and the final
   state, with ``ops.ssd_plan``'s split P beside each; ``verify_argmax``
   and ``lora_logits`` at mamba2-370m's d = 1024 and tied V = 50280, tie
   rule included, and at their edge cases (V about the 128-column strip
   and with rows off 16 bytes, T in one, two and several row passes, r = 1
   and 512, ties at every offset of a strip and a fragment), each gated
   to the loader ``ops.vocab_fast`` must pick (the paths' shapes the fast
   one).  Then each kernel's device time
   (``time_ms``: L2 flushed, the host's enqueue hidden behind a spin kernel
   and checked on every call) and per-call time, its plain version's, a
   library call's where one computes the same function, and the least
   time the card could take, at the main shapes and at the draft feed
   (attention), mamba2's d and V (vocab kernels) and the B = 1 admission
   (``ssd_scan``, its bound on the tensor cores at the kernel's split
   count, the earlier all-float32 CUDA-core figure beside it as
   ``f32_core_bound_ms``); beside each vocab kernel cuBLAS's bf16 h @ w alone
   (``gemm_ms``, a yardstick without the argmax or the LoRA term); and
   ``lora_logits`` at the online update's shape (T = 256 rows, 4 passes of
   64, bf16, r 64): its forward through the differentiable wrapper against
   the plain version, its dA and dB against autograd through the plain
   version, and its device time beside ``gemm_ms`` at T = 256; for the
   training path (phase 11), ``ssd_scan`` at mamba2 pretraining's shape (B
   8, T 256, Q 128, bf16) with inputs that require gradients (``ops.SsdScan``:
   one kernel launch forward) and its gradients against autograd through
   the plain version (``TOL["ssd_scan backward"]``), the backward timed
   alone, and ``lora_logits`` at the DVI step's 8184 rows (forward, dA and
   dB, its time beside ``gemm_ms`` and its bound); for adaptive depth
   (phase 12), both attention kernels at the verify pass's Tq = K_blk + 1
   = 2, 3 and 4 with the split's edge cases, timed at Tq 2 and 3; for
   chunked prefill (phase 13), both attention kernels at a chunk step's Tq
   32 and 128 (vicuna's G = 1; 1 and 2 row tiles of 64 query rows) and Tq
   64 at G = 2 (qwen3-0.6b's 16 heads over 8 kv heads; 2 row tiles), each
   checked and timed with its bound and SDPA's time;
4. the sync path: vicuna-7b at full width and depth in bf16, random weights
   drawn on the card from a seed, a sync ``ServingEngine`` (drafter frozen,
   ``learn=False``, as in phases 8 and 9) answering 8
   requests (prompts of 64-128 tokens, 32 new tokens each), then the same
   requests once more under torch.profiler for the device's busy share
   and the attention and vocab kernels' device time a launch and per
   block-step, beside phase 3's; every vocab launch on the fast loader;
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
   synchronising operations per tick; the profile gives the paged
   and vocab kernels' device time a launch beside phase 3's;
9. mamba2-370m at full width and depth (48 layers) in bf16, random weights
   drawn on the card from a seed: a sync ``ServingEngine`` answering 8
   requests (prompts of 64-128 tokens, left-padded to their bucket, 32 new
   tokens each), then a continuous one over the contiguous layout (8
   lanes, supersteps of 4 blocks) answering 16 requests, each profiled
   once more for the device's busy share and the vocab kernels' and
   ``ssd_scan``'s device time a launch (and per prefill call) beside
   phase 3's.  It checks every completion
   against ``ar_generate`` on the prompt the engine decoded (bucket-padded,
   in one batch, on the sync path; exact and alone on the continuous one);
   on the continuous path a first difference outside a near-tie passes
   only if greedy AR decoded at the engine's row counts (``ar_at_engine_rows``)
   gives the completion bit for bit; then the launch formula (per
   block 0 attention, 5 ``lora_logits``, 1 ``verify_argmax``, 0
   ``ssd_scan``; 48 ``ssd_scan`` per prefill call), no synchronising
   operation inside a continuous dispatch, all lanes empty at the end,
   every vocab launch on the fast loader;
10. the Improve loop on vicuna-7b, after phase 8 on the same weights: the
   continuous engine of phase 8 (ample pool) with ``learn=True`` (an update
   every 4 blocks, mode "full", lr 1e-3, the trainer state drawn from the
   seed) answering phase 8's 16 requests, and the sync engine with one
   update a batch answering phase 4's 8, each eagerly and graphed.  It
   checks graphed against eager bit for bit, streams and the final drafter
   state (A, B, moments, baseline, steps); each completion against the
   frozen drafter's (or AR's, near-ties allowed); the launch formula plus 2
   ``lora_logits`` an update; the reference's update cadence counted on the
   host; 0 synchronising operations inside every dispatch and update; A
   and B at their addresses; every ``dvi_train_*`` gauge finite.  It
   reports the first and last update's loss terms, acceptance over the
   first and last quarter of the blocks, an update's host and device ms,
   and the graphed path's wall and device ms a block-step and tokens/s
   against phase 8's;
11. the training path, through the port's launcher (``launch/train.py``):
   (b, after phase 10, on its vicuna-7b weights) ``--mode dvi-batch
   --pretrain-steps 0``, 8 teacher-forced drafter steps of 8 x 1024 tokens
   (8184 positions), with gates: the backbone's bits unchanged (checksummed
   on the device), A and B changed, finite loss, gnorm and acc_rate, one
   ``lora_logits`` launch a step, 0 synchronising operations in a step
   after the first; (a, after phase 9) mamba2-370m at full width and depth
   (48 layers, bf16, weights from the seed) ``--mode pretrain``, 40 steps
   of 8 x 256 at lr 2e-3, with gates: step 1's gradient non-zero and finite
   in every layer's A_log, dt_bias, in_proj and conv_w (the scan's
   backward), finite losses and gnorms, 48 ``ssd_scan`` launches a step,
   ``lm_head`` == ``embed.T`` at its address after every step, the
   checkpoint loading back bit for bit with exactly the trained tree's
   keys; then 5 steps on one batch alone, which must cut its loss by 0.5
   nats (the streaming loss's first and last 5 steps are reported), the
   last of them profiled; (c)
   ``examples/torch_quickstart.py`` at its own tiny float32 size, lossless
   against AR.  It reports each step's wall, host and device ms, tokens/s,
   peak memory, the scan backward's share of a pretraining step, and the
   quickstart's acceptance, MAT and AR / DVI wall ratio;
12. speculative sampling and adaptive depth on vicuna-7b, after phase 11b
   on the same weights: (a) ``speculative_generate`` at temperature 0.8 on
   phase 4's 8 requests (padded to 128, 32 new tokens) from a generator
   seeded from SEED, with gates: tokens in the vocabulary, lengths as
   asked, tuples logged, the same seed giving the same streams bit for bit
   and another seed other streams, one sampled block under sync debug mode
   "error", 40 ``decode_attention``, 5 ``lora_logits`` and 0
   ``verify_argmax`` launches a block; ``rejection_commit`` alone at V 64
   over 2^20 lanes, the emitted token within total variation 0.01 of p;
   a sampled and a greedy block's device ms on one cache.  (b) phase 8's
   continuous engine (ample pool, its 16 requests, graphed) with
   ``adaptive_k``: pinned at K (k_min = k_max = k_init = 4) equal to phase
   8's graphed run bit for bit (streams, drafted, blocks); the default
   controller (k_min 1, k_max 4) with gates: each completion equal to
   phase 8's or passing the AR near-tie rule, every lane's depth within
   [k_min, its ceiling k_cap] after each harvest, the launch formula at
   each dispatched draft width (2 K_blk + 32 ``paged_decode_attention``,
   K_blk + 1 ``lora_logits``, 1 ``verify_argmax`` a block), each graph's
   kernel nodes equal to its capture's launches, at most 4 captures, 0
   synchronising operations in a dispatch, host syncs == dispatches, the
   pool empty; then an adversarial swing (cooldown 1, k_init 1, hi 0.1)
   from phase 8's tight pool size down until it preempts, lossless, the
   pool drained.  It reports each mode's wall and device ms a block-step,
   tokens/s, busy share, mean depth, draft efficiency, captures, graph
   pool and peak memory beside phase 8's fixed-K run;
13. chunked prefill (``prefill_chunk`` 32) on the continuous engine: (a,
   after phase 12, on its vicuna-7b weights) phase 8's ample pool and 16
   requests, graphed and eagerly; (b) phase 8's tight pool size, swung
   down until a lane is preempted, counting the victims caught
   mid-prefill; (d) the ample pool with ``learn=True`` and ``adaptive_k``
   (graphed); (c, after phase 9) mamba2-370m at 48 layers on the
   contiguous engine (graphed).  Gates: graphed == eager bit for bit (a);
   every completion == ``ar_generate`` on its exact prompt or the near-tie
   rule (a; b and d through the equal completions of a and of phase 8,
   the rest against AR; c through phase 9's, the rest against AR alone or
   at the chunked engine's row counts), with the count equal to phase 8's
   or 9's one-shot streams reported; the largest tick's prefill at most 8
   x 32 tokens; 0 synchronising operations inside a chunk step and a
   dispatch, host syncs == dispatches; the pool or the lanes empty; A and
   B at their addresses (d); launches exact: the per-block formula plus 32
   ``paged_decode_attention`` a chunk step (vicuna), 48 ``ssd_scan`` a
   first-chunk admission and no attention (mamba2), 2 ``lora_logits`` an
   update (d); each graph's kernel nodes == its capture's launches; the
   port's metrics schema gate (``scripts/torch_check_metrics_schema.py``)
   on the drained engines of a and d.  It reports wall and device ms a
   block-step, tokens/s, busy share, tick percentiles, the chunk graph's
   nodes and capture seconds, peak memory and the host ms a block-step per
   tick phase (``admit`` and ``pre_admit`` beside phase 8's);
7. a ``{"kernels": [...]}`` JSON line, then the ``{"ok": true, ...}`` line.

Phases 4, 8 and 9 run every path twice: eagerly (``graphs=False``) and
replaying one CUDA graph a block-step (the engine's default, the main
path).  The graphed streams must equal the eager ones bit for bit, every
gate above holds on both, each graph's kernel nodes (counted through
libcuda) must equal the launches its capture recorded, and one line per
mode gives the wall and device time per block-step, tokens/s, the busy
share, host launches, captures, nodes, the graph pool and peak memory
(phase 9's eager runs are not profiled again, to keep the script within
its time limit: no device time or busy share for them).
The graphed continuous paths are traced once more for the host's time per
tick phase.

It imports torch, numpy and the port; nothing of JAX.  It needs one card and
exits non-zero without one.
"""
from __future__ import annotations

import gc
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
# by the plain version's bf16 rounding of the probabilities; the SSD scan
# computes in float32 on both sides, so only the order of summation differs
TOL = {"verify_argmax": (2e-3, 1e-3), "lora_logits": (2e-3, 1e-3),
       "decode_attention": (2e-2, 2e-2), "paged_decode_attention": (2e-2, 2e-2),
       "ssd_scan": (1e-4, 1e-4),
       # the scan's gradient (ops.SsdScan: the plain version's recompute on the
       # card) against autograd through the plain version: float32 on both
       # sides, in other orders; (atol x the gradient's largest entry, rtol)
       "ssd_scan backward": (1e-4, 1e-4)}
GAP_RTOL = 2e-2                  # bf16 top-2 logit gap treated as a tie
GEMM_NOTE = ("gemm_ms: cuBLAS torch.matmul(h, w) in bf16 alone, a yardstick: it writes "
             "the logits and computes neither the argmax nor the LoRA term")
# the continuous path (phase 8)
C_SLOTS, C_PAGE, C_SYNC, C_REQUESTS = 8, 16, 4, 16
C_PROMPTS, C_NEW = (64, 96, 128), (16, 32)
C_PAGES_AMPLE, C_PAGES_TIGHT = 152, 48
# the Improve loop (phase 10): phase 8's continuous path and phase 4's sync
# path with learn=True, the reference engine's defaults
L_UPDATE_EVERY, L_LR, L_MODE = 4, 1e-3, "full"
# rows of h one pass of the vocab kernels holds (csrc/vocab_tile.cuh: MAX_NT
# n8 tiles); the update's lora_logits at dvi.batch_size = 256 rows takes 4
VOCAB_PASS_ROWS = 64
# the LoraLogits backward (dA, dB) against autograd through the plain
# version: both are float32 products on the card, in other orders
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4   # atol x the gradient's largest entry
# the mamba2 paths (phase 9): the sync path's 8 requests and the continuous
# path's 16, as for vicuna; the continuous cache is contiguous
M_NAME = "mamba2-370m"
# the training path (phase 11): mamba2-370m pretraining, B 8 x T 256 at the
# reference launcher's lr, 40 steps (each batch one task category, in turn:
# at this depth each step overshoots toward its batch's category, so the
# streaming loss does not fall in 40 steps at any rate tried,
# repro_torch/launch/lr_sweep.py), then P_DESCENT more steps on one batch,
# which must cut that batch's loss by at least P_DROP nats; vicuna-7b
# dvi-batch, 8 steps of B 8 x T 1024, whose 8 x 1023 = 8184 positions stay
# under the reference's 8192
P_STEPS, P_B, P_T, P_DESCENT, P_DROP = 40, 8, 256, 5, 0.5
D_STEPS, D_B, D_T = 8, 8, 1024
D_ROWS = D_B * (D_T - 1)
# speculative sampling (phase 12a): phase 4's requests at this temperature;
# rejection_commit alone over 2^20 lanes at V = 64, in chunks of 2^18
S_TEMP, S_TV_V, S_TV_LANES, S_TV_CHUNK = 0.8, 64, 1 << 20, 1 << 18
# adaptive depth (phase 12b): the default controller's depth range
A_KMIN, A_KMAX = 1, 4
# chunked prefill (phase 13): phase 8's continuous paths with prompts
# prefilled in chunks of this many tokens (phase 8's prompts of 64-128
# tokens take 2-4 chunks); phase 3 times both attention kernels at a chunk
# step's Tq 32 and 128 (vicuna's G = 1) and 64 at G = 2 (qwen3-0.6b's 16
# query heads over 8 kv heads)
P_CHUNK = 32
CHUNK_ATTN = ((32, 32, 32), (128, 32, 32), (64, 16, 8))      # (Tq, H, KV)
# phase 13c's witness for a mamba2 chunked completion that differs from AR
# beyond a bf16 near-tie (chunk_witness): in float32 a top-2 logit gap
# within this share of the top logit is a tie, and the chunk-built SSM
# states and conv windows equal one-shot prefill's within F32_STATE_RTOL a
# layer (the two paths differ in float32 summation order alone); in bf16
# the chunk-built ones lie at most BF16_STATE_RATIO times as far from the
# float32 one-shot ones as bf16 one-shot prefill's do
F32_GAP_RTOL, F32_STATE_RTOL, BF16_STATE_RATIO = 1e-3, 1e-3, 4.0


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


_SPIN: dict = {}


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond, measured once."""
    if not _SPIN:
        n = 1 << 21
        torch.cuda._sleep(n)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(n)
        b.record()
        b.synchronize()
        _SPIN["cycles_per_ms"] = n / a.elapsed_time(b)
    return _SPIN["cycles_per_ms"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple:
    """(device ms, call ms): medians over `iters` calls of `fn`, with the
    50 MB L2 flushed before each call (the model path finds these operands
    cold).

    Device ms: after the flush a spin kernel (``torch.cuda._sleep``) holds
    the device while the host enqueues event a, the call and event b, so
    the events time the call's kernels back to back and none of the host's
    work (the wrapper's checks, ctypes, PyTorch's dispatch).  The spin is 10
    times the slowest warm enqueue, at least 10 ms, so that a stall of the
    shared host hides behind it too; the host's enqueue time
    is measured on every call, from before the spin's launch, and the
    timing fails if it ever reaches the spin.  Call ms: the same events
    without the spin, so they also hold any wait for the host, as an idle
    device sees the call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    enqueue = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    spin_ms = max(10.0, 10e3 * max(enqueue[1:]))
    cycles = int(spin_ms * spin_cycles_per_ms())
    dev, call, worst = [], [], 0.0
    gc.disable()
    try:
        for _ in range(iters):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            torch.cuda._sleep(cycles)
            a.record()
            fn()
            b.record()
            worst = max(worst, time.perf_counter() - t0)
            b.synchronize()
            dev.append(a.elapsed_time(b))
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            call.append(a.elapsed_time(b))
    finally:
        gc.enable()
    check(worst * 1e3 < spin_ms, f"timing: the host took {worst * 1e3:.3f} ms to enqueue a "
                                 f"call, not hidden by the {spin_ms:.3f} ms spin")
    return float(np.median(dev)), float(np.median(call))


def timing(kernel, plain, b: tuple, library=None) -> dict:
    """The timing keys of a row: the kernel's, its plain version's and the
    library call's device and call ms (``time_ms``), the bound and the
    share of it the kernel reaches."""
    ms, call_ms = time_ms(kernel)
    plain_ms, plain_call_ms = time_ms(plain)
    lib_ms, lib_call_ms = time_ms(library) if library is not None else (None, None)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                library_ms=lib_ms, library_call_ms=lib_call_ms, bound_ms=b[0],
                bound_by=b[1], bound_share=b[0] / ms)


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

def loader_used(ops, name: str) -> str:
    """The loader of the one vocab launch since the last reset."""
    paths = ops.vocab_paths[name]
    check(sum(paths.values()) == 1, f"{name}: {paths} launches by loader, expected one")
    return "fast" if paths["fast"] else "element"


def check_verify(ops, ref, gen, T, d, V, label):
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    ops.reset_launches()
    arg, mx = ops.verify_argmax(h, w)
    check(loader_used(ops, "verify_argmax") == "fast",
          f"verify_argmax {label}: the paths' shapes must take the fast loader")
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
    ops.reset_launches()
    out = ops.lora_logits(h, w, a, b, gamma)
    check(loader_used(ops, "lora_logits") == "fast",
          f"lora_logits {label}: the paths' shapes must take the fast loader")
    err, rel, ok = close("lora_logits", out, ref.lora_logits(h, w, a, b, gamma))
    atol, rtol = TOL["lora_logits"]
    phase(3, f"lora_logits {label}: T={T} d={d} V={V} r={r} max abs err {err:.3e} "
             f"rel {rel:.3e} (atol {atol} rtol {rtol}) ok={ok}")
    check(ok, f"lora_logits {label} disagrees with its plain version")
    return (h, w, a, b, gamma), err


def check_lora_update(ops, ref, gen, T, d, V, r, gamma, label="the update"):
    """lora_logits at the online update's shape (T = dvi.batch_size rows in
    bf16, A and B requiring gradients): the forward through the
    differentiable wrapper (the kernel, on the fast loader) against the
    plain version at ``TOL``, and its dA and dB against autograd through
    ``ref.lora_logits`` at GRAD_RTOL / GRAD_ATOL.  Returns the timing
    arguments, the forward's and the gradients' max abs errors."""
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    a = (torch.randn((d, r), generator=gen, device=DEV) / d ** 0.5).requires_grad_()
    b = (torch.randn((r, V), generator=gen, device=DEV) * 0.05).requires_grad_()
    g = torch.randn((T, V), generator=gen, device=DEV) / (T * V) ** 0.5
    ops.reset_launches()
    out = ops.lora_logits(h, w, a, b, gamma)
    check(out.requires_grad and loader_used(ops, "lora_logits") == "fast",
          "lora_logits at the update's shape must run the kernel on the fast loader")
    (out * g).sum().backward()
    da, db = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    plain = ref.lora_logits(h, w, a, b, gamma)
    (plain * g).sum().backward()
    err, rel, ok = close("lora_logits", out.detach(), plain.detach())
    grad_err, grad_ok = {}, True
    for name, got, want in (("dA", da, a.grad), ("dB", db, b.grad)):
        diff = (got - want).abs()
        grad_err[name] = float(diff.max())
        grad_ok &= bool((diff <= GRAD_ATOL * float(want.abs().max())
                         + GRAD_RTOL * want.abs()).all())
    atol, rtol = TOL["lora_logits"]
    phase(3, f"lora_logits at {label} (T={T}, {-(-T // VOCAB_PASS_ROWS)} row passes): d={d} "
             f"V={V} r={r} forward max abs err {err:.3e} rel {rel:.3e} (atol {atol} rtol "
             f"{rtol}); backward max abs err dA {grad_err['dA']:.3e}, dB {grad_err['dB']:.3e} "
             f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL} x max |grad|), launches "
             f"{ops.launches['lora_logits']}; ok={ok and grad_ok}")
    check(ok and grad_ok and ops.launches["lora_logits"] == 1,
          f"lora_logits at {label}'s shape disagrees with its plain version")
    return (h, w, a.detach(), b.detach(), gamma), err, grad_err


# the vocab kernels' edge cases (phase 3): widths about the 128-column strip
# (8 and 1 short of it, exactly it, 1 and 8 past it) and rows that are not
# 16-byte multiples (odd V in bf16: the element loader); row counts in one,
# two and several passes; ties placed at every offset of a strip and a
# fragment (the first L columns repeated n times; 1001 and 5 are odd); r = 1
# and the largest rank the kernel takes
VOCAB_EDGE_V = (120, 127, 128, 129, 136, 1001)
VOCAB_EDGE_T = (1, 9, 41, 49, 67)
VOCAB_EDGE_TIES = ((1001, 32), (5, 200), (3, 43))
LORA_EDGE_R = (1, 512)


def vocab_edges(ops, ref, gen, d, V):
    """verify_argmax and lora_logits (r = 64) in bf16 at the edge cases,
    each against its plain version at ``TOL``, each on the loader that
    ``vocab_fast`` must pick (fast iff V * 2 is a multiple of 16, d and the
    pointers being aligned); the exact tie rule at every offset."""
    def loader_ok(name, V_):
        return loader_used(ops, name) == ("fast" if V_ * 2 % 16 == 0 else "element")

    def verify_case(T, V_, w=None):
        h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
        if w is None:
            w = (torch.randn((d, V_), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
        ops.reset_launches()
        arg, mx = ops.verify_argmax(h, w)
        ok = loader_ok("verify_argmax", V_)
        arg_r, mx_r = ref.verify_argmax(h, w)
        err, _, close_ok = close("verify_argmax", mx, mx_r)
        top2 = (h.float() @ w.float()).topk(min(2, V_), dim=-1).values
        atol, rtol = TOL["verify_argmax"]
        near = top2[:, 0] - top2[:, -1] <= atol + rtol * top2[:, 0].abs()
        return err, ok and close_ok and not bool(((arg != arg_r) & ~near).any())

    def lora_case(T, V_, r):
        h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
        w = (torch.randn((d, V_), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
        a = torch.randn((d, r), generator=gen, device=DEV) / d ** 0.5
        b = torch.randn((r, V_), generator=gen, device=DEV) * 0.05
        ops.reset_launches()
        out = ops.lora_logits(h, w, a, b, 2.0)
        ok = loader_ok("lora_logits", V_)
        err, _, close_ok = close("lora_logits", out, ref.lora_logits(h, w, a, b, 2.0))
        return err, ok and close_ok

    cases = ([("verify_argmax", f"T=40 V={v}", lambda v=v: verify_case(40, v))
              for v in VOCAB_EDGE_V]
             + [("verify_argmax", f"T={t} V={V}", lambda t=t: verify_case(t, V))
                for t in VOCAB_EDGE_T]
             + [("lora_logits", f"T=8 V={v} r=64", lambda v=v: lora_case(8, v, 64))
                for v in VOCAB_EDGE_V]
             + [("lora_logits", f"T={t} V={V} r=64", lambda t=t: lora_case(t, V, 64))
                for t in VOCAB_EDGE_T]
             + [("lora_logits", f"T=8 V={V} r={r}", lambda r=r: lora_case(8, V, r))
                for r in LORA_EDGE_R])
    for name, label, run in cases:
        err, ok = run()
        atol, rtol = TOL[name]
        phase(3, f"{name} edge {label} d={d}: max abs err {err:.3e} (atol {atol} rtol "
                 f"{rtol}), loader {'fast' if ops.vocab_paths[name]['fast'] else 'element'}: "
                 f"ok={ok}")
        check(ok, f"{name} edge {label} disagrees with its plain version or took the "
                  f"wrong loader")
    for L, n in VOCAB_EDGE_TIES:
        h = torch.randn((41, d), generator=gen, device=DEV).to(torch.bfloat16)
        w = torch.randn((d, L), generator=gen, device=DEV).to(torch.bfloat16)
        arg1, mx1 = ops.verify_argmax(h, w)
        argn, mxn = ops.verify_argmax(h, w.repeat(1, n).contiguous())
        ok = torch.equal(arg1, argn) and torch.equal(mx1, mxn) and bool((argn < L).all())
        phase(3, f"verify_argmax tie rule: {L} columns repeated {n}x (copies at offsets "
                 f"{sorted({L * i % 16 for i in range(n)})} mod 16), T=41 d={d}: lowest "
                 f"index, bit-equal maxima: {ok}")
        check(ok, f"verify_argmax tie rule at offsets of {L} columns")


def close_visible(name, out, plain, visible):
    """Kernel output against its plain version on the (lane, query) rows
    that see a slot; the other rows must be exactly 0 (the plain version
    gives them the reference's uniform average).  visible (B, Tq) bool.
    Returns (max abs err, ok)."""
    B, Tq = visible.shape
    out4, plain4 = out.reshape(B, Tq, *out.shape[-2:]), plain.reshape(B, Tq, *out.shape[-2:])
    vis = torch.as_tensor(visible, device=out.device)
    err, ok = 0.0, True
    if bool(vis.any()):
        err, _, ok = close(name, out4[vis], plain4[vis])
    return err, ok and bool((out4[~vis] == 0).all()) and bool(torch.isfinite(plain4).all())


def check_attention(ops, ref, gen, B, Tq, H, KV, hd, S, lengths, label):
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.decode_attention(q_in, k, v, lens)
    visible = np.array([[min(int(n) - (Tq - 1 - t), S) > 0 for t in range(Tq)]
                        for n in lengths])
    err, ok = close_visible("decode_attention", out, ref.decode_attention(q_in, k, v, lens),
                            visible)
    atol, rtol = TOL["decode_attention"]
    phase(3, f"decode_attention {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} S={S} "
             f"C={ops.attn_splits(S, B * KV * ops.attn_row_tiles(Tq * (H // KV)))} row tiles "
             f"{ops.attn_row_tiles(Tq * (H // KV))} lengths {list(map(int, lengths))} max abs err "
             f"{err:.3e} on {int(visible.sum())} of {visible.size} queries that see a slot "
             f"(atol {atol} rtol {rtol}), the others exactly 0: ok={ok}")
    check(ok, f"decode_attention {label} disagrees with its plain version")
    return (q_in, k, v, lens), err


def attn_bound(q, lengths, cap, KV, hd) -> tuple:
    """The least time of one contiguous attention call: q read and the
    output written once, each lane's live K and V rows read once, the
    lengths; QK^T and P.V over the slots each query sees, at the bf16 rate."""
    B, H = q.shape[0], q.shape[-2]
    Tq = q.shape[1] if q.ndim == 4 else 1
    live = sum(min(int(n), cap) for n in lengths)
    row_live = sum(max(0, min(int(n) - (Tq - 1 - t), cap)) for n in lengths
                   for t in range(Tq)) * H
    return bound(q.numel() * 2 * 2 + live * KV * hd * 2 * 2 + B * 4,
                 4 * hd * row_live / BF16_FLOP_PER_S)


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
    visible = np.array(paged_live_slots(tbl, lengths, ps, Tq)) > 0
    err, ok = close_visible("paged_decode_attention", out, plain, visible)
    atol, rtol = TOL["paged_decode_attention"]
    tiles = ops.attn_row_tiles(Tq * (H // KV))
    phase(3, f"paged_decode_attention {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} ps={ps} "
             f"MPS={mps} C={ops.attn_splits(mps * ps, B * KV * tiles)} "
             f"row tiles {tiles} P={P} lengths "
             f"{list(map(int, lengths))} holes {list(holes)} max abs err {err:.3e} on "
             f"{int(visible.sum())} of {visible.size} queries that see a mapped slot (atol "
             f"{atol} rtol {rtol}), the others exactly 0 (plain: finite): ok={ok}")
    check(ok, f"paged_decode_attention {label} disagrees with its plain version")
    return (q_in, kp, vp, lens, tbl_t, tbl), err


def check_paged_counts(ops, ref, gen, rng, B, Tq, H, KV, hd, ps, mps, lengths, label):
    """Paged attention with per-lane ``page_counts`` at the given widths: the
    lanes take counts below ceil(len/ps), 0 (clipped to 1), past MPS
    (clipped to MPS) and at ceil(len/ps) in turn; every query sees a slot
    (page 0 is mapped), so all rows are held against the plain version.
    The call with page_counts=None must be bit-identical to the call
    without it, and the counts below ceil(len/ps) must change the lanes
    that take them."""
    tbl, P = paged_tables(rng, lengths, ps, mps)
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    kp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    vp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    tbl_t = torch.as_tensor(tbl, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    need = [-(-int(n) // ps) for n in lengths]
    counts = [(max(1, need[b] // 2), 0, mps + 3, need[b])[b % 4] for b in range(B)]
    pc = torch.as_tensor(np.asarray(counts, np.int32), device=DEV)
    out = ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t, page_counts=pc)
    plain = ref.paged_decode_attention(q_in, kp, vp, lens, tbl_t, page_counts=pc)
    err, _, ok = close("paged_decode_attention", out, plain)
    full = ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t)
    same = torch.equal(ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t,
                                                  page_counts=None), full)
    cut = [b for b in range(B) if min(max(counts[b], 1), mps) < need[b]]
    changed = all(not torch.equal(out[b], full[b]) for b in cut)
    phase(3, f"paged_decode_attention page_counts {label}: B={B} Tq={Tq} MPS={mps} lengths "
             f"{list(map(int, lengths))} pages needed {need} page_counts {counts} max abs err "
             f"{err:.3e} on every query: ok={ok}; page_counts=None bit-identical to the call "
             f"without it: {same}; lanes {cut} cut below their length changed: {changed}")
    check(ok and same and changed and len(cut) > 0,
          f"paged_decode_attention page_counts {label} failed")


def paged_bound(q, tbl, lengths, ps, KV, hd) -> tuple:
    """The least time of one paged attention call: q and the output once,
    each lane's live mapped K and V rows once, the lengths and the table
    entries of its live pages; QK^T and P.V over the mapped slots each query
    sees, at the bf16 rate."""
    B, H = q.shape[0], q.shape[-2]
    Tq = q.shape[1] if q.ndim == 4 else 1
    mps = tbl.shape[1]
    seen = paged_live_slots(tbl, lengths, ps, Tq)
    n_pages = sum(min(-(-int(n) // ps), mps) for n in lengths)
    return bound(q.numel() * 2 * 2 + sum(max(row) for row in seen) * KV * hd * 2 * 2 + B * 4
                 + n_pages * 4, 4 * hd * H * sum(sum(row) for row in seen) / BF16_FLOP_PER_S)


def paged_sdpa_inputs(q, kp, vp, lens, tbl_t):
    """SDPA's inputs for a paged call: each lane's logical view gathered
    into a contiguous (B, MPS * ps, KV, hd) copy (before the clock starts;
    the gather is not timed), unmapped slots masked."""
    P, ps, KV, hd = kp.shape
    jj = torch.arange(tbl_t.shape[1] * ps, device=DEV)
    phys = tbl_t.long().clamp(min=0)[:, jj // ps] * ps + jj % ps
    q4 = q if q.ndim == 4 else q[:, None]
    sq, sk, sv, smask = sdpa_inputs(q4, kp.reshape(P * ps, KV, hd)[phys],
                                    vp.reshape(P * ps, KV, hd)[phys], lens)
    return sq, sk, sv, smask & (tbl_t[:, jj // ps] >= 0)[:, None, None, :]


def ssd_inputs(gen, B, T, H, hd, ds, pad_rows=0):
    """The scan's inputs as ``ssm_forward_full`` hands them over: xh, Bc and
    Cc bf16 strided views of one (B, T, H*hd + 2*ds) conv output after silu,
    dt after softplus in float32 (0 on the last `pad_rows` rows, as on
    padded rows), A = -exp(A_log) with the model's A_log."""
    xbc = torch.nn.functional.silu(
        torch.randn((B, T, H * hd + 2 * ds), generator=gen, device=DEV)).to(torch.bfloat16)
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device=DEV) - 2.0)
    if pad_rows:
        dt[:, T - pad_rows:] = 0.0
    A = -torch.linspace(1.0, 16.0, H, device=DEV)
    return xh, Bc, Cc, dt, A


def check_ssd(ops, ref, gen, B, T, Q, H, hd, ds, label, pad_rows=0, with_h0=False):
    xh, Bc, Cc, dt, A = ssd_inputs(gen, B, T, H, hd, ds, pad_rows)
    h0 = torch.randn((B, H, hd, ds), generator=gen, device=DEV) if with_h0 else None
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    err_y, _, ok_y = close("ssd_scan", y, y_r)
    err_h, _, ok_h = close("ssd_scan", h, h_r)
    ok = ok_y and ok_h and y.dtype == h.dtype == torch.float32
    if pad_rows:                   # dt = 0 rows leave the state where it was
        _, h_np = ref.ssd_scan(xh[:, :T - pad_rows], Bc[:, :T - pad_rows],
                               Cc[:, :T - pad_rows], dt[:, :T - pad_rows], A, 1, h0=h0)
        ok = ok and close("ssd_scan", h, h_np)[2]
    atol, rtol = TOL["ssd_scan"]
    P = ops.ssd_plan(B, H, hd, ds, T, Q)
    phase(3, f"ssd_scan {label}: B={B} T={T} Q={Q} H={H} hd={hd} ds={ds} bf16 inputs, "
             f"P={P} (ops.ssd_plan: slices of {hd // P} of hd), max abs err y {err_y:.3e} "
             f"state {err_h:.3e} (atol {atol} rtol {rtol}), float32 outputs ok={ok}")
    check(ok, f"ssd_scan {label} disagrees with its plain version")
    return (xh, Bc, Cc, dt, A, Q, h0), max(err_y, err_h)


def ssd_bound(xh, Bc, dt, Q, h0) -> dict:
    """The least time of one scan: every input read once, y and the final
    state written once in float32, against its products on the tensor
    cores at the kernel's split count: C.B^T on and below the diagonal once
    per lane and chunk, and per head the intra-chunk term (W in three bf16
    terms), the carried-state term (h in three terms) only on chunks that
    start from a state that may be nonzero (after the first chunk, or with
    h0), and the state update (u x in two terms); float32 inputs split x, B
    and C too (six products each).  ``f32_core_bound_ms`` keeps the earlier
    figure beside it: every product, the carried term on every chunk, at the
    float32 CUDA-core rate."""
    B, T, H, hd = xh.shape
    ds = Bc.shape[3]
    nc = T // Q
    f32 = xh.dtype == torch.float32
    nbytes = (xh.numel() * xh.element_size() + 2 * Bc.numel() * Bc.element_size()
              + dt.numel() * 4 + H * 4 + (h0.numel() * 4 if h0 is not None else 0)
              + B * T * H * hd * 4 + B * H * hd * ds * 4)
    tri = Q * (Q + 1) // 2 * nc
    carried_rows = Q * (nc - (0 if h0 is not None else 1))
    cb, intra = 2 * B * tri * ds, 2 * B * H * tri * hd
    carried, update = 2 * B * H * carried_rows * ds * hd, 2 * B * H * T * ds * hd
    terms = (6, 6, 6, 6) if f32 else (1, 3, 3, 2)
    tc = sum(n * f for n, f in zip(terms, (cb, intra, carried, update)))
    ms, by = bound(nbytes, tc / BF16_FLOP_PER_S)
    f32_flop = cb + intra + 2 * update
    return dict(bound=(ms, by), f32_core_bound_ms=bound(nbytes, f32_flop / F32_FLOP_PER_S)[0])


def check_ssd_grad(ops, ref, gen, B, T, Q, H, hd, ds):
    """``ssd_scan`` at mamba2 pretraining's shape with inputs that require
    gradients (``ops.SsdScan``): bf16 xh, Bc and Cc strided views of a conv
    output, float32 dt and A, as ``ssm_forward_full`` hands them over.  The
    forward (the kernel, one launch) against the plain version at ``TOL``,
    the gradients in the conv output, dt and A against autograd through
    ``ref.ssd_scan`` at ``TOL["ssd_scan backward"]``; the backward launches
    no kernel.  Returns the forward's timing arguments, its max abs error,
    the gradients' max abs errors and the backward as a call."""
    xbc = torch.nn.functional.silu(
        torch.randn((B, T, H * hd + 2 * ds), generator=gen, device=DEV)).to(torch.bfloat16)
    xbc.requires_grad_()
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device=DEV) - 2.0)
    dt.requires_grad_()
    A = (-torch.linspace(1.0, 16.0, H, device=DEV)).requires_grad_()
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
    gy = torch.randn((B, T, H, hd), generator=gen, device=DEV) / (B * T * H * hd) ** 0.5
    leaves = (xbc, dt, A)
    ops.reset_launches()
    y, _ = ops.ssd_scan(xh, Bc, Cc, dt, A, Q)
    check(y.requires_grad and ops.launches["ssd_scan"] == 1,
          "ssd_scan with a gradient must run the kernel once (SsdScan)")
    got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
    y_r, _ = ref.ssd_scan(xh, Bc, Cc, dt, A, Q)
    want = torch.autograd.grad(y_r, leaves, gy)
    err, _, ok = close("ssd_scan", y.detach(), y_r.detach())
    atol, rtol = TOL["ssd_scan backward"]
    grad_err, grad_ok = {}, True
    for name, g, w in zip(("dxBC", "ddt", "dA"), got, want):
        diff = (g.float() - w.float()).abs()
        grad_err[name] = float(diff.max())
        grad_ok &= bool(torch.isfinite(g).all()) and bool(
            (diff <= atol * float(w.float().abs().max()) + rtol * w.float().abs()).all())
    phase(3, f"ssd_scan with its gradient (training): B={B} T={T} Q={Q} H={H} hd={hd} ds={ds}, "
             f"bf16 inputs; forward max abs err {err:.3e}, backward max abs err "
             + ", ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
             + f" (atol {atol} x max |grad|, rtol {rtol}); launches "
             f"{ops.launches['ssd_scan']}; ok={ok and grad_ok}")
    check(ok and grad_ok and ops.launches["ssd_scan"] == 1,
          "ssd_scan's gradient disagrees with autograd through its plain version")
    fwd = (xh.detach(), Bc.detach(), Cc.detach(), dt.detach(), A.detach(), Q, None)
    return fwd, err, grad_err, lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)


def kernels_phase(cfg, mcfg):
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
    # the online update's shape, from a generator of its own so that the
    # other cases keep their inputs
    upd_args, upd_err, upd_grad_err = check_lora_update(
        ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 6), cfg.dvi.batch_size, d, V,
        cfg.dvi.lora_rank, cfg.dvi.lora_alpha / cfg.dvi.lora_rank)
    vocab_edges(ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 4), d, V)
    att_args, err_a = check_attention(ops, ref, gen, B, K + 1, H, KV, hd, cap,
                                      main_lens, "main (verify pass)")
    # a draft feed: one query per lane; its post-write length is the
    # committed length + 1, K below the verify pass's
    feed_lens = [n - K for n in main_lens]
    feed_args, _ = check_attention(ops, ref, gen, B, 1, H, KV, hd, cap, feed_lens,
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
    paged_feed_lens = [n - K for n in paged_lens]
    paged_feed_args, _ = check_paged(ops, ref, gen, rng, B, 1, H, KV, hd, C_PAGE, mps,
                                     paged_feed_lens, "draft feed")
    check_paged(ops, ref, gen, rng, 4, K + 1, 32, 8, 128, C_PAGE, mps,
                [mps * C_PAGE + 3, 100, 60, 0],
                "GQA G=4, lane past the table, -1 mid-row, all -1 lanes",
                holes=((1, 2),), unmapped=(2, 3))
    check_paged(ops, ref, gen, rng, 3, 1, H, KV, hd, 4, -(-cap // 4),
                list(rng.randint(5, cap + 1, size=3)), "ps=4, -1 mid-row", holes=((0, 1),))
    # the split's edge cases at the main widths, for the paths' 8 lanes (one
    # CTA a lane and kv head) and in pairs of lanes (each lane split over a
    # cluster), with their own generators so the cases above keep their
    # inputs: a lane of length 1; one shorter than a CTA's share (the other
    # CTAs of its cluster empty); lanes at the capacity and one past it; an
    # idle lane; a paged lane with -1 entries on both sides of a share border
    egen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    erng = np.random.RandomState(SEED + 3)
    pcap = mps * C_PAGE
    edges = [1, 10, cap, cap + 1, 0, 40, 150, cap - 1]
    pedges = [1, 10, pcap, pcap + 1, 0, 200, 150, 40]
    for lanes in (list(range(B)), [1, 5], [3, 0], [4, 2]):
        nb = len(lanes)
        sh = ops.attn_share(pedges[5], ops.attn_splits(pcap, nb * KV))
        border = sh // C_PAGE if sh < pedges[5] else 1
        holes = ((lanes.index(5), border - 1), (lanes.index(5), border)) if 5 in lanes else ()
        for Tq in (K + 1, 1):
            check_attention(ops, ref, egen, nb, Tq, H, KV, hd, cap, [edges[i] for i in lanes],
                            f"split edges, {nb} lanes, Tq={Tq}")
            check_paged(ops, ref, egen, erng, nb, Tq, H, KV, hd, C_PAGE, mps,
                        [pedges[i] for i in lanes], f"split edges, {nb} lanes, Tq={Tq}",
                        holes=holes, unmapped=(lanes.index(4),) if 4 in lanes else ())
    # page_counts: the reference's optional per-lane page count
    cgen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    crng = np.random.RandomState(SEED + 5)
    for Tq in (K + 1, 1):
        check_paged_counts(ops, ref, cgen, crng, B, Tq, H, KV, hd, C_PAGE, mps,
                           paged_lens, f"at the main widths, Tq={Tq}")
    # adaptive depth's verify pass (phase 12b): Tq = K_blk + 1 in 2..K at the
    # main widths and post-write lengths, with the split's edge cases as
    # above, from generators of their own so the cases above keep their inputs
    agen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    arng = np.random.RandomState(SEED + 9)
    adapt = {}
    for Tq in range(2, K + 1):
        lens_q = [n - (K + 1) + Tq for n in main_lens]
        plens_q = [n - (K + 1) + Tq for n in paged_lens]
        a_args, _ = check_attention(ops, ref, agen, B, Tq, H, KV, hd, cap, lens_q,
                                    f"adaptive verify pass Tq={Tq}")
        p_args, _ = check_paged(ops, ref, agen, arng, B, Tq, H, KV, hd, C_PAGE, mps, plens_q,
                                f"adaptive verify pass Tq={Tq}")
        adapt[Tq] = (a_args, lens_q, p_args, plens_q)
        for lanes in (list(range(B)), [1, 5], [3, 0], [4, 2]):
            nb = len(lanes)
            sh = ops.attn_share(pedges[5], ops.attn_splits(pcap, nb * KV))
            border = sh // C_PAGE if sh < pedges[5] else 1
            holes = ((lanes.index(5), border - 1), (lanes.index(5), border)) if 5 in lanes else ()
            check_attention(ops, ref, agen, nb, Tq, H, KV, hd, cap, [edges[i] for i in lanes],
                            f"split edges, {nb} lanes, Tq={Tq}")
            check_paged(ops, ref, agen, arng, nb, Tq, H, KV, hd, C_PAGE, mps,
                        [pedges[i] for i in lanes], f"split edges, {nb} lanes, Tq={Tq}",
                        holes=holes, unmapped=(lanes.index(4),) if 4 in lanes else ())
    # chunked prefill's chunk step (phase 13): Tq queries a lane whose
    # Tq * G rows a kv head take 1, 2 and 2 row tiles of 64, each lane's
    # post-write length in [Tq, capacity], from generators of their own so
    # the cases above keep their inputs
    kgen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    krng = np.random.RandomState(SEED + 10)
    chunk_cases = {}
    for Tq, Hc, KVc in CHUNK_ATTN:
        label = f"prefill chunk Tq={Tq} G={Hc // KVc}"
        lens_c = list(krng.randint(Tq, cap + 1, size=B))
        a_args, _ = check_attention(ops, ref, kgen, B, Tq, Hc, KVc, hd, cap, lens_c, label)
        plens_c = list(krng.randint(Tq, mps * C_PAGE + 1, size=B))
        p_args, _ = check_paged(ops, ref, kgen, krng, B, Tq, Hc, KVc, hd, C_PAGE, mps, plens_c,
                                label)
        chunk_cases[f"at_chunk_tq{Tq}" + ("" if Hc == KVc else f"_g{Hc // KVc}")] = (
            a_args, lens_c, p_args, plens_c, KVc)
    # the mamba2 paths: the tied vocab (not a multiple of 64 columns) and the
    # scan at the prefill shapes of both schedulers
    md, mV, mK = mcfg.d_model, mcfg.vocab_size, mcfg.dvi.k_spec
    mh, mw, _ = check_verify(ops, ref, gen, B * (mK + 1), md, mV, f"{M_NAME} (V={mV})")
    m_lora, _ = check_lora(ops, ref, gen, B, md, mV, mcfg.dvi.lora_rank, f"{M_NAME} (V={mV})")
    mH, mhd, mds = (mcfg.ssm.expand * md) // mcfg.ssm.head_dim, mcfg.ssm.head_dim, mcfg.ssm.d_state
    ssd_args, err_s = check_ssd(ops, ref, gen, B, 127, 127, mH, mhd, mds,
                                "sync prefill (bucket 128)")
    ssd_one, _ = check_ssd(ops, ref, gen, 1, 95, 95, mH, mhd, mds,
                           "continuous admission (96 tokens)")
    check_ssd(ops, ref, gen, 2, 256, 128, mH, mhd, mds, "padded long prompt", pad_rows=56)
    check_ssd(ops, ref, gen, 2, 64, 64, mH, mhd, mds, "carried h0", with_h0=True)
    check_ssd(ops, ref, gen, 1, 63, 63, mH, mhd, mds, "continuous admission (64 tokens)")
    # chunked prefill's first-chunk admission (phase 13c): B 1 x P_CHUNK
    ssd_chunk, _ = check_ssd(ops, ref, gen, 1, P_CHUNK, P_CHUNK, mH, mhd, mds,
                             f"chunked admission ({P_CHUNK} tokens)")
    # the training path (phase 11), each from a generator of its own: the
    # scan with its gradient at mamba2 pretraining's shape, and lora_logits
    # at the vicuna DVI step's 8184 rows (128 row passes)
    ssd_train, _, ssd_grad_err, ssd_backward = check_ssd_grad(
        ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 7), P_B, P_T,
        mcfg.ssm.chunk_size, mH, mhd, mds)
    dvi_args, dvi_err, dvi_grad_err = check_lora_update(
        ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 8), D_ROWS, d, V,
        cfg.dvi.lora_rank, cfg.dvi.lora_alpha / cfg.dvi.lora_rank, label="the DVI step")

    def verify_bound(T, d, V):
        return bound(T * d * e + d * V * e + T * 8, 2 * T * d * V / BF16_FLOP_PER_S)

    def lora_bound(T, d, V, r):
        return bound(T * d * e + d * V * e + d * r * 4 + r * V * 4 + T * V * 4,
                     2 * T * d * V / BF16_FLOP_PER_S
                     + (2 * T * d * r + 2 * T * r * V) / F32_FLOP_PER_S)

    def gemm(h, w) -> dict:
        """cuBLAS's bf16 product h @ w alone, a yardstick for the vocab
        kernels: it computes the logits without the argmax or the LoRA
        term, and writes them; the port never calls it."""
        ms, call_ms = time_ms(lambda: torch.matmul(h, w))
        return dict(gemm_ms=ms, gemm_call_ms=call_ms)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def attn_timing(args, lengths, kv=KV):
        q, k, v, lens = args
        sq, sk, sv, smask = sdpa_inputs(q if q.ndim == 4 else q[:, None], k, v, lens)
        return timing(lambda: ops.decode_attention(q, k, v, lens),
                      lambda: ref.decode_attention(q, k, v, lens),
                      attn_bound(q, lengths, cap, kv, hd),
                      library=lambda: sdpa(sq, sk, sv, attn_mask=smask))

    def paged_timing(args, lengths, kv=KV):
        q, kp, vp, lens, tbl_t, tbl = args
        sq, sk, sv, smask = paged_sdpa_inputs(q, kp, vp, lens, tbl_t)
        return timing(lambda: ops.paged_decode_attention(q, kp, vp, lens, tbl_t),
                      lambda: ref.paged_decode_attention(q, kp, vp, lens, tbl_t),
                      paged_bound(q, tbl, lengths, C_PAGE, kv, hd),
                      library=lambda: sdpa(sq, sk, sv, attn_mask=smask))

    def ssd_timing(args):
        xh, Bc, Cc, dt, A, Q, h0 = args
        b = ssd_bound(xh, Bc, dt, Q, h0)
        return dict(timing(lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0),
                           lambda: ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0), b["bound"]),
                    f32_core_bound_ms=b["f32_core_bound_ms"])

    def backward_timing(backward) -> dict:
        """The scan's backward alone (plain PyTorch: no kernel of the port)."""
        ms, call_ms = time_ms(backward, iters=10)
        return dict(backward_ms=ms, backward_call_ms=call_ms,
                    backward_note="ops.SsdScan.backward: the plain version's recompute in "
                                  "float32 differentiated by autograd; no backward kernel")

    # what the timer shows for a kernel that does nothing: the launch and
    # the two events around it
    floor_ms, _ = time_ms(lambda: torch.cuda._sleep(1))
    phase(3, f"timer floor: an empty kernel between the events takes {floor_ms:.4f} ms")
    hl, wl, a, b, gamma = lora_args
    rows = [
        dict(name="verify_argmax", route="cuda", source="src/repro_torch/csrc/verify_argmax.cu",
             replaces="src/repro/kernels/verify_argmax.py:62", max_abs_err=err_v,
             **timing(lambda: ops.verify_argmax(h, w), lambda: ref.verify_argmax(h, w),
                      verify_bound(T_verify, d, V)), **gemm(h, w),
             at_mamba2=dict(timing(lambda: ops.verify_argmax(mh, mw),
                                   lambda: ref.verify_argmax(mh, mw),
                                   verify_bound(mh.shape[0], md, mV)), **gemm(mh, mw)),
             gemm_note=GEMM_NOTE),
        dict(name="lora_logits", route="cuda", source="src/repro_torch/csrc/lora_logits.cu",
             replaces="src/repro/kernels/lora_logits.py:53", max_abs_err=err_l,
             **timing(lambda: ops.lora_logits(hl, wl, a, b, gamma),
                      lambda: ref.lora_logits(hl, wl, a, b, gamma),
                      lora_bound(B, d, V, a.shape[1])), **gemm(hl, wl),
             at_mamba2=dict(timing(lambda: ops.lora_logits(*m_lora),
                                   lambda: ref.lora_logits(*m_lora),
                                   lora_bound(B, md, mV, m_lora[2].shape[1])),
                            **gemm(m_lora[0], m_lora[1])),
             # the online update's forward (twice an update): T = 256 rows
             at_update=dict(timing(lambda: ops.lora_logits(*upd_args),
                                   lambda: ref.lora_logits(*upd_args),
                                   lora_bound(cfg.dvi.batch_size, d, V, cfg.dvi.lora_rank)),
                            **gemm(upd_args[0], upd_args[1]), max_abs_err=upd_err,
                            grad_max_abs_err=upd_grad_err,
                            row_passes=-(-cfg.dvi.batch_size // VOCAB_PASS_ROWS)),
             # the teacher-forced DVI step's draft head (phase 11b): 8184 rows
             at_dvi_step=dict(timing(lambda: ops.lora_logits(*dvi_args),
                                     lambda: ref.lora_logits(*dvi_args),
                                     lora_bound(D_ROWS, d, V, cfg.dvi.lora_rank)),
                              **gemm(dvi_args[0], dvi_args[1]), max_abs_err=dvi_err,
                              grad_max_abs_err=dvi_grad_err,
                              row_passes=-(-D_ROWS // VOCAB_PASS_ROWS)),
             gemm_note=GEMM_NOTE),
        # attention at the verify pass (Tq = K+1), with the draft feed
        # (Tq = 1) beside it: 30 and 10 of the 40 launches of a block
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:83", max_abs_err=err_a,
             **attn_timing(att_args, main_lens),
             at_draft_feed=attn_timing(feed_args, feed_lens),
             # adaptive depth's verify pass (phase 12b) at K_blk = 1 and 2
             at_verify_tq2=attn_timing(adapt[2][0], adapt[2][1]),
             at_verify_tq3=attn_timing(adapt[3][0], adapt[3][1]),
             # chunked prefill's chunk step (phase 13), one launch a layer
             **{key: attn_timing(c[0], c[1], kv=c[4]) for key, c in chunk_cases.items()}),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/paged_decode_attention.py:127", max_abs_err=err_p,
             **paged_timing(paged_args, paged_lens),
             at_draft_feed=paged_timing(paged_feed_args, paged_feed_lens),
             at_verify_tq2=paged_timing(adapt[2][2], adapt[2][3]),
             at_verify_tq3=paged_timing(adapt[3][2], adapt[3][3]),
             **{key: paged_timing(c[2], c[3], kv=c[4]) for key, c in chunk_cases.items()},
             library_note="SDPA over the pre-gathered contiguous view; gather not timed"),
        # the scan at the sync path's prefill, with a B = 1 admission of the
        # continuous path and a first-chunk admission of the chunked one
        # beside it; no single PyTorch call scans
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:80", max_abs_err=err_s,
             **ssd_timing(ssd_args), at_admission=ssd_timing(ssd_one),
             at_chunk_admission=ssd_timing(ssd_chunk),
             # mamba2 pretraining (phase 11a): the forward is the kernel, the
             # backward the plain version's recompute differentiated by
             # autograd (ops.SsdScan; the reference has no backward kernel)
             at_training=dict(ssd_timing(ssd_train), grad_max_abs_err=ssd_grad_err,
                              **backward_timing(ssd_backward))),
    ]
    for row in rows:
        for label, t in [("main", row)] + [(k, v) for k, v in row.items()
                                          if k.startswith("at_")]:
            lib = ("-" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} (call {t['library_call_ms']:.4f})")
            gm = ("" if "gemm_ms" not in t else
                  f", cuBLAS h@w alone {t['gemm_ms']:.4f} (call {t['gemm_call_ms']:.4f})")
            if "f32_core_bound_ms" in t:
                gm += (f", f32_core_bound {t['f32_core_bound_ms']:.4f} (computed: every "
                       f"product on the float32 CUDA cores)")
            if "backward_ms" in t:
                gm += (f", backward (plain PyTorch, no kernel) {t['backward_ms']:.4f} (call "
                       f"{t['backward_call_ms']:.4f})")
            phase(3, f"{row['name']} {label}: kernel {t['ms']:.4f} ms (call "
                     f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f} (call "
                     f"{t['plain_call_ms']:.4f}), library {lib}{gm}, bound "
                     f"{t['bound_ms']:.4f} ({t['bound_by']}), bound/kernel "
                     f"{t['bound_share']:.3f}")
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


# the port's kernels in a profile, by the names of their __global__ functions
PORT_KERNELS = ("verify_partial", "verify_reduce", "lora_down", "lora_main", "decode_attn",
                "ssd_chunks")
# each kernel's __global__ functions in a profile, and the one of them that
# runs once a call (the vocab kernels launch two: a pre-pass or a reduction)
KERNEL_NAMES = {
    "decode_attention": (re.compile(r"(?<![A-Za-z_])decode_attn\b"),) * 2,
    "paged_decode_attention": (re.compile(r"(?<![A-Za-z_])paged_decode_attn\b"),) * 2,
    "verify_argmax": (re.compile(r"\bverify_(partial|reduce)\b"),
                      re.compile(r"\bverify_partial\b")),
    "lora_logits": (re.compile(r"\blora_(down|main)\b"), re.compile(r"\blora_main\b")),
    "ssd_scan": (re.compile(r"\bssd_chunks\b"),) * 2,
}


# the __global__ function each kernel launches once a call, as its mangled
# name spells it (length, then the name)
ONCE = {"decode_attention": "decode_attn", "paged_decode_attention": "paged_decode_attn",
        "verify_argmax": "verify_partial", "lora_logits": "lora_main", "ssd_scan": "ssd_chunks"}


def check_census(n: int, label: str, g: dict) -> None:
    """Each captured graph holds, by libcuda's count of its kernel
    nodes, as many launches of each port kernel as its capture recorded:
    the launches each of its replays adds to ``ops.launches``."""
    for recorded, kernel_nodes in g["per_graph"]:
        nodes = {kernel: sum(c for name, c in kernel_nodes.items() if f"{len(fn)}{fn}" in name)
                 for kernel, fn in ONCE.items()}
        phase(n, f"{label}: a graph of {sum(kernel_nodes.values())} kernel nodes holds "
                 f"{nodes} of the port's kernels; its capture recorded {recorded}")
        check(nodes == recorded, f"{label}: a graph's kernel nodes {nodes} disagree with the "
                                 f"launches its capture recorded {recorded}")


def covered_ms(spans) -> float:
    """The time (ms) that a set of (start, end) spans in us covers, each
    instant once: kernels that overlap on the card (a programmatic
    dependent launch beside its primary) are not counted twice."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_events(prof) -> list:
    """(name, start us, end us) of each device activity of a finished
    torch.profiler run, read from its Kineto records: the profiler's own
    FunctionEvents (``prof.events()``) take tens of microseconds an event
    to build on the host, minutes for a mamba2 path's million launches."""
    evs = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    base = min((t for _, t, _ in evs), default=0)
    return [(name, (t - base) / 1e3, (t - base + d) / 1e3) for name, t, d in evs]


def profile_batch(eng, reqs, wall_ms: float, n: int = 4, expect: dict = None,
                  per_call: dict = None) -> dict:
    """The same requests once more under torch.profiler (device activity
    only): device time by kernel and in all, the latter as the time some
    kernel ran (``covered_ms``).  The run repeats the timed run's work, so
    the device's busy share is its device time over the timed run's
    (unprofiled) wall time `wall_ms`.  `expect` maps a kernel's
    name to the per-launch device ms that phase 3 predicts for this path;
    the profile's per-launch and per-block-step times are printed beside it,
    with each of its __global__ functions' share, and its launches must
    equal what ``ops.launches`` counted over the run (under graph replay:
    the launches each capture recorded, once a replay), less at most 10 %
    lost to dropped records; `per_call` maps a
    kernel to its launches in one call of the path (``ssd_scan``: one per
    layer in a prefill call), whose time is printed too.  Returns the busy
    share, device ms and device launches per block-step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    steps0 = eng.stats["steps"]
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    counted = dict(ops.launches)
    by_name: dict = {}
    spans: dict = {}                   # name -> [(start us, end us)]
    for name, t0, t1 in device_events(prof):
        ms, k = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e3, k + 1)
        spans.setdefault(name, []).append((t0, t1))
    busy = covered_ms([s for v in spans.values() for s in v])
    check(busy > 0.0, "profile: the profiler saw no device time")
    ours = covered_ms([s for name, v in spans.items() if any(k in name for k in PORT_KERNELS)
                       for s in v])
    gemm = covered_ms([s for name, v in spans.items()
                       if any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass"))
                       for s in v])
    steps = eng.stats["steps"] - steps0
    launches = sum(k for _, k in by_name.values())
    phase(n, f"profile of the same requests again ({steps} block-steps): device busy "
             f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}% of the timed run's wall "
             f"{wall_ms:.1f} ms; port kernels {ours:.1f} ms, GEMMs {gemm:.1f} ms, other "
             f"{busy - ours - gemm:.1f} ms; {launches} device launches "
             f"({launches / max(steps, 1):.0f} per block-step)")
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        phase(n, f"  {ms:9.3f} ms {k:6d}x  {name[:90]}")
    seen = {}
    for kernel, want in (expect or {}).items():
        every, once = KERNEL_NAMES[kernel]
        hits = {name: v for name, v in by_name.items() if every.search(name)}
        ms = covered_ms([s for name in hits for s in spans[name]])
        k = sum(v[1] for name, v in hits.items() if once.search(name))
        per = ms / k if k else float("nan")
        parts = "; ".join(f"{every.search(name).group(0)} {v[0] / max(v[1], 1) * 1e3:.2f} us "
                          f"a launch" for name, v in sorted(hits.items()))
        phase(n, f"  {kernel}: {k} launches, {ms:.3f} ms, {per * 1e3:.2f} us a launch on the "
                 f"path ({parts}); phase 3 device time at this path's mix {want * 1e3:.2f} us "
                 f"(profile / phase 3 = {per / want:.2f}), "
                 f"{ms / max(steps, 1):.3f} ms per block-step"
                 + (f", {per * per_call[kernel]:.3f} ms per call of {per_call[kernel]} "
                    f"launches" if kernel in (per_call or {}) else ""))
        seen[kernel] = k
    # under graph replay the profiler loses runs of records (up to 1.2 % of
    # a run's, 15 of 1280 decode_attention launches, once): it must see at
    # least 90 % of each kernel's launches and never more than were counted
    missed = {name: counted[name] - k for name, k in seen.items()}
    phase(n, f"  launches the profiler saw {seen}, ops.launches counted "
             f"{ {name: counted[name] for name in seen} }: records missed {missed}")
    check(all(0 <= m <= counted[name] // 10 for name, m in missed.items()),
          f"the profiler's launch counts {seen} disagree with ops.launches {counted}")
    return dict(busy=busy / wall_ms, device_ms=busy / max(steps, 1),
                launches=launches / max(steps, 1))


def check_fast_loader(ops, n: int, label: str) -> None:
    """Every vocab launch since the last reset took the fast loader."""
    paths = {name: dict(v) for name, v in ops.vocab_paths.items()}
    phase(n, f"{label}: vocab kernel launches by loader {paths}")
    check(all(v["element"] == 0 and v["fast"] == ops.launches[name]
              for name, v in paths.items()),
          f"{label}: a vocab kernel on the path left the fast loader")


def path_attention_ms(row, K: int, k: int, L: int) -> float:
    """Phase 3's device ms of one attention launch at a vicuna path's mix:
    per block (K+1) * k draft-feed launches (Tq = 1) and L - k verify
    launches (Tq = K+1)."""
    n_feed, n_verify = (K + 1) * k, L - k
    return (n_feed * row["at_draft_feed"]["ms"] + n_verify * row["ms"]) / (n_feed + n_verify)


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


def serve_checked(eng, reqs, log=None):
    """Serve `reqs` submitted at once.  Every superstep dispatch, every
    drafter update a learning engine dispatches and, with chunked prefill,
    every chunk step (``_advance_prefill``) runs under sync debug mode
    "error" (a synchronising operation inside it raises); the rest of each
    tick runs under "warn", and its synchronising operations are counted
    per tick.  With `log` (a list), each tick appends the block-steps,
    accepted and drafted tokens its harvest counted and the host seconds of
    the updates it dispatched.  Returns (completions, wall s, blocks the
    supersteps ran, syncs per tick)."""
    import warnings
    inner, inner_update = eng._dispatch_superstep, eng._dispatch_update
    iters, update_s = [], []

    def dispatch():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner()
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        iters.append(eng._inflight[0].iters)

    def dispatch_update(*a):
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            inner_update(*a)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        update_s.append(time.perf_counter() - t0)

    eng._dispatch_superstep, eng._dispatch_update = dispatch, dispatch_update
    inner_chunk = eng._advance_prefill

    def advance_prefill():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner_chunk()
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    if eng._chunk:
        eng._advance_prefill = advance_prefill
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    comps, per_tick = [], []
    keys = ("steps", "accepted", "drafted")
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("warn")
        while eng.busy:
            before, n_upd = [eng.stats[k] for k in keys], len(update_s)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                comps.extend(eng.step())
            per_tick.append(sum("synchroniz" in str(w.message) for w in caught))
            if log is not None:
                log.append(dict(zip(keys, (eng.stats[k] - b for k, b in zip(keys, before))),
                                update_s=update_s[n_upd:]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del eng._dispatch_superstep, eng._dispatch_update   # the class's methods; no cycle
        if eng._chunk:
            del eng._advance_prefill
    torch.cuda.synchronize()
    return comps, time.perf_counter() - t0, sum(iters), per_tick


def capped(stream: list, max_new: int) -> list:
    """A generated stream cut at the budget and just after the first EOS (1)."""
    stream = stream[:max_new]
    return stream[:stream.index(1) + 1] if 1 in stream else stream


def ar_alone(model, params, spec, req, memo: dict) -> list:
    """``ar_generate`` of `req`'s prompt alone (B = 1), its generated tokens
    before the budget and EOS cut, kept in `memo` by prompt and budget
    (greedy AR is deterministic): one model's phases share its streams."""
    key = (req.prompt.tobytes(), req.max_new)
    if key not in memo:
        n = len(req.prompt)
        ar = spec.ar_generate(model, params, torch.as_tensor(req.prompt[None], device=DEV),
                              req.max_new)
        memo[key] = ar.tokens[0, n:int(ar.lengths[0])].tolist()
    return memo[key]


def check_against_ar(model, params, spec, reqs, comps, label, n_phase=8, alone=False,
                     same_shape=None, ar_memo=None, witness=None):
    """Each completion against ar_generate on its exact prompt (one AR run
    per prompt length, or per request when `alone`, which prefills each
    prompt by itself as the continuous engine does, its streams kept in
    `ar_memo` when given), EOS 1 and its budget
    applied; a first difference passes at a bf16 near-tie of the AR top-2
    logits, or, where `same_shape(request)` is given, when greedy AR decoded
    at the engine's own row counts gives the completion bit for bit, or,
    where `witness(request, completion)` is given, when it holds."""
    by_uid = {c.uid: c for c in comps}
    check(sorted(by_uid) == sorted(r.uid for r in reqs), f"{label}: missing completions")
    equal, tied, shaped = 0, 0, 0
    groups = ([[r] for r in reqs] if alone else
              [[r for r in reqs if len(r.prompt) == n]
               for n in sorted({len(r.prompt) for r in reqs})])
    for group in groups:
        n = len(group[0].prompt)
        if alone:
            streams_ = [ar_alone(model, params, spec, group[0],
                                 {} if ar_memo is None else ar_memo)]
        else:
            prompts = torch.as_tensor(np.stack([r.prompt for r in group]), device=DEV)
            ar = spec.ar_generate(model, params, prompts, max(r.max_new for r in group))
            streams_ = [ar.tokens[i, n:int(ar.lengths[i])].tolist() for i in range(len(group))]
        for i, r in enumerate(group):
            stream = capped(streams_[i], r.max_new)
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
            phase(n_phase, f"{label}: request {r.uid} first differs from AR at generated token "
                     f"{p}, AR top-2 logits {t1:.4f} / {t2:.4f}, gap {t1 - t2:.4e}")
            if t1 - t2 <= GAP_RTOL * max(abs(t1), 1.0):
                tied += 1
                continue
            if witness is not None:
                check(witness(r, got), f"{label}: request {r.uid} differs from AR outside a "
                                       f"bf16 near-tie and its witness does not hold")
                shaped += 1
                continue
            check(same_shape is not None,
                  f"{label}: request {r.uid} differs from AR outside a bf16 near-tie")
            exact = same_shape(r) == got
            phase(n_phase, f"{label}: request {r.uid}: greedy AR decoded at the engine's row "
                           f"counts gives the completion bit for bit: {exact}")
            check(exact, f"{label}: request {r.uid} differs from AR outside a bf16 near-tie "
                         f"and from AR at the engine's row counts")
            shaped += 1
    phase(n_phase, f"{label}: {equal} of {len(reqs)} completions equal their AR stream; {tied} "
             f"differ only at a bf16 near-tie (rtol {GAP_RTOL})"
             + (f"; {shaped} differ beyond one and equal AR at the engine's row counts"
                if same_shape is not None else "")
             + (f"; {shaped} differ beyond one and pass their witness"
                if witness is not None else ""))


# ---------------------------------------------------------------------------
# eager and graphed runs of a path (phases 4, 8 and 9)
# ---------------------------------------------------------------------------

# every path runs twice: replaying its block-step from CUDA graphs (the
# engine's default, the main path) and eagerly (graphs=False), which the
# graphed streams must equal bit for bit
MODES = (("eager", False), ("graphed", True))


def streams(comps) -> dict:
    return {c.uid: c.gen_tokens.tolist() for c in comps}


def release(run: dict) -> None:
    """Drop a run's engine (its static caches and graphs) and give its
    memory back, so the next run's peak is its own."""
    run.pop("eng", None)
    gc.collect()                       # an engine may sit in a reference cycle
    torch.cuda.empty_cache()


def finish_run(eng, n, label, comps, wall, g0, prefills=None) -> dict:
    """A timed run's figures: completions, wall s, launch counts, block-steps
    and counts, peak memory since the last reset, graph replays in the run
    and the engine's graph figures."""
    from repro_torch.kernels import ops
    check_fast_loader(ops, n, label)
    g, st = eng.graph_stats(), eng.stats
    return dict(eng=eng, comps=comps, wall=wall, launches=dict(ops.launches),
                steps=st["steps"], blocks=st["blocks"], committed=st["committed"],
                drafted=st["drafted"], dispatches=st["dispatches"], host_syncs=st["host_syncs"],
                peak=torch.cuda.max_memory_allocated(),
                peak_reserved=torch.cuda.max_memory_reserved(),
                replays=g["replays"] - g0["replays"], graph=g,
                prefills=None if prefills is None else prefills[0])


def reset_counts(prefills=None) -> None:
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    if prefills is not None:
        prefills[0] = 0


def frozen(model, dvi):
    """A trainer state around the fixed drafter `dvi`: phases 4, 8 and 9
    serve with learn=False."""
    from repro_torch.core import online
    return online.init_trainer(model, dvi_params=dvi)


def sync_run(model, params, dvi, reqs, graphs_on: bool, n: int, label: str,
             prefills=None, state=None, **kw) -> dict:
    """A sync engine with graphs on or off: its graphs captured for the
    requests' buckets (``warmup``) and one warm-up batch, then `reqs` timed.
    The drafter `dvi` is frozen, unless a learning trainer `state` is given
    (with ``learn=True`` in `kw`)."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(model, params, state or frozen(model, dvi), batch_size=N_REQUESTS,
                        max_new=MAX_NEW, graphs=graphs_on, **dict(dict(learn=False), **kw))
    eng.warmup(buckets=sorted({eng._bucket(len(r.prompt)) for r in reqs}))
    eng.submit_request(reqs[0])                  # warm-up batch, not counted
    eng.run()
    eng.reset_stats()
    for r in reqs:
        eng.submit_request(r)
    reset_counts(prefills)
    g0 = eng.graph_stats()
    t0 = time.perf_counter()
    comps = eng.run()
    torch.cuda.synchronize()
    return finish_run(eng, n, label, comps, time.perf_counter() - t0, g0, prefills)


def continuous_engine(model, params, dvi, pages: int, graphs_on: bool, state=None, **kw):
    """A continuous engine (8 lanes, supersteps of 4 blocks; paged over
    `pages` pages, or contiguous with 0), its graph captured.  The drafter
    `dvi` is frozen, unless a learning trainer `state` is given (with
    ``learn=True`` in `kw`)."""
    from repro_torch.serving.engine import ServingEngine
    kw = dict(dict(learn=False), **kw)
    eng = ServingEngine(model, params, state or frozen(model, dvi), scheduler="continuous",
                        num_slots=C_SLOTS, max_new=MAX_NEW, kv_pages=pages,
                        kv_page_size=C_PAGE, sync_every=C_SYNC, graphs=graphs_on, **kw)
    eng.warmup()
    return eng


TICK_PHASES = ("pre_admit", "harvest", "sync_wait", "sweep_cancels", "grow_pages", "admit",
               "prefill_chunk", "dispatch")


def tick_phases(model, params, dvi, reqs, pages: int, n: int, label: str, **kw) -> dict:
    """The graphed continuous path once more with the engine's lifecycle
    tracer on (``telemetry=True``; `kw` to the engine): host ms per
    block-step in each phase of a tick, from the tracer's spans on the
    engine's track.  ``sync_wait`` is the harvest's wait for the device,
    inside ``harvest``; ``admit`` and ``pre_admit`` hold the admissions'
    eager prefills (with chunked prefill: of the first chunk),
    ``prefill_chunk`` the chunk steps' uploads and replays, ``dispatch`` the
    superstep's.  Also the host ms of one admission, from the lanes'
    ``admit`` spans.  Returns {phase: ms per block-step, "admission": ms,
    "admissions": count}."""
    eng = continuous_engine(model, params, dvi, pages, True, telemetry=True, **kw)
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = max(eng.stats["steps"], 1)
    tid = eng.telem.tid_engine
    ms = {name: 0.0 for name in ("tick",) + TICK_PHASES}
    admits = []
    for ev in eng.trace_dict()["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("tid") == tid and ev["name"] in ms:
            ms[ev["name"]] += ev["dur"] / 1e3 / steps
        elif ev.get("ph") == "X" and str(ev.get("name", "")).startswith("admit u"):
            admits.append(ev["dur"] / 1e3)
    phase(n, f"{label}, graphed, traced again: wall {1e3 * wall / steps:.2f} ms a block-step "
             f"({steps} block-steps); host ms a block-step by tick phase: "
             + ", ".join(f"{name} {v:.2f}" for name, v in ms.items())
             + f"; outside ticks {1e3 * wall / steps - ms['tick']:.2f}; {len(admits)} "
             f"admissions, {np.mean(admits) if admits else 0.0:.2f} host ms each")
    ms.update(admission=float(np.mean(admits)) if admits else 0.0, admissions=len(admits))
    del eng
    release({})
    return ms


def continuous_run(model, params, dvi, reqs, graphs_on: bool, pages: int, n: int,
                   label: str, prefills=None, **kw) -> dict:
    """A continuous engine (`kw` to it) with graphs on or off and one
    warm-up request, then `reqs` served at once under ``serve_checked``'s
    zero-sync gate.  With ``prefill_chunk`` it adds the chunk figures, the
    chunk step's replays in the run and the preemptions of mid-prefill
    lanes."""
    eng = continuous_engine(model, params, dvi, pages, graphs_on, **kw)
    eng.submit_request(reqs[0])                  # warm-up, not counted
    eng.run()
    eng.reset_stats()
    reset_counts(prefills)
    g0 = eng.graph_stats()
    step = eng._runner.chunk_step
    c0 = step.replays if step is not None else 0
    mid = mid_prefill_preemptions(eng)
    try:
        comps, wall, blocks_run, per_tick = serve_checked(eng, reqs)
    finally:
        del eng._preempt                         # the class's method; no cycle
    run = finish_run(eng, n, label, comps, wall, g0, prefills)
    run.update(blocks_run=blocks_run, per_tick=per_tick, ticks=eng.tick_percentiles())
    if eng._chunk:
        run.update(chunk_figures(eng), chunk_replays=step.replays - c0, mid=sum(mid),
                   kv=eng.kv_stats() if eng.paged else {})
    return run


def report_modes(n: int, label: str, runs: dict) -> None:
    """The eager and graphed runs of a path side by side, and the gate that
    the graphed streams equal the eager ones bit for bit.  Host launches per
    block-step: the device launches the profile saw (eager: each one a
    kernel launch from the host), or the graph replays (graphed)."""
    for mode, r in runs.items():
        steps, g, p = max(r["steps"], 1), r["graph"], r["profile"]
        if p is None:
            dev = "device busy not profiled"
            host = "every kernel launched from the host"
        else:
            dev = (f"device busy {100 * p['busy']:.1f}% ({p['device_ms']:.2f} ms and "
                   f"{p['launches']:.0f} device launches a block-step)")
            host = (f"{p['launches']:.0f} kernel launches" if mode == "eager" else
                    f"{r['replays'] / steps:.3f} graph replays ({r['replays']} in the run)")
        phase(n, f"{label}, {mode}: wall per block-step {1e3 * r['wall'] / steps:.2f} ms "
                 f"({r['steps']} block-steps in {r['wall']:.3f} s), "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, {dev}, host launches "
                 f"per block-step: {host}; "
                 f"{g['captures']} captures in {g['capture_s']:.2f} s (instantiate "
                 f"{g['instantiate_s']:.3f} s), graph nodes {g['nodes']}, graph pool "
                 f"{g['pool_bytes'] / 2**30:.3f} GiB, replay() "
                 f"{1e6 * g['replay_host_s'] / max(g['replays'], 1):.1f} us on the host; peak "
                 f"memory {r['peak'] / 2**30:.2f} GiB allocated, "
                 f"{r['peak_reserved'] / 2**30:.2f} GiB reserved")
    check_census(n, f"{label}, graphed", runs["graphed"]["graph"])
    eager, graphed = streams(runs["eager"]["comps"]), streams(runs["graphed"]["comps"])
    phase(n, f"{label}: graphed streams bit-identical to eager ones: {eager == graphed} "
             f"({len(graphed)} completions)")
    check(eager == graphed and len(graphed) > 0,
          f"{label}: graphed streams differ from eager ones")


def continuous_phase(cfg, model, params, dvi, paged_row, vocab_rows):
    """Phase 8.  Returns the graphed and the eager ample-pool runs' launch
    counts and the graphed run's busy share."""
    from repro_torch.core import spec
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)
    expect = {"paged_decode_attention": path_attention_ms(paged_row, K, k, L),
              "verify_argmax": vocab_rows["verify_argmax"]["ms"],
              "lora_logits": vocab_rows["lora_logits"]["ms"]}
    runs = {}
    for mode, on in MODES:
        r = runs[mode] = continuous_run(model, params, dvi, reqs, on, C_PAGES_AMPLE, 8,
                                        f"continuous {mode}")
        eng, blocks_run = r["eng"], r["blocks_run"]
        kv = eng.kv_stats()
        phase(8, f"{mode}, ample pool ({C_PAGES_AMPLE} pages of {C_PAGE}, MPS {eng._mps}): "
                 f"{len(r['comps'])} requests in {r['wall']:.3f} s, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, MAT "
                 f"{r['committed'] / max(r['blocks'], 1):.4f}, {r['dispatches']} dispatches, "
                 f"{r['host_syncs']} host syncs, {blocks_run} blocks run ({r['steps']} with a "
                 f"live lane), peak {kv['peak_used_pages']} pages, {kv['preemptions']} "
                 f"preemptions, used pages at the end {kv['used_pages']}, peak memory "
                 f"{r['peak'] / 2**30:.2f} GiB")
        phase(8, f"{mode}: synchronising operations per tick: {r['per_tick']} (0 inside every "
                 f"dispatch: sync debug mode 'error')")
        check(kv["used_pages"] == 0, "pages left in use after the ample run")
        check(r["host_syncs"] == r["dispatches"], "host syncs != dispatches")
        want = {"paged_decode_attention": ((K + 1) * k + (L - k)) * blocks_run,
                "lora_logits": (K + 1) * blocks_run, "verify_argmax": blocks_run,
                "decode_attention": 0, "ssd_scan": 0}
        phase(8, f"{mode}: launches over {blocks_run} blocks: {r['launches']}; expected {want}")
        check(r["launches"] == want,
              "the continuous path did not run the kernels as the formula says")
        r["profile"] = profile_batch(eng, reqs, r["wall"] * 1e3, n=8, expect=expect)
        release(r)
    report_modes(8, "vicuna-7b continuous, ample pool", runs)
    runs["graphed"]["ticks_host"] = tick_phases(model, params, dvi, reqs, C_PAGES_AMPLE, 8,
                                                "vicuna-7b continuous, ample pool")
    check_against_ar(model, params, spec, reqs, runs["graphed"]["comps"], "ample pool")

    # the tight pool: searched with graphed engines, then served eagerly at
    # the size found
    pages = C_PAGES_TIGHT
    while True:
        eng = continuous_engine(model, params, dvi, pages, True)
        comps_t, wall_t, _, per_tick_t = serve_checked(eng, reqs)
        kv_t = eng.kv_stats()
        phase(8, f"graphed, tight pool of {pages} pages: {len(comps_t)} requests in "
                 f"{wall_t:.3f} s, {kv_t['preemptions']} preemptions, peak "
                 f"{kv_t['peak_used_pages']} pages, used pages at the end "
                 f"{kv_t['used_pages']}, syncs per tick max {max(per_tick_t)}")
        check(kv_t["used_pages"] == 0, "pages left in use after the tight run")
        if kv_t["preemptions"] >= 1 or pages <= eng._mps:
            break
        # halve while that stays at 24 or more, then one page at a time: the
        # pre-admission reserve makes preemption need a pool that holds two
        # lanes only just (about 20-24 pages of 16 here at MAT 1)
        pages = pages // 2 if pages // 2 >= 24 else pages - 1
        del eng
        release({})
    check(kv_t["preemptions"] >= 1, "the tight pool never preempted")
    del eng
    release({})
    eng = continuous_engine(model, params, dvi, pages, False)
    comps_e, wall_e, _, per_tick_e = serve_checked(eng, reqs)
    kv_e = eng.kv_stats()
    phase(8, f"eager, tight pool of {pages} pages: {len(comps_e)} requests in {wall_e:.3f} s, "
             f"{kv_e['preemptions']} preemptions, used pages at the end {kv_e['used_pages']}, "
             f"syncs per tick max {max(per_tick_e)}")
    check(kv_e["used_pages"] == 0 and kv_e["preemptions"] >= 1,
          "the eager tight run left pages in use or never preempted")
    same = streams(comps_t) == streams(comps_e)
    phase(8, f"tight pool used: kv_pages={pages}; graphed streams bit-identical to eager "
             f"ones: {same}")
    check(same, "tight pool: graphed streams differ from eager ones")
    del eng
    release({})
    check_against_ar(model, params, spec, reqs, comps_t, f"tight pool ({pages} pages)")
    runs["graphed"]["tight_pages"] = pages
    return runs["graphed"]["launches"], runs["eager"]["launches"], runs["graphed"]


# ---------------------------------------------------------------------------
# phase 10: the Improve loop on vicuna-7b
# ---------------------------------------------------------------------------

def learn_state(model):
    """The drafter's trainer state drawn from the seed (B = 0: the drafter
    starts as the verifier head read at layer k), an empty 4096-slot ring."""
    from repro_torch.core import online
    return online.init_trainer(model, torch.Generator(device=DEV).manual_seed(SEED))


def drafter_tensors(state) -> dict:
    """A copy of every tensor of the drafter's state that an update writes."""
    return {k: t.clone() for k, t in (
        ("A", state.dvi_params["A"]), ("B", state.dvi_params["B"]),
        *((f"{m}/{k}", t) for m in ("m", "v") for k, t in state.opt_state[m].items()),
        ("opt_step", state.opt_state["step"]), ("baseline", state.baseline),
        ("step", state.step))}


def record_updates(eng) -> list:
    """Keep every update's metrics (device scalars) as the engine runs it."""
    seen, inner = [], eng._update_fn

    def update(*a, **kw):
        seen.append(inner(*a, **kw))
        return seen[-1]

    eng._update_fn = update
    return seen


def update_report(metrics: list) -> str:
    keys = (("loss", "loss"), ("kl", "KL"), ("l_ce", "CE"), ("entropy", "entropy"),
            ("gnorm", "gnorm"), ("acc_rate", "batch acceptance"))
    return "; ".join(f"{label} first {float(metrics[0][k]):.4f} last {float(metrics[-1][k]):.4f}"
                     for k, label in keys)


def quarter_acceptance(log: list) -> tuple:
    """Acceptance (accepted / drafted) over the first and the last quarter
    of the block-steps, from serve_checked's per-tick log."""
    total = sum(t["steps"] for t in log)
    first, last, seen = [0, 0], [0, 0], 0
    for t in log:
        for q, inside in ((first, seen < total / 4), (last, seen >= 3 * total / 4)):
            if inside:
                q[0] += t["accepted"]
                q[1] += t["drafted"]
        seen += t["steps"]
    return first[0] / max(first[1], 1), last[0] / max(last[1], 1)


def cadence(log: list, since: int, update_every: int) -> int:
    """The reference engine's update count, counted on the host from the
    block-steps each harvest saw: an update once `update_every` of them ran
    since the last and the buffer holds tuples (after any live block)."""
    updates, seen = 0, 0
    for t in log:
        since += t["steps"]
        seen += t["steps"]
        if since >= update_every and seen > 0:
            since, updates = 0, updates + 1
    return updates


def update_device_ms(eng) -> float:
    """The device time of one update (``time_ms``: L2 flushed, enqueue
    hidden behind a spin) on a copy of the engine's trainer state after its
    run (a full ring), writing into staging tensors as the engine does."""
    from repro_torch.core import online
    st = eng.state
    copy = online.OnlineTrainerState(
        {k: v.clone() for k, v in st.dvi_params.items()},
        {"m": {k: v.clone() for k, v in st.opt_state["m"].items()},
         "v": {k: v.clone() for k, v in st.opt_state["v"].items()},
         "step": st.opt_state["step"].clone()},
        {k: v.clone() for k, v in st.buf.items()}, st.baseline.clone(), st.step.clone())
    staging = {k: torch.empty_like(v) for k, v in copy.dvi_params.items()}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    ms, _ = time_ms(lambda: eng._update_fn(eng.params, copy, gen, out=staging), iters=10)
    return ms


def learn_continuous(cfg, model, params, reqs, base: dict) -> dict:
    """Phase 10, continuous: phase 8's ample pool and requests with
    learn=True, eagerly and graphed, each from the same seeded trainer state
    and after one warm-up request (which learns too).  Returns the launches
    by mode."""
    from repro_torch.core import graphs
    from repro_torch.kernels import ops
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    runs = {}
    for mode, on in MODES:
        state = learn_state(model)
        ptrs = graphs.drafter_ptrs(state.dvi_params)
        eng = continuous_engine(model, params, None, C_PAGES_AMPLE, on, state=state, learn=True,
                                update_every=L_UPDATE_EVERY, lr=L_LR, mode=L_MODE)
        eng.submit_request(reqs[0])                  # warm-up, not counted
        eng.run()
        eng.reset_stats()
        reset_counts()
        since, step0 = eng._blocks_since_update, int(state.step)
        metrics, log = record_updates(eng), []
        g0 = eng.graph_stats()
        comps, wall, blocks_run, per_tick = serve_checked(eng, reqs, log=log)
        r = runs[mode] = finish_run(eng, 10, f"learning continuous {mode}", comps, wall, g0)
        st = eng.stats
        n_upd = st["updates"]
        want = {"paged_decode_attention": ((K + 1) * k + (L - k)) * blocks_run,
                "lora_logits": (K + 1) * blocks_run + 2 * n_upd, "verify_argmax": blocks_run,
                "decode_attention": 0, "ssd_scan": 0}
        host_s = [s for t in log for s in t["update_s"]]
        q1, q4 = quarter_acceptance(log)
        tt = eng.train_telemetry()
        gauges = {name: v["value"] for name, v in eng.metrics_snapshot().items()
                  if name.startswith("dvi_train_") and v.get("type") == "gauge"}
        phase(10, f"continuous {mode}: {len(comps)} requests in {wall:.3f} s, {st['steps']} "
                  f"block-steps, {blocks_run} blocks run, {n_upd} updates (the reference's "
                  f"cadence counted on the host: {cadence(log, since, L_UPDATE_EVERY)}), "
                  f"{st['dispatches']} dispatches, {st['host_syncs']} host syncs, MAT "
                  f"{st['committed'] / max(st['blocks'], 1):.4f}, acceptance first quarter "
                  f"{q1:.4f} last quarter {q4:.4f}; update host ms "
                  f"{1e3 * np.mean(host_s):.2f} (max {1e3 * max(host_s):.2f}); "
                  f"peak memory {r['peak'] / 2**30:.2f} GiB")
        phase(10, f"continuous {mode}: {update_report(metrics)}")
        phase(10, f"continuous {mode}: launches {r['launches']}; expected {want}; syncs per "
                  f"tick {per_tick} (0 inside every superstep and update dispatch)")
        check(r["launches"] == want, "the learning continuous path did not run the kernels "
                                     "as the formula says")
        check(n_upd == cadence(log, since, L_UPDATE_EVERY) > 0,
              "the updates do not follow the reference's cadence")
        check(st["host_syncs"] == st["dispatches"], "host syncs != dispatches")
        check(eng.kv_stats()["used_pages"] == 0, "pages left in use after the learning run")
        check(graphs.drafter_ptrs(state.dvi_params) == ptrs, "A or B moved")
        check(tt["step"] == int(state.step) == step0 + n_upd and tt["updates"] == n_upd,
              "the train telemetry's step disagrees with the updates")
        check(len(gauges) >= 12 and all(np.isfinite(v) for v in gauges.values()),
              f"a dvi_train_* gauge is not finite: {gauges}")
        r.update(blocks_run=blocks_run, metrics=metrics, state=drafter_tensors(state),
                 update_host_ms=1e3 * float(np.mean(host_s)), q=(q1, q4))
        if mode == "graphed":
            check_census(10, "learning continuous, graphed", r["graph"])
            r["update_ms"] = update_device_ms(eng)
            r["profile"] = profile_batch(eng, reqs, wall * 1e3, n=10)
        release(r)
    eager, graphed = runs["eager"], runs["graphed"]
    same = streams(eager["comps"]) == streams(graphed["comps"])
    same_state = all(torch.equal(graphed["state"][k], v) for k, v in eager["state"].items())
    phase(10, f"continuous: graphed streams bit-identical to eager ones: {same}; final drafter "
              f"state (A, B, m, v, baseline, steps) bit-identical: {same_state}")
    check(same and same_state, "learning continuous: graphed differs from eager")
    g, steps = graphed, max(graphed["steps"], 1)
    phase(10, f"continuous graphed, learning against phase 8's frozen drafter: wall per "
              f"block-step {1e3 * g['wall'] / steps:.2f} ms against "
              f"{1e3 * base['wall'] / max(base['steps'], 1):.2f}, device ms a block-step "
              f"{g['profile']['device_ms']:.2f} against {base['profile']['device_ms']:.2f}, "
              f"busy {100 * g['profile']['busy']:.1f}% against "
              f"{100 * base['profile']['busy']:.1f}%, {g['committed'] / g['wall']:.1f} "
              f"committed tokens/s against {base['committed'] / base['wall']:.1f}; an update: "
              f"{g['update_ms']:.3f} device ms (time_ms), {g['update_host_ms']:.2f} host ms")
    return runs


def learn_sync(cfg, model, params, reqs, base: dict) -> dict:
    """Phase 10, sync: phase 4's requests with learn=True and one update a
    batch, eagerly and graphed, each from the same seeded trainer state; the
    updates run under sync debug mode "error".  Returns the runs."""
    from repro_torch.core import graphs
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    runs = {}
    for mode, on in MODES:
        state = learn_state(model)
        ptrs = graphs.drafter_ptrs(state.dvi_params)
        r = runs[mode] = sync_run(model, params, None, reqs, on, 10, f"learning sync {mode}",
                                  state=state, learn=True, updates_per_batch=1, lr=L_LR,
                                  mode=L_MODE)
        eng, n, n_upd = r["eng"], r["steps"], r["eng"].stats["updates"]
        want = {"decode_attention": ((K + 1) * k + (L - k)) * n,
                "lora_logits": (K + 1) * n + 2 * n_upd, "verify_argmax": n,
                "paged_decode_attention": 0, "ssd_scan": 0}
        phase(10, f"sync {mode}: {len(r['comps'])} requests in {n} block-steps, {n_upd} "
                  f"updates, wall {r['wall']:.3f} s, {r['committed'] / r['wall']:.1f} committed "
                  f"tokens/s, acceptance {eng.acceptance:.4f}; launches {r['launches']}; "
                  f"expected {want}")
        check(r["launches"] == want and n_upd == 1, "the learning sync path did not run the "
                                                    "kernels as the formula says")
        check(graphs.drafter_ptrs(state.dvi_params) == ptrs, "A or B moved")
        # one more update on the same engine, under sync debug mode "error"
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._drafter_update(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        r["state"] = drafter_tensors(state)
        release(r)
    eager, graphed = runs["eager"], runs["graphed"]
    same = streams(eager["comps"]) == streams(graphed["comps"])
    same_state = all(torch.equal(graphed["state"][k], v) for k, v in eager["state"].items())
    phase(10, f"sync: graphed streams bit-identical to eager ones: {same}; final drafter state "
              f"bit-identical: {same_state}; an extra update ran with 0 syncs (mode 'error'); "
              f"wall per block-step {1e3 * graphed['wall'] / max(graphed['steps'], 1):.2f} ms "
              f"against phase 4's {1e3 * base['wall'] / max(base['steps'], 1):.2f}")
    check(same and same_state, "learning sync: graphed differs from eager")
    return runs


def against_frozen(model, params, spec, reqs, comps, frozen_comps, label, padded=None,
                   n_phase=10, what="the frozen drafter's", **ar_kw) -> int:
    """Each learning completion equals the frozen drafter's (greedy
    decoding is lossless whatever the drafter); where one does not, it must
    pass ``check_against_ar`` (AR on the prompt the engine decoded, the
    near-tie rule; `ar_kw` to it).  `frozen_comps` may be any run already
    held against AR (`what` names it).  Returns how many were equal."""
    want = streams(frozen_comps)
    differ = [r for r in reqs if streams([c for c in comps if c.uid == r.uid])[r.uid]
              != want[r.uid]]
    phase(n_phase, f"{label}: {len(reqs) - len(differ)} of {len(reqs)} completions equal "
                   f"{what}; {len(differ)} go to the AR check")
    if differ:
        uids = {r.uid for r in differ}
        check_against_ar(model, params, spec, [(padded or {}).get(r.uid, r) for r in differ],
                         [c for c in comps if c.uid in uids], label, n_phase=n_phase, **ar_kw)
    return len(reqs) - len(differ)


# ---------------------------------------------------------------------------
# phase 12: speculative sampling and adaptive depth on vicuna-7b
# ---------------------------------------------------------------------------

def pad_prompt(req, bucket: int) -> np.ndarray:
    """The sync engine's padding: the prompt's last `bucket` tokens, left
    padded by repeating its first."""
    p = req.prompt[-bucket:]
    return np.concatenate([np.full(bucket - len(p), p[0], p.dtype), p]) if len(p) < bucket else p


def sampled_phase(cfg, model, params, dvi, reqs) -> dict:
    """Phase 12a: ``speculative_generate`` at temperature S_TEMP on phase 4's
    8 requests (padded to 128), from a generator seeded from SEED; one
    sampled block under sync debug mode "error"; a sampled and a greedy
    block's device time on the same cache; ``rejection_commit`` alone over
    S_TV_LANES lanes at V = S_TV_V.  Returns the launches and figures."""
    from repro_torch.core import spec
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    K, k, L, V = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers, cfg.vocab_size
    Tp = 128
    prompts = torch.as_tensor(np.stack([pad_prompt(r, Tp) for r in reqs]), device=DEV)

    def run(seed, collect=False):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return spec.speculative_generate(model, params, dvi, prompts, MAX_NEW,
                                         temperature=S_TEMP, generator=gen, collect=collect)

    reset_counts()
    t0 = time.perf_counter()
    res = run(SEED, collect=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, n = dict(ops.launches), res.steps
    want = {"decode_attention": ((K + 1) * k + (L - k)) * n, "lora_logits": (K + 1) * n,
            "verify_argmax": 0, "paged_decode_attention": 0, "ssd_scan": 0}
    phase(12, f"sampled speculative_generate (T {S_TEMP}, {N_REQUESTS} lanes, prompts of {Tp}, "
              f"{MAX_NEW} new tokens): {n} blocks in {wall:.3f} s, MAT "
              f"{int(res.committed) / max(int(res.blocks), 1):.4f}, acceptance "
              f"{int(res.accepted_drafts) / max(int(res.drafted), 1):.4f}, "
              f"{int(res.committed) / wall:.1f} committed tokens/s (eager), tuples logged "
              f"{int(res.buffer['count'])}; launches {launches}; expected {want}")
    check(launches == want, "the sampled path did not run the kernels as the formula says")
    toks, lens = res.tokens.cpu(), res.lengths.cpu()
    for b in range(N_REQUESTS):
        gen_b = toks[b, Tp:int(lens[b])]
        check(bool((gen_b >= 0).all()) and bool((gen_b < V).all()),
              f"sampled lane {b}: a token outside the vocabulary")
        check(Tp + MAX_NEW <= int(lens[b]) <= Tp + MAX_NEW + K or 1 in gen_b.tolist(),
              f"sampled lane {b}: length {int(lens[b])} for {MAX_NEW} new tokens")
    check(int(res.buffer["count"]) > 0, "the sampled path logged no tuples")
    again, other = run(SEED), run(SEED + 1)
    same = torch.equal(again.tokens, res.tokens) and torch.equal(again.lengths, res.lengths)
    differ = not torch.equal(other.tokens, res.tokens)
    phase(12, f"the same seed gives the same streams bit for bit: {same}; another seed changes "
              f"them: {differ}")
    check(same and differ, "sampling is not reproducible from its seed, or ignores it")

    # one sampled block with no synchronising operation
    _, cache = model.prefill(params, prompts[:, :-1],
                             max_len=Tp + MAX_NEW + K + 2 + tfm.RING_SLACK)
    pend = prompts[:, -1].to(torch.int32)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spec.spec_block_step(model, params, dvi, pend, cache, temperature=S_TEMP, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    phase(12, "one sampled spec_block_step under sync debug mode 'error': 0 synchronising "
              "operations")
    # an eager block's 4.4 k launches overflow the launch queue behind
    # time_ms's spin, so the profiler gives its device time
    samp_ms = block_device_ms(lambda: spec.spec_block_step(
        model, params, dvi, pend, cache, temperature=S_TEMP, generator=gen))
    greedy_ms = block_device_ms(lambda: spec.spec_block_step(model, params, dvi, pend, cache))
    phase(12, f"an eager block on the 8 lanes at length {Tp - 1}, device ms (the time some "
              f"kernel ran, torch.profiler, mean of {BLOCK_REPS}): sampled {samp_ms:.3f}, greedy "
              f"{greedy_ms:.3f}; sampled - greedy {samp_ms - greedy_ms:.3f} ms")

    # rejection_commit alone: the emitted token against p
    rng = np.random.RandomState(SEED + 10)
    p = torch.as_tensor(rng.dirichlet(np.full(S_TV_V, 0.5)).astype(np.float32), device=DEV)
    q = torch.as_tensor(rng.dirichlet(np.full(S_TV_V, 0.5)).astype(np.float32), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    counts = torch.zeros(S_TV_V, dtype=torch.float64, device=DEV)
    C = S_TV_CHUNK

    def chunk():
        d = torch.argmax(torch.log(q)[None] + spec.gumbel((C, S_TV_V), gen, DEV), dim=-1)
        d_blk = torch.stack([d, d], dim=1).to(torch.int32)
        m, corr = spec.rejection_commit(d_blk, q.expand(C, 2, S_TV_V), p.expand(C, 2, S_TV_V),
                                        generator=gen)
        return torch.where(m >= 1, d_blk[:, 0], corr)

    for _ in range(S_TV_LANES // C):
        counts += torch.bincount(chunk(), minlength=S_TV_V)
    tv = 0.5 * float((counts / S_TV_LANES - p.double()).abs().sum())
    chunk_ms, _ = time_ms(chunk, iters=5)
    phase(12, f"rejection_commit alone at V={S_TV_V} over {S_TV_LANES} lanes (K = 1, q != p): "
              f"total variation of the emitted token from p {tv:.5f} (limit 0.01); "
              f"{chunk_ms:.3f} device ms a chunk of {C} lanes (draft draw included)")
    check(tv < 0.01, f"rejection_commit: total variation {tv:.5f} from the target")
    return dict(launches=launches, blocks=n, wall=wall, sampled_ms=samp_ms,
                greedy_ms=greedy_ms, tv=tv)


BLOCK_REPS = 5


def block_device_ms(fn) -> float:
    """Device ms of one call of `fn` (an eager block): the time some kernel
    ran (``covered_ms``) over BLOCK_REPS calls under torch.profiler, after
    one call outside it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BLOCK_REPS):
            fn()
        torch.cuda.synchronize()
    busy = covered_ms([(t0, t1) for _, t0, t1 in device_events(prof)])
    check(busy > 0.0, "profile: the profiler saw no device time")
    return busy / BLOCK_REPS


def record_depths(eng, k_min: int) -> dict:
    """Wrap the runner's dispatch and the engine's harvest: each dispatch's
    draft width and blocks, and after each harvest every lane of that
    dispatch's depth against [k_min, its ceiling k_cap].  ``close()`` puts
    the methods back."""
    runner = eng._runner
    rec = dict(dispatches=[], bad=[], last=None)
    inner_d, inner_h = runner.dispatch, eng._harvest

    def dispatch(done, budget, steps, k_blk=None, depth_state=None):
        rec["dispatches"].append((k_blk, steps))
        rec["last"] = (np.array(depth_state[3]), [s for s, st in enumerate(eng._slots)
                                                  if st is not None])
        return inner_d(done, budget, steps, k_blk=k_blk, depth_state=depth_state)

    def harvest():
        last, rec["last"] = rec["last"], None
        outs = inner_h()
        if last is not None:
            kcap, lanes = last
            rec["bad"] += [(s, int(eng._k_host[s]), int(kcap[s])) for s in lanes
                           if not k_min <= int(eng._k_host[s]) <= int(kcap[s])]
        return outs

    def close():
        del runner.dispatch, eng._harvest            # the class's methods; no cycle

    runner.dispatch, eng._harvest = dispatch, harvest
    rec["close"] = close
    return rec


def adaptive_run(model, params, dvi, reqs, pages: int, label: str, floor: int, n: int = 12,
                 **kw) -> dict:
    """A graphed continuous engine with ``adaptive_k`` (its graphs of every
    draft width captured ahead) and one warm-up request, then `reqs` served
    at once under ``serve_checked``'s zero-sync gate, the depths recorded."""
    eng = continuous_engine(model, params, dvi, pages, True, adaptive_k=True, **kw)
    eng.submit_request(reqs[0])                  # warm-up, not counted
    eng.run()
    eng.reset_stats()
    reset_counts()
    g0 = eng.graph_stats()
    chunk = eng._runner.chunk_step
    c0 = chunk.replays if chunk is not None else 0
    rec = record_depths(eng, floor)
    try:
        comps, wall, blocks_run, per_tick = serve_checked(eng, reqs)
    finally:
        rec["close"]()
    run = finish_run(eng, n, label, comps, wall, g0)
    run.update(blocks_run=blocks_run, per_tick=per_tick, dispatch_log=rec["dispatches"],
               bad=rec["bad"], adaptive=eng.adaptive_stats(), kv=eng.kv_stats(),
               chunk_replays=chunk.replays - c0 if chunk is not None else 0)
    return run


def adaptive_phase(cfg, model, params, dvi, base: dict) -> dict:
    """Phase 12b: phase 8's graphed continuous path (ample pool, its 16
    requests) with adaptive depth: pinned at K (== phase 8 bit for bit), the
    default controller (k_min A_KMIN, k_max A_KMAX), and an adversarial
    swing over phase 8's tight pool.  Returns the runs."""
    from repro_torch.core import spec
    from repro_torch.core.schedule import DepthConfig
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)
    runs = {}
    for mode, floor, kw in (("pinned", K, dict(depth_cfg=DepthConfig(k_min=K, k_max=K,
                                                                     k_init=K))),
                            ("controller", A_KMIN, dict(k_min=A_KMIN, k_max=A_KMAX))):
        label = f"adaptive {mode}"
        r = runs[mode] = adaptive_run(model, params, dvi, reqs, C_PAGES_AMPLE, label, floor, **kw)
        widths = sorted({kb for kb, _ in r["dispatch_log"]})
        want = {"paged_decode_attention": sum(n * ((kb + 1) * k + (L - k))
                                              for kb, n in r["dispatch_log"]),
                "lora_logits": sum(n * (kb + 1) for kb, n in r["dispatch_log"]),
                "verify_argmax": r["blocks_run"], "decode_attention": 0, "ssd_scan": 0}
        g, a, kv = r["graph"], r["adaptive"], r["kv"]
        phase(12, f"{label}: {len(r['comps'])} requests in {r['wall']:.3f} s, {r['steps']} "
                  f"block-steps, {r['dispatches']} dispatches, {r['host_syncs']} host syncs, "
                  f"draft widths dispatched {widths}, mean depth {a['mean_depth']:.3f}, draft "
                  f"efficiency {a['draft_efficiency']:.4f}, drafted {r['drafted']}, lanes out of "
                  f"[k_min, k_cap] {r['bad']}, used pages at the end {kv['used_pages']}, "
                  f"captures {g['captures']}, syncs per tick {r['per_tick']} (0 inside every "
                  f"dispatch)")
        phase(12, f"{label}: launches {r['launches']}; expected {want} (per block {k} K_blk + "
                  f"{L} paged_decode_attention, K_blk + 1 lora_logits, 1 verify_argmax)")
        check(r["launches"] == want, f"{label}: the launches disagree with the formula")
        check(not r["bad"], f"{label}: a lane's depth left [k_min, k_cap]")
        check(r["host_syncs"] == r["dispatches"], f"{label}: host syncs != dispatches")
        check(kv["used_pages"] == 0, f"{label}: pages left in use")
        check(g["captures"] <= A_KMAX - A_KMIN + 1, f"{label}: {g['captures']} captures")
        check_census(12, label, g)
        r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=12)
        release(r)
    pin = runs["pinned"]
    same = (streams(pin["comps"]) == streams(base["comps"]) and pin["drafted"] == base["drafted"]
            and pin["blocks"] == base["blocks"])
    phase(12, f"pinned (k_min = k_max = k_init = {K}) == phase 8's graphed run bit for bit "
              f"(streams, drafted {pin['drafted']} / {base['drafted']}, blocks {pin['blocks']} / "
              f"{base['blocks']}): {same}")
    check(same, "pinned adaptive depth differs from fixed K")
    check(len({kb for kb, _ in runs["controller"]["dispatch_log"]}) >= 1
          and runs["controller"]["adaptive"]["mean_depth"] < K,
          "the default controller never lowered the depth")
    against_frozen(model, params, spec, reqs, runs["controller"]["comps"], base["comps"],
                   "adaptive controller", n_phase=12)

    # the adversarial swing: lanes admitted at depth 1 climb every block
    dc = DepthConfig(k_min=1, k_max=K, k_init=1, cooldown=1, hi=0.1, lo=0.05, ema_init=0.9)
    pages = base["tight_pages"]
    while True:
        eng = continuous_engine(model, params, dvi, pages, True, adaptive_k=True, depth_cfg=dc)
        comps, wall, _, per_tick = serve_checked(eng, reqs)
        kv, a = eng.kv_stats(), eng.adaptive_stats()
        phase(12, f"adaptive swing over a tight pool of {pages} pages: {len(comps)} requests in "
                  f"{wall:.3f} s, {kv['preemptions']} preemptions, mean depth "
                  f"{a['mean_depth']:.3f}, used pages at the end {kv['used_pages']}, syncs per "
                  f"tick max {max(per_tick)}")
        check(kv["used_pages"] == 0, "the swing left pages in use")
        check(a["mean_depth"] > 1.0, "the swing never rose above depth 1")
        if kv["preemptions"] >= 1 or pages <= eng._mps:
            break
        pages -= 1
        del eng
        release({})
    check(kv["preemptions"] >= 1, "the swing never preempted")
    del eng
    release({})
    against_frozen(model, params, spec, reqs, comps, base["comps"],
                   f"adaptive swing ({pages} pages)", n_phase=12)
    for mode, r in list(runs.items()) + [("phase 8 fixed K", base)]:
        steps, g, p = max(r["steps"], 1), r["graph"], r["profile"]
        depth = (f"mean depth {r['adaptive']['mean_depth']:.3f}, draft efficiency "
                 f"{r['adaptive']['draft_efficiency']:.4f}" if "adaptive" in r else
                 f"mean depth {r['drafted'] / max(r['blocks'], 1):.3f}, draft efficiency "
                 f"{r['committed'] / max(r['drafted'], 1):.4f}")
        phase(12, f"{mode}: wall per block-step {1e3 * r['wall'] / steps:.2f} ms, device "
                  f"{p['device_ms']:.2f} ms a block-step, busy {100 * p['busy']:.1f}%, "
                  f"{r['committed'] / r['wall']:.1f} committed tokens/s, {depth}, "
                  f"{g['captures']} captures, graph pool {g['pool_bytes'] / 2**30:.3f} GiB, peak "
                  f"memory {r['peak'] / 2**30:.2f} GiB")
    runs["swing_pages"] = pages
    return runs


# ---------------------------------------------------------------------------
# phase 13: chunked prefill in the continuous engine
# ---------------------------------------------------------------------------

def chunked_want(cfg, blocks: int, chunks: int, dispatch_log=None, updates: int = 0) -> dict:
    """The launch formula of a chunked vicuna path: phase 8's per block (or
    12b's at each dispatched draft width), 2 ``lora_logits`` an update, and
    one ``paged_decode_attention`` a layer per chunk step (the first
    chunk's prefill at admission runs no kernel of the port)."""
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    log = dispatch_log or [(K, blocks)]
    return {"paged_decode_attention": sum(n * ((kb + 1) * k + (L - k)) for kb, n in log)
            + L * chunks,
            "lora_logits": sum(n * (kb + 1) for kb, n in log) + 2 * updates,
            "verify_argmax": blocks, "decode_attention": 0, "ssd_scan": 0}


def mid_prefill_preemptions(eng) -> list:
    """Record, per preemption, whether the victim lane was mid-prefill."""
    seen, inner = [], eng._preempt

    def preempt(slot):
        seen.append(eng._slots[slot].pf_pos is not None)
        inner(slot)

    eng._preempt = preempt
    return seen


def chunk_figures(eng) -> dict:
    """A drained chunked engine's chunk counters, its chunk graph's figures,
    its tick percentiles and the lanes it left occupied."""
    step = eng._runner.chunk_step
    return dict(chunks=eng.stats["prefill_chunks"], chunk_tokens=eng.stats["prefill_tokens"],
                max_tick=eng.stats["max_tick_prefill_tokens"], ticks=eng.tick_percentiles(),
                lanes_left=eng.active_slots,
                chunk_graph=dict(nodes=step.nodes, capture_s=step.capture_s,
                                 instantiate_s=step.instantiate_s,
                                 replay_us=1e6 * step.replay_host_s / max(step.replays, 1)))


def chunk_gates(n: int, label: str, r: dict, want: dict, graphed: bool) -> None:
    """The gates every chunked run holds: the launch formula, the chunk
    budget, host syncs == dispatches, the pool or the lanes empty, and
    (graphed) one chunk graph replay a chunk step."""
    phase(n, f"{label}: {len(r['comps'])} requests in {r['wall']:.3f} s, {r['steps']} "
             f"block-steps ({r['blocks_run']} blocks run), {r['dispatches']} dispatches, "
             f"{r['host_syncs']} host syncs, {r['chunks']} chunk steps ({r['chunk_replays']} "
             f"graph replays) of {r['chunk_tokens']} prompt tokens, largest tick "
             f"{r['max_tick']} tokens (budget {C_SLOTS * P_CHUNK}), "
             f"{r['kv'].get('preemptions', 0)} preemptions ({r['mid']} mid-prefill), used "
             f"pages at the end {r['kv'].get('used_pages', 0)}, lanes left {r['lanes_left']}, "
             f"syncs per tick {r['per_tick']} (0 inside every dispatch and chunk step)")
    phase(n, f"{label}: launches {r['launches']}; expected {want}")
    check(r["launches"] == want, f"{label}: the launches disagree with the formula")
    check(r["chunks"] > 0 and 0 < r["max_tick"] <= C_SLOTS * P_CHUNK,
          f"{label}: the chunk budget was not held")
    check(r["host_syncs"] == r["dispatches"], f"{label}: host syncs != dispatches")
    check(r["kv"].get("used_pages", 0) == 0 and r["lanes_left"] == 0,
          f"{label}: pages or lanes left in use")
    check(not graphed or r["chunk_replays"] == r["chunks"],
          f"{label}: chunk steps were not one graph replay each")


def schema_gate(eng, n: int, label: str) -> None:
    """The port's copy of the metrics schema gate
    (``scripts/torch_check_metrics_schema.py``) on the drained engine's
    snapshot and on its Prometheus text."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_check_metrics_schema", os.path.join(ROOT, "scripts",
                                                   "torch_check_metrics_schema.py"))
    chk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chk)
    errs = (chk.check_snapshot(eng.metrics_snapshot(), "snapshot")
            + chk.check_snapshot(chk.parse_prometheus_text(eng.render_prometheus()),
                                 "prometheus"))
    phase(n, f"{label}: scripts/torch_check_metrics_schema.py on the snapshot and the "
             f"Prometheus text: {len(chk.REQUIRED)} required metrics, errors {errs}")
    check(errs == [], f"{label}: the metrics schema gate failed")


def chunked_phase(cfg, model, params, dvi, base: dict, paged_row, vocab_rows) -> dict:
    """Phase 13 (a, b, d) on vicuna-7b: phase 8's continuous path with
    prompts prefilled in chunks of P_CHUNK over the ample pool (graphed and
    eager), a tight pool swung down until a lane is preempted, and the
    ample pool with learning and adaptive depth.  `base` is phase 8's
    graphed ample run.  Returns the runs."""
    from repro_torch.core import graphs, spec
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)
    expect = {"paged_decode_attention": path_attention_ms(paged_row, K, k, L),
              "verify_argmax": vocab_rows["verify_argmax"]["ms"],
              "lora_logits": vocab_rows["lora_logits"]["ms"]}
    runs = {}
    # (a): the ample pool, eager and graphed
    for mode, on in MODES:
        label = f"chunked {mode}, ample pool"
        r = runs[mode] = continuous_run(model, params, dvi, reqs, on, C_PAGES_AMPLE, 13, label,
                                        prefill_chunk=P_CHUNK)
        chunk_gates(13, label, r, chunked_want(cfg, r["blocks_run"], r["chunks"]), on)
        if on:
            schema_gate(r["eng"], 13, label)
            r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=13, expect=expect)
        release(r)
    g, e = runs["graphed"], runs["eager"]
    same = streams(g["comps"]) == streams(e["comps"])
    phase(13, f"chunked, ample pool: graphed streams bit-identical to eager ones: {same} "
              f"({len(g['comps'])} completions)")
    check(same, "chunked: graphed streams differ from eager ones")
    check_census(13, "chunked graphed", g["graph"])
    g["ticks_host"] = tick_phases(model, params, dvi, reqs, C_PAGES_AMPLE, 13,
                                  "vicuna-7b chunked, ample pool", prefill_chunk=P_CHUNK)
    check_against_ar(model, params, spec, reqs, g["comps"], "chunked ample pool", n_phase=13)
    g["equal_one_shot"] = sum(streams(g["comps"])[u] == v for u, v in
                              streams(base["comps"]).items())
    phase(13, f"chunked ample pool: {g['equal_one_shot']} of {len(reqs)} completions equal "
              f"phase 8's one-shot streams")

    # (b): the tight pool, swung down from phase 8's until a lane is preempted
    pages = base["tight_pages"]
    while True:
        eng = continuous_engine(model, params, dvi, pages, True, prefill_chunk=P_CHUNK)
        mid = mid_prefill_preemptions(eng)
        comps_t, wall_t, _, per_tick_t = serve_checked(eng, reqs)
        del eng._preempt
        kv_t = eng.kv_stats()
        phase(13, f"chunked graphed, tight pool of {pages} pages: {len(comps_t)} requests in "
                  f"{wall_t:.3f} s, {kv_t['preemptions']} preemptions ({sum(mid)} mid-prefill), "
                  f"{eng.stats['prefill_chunks']} chunk steps, peak {kv_t['peak_used_pages']} "
                  f"pages, used pages at the end {kv_t['used_pages']}, syncs per tick max "
                  f"{max(per_tick_t)}")
        check(kv_t["used_pages"] == 0 and eng.active_slots == 0,
              "chunked tight pool: pages or lanes left in use")
        check(eng.stats["host_syncs"] == eng.stats["dispatches"],
              "chunked tight pool: host syncs != dispatches")
        check(0 < eng.stats["max_tick_prefill_tokens"] <= C_SLOTS * P_CHUNK,
              "chunked tight pool: the chunk budget was not held")
        if kv_t["preemptions"] >= 1 or pages <= eng._mps:
            break
        pages -= 1
        del eng
        release({})
    check(kv_t["preemptions"] >= 1, "chunked: the tight pool never preempted")
    del eng
    release({})
    runs["tight"] = dict(pages=pages, preemptions=kv_t["preemptions"], mid=sum(mid))
    against_frozen(model, params, spec, reqs, comps_t, g["comps"],
                   f"chunked tight pool ({pages} pages)", n_phase=13,
                   what="the chunked ample pool's")

    # (d): the ample pool with learning and adaptive depth (ROADMAP 12.6)
    label = "chunked, learning, adaptive"
    r = runs["learn_adaptive"] = adaptive_run(
        model, params, dvi, reqs, C_PAGES_AMPLE, label, A_KMIN, n=13, state=learn_state(model),
        learn=True, update_every=L_UPDATE_EVERY, lr=L_LR, mode=L_MODE, k_min=A_KMIN,
        k_max=A_KMAX, prefill_chunk=P_CHUNK)
    eng = r["eng"]
    r.update(chunk_figures(eng), mid=0, updates=eng.stats["updates"])
    want = chunked_want(cfg, r["blocks_run"], r["chunks"], r["dispatch_log"], r["updates"])
    chunk_gates(13, label, r, want, True)
    at_home = graphs.drafter_ptrs(eng.state.dvi_params) == eng._runner.drafter
    phase(13, f"{label}: {r['updates']} updates, draft widths dispatched "
              f"{sorted({kb for kb, _ in r['dispatch_log']})}, mean depth "
              f"{r['adaptive']['mean_depth']:.3f}, lanes out of [k_min, k_cap] {r['bad']}, "
              f"A and B at their addresses: {at_home}, captures {r['graph']['captures']}")
    check(r["updates"] > 0 and at_home and not r["bad"],
          f"{label}: no update, a rebound drafter or a depth out of its range")
    check_census(13, label, r["graph"])
    schema_gate(eng, 13, label)
    r["profile"] = profile_batch(eng, reqs, r["wall"] * 1e3, n=13)
    release(r)
    against_frozen(model, params, spec, reqs, r["comps"], base["comps"], label, n_phase=13,
                   what="phase 8's one-shot fixed-K streams")
    return runs


def report_chunked(label: str, r: dict, base: dict) -> None:
    """One line of a chunked run's figures, beside the one-shot run `base`."""
    steps, p, cg, t = max(r["steps"], 1), r["profile"], r["chunk_graph"], r["ticks"]
    phase(13, f"{label}: wall per block-step {1e3 * r['wall'] / steps:.2f} ms, device "
              f"{p['device_ms']:.2f} ms a block-step, busy {100 * p['busy']:.1f}%, "
              f"{r['committed'] / r['wall']:.1f} committed tokens/s, tick p50 "
              f"{1e3 * t['p50_s']:.2f} / p95 {1e3 * t['p95_s']:.2f} / max "
              f"{1e3 * t['max_s']:.2f} ms over {t['count']} ticks, chunk graph "
              f"{cg['nodes']} nodes (capture {cg['capture_s']:.2f} s, instantiate "
              f"{cg['instantiate_s']:.3f} s, replay() {cg['replay_us']:.1f} us on the host), "
              f"graph pool {r['graph']['pool_bytes'] / 2**30:.3f} GiB, peak memory "
              f"{r['peak'] / 2**30:.2f} GiB allocated; one-shot: wall "
              f"{1e3 * base['wall'] / max(base['steps'], 1):.2f} ms, device "
              f"{base['profile']['device_ms']:.2f} ms a block-step, "
              f"{base['committed'] / base['wall']:.1f} tokens/s, tick p50 "
              f"{1e3 * base['ticks']['p50_s']:.2f} / p95 {1e3 * base['ticks']['p95_s']:.2f} / max "
              f"{1e3 * base['ticks']['max_s']:.2f} ms over {base['ticks']['count']} ticks")


# ---------------------------------------------------------------------------
# phase 9: mamba2-370m through both schedulers
# ---------------------------------------------------------------------------

def count_prefills(model) -> list:
    """Count the model's prefill calls (each runs one ssd_scan per SSM layer)
    in a one-element list, by wrapping ``model.prefill``."""
    calls = [0]
    inner = model.prefill

    def prefill(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    model.prefill = prefill
    return calls


def mamba_want(cfg, blocks: int, prefills: int) -> dict:
    """The launch formula of the mamba2 paths: per block 5 lora_logits, 1
    verify_argmax and no attention or scan; one ssd_scan per layer per
    prefill call."""
    return {"decode_attention": 0, "paged_decode_attention": 0,
            "lora_logits": (cfg.dvi.k_spec + 1) * blocks, "verify_argmax": blocks,
            "ssd_scan": cfg.num_layers * prefills}


def engine_rows_cache(model, params, req, chunk: int = 0) -> dict:
    """`req`'s prompt but its last token prefilled as the continuous engine
    prefills it, in lane 0 of a C_SLOTS-lane contiguous cache: alone (B = 1)
    and spliced in, or with `chunk` as the chunked engine does, its first
    `chunk` tokens alone and the rest in chunk steps of (C_SLOTS, chunk)
    tokens that advance lane 0 alone."""
    from repro_torch.models import transformer as tfm
    prompt = torch.as_tensor(req.prompt, device=DEV)
    n = len(req.prompt) - 1
    c1 = min(chunk, n) if chunk else n
    _, pc = model.prefill(params, prompt[None, :c1])
    cache = tfm.insert_slot(model.cfg, model.init_cache(C_SLOTS, len(req.prompt) + req.max_new
                                                        + tfm.RING_SLACK), pc, 0)
    pos = c1
    while pos < n:
        take = min(chunk, n - pos)
        blk = torch.zeros((C_SLOTS, chunk), dtype=torch.int32, device=DEV)
        blk[0, :take] = prompt[pos:pos + take]
        lanes = torch.zeros((C_SLOTS,), dtype=torch.int32, device=DEV)
        lanes[0] = take
        model.prefill_chunk(params, blk, cache, lanes)
        pos += take
    return cache


def ar_at_engine_rows(model, params, req, chunk: int = 0, cache=None) -> list:
    """Greedy AR of `req` decoded as the continuous engine decodes it: from
    the cache of ``engine_rows_cache`` (or `cache`, one it built, which the
    decode advances in place), one-token blocks of ``spec_block_step`` at
    K = 0 with ar_generate's zero draft adapter, the other lanes masked
    done.  Every matrix product then runs at the engine's row counts, so in
    bf16 it rounds as the engine's does; ar_generate on the prompt alone
    runs its decode products at one row."""
    from repro_torch.core import spec
    cfg = model.cfg
    dvi0 = {"A": torch.zeros((cfg.d_model, 1), device=DEV),
            "B": torch.zeros((1, cfg.vocab_size), device=DEV)}
    if cache is None:
        cache = engine_rows_cache(model, params, req, chunk)
    pending = torch.zeros((C_SLOTS,), dtype=torch.int32, device=DEV)
    pending[0] = int(req.prompt[-1])
    done = torch.arange(C_SLOTS, device=DEV) > 0
    out = []
    while len(out) < req.max_new and 1 not in out:
        blk = spec.spec_block_step(model, params, dvi0, pending, cache, k_spec=0, done=done)
        pending, cache = blk.pending, blk.cache
        out.append(int(blk.commit_vec[0, 0]))
    return out


def float32_model(model, params):
    """The model and its weights cast up to float32 (every floating leaf)."""
    from repro_torch.models.model import build_model

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        return t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    return build_model(model.cfg.replace(dtype="float32"), device=DEV), up(params)


def ssm_state_errors(cfg, cache, ref_cache) -> dict:
    """Lane 0's SSM conv windows and states in `cache` against `ref_cache`'s
    lane 0: the largest relative Frobenius error over the layers of each."""
    from repro_torch.models import transformer as tfm
    out = {"conv": 0.0, "state": 0.0}
    for seg in tfm.model_segments(cfg):
        if seg.kind != "ssm":
            continue
        for key in out:
            a = cache["segs"][seg.name][key][:, 0].float()
            b = ref_cache["segs"][seg.name][key][:, 0].float()
            err = ((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1).clamp_min(1e-30))
            out[key] = max(out[key], float(err.max()))
    return out


def chunk_witness(model, params, spec, f32: dict, n_phase: int, label: str):
    """The witness for a chunked completion that differs from AR beyond a
    bf16 near-tie, which uses no chunk step on one side of any comparison:
    (1) in float32 (the weights cast up, in `f32`, made at first use), where
    rounding no longer flips a greedy pick, the chunked path's stream at the
    engine's row counts equals ``ar_generate`` of the prompt alone (one-shot
    prefill), or first differs at a float32 near-tie (F32_GAP_RTOL); (2) the
    float32 chunk-built SSM states and conv windows equal one-shot
    ``prefill``'s within F32_STATE_RTOL a layer; (3) the bf16 chunk-built
    ones are no further from the float32 one-shot ones than BF16_STATE_RATIO
    times bf16 one-shot ``prefill``'s.  Returns witness(request, got) ->
    bool, for ``check_against_ar``."""
    def one_shot(m, p, req):
        return m.prefill(p, torch.as_tensor(req.prompt[None, :-1], device=DEV))[1]

    def witness(req, got) -> bool:
        if not f32:
            f32["model"], f32["params"] = float32_model(model, params)
            f32["memo"] = {}
        m32, p32 = f32["model"], f32["params"]
        o32 = one_shot(m32, p32, req)
        c32 = engine_rows_cache(m32, p32, req, P_CHUNK)
        e32 = ssm_state_errors(m32.cfg, c32, o32)          # before the decode moves c32
        e16 = ssm_state_errors(model.cfg, engine_rows_cache(model, params, req, P_CHUNK), o32)
        e16_one = ssm_state_errors(model.cfg, one_shot(model, params, req), o32)
        states_ok = (max(e32.values()) <= F32_STATE_RTOL
                     and all(e16[k] <= BF16_STATE_RATIO * e16_one[k] for k in e16))
        chunked = ar_at_engine_rows(m32, p32, req, cache=c32)
        alone = capped(ar_alone(m32, p32, spec, req, f32["memo"]), req.max_new)
        p = next((j for j, (a, b) in enumerate(zip(chunked, alone)) if a != b), None)
        if p is None:
            streams_ok, why = chunked == alone, f"equal: {chunked == alone}"
        else:
            prefix = torch.as_tensor(np.concatenate([req.prompt, alone[:p]]).astype(np.int64),
                                     device=DEV)[None]
            t1, t2 = top2_gap(m32, p32, prefix)
            streams_ok = t1 - t2 <= F32_GAP_RTOL * max(abs(t1), 1.0)
            why = f"first differ at token {p}, float32 top-2 gap {t1 - t2:.4e}"
        phase(n_phase, f"{label}: request {req.uid}, float32 witness: the chunked path at the "
                       f"engine's row counts vs AR of the prompt alone: {why}; largest "
                       f"relative error a layer, chunk-built vs one-shot float32: state "
                       f"{e32['state']:.3e}, conv {e32['conv']:.3e}; against the float32 "
                       f"one-shot, bf16 chunk-built: state {e16['state']:.3e}, conv "
                       f"{e16['conv']:.3e}, bf16 one-shot: state {e16_one['state']:.3e}, conv "
                       f"{e16_one['conv']:.3e}; holds: {streams_ok and states_ok}")
        return streams_ok and states_ok
    return witness


def mamba_phase(by_row):
    """Phase 9.  Returns the graphed sync and continuous runs' launch counts,
    the eager ones', and the graphed runs' busy shares."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request
    cfg = get_config(M_NAME)
    model = build_model(cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
    torch.cuda.synchronize()
    n_par = sum(p.numel() for s in params["segments"].values() for p in s.values())
    phase(9, f"{M_NAME} bf16 params drawn on the card in {time.perf_counter() - t0:.1f} s "
             f"({cfg.num_layers} layers, {n_par / 1e6:.1f}M in segments, tied head "
             f"{tuple(params['lm_head'].shape)})")
    prefills = count_prefills(model)
    expect = {name: by_row[name]["at_mamba2"]["ms"]
              for name in ("verify_argmax", "lora_logits")}
    per_prefill = {"ssd_scan": cfg.num_layers}

    # ---- sync scheduler: bucket-padded prompts ----
    reqs = make_requests(cfg)
    sync = {}
    for mode, on in MODES:
        r = sync[mode] = sync_run(model, params, dvi, reqs, on, 9, f"{M_NAME} sync {mode}",
                                  prefills=prefills)
        n, n_pre = r["steps"], r["prefills"]
        check(len(r["comps"]) == N_REQUESTS and n > 0,
              f"{len(r['comps'])} completions in {n} block-steps")
        phase(9, f"sync {mode}: served {len(r['comps'])} requests in {n} block-steps and "
                 f"{n_pre} prefill calls, wall {r['wall']:.3f} s: MAT "
                 f"{r['committed'] / max(r['blocks'], 1):.4f}, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, peak memory "
                 f"{r['peak'] / 2**30:.2f} GiB")
        want = mamba_want(cfg, n, n_pre)
        phase(9, f"sync {mode}: launches {r['launches']}; expected {want}")
        check(r["launches"] == want, "the mamba2 sync path did not run the kernels as the "
                                     "formula says")
        # the eager reruns are not profiled (the script's time limit)
        r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=9,
                                     expect=dict(expect, ssd_scan=by_row["ssd_scan"]["ms"]),
                                     per_call=per_prefill) if on else None
        padded = [Request(uid=q.uid, prompt=r["eng"]._pad(q, r["eng"]._bucket(len(q.prompt))),
                          max_new=q.max_new) for q in reqs]
        release(r)
    report_modes(9, f"{M_NAME} sync", sync)
    check_against_ar(model, params, spec, padded, sync["graphed"]["comps"], f"{M_NAME} sync",
                     n_phase=9)

    # ---- continuous scheduler, contiguous layout: exact prompts ----
    creqs = continuous_requests(cfg)
    cont = {}
    for mode, on in MODES:
        r = cont[mode] = continuous_run(model, params, dvi, creqs, on, 0, 9,
                                        f"{M_NAME} continuous {mode}", prefills=prefills)
        eng, blocks_run, n_pre = r["eng"], r["blocks_run"], r["prefills"]
        check(len(r["comps"]) == C_REQUESTS and blocks_run > 0, f"{len(r['comps'])} completions")
        phase(9, f"continuous {mode} (contiguous, {C_SLOTS} lanes, sync_every {C_SYNC}): "
                 f"{len(r['comps'])} requests in {r['wall']:.3f} s, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, MAT "
                 f"{r['committed'] / max(r['blocks'], 1):.4f}, {r['dispatches']} dispatches, "
                 f"{r['host_syncs']} host syncs, {blocks_run} blocks run ({r['steps']} with a "
                 f"live lane), {n_pre} prefill calls, peak memory {r['peak'] / 2**30:.2f} GiB")
        phase(9, f"continuous {mode}: synchronising operations per tick: {r['per_tick']} (0 "
                 f"inside every dispatch: sync debug mode 'error')")
        check(eng.active_slots == 0 and not eng.busy, "lanes left occupied at the end")
        check(r["host_syncs"] == r["dispatches"], "host syncs != dispatches")
        want = mamba_want(cfg, blocks_run, n_pre)
        phase(9, f"continuous {mode}: launches {r['launches']}; expected {want}")
        check(r["launches"] == want, "the mamba2 continuous path did not run the kernels as "
                                     "the formula says")
        r["profile"] = profile_batch(
            eng, creqs, r["wall"] * 1e3, n=9, per_call=per_prefill,
            expect=dict(expect, ssd_scan=by_row["ssd_scan"]["at_admission"]["ms"])) if on else None
        release(r)
    report_modes(9, f"{M_NAME} continuous", cont)
    tick_phases(model, params, dvi, creqs, 0, 9, f"{M_NAME} continuous")
    ar_memo: dict = {}                 # phase 13c reuses these AR streams
    check_against_ar(model, params, spec, creqs, cont["graphed"]["comps"],
                     f"{M_NAME} continuous", n_phase=9, alone=True,
                     same_shape=lambda q: ar_at_engine_rows(model, params, q), ar_memo=ar_memo)

    # ---- phase 13c: chunked prefill on the contiguous continuous engine ----
    t13 = time.perf_counter()
    label = f"{M_NAME} chunked graphed (contiguous)"
    r = continuous_run(model, params, dvi, creqs, True, 0, 13, label, prefills=prefills,
                       prefill_chunk=P_CHUNK)
    chunk_gates(13, label, r, mamba_want(cfg, r["blocks_run"], r["prefills"]), True)
    phase(13, f"{label}: {r['prefills']} first-chunk admissions, {cfg.num_layers} ssd_scan "
              f"each; 0 attention launches in {r['chunks']} chunk steps")
    check(r["prefills"] == C_REQUESTS, f"{label}: {r['prefills']} admissions")
    check_census(13, label, r["graph"])
    r["profile"] = profile_batch(r["eng"], creqs, r["wall"] * 1e3, n=13, per_call=per_prefill,
                                 expect=dict(expect, ssd_scan=by_row["ssd_scan"]
                                             ["at_chunk_admission"]["ms"]))
    release(r)
    report_chunked(label, r, base=cont["graphed"])
    r["equal_one_shot"] = against_frozen(
        model, params, spec, creqs, r["comps"], cont["graphed"]["comps"], label, n_phase=13,
        what="phase 9's one-shot streams", alone=True, ar_memo=ar_memo,
        witness=chunk_witness(model, params, spec, {}, 13, label))
    phase(13, f"{label}: phase 13c took {time.perf_counter() - t13:.1f} s")
    return (sync["graphed"]["launches"], cont["graphed"]["launches"],
            sync["eager"]["launches"], cont["eager"]["launches"], r)


# ---------------------------------------------------------------------------
# phase 11: the training path
# ---------------------------------------------------------------------------

def bits_checksum(tree) -> torch.Tensor:
    """Two sums over the raw bits of every leaf of `tree`, on the device, in
    chunks of 16 M elements: the sum of the bits read as integers and the
    sum of their squares (both wrap in int64).  Any changed bit changes
    them, barring a collision in both."""
    from repro_torch.tree import flatten
    out = []
    for p in flatten(tree).values():
        flat = p.reshape(-1).view(torch.int16 if p.element_size() == 2 else torch.int32)
        for c in flat.split(1 << 24):
            b = c.long()
            out.append(torch.stack([b.sum(), (b * b).sum()]))
    return torch.stack(out)


def pretrain_phase(ssd_backward_ms: float) -> dict:
    """Phase 11a: mamba2-370m at full width and depth (48 layers, bf16,
    weights from the seed) pretrained through the launcher (``--mode
    pretrain``) for P_STEPS steps of P_B x P_T synthetic batches.  Gates:
    step 1's gradient (its batch and weights, before the run) non-zero and
    finite in A_log, dt_bias, in_proj and conv_w of every layer; finite
    losses and gnorms; 48 ``ssd_scan`` launches a step; ``lm_head`` ==
    ``embed.T`` bit for bit at its address after every step; the
    checkpoint it writes loads back bit for bit through ``load_checkpoint``
    and ``weights.load_npz`` and holds exactly the trained tree's keys;
    then P_DESCENT steps on the first batch alone (fresh optimizer state,
    the last one under torch.profiler for its device time) cut its loss by
    at least P_DROP nats.  The streaming loss's first and last 5 steps are
    reported.  Returns the launches of the launcher's run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import weights
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import TASK_CATEGORIES, SyntheticTasks
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.model import build_model, trained_tree
    from repro_torch.training import (init_pretrain_state, lm_loss, loss_and_grads,
                                      make_pretrain_step)
    from repro_torch.tree import flatten
    cfg = get_config(M_NAME)
    L = cfg.num_layers
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    path = os.path.join(ROOT, "build", "phase11_mamba2_pretrain.npz")
    args = train.parse_args(["--arch", M_NAME, "--mode", "pretrain", "--steps", str(P_STEPS),
                             "--batch", str(P_B), "--seq", str(P_T), "--dtype", "bfloat16",
                             "--seed", str(SEED), "--ckpt", path])
    # step 1's gradient: the launcher's first batch (its stream at seed + 1)
    first = next(SyntheticTasks(cfg.vocab_size, seed=SEED).stream(
        TASK_CATEGORIES, 1, P_B, P_T, seed=SEED + 1))
    _, _, grads = loss_and_grads(model, params, torch.as_tensor(first, device=DEV))
    layers = {}
    for name in ("A_log", "dt_bias", "in_proj", "conv_w"):
        per = torch.cat([g.reshape(g.shape[0], -1).float().abs().amax(1)
                         for k, g in sorted(grads.items()) if k.endswith("/" + name)])
        fin = all(bool(torch.isfinite(g).all()) for k, g in grads.items()
                  if k.endswith("/" + name))
        layers[name] = (int((per > 0).sum()), len(per), fin)
    del grads
    phase(11, f"{M_NAME} pretraining, step 1's gradient: layers with a non-zero, finite "
              f"gradient: " + ", ".join(f"{k} {n}/{m}" + ("" if f else " (NOT FINITE)")
                                        for k, (n, m, f) in layers.items()))
    check(all(n == m == L and f for n, m, f in layers.values()),
          "a Mamba-2 layer got no gradient through the scan")
    head, ptr = params["lm_head"], params["lm_head"].data_ptr()
    rec = []

    def on_step(i, m):
        rec.append(dict(t=time.perf_counter(), loss=float(m["loss"]), gnorm=float(m["gnorm"]),
                        ssd=ops.launches["ssd_scan"],
                        head=bool(params["lm_head"] is head and head.data_ptr() == ptr
                                  and torch.equal(head, params["embed"].T))))

    reset_counts()
    t0 = time.perf_counter()
    train.run(args, model, params, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = [r["loss"] for r in rec], [r["gnorm"] for r in rec]
    per_step = [b["ssd"] - a for a, b in zip([0] + [r["ssd"] for r in rec], rec)]
    walls = [b["t"] - a["t"] for a, b in zip(rec, rec[1:])]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(walls))
    phase(11, f"{M_NAME} pretraining through the launcher: {len(rec)} steps of {P_B} x {P_T} in "
              f"{wall:.1f} s (checkpoint included); loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"mean of the first 5 {first5:.4f}, of the last 5 {last5:.4f} (drop "
              f"{first5 - last5:.4f}, reported); gnorm {gnorms[0]:.3f} -> "
              f"{gnorms[-1]:.3f}; ssd_scan launches a step {sorted(set(per_step))}; lm_head == "
              f"embed.T at its address after every step: {all(r['head'] for r in rec)}; a "
              f"step's wall (median of steps 2-{len(rec)}) {1e3 * step_s:.1f} ms, "
              f"{P_B * P_T / step_s:.0f} tokens/s; peak {peak / 2**30:.2f} GiB")
    check(len(rec) == P_STEPS and np.isfinite(losses).all() and np.isfinite(gnorms).all(),
          "pretraining gave a non-finite loss or gnorm")
    check(per_step == [L] * P_STEPS, "pretraining did not launch ssd_scan once a layer a step")
    check(all(r["head"] for r in rec), "lm_head is not embed.T at its address after a step")
    # the checkpoint: the trained tree's keys, bit for bit through both readers
    with np.load(path) as data:
        keys = set(data.files)
    want = flatten(trained_tree(cfg, params))
    back = flatten(load_checkpoint(path, trained_tree(cfg, params)))
    same = keys == set(want) and "lm_head" not in keys and all(
        torch.equal(back[k].view(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8))
        for k, v in want.items())
    del back
    bridged = flatten(weights.load_npz(cfg, path, DEV))
    same_bridge = set(bridged) == set(flatten(params)) and all(
        torch.equal(bridged[k], v) for k, v in flatten(params).items())
    del bridged
    os.remove(path)
    phase(11, f"checkpoint: {len(keys)} keys == the trained tree's (no lm_head): "
              f"{keys == set(want)}; load_checkpoint bit for bit: {same}; weights.load_npz "
              f"(lm_head tied again) equal: {same_bridge}")
    check(same and same_bridge, "the pretraining checkpoint does not load back bit for bit")
    # descent: P_DESCENT steps on the first batch alone, the last profiled
    step = make_pretrain_step(model, 2e-3)
    st = init_pretrain_state(model, params)
    tokens = torch.as_tensor(first, device=DEV)
    with torch.no_grad():
        before = float(lm_loss(model, params, tokens)[0])
    seen = []
    for _ in range(P_DESCENT - 1):
        seen.append(float(step(params, st, tokens)[2]["loss"]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, st, tokens)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    with torch.no_grad():
        after = float(lm_loss(model, params, tokens)[0])
    phase(11, f"{P_DESCENT} more steps on the first batch alone (lr 2e-3, fresh moments): its "
              f"loss {before:.4f} -> " + " ".join(f"{x:.4f}" for x in seen[1:])
              + f" -> {after:.4f} (drop {before - after:.4f}, gate >= {P_DROP})")
    check(np.isfinite(after) and before - after >= P_DROP,
          f"{P_DESCENT} steps on one batch cut its loss by {before - after:.4f} nats, "
          f"less than {P_DROP}")
    spans = [(t0, t1) for _, t0, t1 in device_events(prof)]
    dev_ms = covered_ms(spans)
    share = L * ssd_backward_ms / dev_ms
    phase(11, f"{M_NAME} pretraining step, profiled: device busy {dev_ms:.1f} ms of "
              f"{1e3 * prof_wall:.1f} ms wall ({len(spans)} device records); the scan's "
              f"backward, {L} x {ssd_backward_ms:.3f} ms (phase 3, alone) = "
              f"{L * ssd_backward_ms:.1f} ms, {100 * share:.1f}% of the step's device time")
    del st, step
    return dict(launches=counts, step_ms=1e3 * step_s, device_ms=dev_ms, peak=peak,
                drop=first5 - last5, descent=before - after, backward_share=share)


def dvi_batch_phase(model, params) -> dict:
    """Phase 11b: vicuna-7b (phases 4-10's weights) through the launcher's
    ``--mode dvi-batch --pretrain-steps 0``: D_STEPS teacher-forced drafter
    steps over D_B x D_T synthetic batches (8184 positions each).  Each step
    runs under sync debug mode "warn", its synchronising operations
    counted, between CUDA events (its device span) and host clocks.  Gates:
    the backbone's bits unchanged (``bits_checksum``); A and B changed;
    finite loss, gnorm and acc_rate every step; one ``lora_logits`` launch
    a step; 0 synchronising operations in every step after the first.
    Returns the launches."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    before = bits_checksum(params)
    real = train.make_dvi_train_step
    steps, first = [], {}

    def make(*a, **kw):
        inner = real(*a, **kw)

        def step(*args):
            if not first:
                first.update({k: v.clone() for k, v in args[1].items()})
            n0 = ops.launches["lora_logits"]
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    ev[0].record()
                    t0 = time.perf_counter()
                    out = inner(*args)
                    host = time.perf_counter() - t0
                    ev[1].record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            steps.append(dict(ev=ev, host=host, launches=ops.launches["lora_logits"] - n0,
                              syncs=sum("synchroniz" in str(w.message) for w in caught),
                              metrics=out[3]))
            return out
        return step

    args = train.parse_args(["--arch", "vicuna-7b", "--mode", "dvi-batch", "--pretrain-steps",
                             "0", "--steps", str(D_STEPS), "--batch", str(D_B), "--seq",
                             str(D_T), "--dtype", "bfloat16", "--seed", str(SEED)])
    reset_counts()
    train.make_dvi_train_step = make
    t0 = time.perf_counter()
    try:
        out = train.run(args, model, params)
    finally:
        train.make_dvi_train_step = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    same_backbone = torch.equal(before, bits_checksum(params))
    dvi = out["state"].dvi_params
    moved = {k: not torch.equal(first[k], dvi[k]) for k in ("A", "B")}
    keys = ("loss", "gnorm", "acc_rate")
    vals = [{k: float(s["metrics"][k]) for k in keys} for s in steps]
    finite = all(np.isfinite(v[k]) for v in vals for k in keys)
    dev = [s["ev"][0].elapsed_time(s["ev"][1]) for s in steps]
    host = [1e3 * s["host"] for s in steps]
    syncs = [s["syncs"] for s in steps]
    phase(11, f"vicuna-7b dvi-batch through the launcher: {len(steps)} steps of {D_B} x {D_T} "
              f"({D_ROWS} positions) in {wall:.1f} s; loss {vals[0]['loss']:.4f} -> "
              f"{vals[-1]['loss']:.4f}, gnorm {vals[0]['gnorm']:.3f} -> {vals[-1]['gnorm']:.3f}, "
              f"acc_rate {vals[0]['acc_rate']:.4f} -> {vals[-1]['acc_rate']:.4f}, baseline "
              f"{float(out['baseline']):.4f}; a step (median of steps 2-{len(steps)}): host "
              f"{np.median(host[1:]):.1f} ms, device span {np.median(dev[1:]):.1f} ms (CUDA "
              f"events around the call); first step host {host[0]:.1f}, device {dev[0]:.1f}; "
              f"lora_logits launches a step {[s['launches'] for s in steps]}; synchronising "
              f"operations a step {syncs}; peak {peak / 2**30:.2f} GiB")
    phase(11, f"backbone bit-identical before and after (checksums of {before.shape[0]} "
              f"chunks): {same_backbone}; A changed {moved['A']}, B changed {moved['B']}")
    check(len(steps) == D_STEPS and finite, "dvi-batch gave a non-finite loss, gnorm or acc_rate")
    check(same_backbone, "the DVI step changed the backbone")
    check(all(moved.values()), "the DVI step left A or B unchanged")
    check(all(s["launches"] == 1 for s in steps), "dvi-batch did not launch lora_logits once a step")
    check(all(n == 0 for n in syncs[1:]), "a dvi-batch step after the first synchronised")
    del out, first
    return dict(launches=counts, host_ms=float(np.median(host[1:])),
                device_ms=float(np.median(dev[1:])), peak=peak)


def quickstart_phase() -> dict:
    """Phase 11c: ``examples/torch_quickstart.py`` on the card at its own
    (tiny, float32) size: pretraining, AR, DVI with an untrained drafter,
    the online KL->RL loop, the trained drafter against AR.  Gate: lossless
    against AR.  Returns the launches."""
    import importlib.util

    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", os.path.join(ROOT, "examples", "torch_quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    reset_counts()
    t0 = time.perf_counter()
    out = mod.main([])
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    phase(11, f"quickstart on the card in {time.perf_counter() - t0:.1f} s: pretraining loss "
              f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; lossless vs AR "
              f"{out['lossless']}; block acceptance over the first / last 8 batches "
              f"{out['block_acc'][0]:.4f} / {out['block_acc'][1]:.4f}, MAT "
              f"{out['mat'][0]:.4f} / {out['mat'][1]:.4f}; trained drafter: AR "
              f"{out['ar_s']:.3f} s against DVI {out['dvi_s']:.3f} s (AR / DVI "
              f"{out['speedup']:.3f}), MAT {out['mat_trained']:.4f}; launches {counts}")
    check(out["lossless"] is True, "the quickstart's DVI stream differs from AR")
    return dict(launches=counts, **{k: out[k] for k in ("block_acc", "mat", "speedup")})


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
    from repro_torch.serving.engine import Request, ServingEngine

    t_start = time.perf_counter()
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
    marks = {"1-2": time.perf_counter() - t_start}
    rows = kernels_phase(cfg, get_config(M_NAME))
    marks["3"] = time.perf_counter() - t_start

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
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    by_row = {row["name"]: row for row in rows}
    expect = {"decode_attention": path_attention_ms(by_row["decode_attention"], K, k, L),
              "verify_argmax": by_row["verify_argmax"]["ms"],
              "lora_logits": by_row["lora_logits"]["ms"]}
    runs = {}
    for mode, on in MODES:
        r = runs[mode] = sync_run(model, params, dvi, reqs, on, 4, f"sync {mode}")
        comps, n = r["comps"], r["steps"]  # spec_block_step calls of this run
        check(len(comps) == N_REQUESTS, f"{len(comps)} completions for {N_REQUESTS} requests")
        for c in comps:
            check(1 <= len(c.gen_tokens) <= MAX_NEW and bool((c.gen_tokens >= 0).all())
                  and bool((c.gen_tokens < cfg.vocab_size).all()),
                  f"request {c.uid}: bad generation {c.gen_tokens}")
        phase(4, f"{mode}: served {len(comps)} requests in {n} block-steps, wall "
                 f"{r['wall']:.3f} s: MAT {r['committed'] / max(r['blocks'], 1):.4f}, "
                 f"acceptance {r['eng'].acceptance:.4f}, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, "
                 f"peak memory {r['peak'] / 2**30:.2f} GiB")
        r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3, expect=expect)

        # ---- phase 5: launch counts ----
        want = {"decode_attention": ((K + 1) * k + (L - k)) * n, "lora_logits": (K + 1) * n,
                "verify_argmax": n, "paged_decode_attention": 0, "ssd_scan": 0}
        phase(5, f"{mode}: launches over {n} block-steps: {r['launches']}; expected {want}")
        check(r["launches"] == want, "the sync path did not run the kernels as the formula says")
        if mode == "eager":
            release(r)
    report_modes(4, "vicuna-7b sync", runs)
    launches = runs["graphed"]["launches"]

    # ---- phase 6: greedy losslessness on the card ----
    eng = runs["graphed"].pop("eng")
    prompts = torch.as_tensor(np.stack([eng._pad(r, 128) for r in reqs]), device=DEV)
    r_sd = spec.speculative_generate(model, params, dvi, prompts, MAX_NEW)
    r_ar = spec.ar_generate(model, params, prompts, MAX_NEW)
    # the engine's graphed block-step on the same batch: its replays must
    # give the functional loop's streams bit for bit
    r_gr = eng._runner.generate(prompts, torch.ones((N_REQUESTS,), dtype=torch.bool,
                                                    device=DEV))
    same = torch.equal(r_gr.tokens, r_sd.tokens) and torch.equal(r_gr.lengths, r_sd.lengths)
    phase(6, f"graphed block-step == speculative_generate bit for bit on the 8 lanes padded "
             f"to 128: {same} ({r_gr.steps} replays, {r_sd.steps} blocks)")
    check(same and r_gr.steps == r_sd.steps,
          "the graphed block-step differs from speculative_generate")
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
    del eng, r_sd, r_ar, r_gr
    release({})
    marks["4-6"] = time.perf_counter() - t_start
    c_launches, c_eager, c_frozen = continuous_phase(cfg, model, params, dvi,
                                                     by_row["paged_decode_attention"], by_row)
    marks["8"] = time.perf_counter() - t_start

    # ---- phase 10: the Improve loop, on the same weights ----
    c_reqs = continuous_requests(cfg)
    learn_c = learn_continuous(cfg, model, params, c_reqs, c_frozen)
    against_frozen(model, params, spec, c_reqs, learn_c["graphed"]["comps"], c_frozen["comps"],
                   "learning continuous")
    learn_s = learn_sync(cfg, model, params, reqs, runs["graphed"])
    pad = ServingEngine(model, params, frozen(model, dvi), learn=False)
    padded = {q.uid: Request(uid=q.uid, prompt=pad._pad(q, pad._bucket(len(q.prompt))),
                             max_new=q.max_new) for q in reqs}
    against_frozen(model, params, spec, reqs, learn_s["graphed"]["comps"],
                   runs["graphed"]["comps"], "learning sync", padded=padded)
    del pad
    marks["10"] = time.perf_counter() - t_start

    # ---- phase 11b: the teacher-forced DVI step, on the same weights ----
    release({})
    t_dvi = dvi_batch_phase(model, params)
    marks["11b"] = time.perf_counter() - t_start

    # ---- phase 12: speculative sampling and adaptive depth, on the same weights ----
    release({})
    t_samp = sampled_phase(cfg, model, params, dvi, reqs)
    release({})
    a_runs = adaptive_phase(cfg, model, params, dvi, c_frozen)
    marks["12"] = time.perf_counter() - t_start

    # ---- phase 13 (a, b, d): chunked prefill, on the same weights ----
    release({})
    ch = chunked_phase(cfg, model, params, dvi, c_frozen, by_row["paged_decode_attention"],
                       by_row)
    report_chunked("chunked graphed, ample pool", ch["graphed"], base=c_frozen)
    t_ch, t_one = ch["graphed"]["ticks_host"], c_frozen["ticks_host"]
    phase(13, f"host ms a block-step in admit + pre_admit: chunked {t_ch['admit']:.2f} + "
              f"{t_ch['pre_admit']:.2f}, prefill_chunk {t_ch['prefill_chunk']:.2f}; phase 8 "
              f"one-shot {t_one['admit']:.2f} + {t_one['pre_admit']:.2f}; one admission "
              f"{t_ch['admission']:.2f} host ms chunked (eager, the first chunk) against "
              f"{t_one['admission']:.2f} one-shot")
    report_chunked("chunked graphed, learning, adaptive", ch["learn_adaptive"], base=c_frozen)
    marks["13abd"] = time.perf_counter() - t_start

    # ---- phase 9: mamba2-370m through both schedulers ----
    del model, params, dvi
    release({})                        # engines in reference cycles hold the weights
    m_sync, m_cont, m_sync_e, m_cont_e, m_chunk = mamba_phase(by_row)
    marks["9,13c"] = time.perf_counter() - t_start

    # ---- phase 11a and 11c: mamba2 pretraining, the quickstart ----
    release({})
    t_pre = pretrain_phase(by_row["ssd_scan"]["at_training"]["backward_ms"])
    release({})
    t_qs = quickstart_phase()
    marks["11a,c"] = time.perf_counter() - t_start

    # ---- phase 7: result lines ----
    for row in rows:
        name = row["name"]
        by_path = {"sync": launches.get(name, 0), "continuous": c_launches.get(name, 0),
                   "learn_sync": learn_s["graphed"]["launches"].get(name, 0),
                   "learn_continuous": learn_c["graphed"]["launches"].get(name, 0),
                   "mamba2_sync": m_sync.get(name, 0), "mamba2_continuous": m_cont.get(name, 0),
                   # the training paths (phase 11), eager
                   "mamba2_pretrain": t_pre["launches"].get(name, 0),
                   "dvi_batch": t_dvi["launches"].get(name, 0),
                   "quickstart": t_qs["launches"].get(name, 0),
                   # phase 12: the sampled path (eager) and adaptive depth (graphed)
                   "sampled": t_samp["launches"].get(name, 0),
                   "adaptive_pinned": a_runs["pinned"]["launches"].get(name, 0),
                   "adaptive": a_runs["controller"]["launches"].get(name, 0),
                   # phase 13: chunked prefill (graphed)
                   "chunked": ch["graphed"]["launches"].get(name, 0),
                   "chunked_learn_adaptive": ch["learn_adaptive"]["launches"].get(name, 0),
                   "mamba2_chunked": m_chunk["launches"].get(name, 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["launches_eager_by_path"] = {
            "sync": runs["eager"]["launches"].get(name, 0), "continuous": c_eager.get(name, 0),
            "learn_sync": learn_s["eager"]["launches"].get(name, 0),
            "learn_continuous": learn_c["eager"]["launches"].get(name, 0),
            "mamba2_sync": m_sync_e.get(name, 0), "mamba2_continuous": m_cont_e.get(name, 0),
            "chunked": ch["eager"]["launches"].get(name, 0)}
    ends = list(marks.values())
    phase(7, f"all phases passed in {time.perf_counter() - t_start:.1f} s; seconds by phase: "
             + ", ".join(f"{name} {end - start:.1f}" for name, start, end
                         in zip(marks, [0.0] + ends[:-1], ends)))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
