"""Pretraining's loss at several learning rates: the port's ``pretrain``
over the stream the launcher's ``--mode pretrain`` builds (``SyntheticTasks``
at the seed, its stream at seed + 1), from the same weights drawn from the
seed for every rate.  Prints the card, then for each rate the loss every 5
steps, the means of the first and the last 5 losses, and the step's median
wall.  With ``--overfit N`` each rate then takes N steps on the stream's
first batch alone, from fresh weights and optimizer state, and prints that
batch's loss after each (a descent check: no data rotates under the
model).  On the card:

    PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.launch.lr_sweep \
        --arch mamba2-370m --lrs 2e-3,1e-3,5e-4,3e-4 --overfit 10

PYTHONHASHSEED repeats the data between runs (the synthetic stream seeds
with ``hash``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.lr_sweep")
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--lrs", default="2e-3,1e-3,5e-4")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overfit", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lr_sweep: needs the card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import TASK_CATEGORIES, SyntheticTasks
    from repro_torch.models.model import build_model
    from repro_torch.training import lm_loss, pretrain
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch).replace(dtype=args.dtype)
    model = build_model(cfg)
    for lr in (float(x) for x in args.lrs.split(",")):
        params = model.init(torch.Generator(device="cuda").manual_seed(args.seed))
        tasks = SyntheticTasks(cfg.vocab_size, seed=args.seed)
        stamps = []
        _, losses = pretrain(model, params, tasks.stream(TASK_CATEGORIES, args.steps, args.batch,
                                                         args.seq, seed=args.seed + 1),
                             lr=lr, on_step=lambda i, m: stamps.append(time.perf_counter()))
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        print(f"{args.arch} lr {lr:g}: loss every 5 steps "
              + " ".join(f"{x:.4f}" for x in losses[::5])
              + f"; first 5 {first:.4f}, last 5 {last:.4f}, drop {first - last:.4f}; step "
              f"{1e3 * float(np.median(np.diff(stamps))):.1f} ms", flush=True)
        del params
        torch.cuda.empty_cache()
        if not args.overfit:
            continue
        params = model.init(torch.Generator(device="cuda").manual_seed(args.seed))
        first_batch = next(SyntheticTasks(cfg.vocab_size, seed=args.seed).stream(
            TASK_CATEGORIES, 1, args.batch, args.seq, seed=args.seed + 1))
        tokens = torch.as_tensor(first_batch, device="cuda")
        with torch.no_grad():
            before = float(lm_loss(model, params, tokens)[0])
        _, losses = pretrain(model, params, [tokens] * args.overfit, lr=lr)
        with torch.no_grad():
            after = float(lm_loss(model, params, tokens)[0])
        print(f"{args.arch} lr {lr:g}, {args.overfit} steps on one batch: its loss {before:.4f} "
              f"-> " + " ".join(f"{x:.4f}" for x in losses[1:]) + f" -> {after:.4f} "
              f"(drop {before - after:.4f})", flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
