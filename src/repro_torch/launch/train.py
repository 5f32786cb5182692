"""Training launcher: port of ``repro.launch.train``.

Modes:
  pretrain    — full-backbone LM pretraining
  dvi-online  — the paper's protocol: speculative generation with logging +
                online LoRA updates over a prompt stream
  dvi-batch   — teacher-forced DVI drafter updates over token batches
                (the `train_4k` workload)

The reference's flags and defaults, plus ``--device`` (the card unless
``cpu`` is asked for).  Example:

    PYTHONPATH=src python -m repro_torch.launch.train --arch vicuna-7b --tiny \\
        --mode dvi-online --prompts 200 --batch 8 --max-new 24

``main(argv)`` parses and runs; ``run(args, model, params, on_step)`` runs
parsed arguments on a model and parameters the caller already holds (drawn
from ``--seed`` when not given) and returns what it trained.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint, save_lora
from repro_torch.configs import get_config
from repro_torch.core import online as online_mod
from repro_torch.data import SyntheticTasks, TASK_CATEGORIES
from repro_torch.models.model import build_model, trained_tree
from repro_torch.optim import adamw_init
from repro_torch.training import make_dvi_train_step, pretrain


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="vicuna-7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mode", default="dvi-online",
                    choices=["pretrain", "dvi-online", "dvi-batch"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--prompts", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--loss-mode", default="full",
                    choices=["full", "kl", "pg", "ce"])
    ap.add_argument("--pretrain-steps", type=int, default=200,
                    help="backbone warmup before DVI modes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, model=None, params: Optional[dict] = None,
        on_step=None) -> dict:
    """Run the parsed arguments.  `model` and `params` default to the
    configured model with parameters drawn from ``--seed``; given ones are
    trained in place.  ``on_step(i, metrics)`` runs after each pretraining
    or dvi-batch step.  Returns {"model", "params", "losses" (pretraining),
    "state" (DVI modes), "history" (dvi-online), "metrics" and "baseline"
    (dvi-batch: the last step's)}."""
    if model is None:
        cfg = get_config(args.arch, tiny=args.tiny).replace(dtype=args.dtype)
        model = build_model(cfg, device=args.device)
    cfg, dev = model.cfg, model.device
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    tasks = SyntheticTasks(cfg.vocab_size, seed=args.seed)
    out = {"model": model, "params": params}
    t0 = time.time()

    if args.mode == "pretrain" or args.pretrain_steps:
        n = args.steps if args.mode == "pretrain" else args.pretrain_steps
        params, losses = pretrain(
            model, params, tasks.stream(TASK_CATEGORIES, n, args.batch,
                                        args.seq, seed=args.seed + 1),
            lr=2e-3, log_every=max(n // 4, 1),
            on_step=on_step if args.mode == "pretrain" else None)
        out["losses"] = losses
        print(f"[train] pretrain {n} steps: loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f} ({time.time()-t0:.1f}s)")
        if args.mode == "pretrain":
            if args.ckpt:
                save_checkpoint(args.ckpt, trained_tree(cfg, params))
            return out

    state = online_mod.init_trainer(model, torch.Generator(device=dev).manual_seed(args.seed + 7))
    out["state"] = state

    if args.mode == "dvi-online":
        n_batches = max(args.prompts // args.batch, 1)
        stream = tasks.stream(TASK_CATEGORIES, n_batches, args.batch,
                              args.seq // 2, seed=args.seed + 2)
        state, hist = online_mod.online_loop(
            model, params, stream, state, max_new=args.max_new,
            mode=args.loss_mode, lr=args.lr,
            log_every=max(n_batches // 10, 1))
        out["history"] = hist
        acc = np.array(hist["block_acc"])
        print(f"[train] dvi-online: block_acc {acc[:5].mean():.3f} -> "
              f"{acc[-5:].mean():.3f}; MAT {np.mean(hist['mat'][-5:]):.2f} "
              f"({time.time()-t0:.1f}s)")
    else:
        step_fn = make_dvi_train_step(model, lr=args.lr, mode=args.loss_mode)
        opt = adamw_init(state.dvi_params)
        baseline = torch.zeros((), dtype=torch.float32, device=dev)
        dvi_params = state.dvi_params
        metrics = {}
        for i, tokens in enumerate(tasks.stream(
                TASK_CATEGORIES, args.steps, args.batch, args.seq,
                seed=args.seed + 3)):
            dvi_params, opt, baseline, metrics = step_fn(
                params, dvi_params, opt, torch.as_tensor(tokens, device=dev), i,
                baseline)
            if on_step is not None:
                on_step(i, metrics)
            if (i + 1) % max(args.steps // 10, 1) == 0:
                print(f"[train] dvi-batch step {i+1}: "
                      f"acc={float(metrics['acc_rate']):.3f} "
                      f"loss={float(metrics['loss']):.4f}")
        # as the reference: the trainer state takes the new adapters only,
        # so a LoRA checkpoint of this mode records step 0 and baseline 0
        state.dvi_params = dvi_params
        out.update(metrics=metrics, baseline=baseline)

    if args.ckpt:
        save_lora(args.ckpt, state.dvi_params, int(state.step),
                  float(state.baseline))
        print(f"[train] saved LoRA checkpoint to {args.ckpt}")
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
