"""End-to-end driver on the PyTorch port: pretrain a ~100M-parameter
decoder for a few hundred steps, then run the paper's DVI protocol on it
(online drafter learning with a KL->RL schedule) and report the resulting
lossless speedup.

The default scale is the tiny vicuna geometry in float32; pass --full for
the 100M config.

    PYTHONPATH=src python examples/torch_train_100m.py [--full] [--steps 300]   # on the card
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 20 --dvi-prompts 16

``main(argv)`` returns the numbers it prints.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.checkpoint import save_checkpoint, save_lora  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import DVIConfig  # noqa: E402
from repro_torch.core import online, spec  # noqa: E402
from repro_torch.data import SyntheticTasks, TASK_CATEGORIES  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from repro_torch.training import pretrain  # noqa: E402


def config(full: bool):
    base = get_config("vicuna-7b", tiny=True)
    if not full:
        return base.replace(dtype="float32")
    # ~100M params: 12L x d640 x ff2560, 16k vocab
    return base.replace(
        name="dvi-100m", num_layers=12, d_model=640, num_heads=10,
        num_kv_heads=10, head_dim=64, d_ff=2560, vocab_size=16_384,
        dtype="float32",
        dvi=DVIConfig(split_layer=2, k_spec=4, lora_rank=32,
                      buffer_slots=2048, batch_size=128))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="torch_train_100m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dvi-prompts", type=int, default=400)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    cfg = config(args.full)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in flatten(params).values())
    print(f"backbone: {cfg.name}, {n_params/1e6:.1f}M params")

    tasks = SyntheticTasks(cfg.vocab_size, seed=0)
    t0 = time.time()
    params, losses = pretrain(
        model, params,
        tasks.stream(TASK_CATEGORIES, args.steps, 8, 64, seed=9),
        lr=1.5e-3, log_every=max(args.steps // 5, 1))
    print(f"pretrain: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.time()-t0:.0f}s, {args.steps} steps)")
    if args.ckpt:
        save_checkpoint(args.ckpt + ".backbone.npz", params)

    state = online.init_trainer(model, torch.Generator(device=dev).manual_seed(7))
    n_batches = args.dvi_prompts // 8
    stream = tasks.stream(TASK_CATEGORIES, n_batches, 8, 16, seed=1)
    t0 = time.time()
    state, hist = online.online_loop(model, params, stream, state,
                                     max_new=24, lr=3e-3,
                                     log_every=max(n_batches // 5, 1))
    acc = (float(np.mean(hist["block_acc"][:5])), float(np.mean(hist["block_acc"][-5:])))
    print(f"DVI online: acceptance {acc[0]:.2f} -> {acc[1]:.2f} ({time.time()-t0:.0f}s, "
          f"{int(state.step)} updates over {args.dvi_prompts} prompts)")
    if args.ckpt:
        save_lora(args.ckpt + ".lora.npz", state.dvi_params, int(state.step),
                  float(state.baseline))

    # final eval: lossless speedup on held-out prompts
    prompts = torch.as_tensor(tasks.sample("math", 8, 16, seed=777), device=dev)

    def timed(fn):
        fn()                                      # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    r_ar, t_ar = timed(lambda: spec.ar_generate(model, params, prompts, 48))
    r_dv, t_dv = timed(lambda: spec.speculative_generate(model, params, state.dvi_params,
                                                         prompts, 48))
    ok = all(bool(torch.equal(
        r_ar.tokens[b, :min(int(r_ar.lengths[b]), int(r_dv.lengths[b]))],
        r_dv.tokens[b, :min(int(r_ar.lengths[b]), int(r_dv.lengths[b]))]))
        for b in range(8))
    mat = float(r_dv.committed) / float(r_dv.blocks)
    print(f"eval: lossless={ok}  speedup={t_ar/t_dv:.2f}x  MAT={mat:.2f}")
    return {"params": n_params, "losses": losses, "block_acc": acc, "updates": int(state.step),
            "lossless": ok, "speedup": t_ar / t_dv, "mat": mat}


if __name__ == "__main__":
    main()
