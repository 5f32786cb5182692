"""Quickstart on the PyTorch port: Draft, Verify, & Improve.

Builds a tiny Vicuna-family backbone, pretrains it briefly on a synthetic
task mixture (so the verifier is peaked, like a real LM), then:

 1. decodes greedily (AR baseline),
 2. decodes with DVI self-speculation (losslessly — same tokens),
 3. runs the online KL->RL loop and shows acceptance/MAT climbing,
 4. times the trained drafter against AR.

    PYTHONPATH=src python examples/torch_quickstart.py              # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --pretrain-steps 20 --batches 4                             # small, on the CPU

``main(argv)`` returns the numbers it prints.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lora, online, spec  # noqa: E402
from repro_torch.data import SyntheticTasks, TASK_CATEGORIES  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import pretrain  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="torch_quickstart")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--pretrain-steps", type=int, default=200)
    ap.add_argument("--batches", type=int, default=60, help="prompt batches of stage 3")
    args = ap.parse_args(argv)

    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tasks = SyntheticTasks(cfg.vocab_size, seed=0)

    print("== pretraining the backbone (substrate) ==")
    params, losses = pretrain(model, params,
                              tasks.stream(TASK_CATEGORIES, args.pretrain_steps, 16, 32, seed=9),
                              lr=2e-3, log_every=100)

    prompts = torch.as_tensor(tasks.sample("qa", 4, 12, seed=5), device=dev)

    print("\n== 1) greedy AR decoding (the target distribution) ==")
    t0 = time.perf_counter()
    r_ar = spec.ar_generate(model, params, prompts, 48)
    _sync(dev)
    print(f"   {int(r_ar.committed)} tokens in {time.perf_counter() - t0:.2f}s")

    print("\n== 2) DVI self-speculation (drafter untrained -> static self-spec) ==")
    dvi_params = lora.init_draft_params(torch.Generator(device=dev).manual_seed(5), cfg)
    r_sd = spec.speculative_generate(model, params, dvi_params, prompts, 48)
    same = all(bool(torch.equal(
        r_ar.tokens[b, :min(int(r_ar.lengths[b]), int(r_sd.lengths[b]))],
        r_sd.tokens[b, :min(int(r_ar.lengths[b]), int(r_sd.lengths[b]))]))
        for b in range(4))
    print(f"   lossless vs AR: {same}   "
          f"MAT={float(r_sd.committed)/float(r_sd.blocks):.2f}")

    print("\n== 3) Improve: online KL->RL drafter training ==")
    state = online.init_trainer(model, torch.Generator(device=dev).manual_seed(7))
    stream = tasks.stream(TASK_CATEGORIES, args.batches, 8, 16, seed=1)
    state, hist = online.online_loop(model, params, stream, state,
                                     max_new=24, lr=3e-3, log_every=20)
    acc = (float(np.mean(hist["block_acc"][:8])), float(np.mean(hist["block_acc"][-8:])))
    mat = (float(np.mean(hist["mat"][:8])), float(np.mean(hist["mat"][-8:])))
    print(f"   block acceptance {acc[0]:.2f} -> {acc[1]:.2f}; MAT {mat[0]:.2f} -> {mat[1]:.2f}")

    print("\n== 4) trained drafter: wall-time speedup (still lossless) ==")

    def timed(fn):
        fn()                                      # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    r_tr, t_sd = timed(lambda: spec.speculative_generate(model, params, state.dvi_params,
                                                         prompts, 48))
    r_ar2, t_ar = timed(lambda: spec.ar_generate(model, params, prompts, 48))
    mat_tr = float(r_tr.committed) / float(r_tr.blocks)
    print(f"   AR {t_ar:.2f}s vs DVI {t_sd:.2f}s -> {t_ar/t_sd:.2f}x speedup, MAT={mat_tr:.2f}")
    return {"losses": losses, "lossless": same, "block_acc": acc, "mat": mat,
            "ar_s": t_ar, "dvi_s": t_sd, "speedup": t_ar / t_sd, "mat_trained": mat_tr}


if __name__ == "__main__":
    main()
