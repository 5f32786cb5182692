"""DVI across architecture families on the PyTorch port: the same
Draft->Verify->Improve loop runs unmodified on a dense GQA model, an
attention-free SSM (Mamba-2, with per-step state rollback), and a top-k MoE
(with dropless decode dispatch) — all losslessly.

    PYTHONPATH=src python examples/torch_multi_arch.py                # on the card
    PYTHONPATH=src python examples/torch_multi_arch.py --device cpu   # on the CPU

``main(argv)`` returns each architecture's line as a dict.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online, spec  # noqa: E402
from repro_torch.data import SyntheticTasks, TASK_CATEGORIES  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import pretrain  # noqa: E402

ARCHS = ["qwen3-0.6b", "mamba2-370m", "llama4-scout-17b-a16e"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="torch_multi_arch")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    out = []
    for name in ARCHS:
        cfg = get_config(name, tiny=True).replace(dtype="float32")
        model = build_model(cfg, device=args.device)
        dev = model.device
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        tasks = SyntheticTasks(cfg.vocab_size, seed=0)
        params, _ = pretrain(model, params,
                             tasks.stream(TASK_CATEGORIES, 150, 16, 32, seed=9),
                             lr=2e-3)
        state = online.init_trainer(model, torch.Generator(device=dev).manual_seed(7))
        state, hist = online.online_loop(
            model, params, tasks.stream(TASK_CATEGORIES, 40, 8, 16, seed=1),
            state, max_new=24, lr=3e-3)

        prompts = torch.as_tensor(tasks.sample("rag", 4, 12, seed=5), device=dev)
        r_ar = spec.ar_generate(model, params, prompts, 32)
        r_dv = spec.speculative_generate(model, params, state.dvi_params, prompts, 32)
        ok = all(bool(torch.equal(
            r_ar.tokens[b, :min(int(r_ar.lengths[b]), int(r_dv.lengths[b]))],
            r_dv.tokens[b, :min(int(r_ar.lengths[b]), int(r_dv.lengths[b]))]))
            for b in range(4))
        mat = float(r_dv.committed) / float(r_dv.blocks)
        acc = float(np.mean(hist["block_acc"][-8:]))
        print(f"{name:26s} [{cfg.arch_type:6s}] lossless={ok} "
              f"MAT={mat:.2f} final_acc={acc:.2f}", flush=True)
        out.append({"name": name, "lossless": ok, "mat": mat, "final_acc": acc})
    return out


if __name__ == "__main__":
    main()
