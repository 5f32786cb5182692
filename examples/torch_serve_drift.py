"""Continual-learning serving under distribution drift, on the PyTorch port.

The paper's core argument for training-aware speculation: offline-trained
drafters go stale when traffic drifts.  This demo serves QA-style traffic
through the continuous engine with per-lane adaptive depth, then switches
to math-style mid-run:

* a FROZEN drafter's acceptance drops at the shift and stays low, and its
  adaptive depth K throttles towards the floor;
* the ONLINE (DVI) drafter's acceptance drops and then recovers, and the
  depth controller tracks the recovery.

    PYTHONPATH=src python examples/torch_serve_drift.py              # on the card
    PYTHONPATH=src python examples/torch_serve_drift.py --device cpu \\
        --pretrain-steps 20 --warm-batches 8 --batches 12 --shift-at 4   # small, on the CPU

``main(argv)`` returns the curves it prints.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online  # noqa: E402
from repro_torch.core.schedule import DepthConfig  # noqa: E402
from repro_torch.data import SyntheticTasks, TASK_CATEGORIES  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training import pretrain  # noqa: E402

PHASE1, PHASE2 = "qa", "math"
BATCH = 8
MAX_NEW = 24
PROMPT_LEN = 16
# the controller's target band lies between the healthy phase-1 acceptance
# (~0.8) and the degraded post-shift level, so depth throttles exactly when
# the drafter goes stale
DEPTH = DepthConfig(k_min=1, k_max=4, k_init=4, ema_alpha=0.3,
                    hi=0.80, lo=0.60, cooldown=3, ema_init=0.75)


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def copy_state(s: online.OnlineTrainerState) -> online.OnlineTrainerState:
    """A copy of the trainer state: the engine updates its tensors in place."""
    return online.OnlineTrainerState(dvi_params=_clone(s.dvi_params),
                                     opt_state=_clone(s.opt_state), buf=_clone(s.buf),
                                     baseline=s.baseline.clone(), step=s.step.clone())


def run(learn: bool, model, params, tasks, warm_state, n_batches: int, shift_at: int):
    """One arm: `n_batches` closed-loop batches of BATCH requests, the
    category switched at `shift_at`.  Returns (acceptance, realized K per
    block, engine) per batch."""
    eng = ServingEngine(model, params, copy_state(warm_state), scheduler="continuous",
                        num_slots=BATCH, batch_size=BATCH, max_new=MAX_NEW,
                        buckets=(PROMPT_LEN,), learn=learn,
                        updates_per_batch=2, sync_every=2,
                        adaptive_k=True, depth_cfg=DEPTH)
    acc, depth = [], []
    uid = 0
    for b in range(n_batches):
        cat = PHASE1 if b < shift_at else PHASE2
        for _ in range(BATCH):
            eng.submit_request(Request(uid=uid,
                                       prompt=tasks.sample(cat, 1, PROMPT_LEN, seed=uid)[0],
                                       max_new=MAX_NEW))
            uid += 1
        before = (eng.stats["accepted"], eng.stats["drafted"], eng.stats["blocks"])
        while eng.busy:                 # closed loop: drain the batch
            eng.step()
        da = eng.stats["accepted"] - before[0]
        dd = eng.stats["drafted"] - before[1]
        db = eng.stats["blocks"] - before[2]
        acc.append(da / max(dd, 1))
        depth.append(dd / max(db, 1))   # drafted per block = realized K
    return acc, depth, eng


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="torch_serve_drift")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--pretrain-steps", type=int, default=60)
    ap.add_argument("--warm-batches", type=int, default=40,
                    help="online-loop batches that warm the drafter on phase-1 traffic")
    ap.add_argument("--batches", type=int, default=30, help="served batches an arm")
    ap.add_argument("--shift-at", type=int, default=10, help="the batch the traffic shifts at")
    args = ap.parse_args(argv)
    n, shift = args.batches, args.shift_at

    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tasks = SyntheticTasks(cfg.vocab_size, seed=0)
    # the VERIFIER is a general model (all six categories, briefly); only
    # the DRAFTER's LoRA is tuned to recent traffic, so on the unseen
    # category its acceptance rides on a LoRA trained for somewhere else
    params, _ = pretrain(model, params,
                         tasks.stream(TASK_CATEGORIES, args.pretrain_steps, 16, 32, seed=9),
                         lr=2e-3)

    # warm the drafter on phase-1 traffic only
    warm = online.init_trainer(model, torch.Generator(device=dev).manual_seed(7))
    warm, _ = online.online_loop(model, params,
                                 tasks.stream((PHASE1,), args.warm_batches, 8, 16, seed=1),
                                 warm, max_new=MAX_NEW, lr=3e-3)

    f_acc, f_k, _ = run(False, model, params, tasks, warm, n, shift)
    a_acc, a_k, a_eng = run(True, model, params, tasks, warm, n, shift)

    cols = range(0, n, 3)
    print(f"\nacceptance + adaptive K per batch (shift at batch {shift}, "
          f"K in [{DEPTH.k_min},{DEPTH.k_max}]):")
    print("batch:      " + " ".join(f"{i:5d}" for i in cols))
    print("frozen acc: " + " ".join(f"{f_acc[i]:5.2f}" for i in cols))
    print("online acc: " + " ".join(f"{a_acc[i]:5.2f}" for i in cols))
    print("frozen K:   " + " ".join(f"{f_k[i]:5.2f}" for i in cols))
    print("online K:   " + " ".join(f"{a_k[i]:5.2f}" for i in cols))
    post = min(shift + 5, n - 1)
    f_post, a_post = float(np.mean(f_acc[post:])), float(np.mean(a_acc[post:]))
    print(f"\npost-shift acceptance: frozen={f_post:.3f} online={a_post:.3f} "
          f"(recovery {a_post - f_post:+.3f})")
    print(f"post-shift mean depth: frozen={np.mean(f_k[post:]):.2f} "
          f"online={np.mean(a_k[post:]):.2f} "
          f"(the controller re-deepens only as acceptance recovers)")

    # what the DVI training loop was doing while the online arm recovered:
    # schedule phase, the three loss components, and the acceptance EMA the
    # updates steered (dvi_train_* telemetry)
    tt = a_eng.train_telemetry()
    print(f"\nonline drafter training (dvi_train_*): updates={tt['updates']} "
          f"step={tt['step']} phase={tt['phase_name']} "
          f"(lambda_pg={tt['lambda_pg']:.2f} lambda_kl={tt['lambda_kl']:.2f} "
          f"beta={tt['beta']:.3f})")
    print(f"last update: loss={tt['loss']:.4f} kl={tt['loss_kl']:.4f} "
          f"ce={tt['loss_ce']:.4f} pg={tt['loss_pg']:.4f} "
          f"acc_ema {tt['acceptance_ema_before']:.3f}->{tt['acceptance_ema_after']:.3f} "
          f"buffer={tt['buffer_count']:.0f}")
    hist = tt["history"]
    if hist:
        cols_h = range(0, len(hist), max(1, len(hist) // 10))
        print("update step:  " + " ".join(f"{hist[i]['step']:6d}" for i in cols_h))
        print("loss:         " + " ".join(f"{hist[i]['loss']:6.3f}" for i in cols_h))
        print("acc_ema:      " + " ".join(f"{hist[i]['ema_after']:6.3f}" for i in cols_h))
    return {"frozen_acc": f_acc, "online_acc": a_acc, "frozen_k": f_k, "online_k": a_k,
            "frozen_post": f_post, "online_post": a_post, "updates": tt["updates"]}


if __name__ == "__main__":
    main()
