"""Online DVI trainer: closes the loop between speculation and learning.
Port of ``repro.core.online``.

Prompts stream in one batch at a time; each batch is generated with tuple
logging into the replay buffer, then the LoRA drafter takes small, frequent
updates from the buffer (paper: 2000 prompts -> 2000 optimizer steps).

Every update works in place on the trainer state: A and B (or staging
tensors the caller folds in later), the optimizer's moments and step, the
baseline and the step.  The block-step's CUDA graphs hold the addresses of
A, B and the replay buffer (``core.graphs``), so nothing here rebinds them.
An update reads no value on the host: it adds no sync, and its metrics stay
device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import buffer as buffer_mod
from repro_torch.core import graphs as graphs_mod
from repro_torch.core import losses as losses_mod
from repro_torch.core.lora import init_draft_params
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init, adamw_update


@dataclass
class OnlineTrainerState:
    dvi_params: dict             # {"A": (d, r), "B": (r, V)} float32
    opt_state: dict              # adamw_init's {"m", "v", "step"}
    buf: dict                    # the replay ring (core.buffer)
    baseline: torch.Tensor       # () float32: EMA of recent rewards
    step: torch.Tensor           # () int32: optimizer step t (drives the KL->RL schedule)


def init_trainer(model: Model, gen: Optional[torch.Generator] = None, slots: int = 0, *,
                 dvi_params: Optional[dict] = None) -> OnlineTrainerState:
    """Draft params drawn from `gen` (on the model's device), or the given
    `dvi_params` tensors themselves; fresh optimizer state, an empty buffer
    of `slots` (0: the config's), baseline and step 0."""
    if dvi_params is None:
        dvi_params = init_draft_params(gen, model.cfg)
    dev = model.device
    return OnlineTrainerState(
        dvi_params=dvi_params,
        opt_state=adamw_init(dvi_params),
        buf=buffer_mod.init_buffer(model.cfg, slots, device=dev),
        baseline=torch.zeros((), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def make_update_fn(model: Model, mode: str = "full", lr: float = 1e-3):
    """One minibatch LoRA update from the buffer:
    ``update(params, state, gen, out=None) -> metrics``.

    It samples a minibatch (``buffer_mod.sample``, looked up at call time)
    and, in mode "full", takes the fresh batch; runs ``composite_loss``
    forward and backward in A and B; takes an AdamW step; advances the EMA
    baseline and the step.  The new A and B go into `out` ({"A", "B"}
    tensors like the state's) when given, else into the state's own; every
    other write is in place on the state.  Returns the reference's metrics
    plus ``gnorm``, ``baseline_before``, ``baseline_after`` and
    ``buffer_count``, as device scalars."""
    dvi = model.cfg.dvi

    def update(params: dict, state: OnlineTrainerState, gen: torch.Generator,
               out: Optional[dict] = None) -> dict:
        batch = buffer_mod.sample(state.buf, gen, dvi.batch_size)
        fresh = buffer_mod.fresh_batch(state.buf, dvi.batch_size) if mode == "full" else None
        leaves = {k: p.detach().requires_grad_() for k, p in state.dvi_params.items()}
        with torch.enable_grad():
            loss, metrics = losses_mod.composite_loss(leaves, model, params, batch, fresh,
                                                      state.step, state.baseline, mode)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        metrics = {k: v.detach() for k, v in metrics.items()}
        before = state.baseline.clone()
        gnorm = adamw_update(state.dvi_params, grads, state.opt_state, lr, out=out)
        # EMA baseline over the observed batch acceptance
        state.baseline.mul_(dvi.baseline_ema).add_((1 - dvi.baseline_ema) * metrics["acc_rate"])
        state.step.add_(1)
        metrics.update(gnorm=gnorm, baseline_before=before,
                       baseline_after=state.baseline.clone(),
                       buffer_count=state.buf["count"].clone())
        return metrics

    return update


def online_loop(model: Model, params: dict, prompt_stream, state: OnlineTrainerState, *,
                max_new: int = 64, updates_per_batch: int = 1, mode: str = "full",
                lr: float = 1e-3, gen: Optional[torch.Generator] = None,
                log_every: int = 0, graphs: bool = True):
    """The paper's generate-and-improve loop over a prompt stream.

    prompt_stream: iterable of (B, Tp) int arrays or tensors (one Tp per
    batch).  Each batch is generated through ``graphs.GenerateRunner`` (one
    CUDA graph a block-step on the card with `graphs`), the counterpart of
    the reference's jitted ``speculative_generate``, then
    `updates_per_batch` updates follow.  Returns (state, history) with the
    reference's per-batch keys."""
    gen = gen if gen is not None else torch.Generator(device=model.device).manual_seed(0)
    update = make_update_fn(model, mode, lr)
    runner = graphs_mod.GenerateRunner(model, params, state.dvi_params, state.buf,
                                       max_new=max_new, graphs=graphs)
    history = {"acc_rate": [], "block_acc": [], "mat": [], "loss": [], "kl": []}
    for bi, prompts in enumerate(prompt_stream):
        prompts = torch.as_tensor(prompts, device=model.device)
        live = torch.ones((prompts.shape[0],), dtype=torch.bool, device=model.device)
        res = runner.generate(prompts, live)
        block_acc = float(res.accepted_drafts) / max(float(res.drafted), 1.0)
        mat = float(res.committed) / max(float(res.blocks), 1.0)
        for _ in range(updates_per_batch):
            metrics = update(params, state, gen)
        history["block_acc"].append(block_acc)
        history["mat"].append(mat)
        history["acc_rate"].append(float(metrics["acc_rate"]))
        history["loss"].append(float(metrics["loss"]))
        history["kl"].append(float(metrics["kl"]))
        if log_every and (bi + 1) % log_every == 0:
            print(f"[online] batch {bi+1}: block_acc={block_acc:.3f} "
                  f"MAT={mat:.2f} loss={history['loss'][-1]:.4f} "
                  f"kl={history['kl'][-1]:.4f} step={int(state.step)}")
    return state, history
