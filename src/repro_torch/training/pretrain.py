"""Backbone pretraining and the DVI drafter's teacher-forced step: port of
``repro.training.pretrain``.

``make_pretrain_step`` — full-model next-token cross-entropy with AdamW
(weight decay 0.01 on every leaf, as the reference): it gives a backbone
real predictive structure before DVI learns a drafter on it.

``make_dvi_train_step`` — the paper's training workload (the `train_4k`
shape): one forward h_k -> h_L without autograd, the composite KL->RL loss,
gradients and AdamW state for the LoRA factors ONLY.  The backbone never
sees a gradient; that is what makes training-aware serving cheap.

Both steps run eagerly and update in place: the parameters, the moments
and the step counter keep their tensors (``optim.adamw_update``), and a
tied ``lm_head`` is refreshed from ``embed`` after every pretraining step
(``models.model.refresh_head``).  The step's metrics stay device tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import losses as losses_mod
from repro_torch.models.model import Model, refresh_head, trained_tree
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import flatten, unflatten


def lm_loss(model: Model, params: dict, tokens: torch.Tensor, aux_inputs=None,
            remat: bool = False):
    """Mean float32 next-token NLL of `tokens` (B, T) under the model (a
    VLM's P patch positions, which lead its logits, dropped), plus the
    forward's auxiliary loss.  `aux_inputs`: the modality stubs.  Returns
    (loss, {"nll", "aux"})."""
    logits, aux = model.forward_train(params, tokens, aux_inputs, remat=remat)
    logits = logits[:, model.prefix_len():]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return nll.mean() + aux, {"nll": nll.mean(), "aux": aux}


def loss_and_grads(model: Model, params: dict, tokens: torch.Tensor, remat: bool = False,
                   aux_inputs=None):
    """(loss, metrics, grads): ``lm_loss`` and its gradient in every trained
    leaf, keyed by "/"-joined path (``trained_tree``; a tied model's head
    gradient lands on ``embed``; an encoder's and a ``vision_proj``'s
    leaves too).  The parameters are not written."""
    leaves = {k: p.detach().requires_grad_() for k, p in
              flatten(trained_tree(model.cfg, params)).items()}
    with torch.enable_grad():
        loss, metrics = lm_loss(model, unflatten(leaves), tokens, aux_inputs, remat)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_pretrain_step(model: Model, lr, remat: bool = False):
    """``step(params, opt_state, tokens, aux_inputs=None) -> (params,
    opt_state, metrics)``; lr is a float or a schedule of the step
    (``optim.cosine_schedule``).
    `opt_state` is ``adamw_init`` of the flat trained parameters
    (``init_pretrain_state``).  `params` and `opt_state` are updated in
    place and returned; metrics {"nll", "aux", "loss", "gnorm"} are device
    scalars."""
    lr_fn = lr if callable(lr) else (lambda s: lr)

    def step(params: dict, opt_state: dict, tokens: torch.Tensor, aux_inputs=None):
        loss, metrics, grads = loss_and_grads(model, params, tokens, remat, aux_inputs)
        flat = flatten(trained_tree(model.cfg, params))
        gnorm = adamw_update(flat, grads, opt_state, lr_fn(opt_state["step"]),
                             weight_decay=0.01)
        refresh_head(model.cfg, params)
        metrics.update(loss=loss, gnorm=gnorm)
        return params, opt_state, metrics

    return step


def init_pretrain_state(model: Model, params: dict) -> dict:
    """AdamW state of the trained parameters (``trained_tree``), keyed by
    path."""
    return adamw_init(flatten(trained_tree(model.cfg, params)))


def pretrain(model: Model, params: dict, data_stream, *, lr=1e-3, remat: bool = False,
             log_every: int = 0, aux_inputs_fn=None, on_step=None):
    """Train the backbone over a stream of (B, T) token batches (numpy or
    tensors), in place.  ``aux_inputs_fn(tokens)``, when given, makes each
    batch's modality stubs; ``on_step(i, metrics)`` runs after each step.
    Returns (params, losses) with one float loss a step."""
    opt_state = init_pretrain_state(model, params)
    step_fn = make_pretrain_step(model, lr, remat)
    losses = []
    for i, tokens in enumerate(data_stream):
        tokens = torch.as_tensor(tokens, device=model.device)
        aux = aux_inputs_fn(tokens) if aux_inputs_fn else None
        params, opt_state, metrics = step_fn(params, opt_state, tokens, aux)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(i, metrics)
        if log_every and (i + 1) % log_every == 0:
            print(f"[pretrain] step {i+1}: loss={losses[-1]:.4f}")
    return params, losses


def make_dvi_train_step(model: Model, lr: float = 1e-3, mode: str = "full",
                        remat: bool = False):
    """The paper's drafter-update step over a token batch:
    ``step(params, dvi_params, opt_state, tokens, t, baseline,
    aux_inputs=None) -> (dvi_params, opt_state, baseline, metrics)``.

    ``losses.dense_train_losses`` runs the backbone without autograd (so
    `remat`, kept for the reference's signature, has nothing to
    recompute), then the draft head through the differentiable
    ``lora_logits``.  A and B, the moments and the optimizer step are
    updated in place; the new EMA baseline is a new device scalar, and the
    metrics (with ``gnorm``) stay on the device: the step reads nothing on
    the host."""
    ema = model.cfg.dvi.baseline_ema

    def step(params: dict, dvi_params: dict, opt_state: dict, tokens: torch.Tensor, t,
             baseline, aux_inputs=None):
        leaves = {k: p.detach().requires_grad_() for k, p in dvi_params.items()}
        with torch.enable_grad():
            loss, metrics = losses_mod.dense_train_losses(model, params, leaves, tokens, t,
                                                          baseline, mode, aux_inputs)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        metrics = {k: v.detach() for k, v in metrics.items()}
        gnorm = adamw_update(dvi_params, grads, opt_state, lr)
        baseline = ema * baseline + (1 - ema) * metrics["acc_rate"]
        metrics["gnorm"] = gnorm
        return dvi_params, opt_state, baseline, metrics

    return step
