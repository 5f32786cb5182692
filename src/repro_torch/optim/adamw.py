"""AdamW, global-norm clipping and learning-rate schedules: port of
``repro.optim.adamw``, as plain functions on tensors in the reference's
formulas (clip first, bias-corrected moments, ``weight_decay * p`` added to
the step), not ``torch.optim.AdamW``, whose step accounting and eps
placement are its own.

Parameters, gradients and moments are flat dicts of tensors.  Everything is
written in place and stays on the device: the update never reads a value
on the host, so it adds no sync, and a CUDA graph that holds the
parameters' addresses reads the new values.
"""
from __future__ import annotations

import math

import torch


def adamw_init(params: dict) -> dict:
    """{"m", "v": float32 zeros like each parameter, "step": int32 0}."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, the norm before
    scaling); both stay device tensors."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gnorm


def adamw_update(params: dict, grads: dict, state: dict, lr, *, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, max_norm=1.0, out=None) -> torch.Tensor:
    """One AdamW step.  The moments and ``state["step"]`` advance in place;
    the new parameter values are written into `out` (a dict of tensors like
    `params`), by default into `params` themselves.  `lr` may be a tensor.
    Returns the gradients' global norm before clipping, on the device."""
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    state["step"].add_(1)
    sf = state["step"].to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, sf)
    bc2 = 1.0 - torch.pow(b2, sf)
    out = params if out is None else out
    for k, p in params.items():
        g, m, v = grads[k].float(), state["m"][k], state["v"][k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
        out[k].copy_(p.float() - lr * delta)
    return gnorm


def _step(step) -> torch.Tensor:
    return step.to(torch.float32) if torch.is_tensor(step) else torch.tensor(float(step))


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def f(step):
        frac = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return f


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def f(step):
        s = _step(step)
        w = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
        return torch.where(s < warmup, base_lr * w, cos(s - warmup))
    return f
