"""The KL->RL control schedules (paper §3.4), port of the first half of
``repro.core.schedule``:

    (lambda_pg, lambda_kl)(t) =
        (0, lambda_0)                                   t < T_warmup
        linear ramp to (lambda_pg_max, lambda_kl_min)   T_warmup <= t < T_warmup + T_ramp
        (lambda_pg_max, lambda_kl_min)                  after

beta(t) for the on-policy correction decays from beta0 to beta_min.  The
step `t` may be a device tensor (the trainer's step): the schedules are
tensor ops on it and never read it on the host.  ``phase_info`` is the
host-side mirror for telemetry.  The per-lane depth controller of the
reference's second half comes with adaptive depth (ROADMAP item 10).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import DVIConfig


def _step(t) -> torch.Tensor:
    return t.to(torch.float32) if torch.is_tensor(t) else torch.tensor(float(t))


def lambda_schedule(t, dvi: DVIConfig):
    """t: a step (int or tensor).  Returns (lambda_pg, lambda_kl) float32
    tensors on t's device."""
    t = _step(t)
    frac = torch.clamp((t - dvi.warmup_steps) / max(dvi.ramp_steps, 1), 0.0, 1.0)
    lam_pg = frac * dvi.lambda_pg_max
    lam_kl = dvi.lambda_kl0 - frac * (dvi.lambda_kl0 - dvi.lambda_kl_min)
    return lam_pg, lam_kl


def beta_schedule(t, dvi: DVIConfig) -> torch.Tensor:
    decay = torch.exp(-_step(t) / max(dvi.beta_decay_steps, 1))
    return dvi.beta_min + (dvi.beta0 - dvi.beta_min) * decay


def policy_gate(t, dvi: DVIConfig) -> torch.Tensor:
    """On-policy correction is off during warmup, ramps in with lambda_pg."""
    lam_pg, _ = lambda_schedule(t, dvi)
    return lam_pg / max(dvi.lambda_pg_max, 1e-9)


def phase_info(t: int, dvi: DVIConfig) -> dict:
    """Host-side, math-only mirror of the schedules at step `t`, for
    telemetry: ``{phase, phase_name, lambda_pg, lambda_kl, beta, gate}``
    with phase 0 = warmup, 1 = ramp, 2 = rl."""
    t = float(t)
    frac = min(max((t - dvi.warmup_steps) / max(dvi.ramp_steps, 1), 0.0), 1.0)
    lam_pg = frac * dvi.lambda_pg_max
    lam_kl = dvi.lambda_kl0 - frac * (dvi.lambda_kl0 - dvi.lambda_kl_min)
    beta = dvi.beta_min + (dvi.beta0 - dvi.beta_min) * math.exp(
        -t / max(dvi.beta_decay_steps, 1))
    phase = 0 if t < dvi.warmup_steps else (1 if frac < 1.0 else 2)
    return {"phase": phase,
            "phase_name": ("warmup", "ramp", "rl")[phase],
            "lambda_pg": lam_pg, "lambda_kl": lam_kl, "beta": beta,
            "gate": lam_pg / max(dvi.lambda_pg_max, 1e-9)}
