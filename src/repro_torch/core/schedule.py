"""Training-aware control schedules, port of ``repro.core.schedule``.

1. The KL->RL annealing schedule (paper §3.4):

    (lambda_pg, lambda_kl)(t) =
        (0, lambda_0)                                   t < T_warmup
        linear ramp to (lambda_pg_max, lambda_kl_min)   T_warmup <= t < T_warmup + T_ramp
        (lambda_pg_max, lambda_kl_min)                  after

beta(t) for the on-policy correction decays from beta0 to beta_min.  The
step `t` may be a device tensor (the trainer's step): the schedules are
tensor ops on it and never read it on the host.  ``phase_info`` is the
host-side mirror for telemetry.

2. The per-lane speculation-depth controller (``DepthConfig`` /
``depth_update``): each lane keeps an EMA of its per-block acceptance
fraction ``r = m / k`` and moves its depth AIMD-style, +1 when the EMA
reaches ``hi`` and halved when it falls to ``lo``, each move arming a
``cooldown``.  ``depth_update`` is tensor ops on the device with no host
read, run after every block of a superstep, so depth changes only at block
boundaries; ``max_depth_rises`` is its host-side bound for page growth.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

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



# ---------------------------------------------------------------------------
# per-lane adaptive speculation depth
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DepthConfig:
    """Knobs of the per-lane depth controller.  ``k_min >= 1``: a lane at
    depth 0 drafts nothing, sees no accept/reject signal and could never
    rise again.  ``cooldown >= 1`` bounds the rises over a superstep
    (``max_depth_rises``), which page growth provisions for."""
    k_min: int = 1
    k_max: int = 4
    k_init: int = 4              # depth of a freshly admitted lane
    ema_alpha: float = 0.25      # acceptance-EMA step a block
    hi: float = 0.70             # EMA >= hi (cooled down): k += 1
    lo: float = 0.35             # EMA <= lo (cooled down): k = max(k // 2, k_min)
    cooldown: int = 4            # blocks between depth changes of a lane
    ema_init: float = 0.5        # neutral start between lo and hi

    def __post_init__(self):
        if not 1 <= self.k_min <= self.k_init <= self.k_max:
            raise ValueError(f"need 1 <= k_min <= k_init <= k_max, got "
                             f"({self.k_min}, {self.k_init}, {self.k_max})")
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1 (bounds depth slew rate)")
        if not 0.0 <= self.lo < self.hi <= 1.0:
            raise ValueError(f"need 0 <= lo < hi <= 1, got ({self.lo}, {self.hi})")


def init_depth_state(dc: DepthConfig, n: int, device="cpu"):
    """Fresh controller state for `n` lanes: (k int32, ema float32, cool
    int32) tensors on `device`."""
    return (torch.full((n,), dc.k_init, dtype=torch.int32, device=device),
            torch.full((n,), dc.ema_init, dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.int32, device=device))


def depth_update(dc: DepthConfig, k, ema, cool, m, live, k_hi=None):
    """ONE controller step at a block boundary, on the device.

    k / ema / cool: (B,) per-lane state; m: (B,) accepted drafted tokens of
    the block; live: (B,) bool, masked lanes keep their state.  `k_hi`: an
    optional per-lane ceiling below ``k_max`` (the depth page growth
    provisioned for).  Returns the new (k, ema, cool)."""
    k_hi = (torch.full_like(k, dc.k_max) if k_hi is None
            else torch.as_tensor(k_hi, dtype=torch.int32, device=k.device))
    r = m.to(torch.float32) / torch.clamp(k, min=1).to(torch.float32)
    ema2 = torch.where(live, ema + dc.ema_alpha * (r - ema), ema)
    cool2 = torch.where(live, torch.clamp(cool - 1, min=0), cool)
    ready = live & (cool2 == 0)
    up = ready & (ema2 >= dc.hi) & (k < k_hi)
    dn = ready & (ema2 <= dc.lo) & (k > dc.k_min)
    k2 = torch.where(up, torch.minimum(k + 1, k_hi),
                     torch.where(dn, torch.clamp(k // 2, min=dc.k_min), k))
    cool2 = torch.where(up | dn, torch.full_like(cool2, dc.cooldown), cool2)
    return k2.to(torch.int32), ema2, cool2.to(torch.int32)


def max_depth_rises(dc: DepthConfig, steps: int, cool0: int) -> int:
    """Host-side upper bound on the +1 rises ``depth_update`` can make over
    `steps` blocks for a lane entering with cooldown `cool0`: page growth
    provisions ``k + max_depth_rises`` and passes it back as ``k_hi``."""
    first = max(int(cool0) - 1, 0)       # cool decrements before the gate
    if first >= steps:
        return 0
    return 1 + (steps - 1 - first) // max(dc.cooldown, 1)
