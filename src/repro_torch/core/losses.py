"""DVI composite training objective (paper §3.4), port of
``repro.core.losses``:

    L_fast  = lambda_pg * L_pg + lambda_kl * KL(p_theta || p_phi^tau)
              + w_ce * L_CE - w_ent * H[p_theta]
    L_policy = w_rl * E[-(r - b) log p_theta(a|s)] + beta(t) KL(p_theta||p_phi)

* L_pg: reward-masked CE over accepted positions only.
* L_CE: CE to the verifier's greedy token over all logged positions.
* KL: online distillation to the temperature-softened frozen verifier.
* L_policy: REINFORCE with an EMA-of-rewards baseline over accepted and
  first-reject tuples.

Ablation modes (paper §4.3): 'kl' / 'pg' / 'ce' single-term variants, 'full'
= the KL->RL schedule.

The draft logits come from the ``lora_logits`` kernel through its
differentiable wrapper (gradients in A and B only); the (N, V) softmaxes,
KL and entropy are plain torch, as they are plain jnp in the reference.  In
a bf16 model the buffer's float32 hidden states are normed and rounded to
bf16 before both heads, and the verifier's logits come out in float32 from
bf16 operands (no float32 copy of the head); the reference multiplies the
float32 rows by the bf16 head (ROADMAP §3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import schedule as sched
from repro_torch.core.lora import draft_logits
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import Model


def verifier_logits(model: Model, params: dict, h_L: torch.Tensor) -> torch.Tensor:
    """Frozen target-path logits (..., V) in float32 from buffered deep
    hidden states (..., d)."""
    w = model.head_matrix(params)
    hn = rms_norm(h_L, params["final_norm"], model.cfg.norm_eps).to(w.dtype)
    if w.dtype == torch.float32 or not hn.is_cuda:
        return hn.float() @ w.float()
    flat = hn.reshape(-1, hn.shape[-1])
    return torch.mm(flat, w, out_dtype=torch.float32).reshape(*hn.shape[:-1], w.shape[1])


def _take(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return logp.gather(-1, idx.long()[:, None])[:, 0]


def loss_terms(model: Model, params: dict, dvi_params: dict, batch: dict) -> dict:
    """Per-term losses on a buffer minibatch.  Returns a dict of scalars
    (and the per-row ``act_logp``, ``mask``, ``reward``).  The batch may
    carry its rows' draft and verifier logits already (``logits_t``,
    ``logits_v``); else both heads run here."""
    tau = model.cfg.dvi.kd_temperature
    mask = batch["mask"]                                   # (N,) 0/1
    r = batch["reward"]                                    # (N,) 1 accept / 0 first reject

    logits_t = batch.get("logits_t")
    if logits_t is None:
        logits_t = draft_logits(model, params, dvi_params, batch["h_k"])   # (N, V)
    logits_v = batch.get("logits_v")
    if logits_v is None:
        logits_v = verifier_logits(model, params, batch["h_L"])            # (N, V)

    logp_t = torch.log_softmax(logits_t, dim=-1)
    p_t = torch.exp(logp_t)
    logp_v_tau = torch.log_softmax(logits_v / tau, dim=-1)
    logp_v = torch.log_softmax(logits_v, dim=-1)

    denom = torch.clamp(mask.sum(), min=1.0)
    acc_denom = torch.clamp((mask * r).sum(), min=1.0)

    # KL(p_theta || p_phi^tau), dense online distillation
    kl_tau = torch.sum(p_t * (logp_t - logp_v_tau), dim=-1)
    kl_tau = (kl_tau * mask).sum() / denom
    kl_1 = torch.sum(p_t * (logp_t - logp_v), dim=-1)
    kl_1 = (kl_1 * mask).sum() / denom

    # reward-masked CE on accepted actions
    act_logp = _take(logp_t, batch["action"])
    l_pg = -(act_logp * r * mask).sum() / acc_denom

    # CE to the verifier's greedy token (accepted + first reject)
    star_logp = _take(logp_t, torch.argmax(logits_v, dim=-1))
    l_ce = -(star_logp * mask).sum() / denom

    ent = (-torch.sum(p_t * logp_t, dim=-1) * mask).sum() / denom
    acc_rate = (r * mask).sum() / denom
    return {"kl_tau": kl_tau, "kl_1": kl_1, "l_pg": l_pg, "l_ce": l_ce,
            "entropy": ent, "act_logp": act_logp, "acc_rate": acc_rate,
            "mask": mask, "reward": r}


def _policy_gradient(terms: dict, baseline) -> torch.Tensor:
    adv = (terms["reward"] - baseline) * terms["mask"]
    return -(adv * terms["act_logp"]).sum() / torch.clamp(terms["mask"].sum(), min=1.0)


def composite_loss(dvi_params: dict, model: Model, params: dict, batch: dict,
                   fresh: Optional[dict], t, baseline, mode: str = "full"):
    """The DVI objective at optimizer step `t` (an int or a device tensor).
    Returns (loss, metrics), all device scalars."""
    dvi = model.cfg.dvi
    terms = loss_terms(model, params, dvi_params, batch)
    lam_pg, lam_kl = sched.lambda_schedule(t, dvi)
    gate = sched.policy_gate(t, dvi)
    beta = sched.beta_schedule(t, dvi)
    pg_on = torch.zeros((), dtype=torch.float32, device=terms["l_pg"].device)

    if mode == "kl":
        loss = terms["kl_tau"]
    elif mode == "pg":
        loss = _policy_gradient(terms, baseline)      # pure on-policy REINFORCE
    elif mode == "ce":
        loss = terms["l_pg"]                          # reward-masked CE only
    else:
        loss = (lam_pg * terms["l_pg"] + lam_kl * terms["kl_tau"]
                + dvi.w_ce * terms["l_ce"] - dvi.w_ent * terms["entropy"])
        if fresh is not None:
            ft = loss_terms(model, params, dvi_params, fresh)
            pg_on = _policy_gradient(ft, baseline)
            loss = loss + gate * (dvi.w_rl * pg_on + beta * ft["kl_1"])

    # every DVI component and the schedule state, whatever the mode: the
    # dvi_train_* telemetry reads these keys unconditionally
    metrics = {"loss": loss, "kl": terms["kl_tau"], "l_pg": terms["l_pg"],
               "l_ce": terms["l_ce"], "entropy": terms["entropy"],
               "acc_rate": terms["acc_rate"], "lam_pg": lam_pg,
               "lam_kl": lam_kl, "pg_on": pg_on, "beta": beta, "gate": gate}
    return loss, metrics


def dense_train_losses(model: Model, params: dict, dvi_params: dict, tokens: torch.Tensor,
                       t, baseline, mode: str = "full", aux_inputs=None, remat: bool = False,
                       max_positions: int = 8192):
    """Teacher-forced batch variant of the objective: one forward computes
    h_k and h_L at every position, position-wise accept = (draft greedy ==
    verifier greedy), and the composite loss applies with the dense accept
    mask as reward.  Positions are stride-subsampled to at most
    `max_positions` before the (N, V) logits.  The backbone runs without
    autograd; gradients reach only the LoRA factors.  `aux_inputs` are the
    modality stubs (``Model.embed`` / ``Model.encode``): a VLM's patch
    positions lead the sequence and count as positions, as in the
    reference.  `remat` stands where the reference's does, so a positional
    call binds the same arguments; it changes no value and no memory here,
    since the backbone keeps no activations for a backward."""
    cfg = model.cfg
    k = cfg.dvi.split_layer
    with torch.no_grad():
        enc = model.encode(params, aux_inputs) if cfg.encoder is not None else None
        x = model.embed(params, tokens, aux_inputs)
        P = model.prefix_len()
        h_k, _ = model.hidden(params, x, 0, k, prefix_len=P, enc_out=enc)
        h_L, _ = model.hidden(params, h_k, k, prefix_len=P, enc_out=enc)
    d = h_k.shape[-1]
    # position i's tuple: (h_k[i], predicts token i+1); drop the last position
    hk = h_k[:, :-1].reshape(-1, d)
    hL = h_L[:, :-1].reshape(-1, d)
    N = hk.shape[0]
    if N > max_positions:
        stride = -(-N // max_positions)
        hk, hL = hk[::stride], hL[::stride]
    logits_t = draft_logits(model, params, dvi_params, hk)
    logits_v = verifier_logits(model, params, hL)
    a = torch.argmax(logits_t, dim=-1)
    y = torch.argmax(logits_v, dim=-1)
    reward = (a == y).to(torch.float32)
    # the loss reuses both heads' logits: one lora_logits launch a call (the
    # reference computes each head twice and leaves XLA to merge them)
    batch = {"h_k": hk, "h_L": hL, "action": a, "reward": reward,
             "mask": torch.ones_like(reward), "logits_t": logits_t, "logits_v": logits_v}
    return composite_loss(dvi_params, model, params, batch, None, t, baseline, mode)
