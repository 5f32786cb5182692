"""Mixture-of-Experts FFN with capacity dispatch (GShard-style): port of
``repro.models.moe`` for one group (the reference splits tokens into one
group per data-parallel shard; without a mesh it has one).

Each token's top-k experts are chosen by a float32 router; the token's
rows go into a per-expert buffer (E, C, d) at their rank among the rows
routed to that expert, rows ranked C or later are dropped (capacity-factor
routing), every expert runs over its whole buffer, and the outputs are
gathered back and weighed by the renormalised gate.  ``dropless=True``
(the block-decode path) sets C = N, so no token is ever dropped and
speculative verification on MoE stacks is deterministic.  Every shape
depends on N alone, never on the routing: the step replays as one CUDA
graph.  The expert products are plain ``torch`` batched products, as the
reference computes them outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init

# above this many (rows x experts) the ranks come from a stable sort rather
# than the one-hot cumulative sum (the reference's threshold)
ONE_HOT_LIMIT = 1 << 22


def init_moe(gen: torch.Generator, n: int, d: int, mo: MoEConfig, glu: bool,
             dtype: torch.dtype) -> dict:
    """Random parameters of `n` stacked MoE FFNs, on the generator's device:
    the router (n, d, E) float32, the experts (n, E, d, fe) / (n, E, fe, d)
    and the shared experts, in the reference's layout."""
    fe, E = mo.d_ff_expert, mo.num_experts
    p = {"router": dense_init(gen, (n, d, E), torch.float32),
         "we_gate": dense_init(gen, (n, E, d, fe), dtype),
         "we_down": dense_init(gen, (n, E, fe, d), dtype)}
    if glu:
        p["we_up"] = dense_init(gen, (n, E, d, fe), dtype)
    if mo.num_shared_experts:
        fs = (mo.d_ff_shared or fe) * mo.num_shared_experts
        p["ws_gate"] = dense_init(gen, (n, d, fs), dtype)
        p["ws_down"] = dense_init(gen, (n, fs, d), dtype)
        if glu:
            p["ws_up"] = dense_init(gen, (n, d, fs), dtype)
    return p


def expert_ranks(flat_e: torch.Tensor, E: int, one_hot_limit: int = ONE_HOT_LIMIT
                 ) -> torch.Tensor:
    """The rank (0-based) of each row among the earlier rows routed to the
    same expert, for flat_e (Nk,) expert ids.  Few rows: a one-hot
    cumulative sum (built by comparison: ``F.one_hot`` checks its range on
    the host); many: a stable sort and each run's start by a cumulative
    max.  Both give the same ranks."""
    Nk = flat_e.shape[0]
    ar = torch.arange(Nk, device=flat_e.device)
    if Nk * E <= one_hot_limit:
        oh = (flat_e[:, None] == torch.arange(E, device=flat_e.device)[None, :]).to(torch.int32)
        ranks = torch.cumsum(oh, dim=0) - oh
        return ranks.gather(1, flat_e[:, None].long())[:, 0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=flat_e.device),
                          sorted_e[1:] != sorted_e[:-1]])
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    return torch.zeros((Nk,), dtype=torch.int32, device=flat_e.device).scatter_(
        0, order, (ar - seg_start).to(torch.int32))


def capacity(N: int, mo: MoEConfig, dropless: bool) -> int:
    """Rows of each expert's buffer for N tokens: N when dropless, else
    max(8, ceil(N k / E * capacity_factor))."""
    if dropless:
        return N
    return max(8, int(math.ceil(N * mo.top_k / mo.num_experts * mo.capacity_factor)))


def moe_ffn(p: dict, x: torch.Tensor, mo: MoEConfig, act: str, glu: bool,
            dropless: bool = False):
    """x (B, T, d) -> (y (B, T, d), the load-balance auxiliary loss, a
    float32 scalar E * <f_e><p_e> * router_aux_weight)."""
    B, T, d = x.shape
    N, E, k = B * T, mo.num_experts, mo.top_k
    fn = F.silu if act == "silu" else (lambda u: F.gelu(u, approximate="tanh"))
    xf = x.reshape(N, d)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)          # (N, E)
    gate, idx = torch.topk(probs, k, dim=-1)                                 # (N, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(N * k)
    slot = expert_ranks(flat_e, E)
    C = capacity(N, mo, dropless)
    keep = slot < C
    slot_c = torch.where(keep, slot, C)                                      # C: dropped
    # the buffer's row map (E, C): source row of each (expert, rank), -1 empty;
    # dropped rows all land in the spare column C, which is cut off
    idx_map = torch.full((E, C + 1), -1, dtype=torch.long, device=x.device)
    idx_map.index_put_((flat_e.long(), slot_c.long()),
                       torch.arange(N * k, device=x.device))
    idx_map = idx_map[:, :C].reshape(E * C)
    upd = xf.repeat_interleave(k, dim=0)                                     # (N k, d)
    buf = torch.where((idx_map >= 0)[:, None], upd[idx_map.clamp(min=0)],
                      torch.zeros((), dtype=x.dtype, device=x.device)).reshape(E, C, d)
    h = torch.bmm(buf, p["we_gate"])                                         # (E, C, fe)
    h = fn(h) * torch.bmm(buf, p["we_up"]) if glu else fn(h)
    out_buf = torch.bmm(h, p["we_down"]).reshape(E * C, d)
    rows = out_buf[(flat_e.long() * C + torch.clamp(slot_c, max=C - 1).long())]
    rows = rows * (keep[:, None] * gate.reshape(N * k)[:, None]).to(rows.dtype)
    y = rows.reshape(N, k, d).sum(dim=1)
    if mo.num_shared_experts:
        hs = xf @ p["ws_gate"]
        hs = fn(hs) * (xf @ p["ws_up"]) if glu else fn(hs)
        y = y + hs @ p["ws_down"]
    frac_dispatch = (idx[..., None] == torch.arange(E, device=x.device)).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac_dispatch * probs.mean(dim=0)) * mo.router_aux_weight
    return y.reshape(B, T, d), aux
