"""Mixture-of-Experts FFN with capacity dispatch (GShard-style): port of
``repro.models.moe``.  Tokens split into one group per shard of the hint
mesh's "data" axis (``num_groups``; one group without a hint mesh, every
run on one card), each group routed and capacity-limited on its own.

Each token's top-k experts are chosen by a float32 router; the token's
rows go into a per-expert buffer (E, C, d) at their rank among the rows
routed to that expert within its group, rows ranked C or later are
dropped (capacity-factor routing), every expert runs over its whole buffer, and the outputs are
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
from repro_torch.launch import hints
from repro_torch.launch.hints import hint
from repro_torch.launch.mesh import axis_sizes
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
    same expert, for flat_e (..., Nk) expert ids, each leading index (a
    token group) ranked on its own.  Few rows: a one-hot cumulative sum
    (built by comparison: ``F.one_hot`` checks its range on the host);
    many: a stable sort and each run's start by a cumulative max.  Both
    give the same ranks."""
    Nk = flat_e.shape[-1]
    ar = torch.arange(Nk, device=flat_e.device)
    if Nk * E <= one_hot_limit:
        oh = (flat_e[..., None] == torch.arange(E, device=flat_e.device)).to(torch.int32)
        ranks = torch.cumsum(oh, dim=-2) - oh
        return ranks.gather(-1, flat_e[..., None].long())[..., 0]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    is_start = torch.cat([torch.ones_like(sorted_e[..., :1], dtype=torch.bool),
                          sorted_e[..., 1:] != sorted_e[..., :-1]], dim=-1)
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=-1).values
    return torch.zeros(flat_e.shape, dtype=torch.int32, device=flat_e.device).scatter_(
        -1, order, (ar - seg_start).to(torch.int32))


def capacity(N: int, mo: MoEConfig, dropless: bool) -> int:
    """Rows of each expert's buffer for a group of N tokens: N when
    dropless, else max(8, ceil(N k / E * capacity_factor))."""
    if dropless:
        return N
    return max(8, int(math.ceil(N * mo.top_k / mo.num_experts * mo.capacity_factor)))


def num_groups(N: int) -> int:
    """Token groups of N tokens: one a shard of the hint mesh's "data" axis
    when it divides N (the reference's ``_num_groups``), else one; one
    without a hint mesh."""
    mesh = hints._MESH
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    g = 1
    for ax in ("data",):
        if ax in sizes and N % (g * sizes[ax]) == 0:
            g *= sizes[ax]
    return g


def moe_ffn(p: dict, x: torch.Tensor, mo: MoEConfig, act: str, glu: bool,
            dropless: bool = False):
    """x (B, T, d) -> (y (B, T, d), the load-balance auxiliary loss, a
    float32 scalar E * <f_e><p_e> * router_aux_weight).  The N = B T tokens
    split into ``num_groups(N)`` groups of consecutive tokens, each routed,
    ranked and capacity-limited on its own, as in the reference."""
    B, T, d = x.shape
    N, E, k = B * T, mo.num_experts, mo.top_k
    fn = F.silu if act == "silu" else (lambda u: F.gelu(u, approximate="tanh"))
    g = num_groups(N)
    n = N // g
    xg = hint(x.reshape(g, n, d), "data", None, None)
    probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)         # (g, n, E)
    gate, idx = torch.topk(probs, k, dim=-1)                                 # (g, n, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(g, n * k)
    slot = expert_ranks(flat_e, E)
    C = capacity(n, mo, dropless)
    keep = slot < C
    slot_c = torch.where(keep, slot, C)                                      # C: dropped
    # the buffer's row map (g, E, C): source row of each (expert, rank), -1
    # empty; dropped rows all land in the spare column C, which is cut off
    # (a row of (g E, C + 1) a group and expert; one group adds no offsets)
    ge = flat_e.long() if g == 1 else \
        flat_e.long() + E * torch.arange(g, device=x.device)[:, None]
    idx_map = torch.full((g * E, C + 1), -1, dtype=torch.long, device=x.device)
    idx_map.index_put_((ge, slot_c.long()), torch.arange(n * k, device=x.device).expand(g, n * k))
    idx_map = idx_map[:, :C].reshape(g, E * C)
    upd = hint(xg.repeat_interleave(k, dim=1), "data", None, "model")        # (g, n k, d)
    rows_in = torch.gather(upd, 1, idx_map.clamp(min=0)[..., None].expand(g, E * C, d))
    buf = torch.where((idx_map >= 0)[..., None], rows_in,
                      torch.zeros((), dtype=x.dtype, device=x.device)).reshape(g, E, C, d)
    buf = hint(buf, "data", None, None, "model")
    # expert-parallel re-layout: the experts move onto "model"
    buf = hint(buf, "data", "model", None, None)
    h = experts(buf, p["we_gate"])                                           # (g, E, C, fe)
    h = fn(h) * experts(buf, p["we_up"]) if glu else fn(h)
    h = hint(h, "data", "model", None, None)
    out_buf = hint(experts(h, p["we_down"]), "data", "model", None, None)   # (g, E, C, d)
    out_buf = hint(out_buf.reshape(g, E * C, d), "data", None, None)
    flat_slot = flat_e.long() * C + torch.clamp(slot_c, max=C - 1).long()    # (g, n k)
    rows = torch.gather(out_buf, 1, flat_slot[..., None].expand(g, n * k, d))
    rows = rows * (keep[..., None] * gate.reshape(g, n * k)[..., None]).to(rows.dtype)
    y = rows.reshape(g, n, k, d).sum(dim=2)
    if mo.num_shared_experts:
        hs = xg @ p["ws_gate"]
        hs = fn(hs) * (xg @ p["ws_up"]) if glu else fn(hs)
        y = y + hs @ p["ws_down"]
    frac_dispatch = (idx[..., None] == torch.arange(E, device=x.device)).float().mean(
        dim=(0, 1, 2))
    aux = E * torch.sum(frac_dispatch * probs.mean(dim=(0, 1))) * mo.router_aux_weight
    return y.reshape(B, T, d), aux


def experts(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert's rows of every group through its own matrix:
    buf (g, E, C, a) @ w (E, a, b) -> (g, E, C, b), one batched product over
    the experts (the group's rows of an expert side by side)."""
    g, E, C, a = buf.shape
    out = torch.bmm(buf.transpose(0, 1).reshape(E, g * C, a), w)
    return out.reshape(E, g, C, w.shape[-1]).transpose(0, 1)
