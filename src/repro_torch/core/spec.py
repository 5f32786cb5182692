"""Draft -> Verify -> commit, greedy (paper §3.2-3.3): port of ``repro.core.spec``.

One speculative block at committed length t:

1. **Draft** — K+1 shallow feeds through layers [0, k).  Feed j embeds the
   pending token, produces ``h_k(t+j)``, and the LoRA draft head
   (``lora_logits`` kernel) greedily proposes the next token.
2. **Verify** — one deep pass of layers [k, L) over the h_k block; the
   verifier's greedy tokens come from the ``verify_argmax`` kernel on the
   normed h_L, so the (B, K+1, V) logits are never materialised.
3. **Commit** — the longest agreeing prefix m plus the verifier's token at
   m: m+1 tokens per block, exactly the target path's greedy decoding.
   Drafted positions 1..K up to the first reject go to the replay buffer.

``k_spec=0`` is plain autoregressive decoding through the same code
(``ar_generate``).  ``spec_superstep`` fuses up to ``steps`` blocks into one
dispatch for the continuous serving engine.  Temperature sampling
(``rejection_commit``), per-lane depth (``k_lane``) and the adaptive-depth
controller are later slices and raise.

The cache may be contiguous or paged (its block table rides in
``cache["tbl"]``): the block code is layout-agnostic.  Stateful (SSM)
segments return per-token candidate states from every ``model.step``: each
draft feed commits its shallow candidates with ``draft_accept`` (done lanes
stay frozen), and the final commit selects both the restacked shallow and
the deep candidates at each lane's accepted length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import buffer as buffer_mod
from repro_torch.core.lora import draft_logits
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import Model


class GenResult(NamedTuple):
    tokens: torch.Tensor           # (B, total) committed stream (prompt + gen)
    lengths: torch.Tensor          # (B,) valid token count
    blocks: torch.Tensor           # scalar: live lane-blocks (verification steps)
    committed: torch.Tensor        # scalar: committed tokens (gen only)
    accepted_drafts: torch.Tensor  # scalar: accepted drafted tokens
    drafted: torch.Tensor          # scalar: drafted tokens (live blocks * K)
    buffer: Optional[dict]
    steps: int                     # loop iterations (batch block-steps)


class SuperstepResult(NamedTuple):
    """Result of a fused run of ``iters`` speculative blocks (one dispatch,
    one host sync).  ``gen_buf[:, :gen_count]`` holds the tokens committed
    THIS superstep per lane, already EOS/budget-capped; the per-lane
    counters summarise what a per-block host loop would have accumulated."""
    pending: torch.Tensor          # (B,) next pending token
    done: torch.Tensor             # (B,) bool, in-graph EOS/budget exits included
    gen_buf: torch.Tensor          # (B, >= steps*(K+1)) committed tokens, capped
    gen_count: torch.Tensor        # (B,) valid prefix length of gen_buf
    lane_blocks: torch.Tensor      # (B,) blocks the lane was live for
    lane_committed: torch.Tensor   # (B,) cache advance (sum of accepts)
    lane_accepted: torch.Tensor    # (B,) accepted drafted tokens (sum of m)
    lane_drafted: torch.Tensor     # (B,) drafted tokens (K per live block)
    accept_hist: torch.Tensor      # (K+1,) live blocks by accepted drafts m
    depth_hist: torch.Tensor       # (K+1,) live blocks by the depth they ran at
    cache: dict                    # advanced decode cache
    buffer: Optional[dict]         # replay buffer with this superstep's tuples
    iters: int                     # blocks run (the loop's iterations)


# the per-lane counters of a superstep, in SuperstepResult's order
LANE_COUNTERS = ("gen_count", "lane_blocks", "lane_committed", "lane_accepted",
                 "lane_drafted")
# the batch counters of a generation, in GenResult's order
GEN_COUNTERS = ("blocks", "committed", "accepted_drafts", "drafted")


class BlockStep(NamedTuple):
    """Result of ONE speculative block (draft K+1, verify once, commit m+1)."""
    pending: torch.Tensor          # (B,) next pending token (unchanged where done)
    commit_vec: torch.Tensor       # (B, K+1) committed tokens (first `accept` valid)
    accept: torch.Tensor           # (B,) committed count: m+1 live, 0 where done
    m: torch.Tensor                # (B,) accepted drafted tokens this block
    cache: dict                    # advanced decode cache
    hk_blk: torch.Tensor           # (B, K+1, d) draft-path hiddens
    hL_blk: torch.Tensor           # (B, K+1, d) target-path hiddens
    d_blk: torch.Tensor            # (B, K+1) drafted tokens


def _greedy_only(temperature: float, k_lane=None) -> None:
    if temperature > 0.0:
        raise NotImplementedError("temperature sampling / rejection_commit is a "
                                  "later slice of the port (ROADMAP item 9)")
    if k_lane is not None:
        raise NotImplementedError("per-lane depth (k_lane) is a later slice of "
                                  "the port (ROADMAP item 10)")


def _restack_cands(cand_list):
    """Per-feed shallow candidates [{seg: {leaf: (n, B, 1, ...)}}] * (K+1)
    -> {seg: {leaf: (n, B, K+1, ...)}}."""
    return {name: {key: torch.cat([c[name][key] for c in cand_list], dim=2)
                   for key in leaves}
            for name, leaves in cand_list[0].items()}


def verify_tokens(model: Model, params: dict, h_L: torch.Tensor) -> torch.Tensor:
    """Verifier greedy tokens argmax(final_norm(h_L) @ head) for h_L (B, T, d),
    through the ``verify_argmax`` kernel.  Returns (B, T) int32."""
    B, T, d = h_L.shape
    hn = rms_norm(h_L, params["final_norm"], model.cfg.norm_eps)
    arg, _ = ops.verify_argmax(hn.reshape(B * T, d), model.head_matrix(params))
    return arg.reshape(B, T)


def spec_block_step(model: Model, params: dict, dvi_params: dict,
                    pending: torch.Tensor, cache: dict, *,
                    k_spec: Optional[int] = None,
                    done: Optional[torch.Tensor] = None,
                    temperature: float = 0.0,
                    k_lane: Optional[torch.Tensor] = None) -> BlockStep:
    """ONE greedy speculative block against a live cache.

    pending: (B,) the last committed token per lane.  done: (B,) bool —
    lanes marked done are masked out (accept = 0, cache length and SSM
    states unchanged, pending passed through); their eager K/V writes land
    past their length and are never read."""
    _greedy_only(temperature, k_lane)
    cfg = model.cfg
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    k, L = cfg.dvi.split_layer, cfg.num_layers
    B = pending.shape[0]
    dev = pending.device
    done = torch.zeros((B,), dtype=torch.bool, device=dev) if done is None else done
    t0 = cache["lengths"]
    draft_accept = (~done).to(torch.int32)

    cache_c, pend = cache, pending
    hks, toks, shallow = [], [], []
    for _ in range(K + 1):
        x = model.embed_block(params, pend[:, None])
        h_k, cache_c, cands = model.step(params, x, cache_c, 0, k)
        dlog = draft_logits(model, params, dvi_params, h_k[:, 0])
        pend = torch.argmax(dlog, dim=-1).to(torch.int32)
        cache_c = model.commit(cache_c, cands, draft_accept)
        hks.append(h_k[:, 0])
        toks.append(pend)
        shallow.append(cands)
    hk_blk = torch.stack(hks, dim=1)                      # (B, K+1, d)
    d_blk = torch.stack(toks, dim=1)                      # (B, K+1)

    # ---- verify: one deep pass over the h_k block ----
    h_L_blk, cache_v, deep = model.step(params, hk_blk, dict(cache_c, lengths=t0), k, L)
    y_star = verify_tokens(model, params, h_L_blk)        # (B, K+1)

    matches = (d_blk[:, :K] == y_star[:, :K]).to(torch.int32)
    m = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32)
    accept = torch.where(done, 0, m + 1).to(torch.int32)
    cache_new = model.commit(cache_v, dict(_restack_cands(shallow), **deep), accept)

    ar = torch.arange(K + 1, device=dev)
    y_at_m = y_star.gather(1, m[:, None].long())[:, 0]
    commit_vec = torch.where(ar[None, :] < m[:, None], d_blk, y_at_m[:, None])
    new_pending = torch.where(done, pending, y_at_m)
    return BlockStep(new_pending, commit_vec, accept, m, cache_new,
                     hk_blk, h_L_blk, d_blk)


def log_block_tuples(cfg, buf: dict, step: BlockStep, prev_pending: torch.Tensor,
                     done: torch.Tensor, k_spec: Optional[int] = None) -> dict:
    """Append one block's accept/reject tuples to the replay buffer: drafted
    positions 1..K up to and including the first reject; lanes marked
    `done` are excluded."""
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    if K == 0:
        return buf
    B = step.d_blk.shape[0]
    d = cfg.d_model
    dev = step.d_blk.device
    i_idx = torch.arange(1, K + 1, device=dev)            # (K,)
    lim = torch.clamp(step.m + 1, max=K)
    valid = (~done)[:, None] & (i_idx[None, :] <= lim[:, None])
    reward = (i_idx[None, :] <= step.m[:, None]).to(torch.float32)
    prev = torch.cat([prev_pending[:, None], step.d_blk[:, :K - 1]], dim=1)
    return buffer_mod.add_block(
        buf,
        step.hk_blk[:, :K].reshape(B * K, d),
        step.hL_blk[:, :K].reshape(B * K, d),
        step.d_blk[:, :K].reshape(B * K),
        reward.reshape(B * K),
        i_idx[None].expand(B, K).reshape(B * K),
        prev.reshape(B * K),
        valid.reshape(B * K))


def spec_superstep(model: Model, params: dict, dvi_params: dict,
                   pending: torch.Tensor, cache: dict, *, steps: int,
                   done: Optional[torch.Tensor] = None,
                   budget: Optional[torch.Tensor] = None,
                   eos_id: int = 1,
                   buf: Optional[dict] = None,
                   collect: bool = False,
                   k_spec: Optional[int] = None,
                   temperature: float = 0.0,
                   k_lane: Optional[torch.Tensor] = None,
                   depth_cfg=None) -> SuperstepResult:
    """Fused multi-block tick: run ``steps`` speculative blocks with no host
    check in between, so the serving engine syncs with the device once per
    superstep instead of once per block.

    Everything a per-block host loop did between blocks happens on the
    device: committed tokens are appended to a per-lane buffer with the
    loop's sequential semantics (stop at the lane's remaining ``budget``;
    stop just after the first EOS), lanes flip ``done`` the block they
    exhaust their budget or emit EOS (masking them out of every later
    block: accept = 0, cache length and pending unchanged, no tuples), and
    per-lane counters and the accept/depth histograms accumulate.

    The reference's device loop exits once every lane is done.  Here the
    loop always runs ``steps`` blocks, since testing ``done.all()`` would
    sync; blocks after the last lane finished ride along fully masked and
    change nothing (the replay buffer's write generation advances only on
    a block with a live lane, as in the reference).  A caller may pass the
    largest remaining budget of a live lane as ``steps`` without a sync:
    every live block commits at least one token.

    ``budget``: (B,) int32 REMAINING generation budget per lane."""
    _greedy_only(temperature, k_lane)
    if depth_cfg is not None:
        raise NotImplementedError("the adaptive-depth controller is a later slice "
                                  "of the port (ROADMAP item 10)")
    if steps < 1:
        raise ValueError("spec_superstep needs steps >= 1")
    cfg = model.cfg
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    B = pending.shape[0]
    dev = pending.device
    done = torch.zeros((B,), dtype=torch.bool, device=dev) if done is None else done
    budget = (torch.full((B,), torch.iinfo(torch.int32).max // 2, dtype=torch.int32,
                         device=dev)
              if budget is None else budget.to(torch.int32))
    if collect and buf is None:
        buf = buffer_mod.init_buffer(cfg, device=dev)
    cap = steps * (K + 1)
    # one spare slot past the buffer takes the writes the reference drops
    gen_flat = torch.zeros((B * cap + 1,), dtype=torch.int32, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.int32, device=dev)

    st = dict(pending=pending, done=done, budget=budget, cache=cache, buf=buf,
              **{name: zeros(B) for name in LANE_COUNTERS},
              accept_hist=zeros(K + 1), depth_hist=zeros(K + 1))
    for _ in range(steps):
        st = superstep_block(model, params, dvi_params, st, gen_flat, cap, k_spec=K,
                             eos_id=eos_id, collect=collect)
    return SuperstepResult(st["pending"], st["done"], gen_flat[:B * cap].view(B, cap),
                           *(st[name] for name in LANE_COUNTERS),
                           st["accept_hist"], st["depth_hist"], st["cache"], st["buf"], steps)


def superstep_block(model: Model, params: dict, dvi_params: dict, st: dict,
                    gen_flat: torch.Tensor, cap: int, *, k_spec: int, eos_id: int,
                    collect: bool) -> dict:
    """ONE block of ``spec_superstep`` with its bookkeeping, shared by the
    functional superstep and the block-step graph (``core.graphs``).

    st: the superstep's state, {"pending", "done", "budget", "cache", "buf",
    the ``LANE_COUNTERS``, "accept_hist", "depth_hist"}.  gen_flat: (B * cap
    + 1,) int32, lane b's committed tokens at [b * cap, (b + 1) * cap) and a
    spare last slot for the writes the reference drops.  Returns the state
    after the block as a new dict; gen_flat, the histograms, the cache's
    K/V and SSM states and the buffer's rows are written in place."""
    K = k_spec
    pending, done, budget, cache = st["pending"], st["done"], st["budget"], st["cache"]
    gen_count, buf = st["gen_count"], st["buf"]
    B = pending.shape[0]
    dev = pending.device
    ar = torch.arange(K + 1, device=dev)
    base = torch.arange(B, device=dev)[:, None] * cap
    depth = torch.full((B,), K, dtype=torch.long, device=dev)
    live = (~done).to(torch.int32)
    blk = spec_block_step(model, params, dvi_params, pending, cache, k_spec=K, done=done)
    can = ((ar[None, :] < blk.accept[:, None])
           & (gen_count[:, None] + ar[None, :] < budget[:, None]))
    hit_eos = can & (blk.commit_vec == eos_id)
    eos_before = torch.cumsum(hit_eos.to(torch.int32), dim=1) - hit_eos.to(torch.int32)
    written = can & (eos_before == 0)
    dest = torch.where(written, base + gen_count[:, None] + ar[None, :], B * cap)
    gen_flat.index_put_((dest.reshape(-1),), blk.commit_vec.reshape(-1))
    new_count = (gen_count + written.sum(dim=1)).to(torch.int32)
    new_done = done | hit_eos.any(dim=1) | (new_count >= budget)
    if collect:
        gen0 = buf["gen"]
        buf = log_block_tuples(model.cfg, buf, blk, pending, done, k_spec=K)
        buf["gen"] = torch.where(live.any(), buf["gen"], gen0)
    st["accept_hist"].scatter_add_(0, blk.m.long(), live)
    st["depth_hist"].scatter_add_(0, depth, live)
    return dict(st, pending=blk.pending, done=new_done, cache=blk.cache, buf=buf,
                gen_count=new_count, lane_blocks=st["lane_blocks"] + live,
                lane_committed=st["lane_committed"] + blk.accept,
                lane_accepted=st["lane_accepted"] + blk.m * live,
                lane_drafted=st["lane_drafted"] + K * live)


def speculative_generate(model: Model, params: dict, dvi_params: dict,
                         prompts: torch.Tensor, max_new: int,
                         k_spec: Optional[int] = None,
                         eos_id: int = 1,
                         collect: bool = False,
                         buf: Optional[dict] = None,
                         temperature: float = 0.0,
                         live_mask: Optional[torch.Tensor] = None) -> GenResult:
    """Batched lossless greedy speculative generation with optional tuple
    logging.  prompts: (B, Tp) with Tp >= 2, one length for the batch.

    live_mask: (B,) bool — lanes marked False (batch padding) generate
    nothing, log no tuples and count in no statistics.  The loop tests
    ``all(done)`` on the host once per block."""
    _greedy_only(temperature)
    cfg = model.cfg
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    B, Tp = prompts.shape
    if Tp < 2:
        raise ValueError("need at least 2 prompt tokens (one prefill + one pending)")
    dev = prompts.device
    prompts = prompts.to(torch.int32)
    total = Tp + max_new + K + 2

    # ---- prefill all but the last prompt token; it becomes `pending` ----
    _, cache = model.prefill(params, prompts[:, :Tp - 1], max_len=total + tfm.RING_SLACK)
    pending = prompts[:, Tp - 1]
    out = torch.zeros((B, total), dtype=torch.int32, device=dev)
    out[:, :Tp] = prompts
    out_len = torch.full((B,), Tp, dtype=torch.int32, device=dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if live_mask is None
            else ~live_mask.to(dev))
    if collect and buf is None:
        buf = buffer_mod.init_buffer(cfg, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = dict(pending=pending, done=done, cache=cache, buf=buf, out=out, out_len=out_len,
              **{name: zero for name in GEN_COUNTERS})
    steps = 0
    while not bool(st["done"].all()):
        st = generate_block(model, params, dvi_params, st, k_spec=K, limit=Tp + max_new,
                            eos_id=eos_id, collect=collect)
        steps += 1
    return GenResult(st["out"], st["out_len"], *(st[name] for name in GEN_COUNTERS),
                     st["buf"], steps)


def generate_block(model: Model, params: dict, dvi_params: dict, st: dict, *,
                   k_spec: int, limit: int, eos_id: int, collect: bool) -> dict:
    """ONE block of ``speculative_generate`` with its bookkeeping, shared by
    the functional loop and the block-step graph (``core.graphs``).

    st: {"pending", "done", "cache", "buf", "out" (B, total), "out_len",
    the ``GEN_COUNTERS``}; a lane is done once it emits EOS or reaches
    `limit` (prompt length + max_new) tokens.  Returns the state after the
    block as a new dict; "out", the cache's K/V and SSM states and the
    buffer's rows are written in place."""
    K = k_spec
    pending, done, out, out_len = st["pending"], st["done"], st["out"], st["out_len"]
    total = out.shape[1]
    ar = torch.arange(K + 1, device=pending.device)
    blk = spec_block_step(model, params, dvi_params, pending, st["cache"], k_spec=K,
                          done=done)
    # the reference's dynamic_update_slice clamps its start index, so a
    # done lane's block may land before Tp + max_new: mirror the clamp
    start = torch.clamp(out_len, max=total - (K + 1))
    out.scatter_(1, (start[:, None] + ar[None, :]).long(), blk.commit_vec)
    emitted_eos = ((ar[None, :] < blk.accept[:, None])
                   & (blk.commit_vec == eos_id)).any(dim=1)
    new_len = out_len + blk.accept
    new_done = done | emitted_eos | (new_len >= limit)
    buf = st["buf"]
    if collect:
        buf = log_block_tuples(model.cfg, buf, blk, pending, done, k_spec=K)
    live = (~done).to(torch.int64)
    return dict(st, pending=blk.pending, done=new_done, cache=blk.cache, buf=buf,
                out_len=new_len, blocks=st["blocks"] + live.sum(),
                committed=st["committed"] + blk.accept.sum(),
                accepted_drafts=st["accepted_drafts"] + (blk.m * live).sum(),
                drafted=st["drafted"] + K * live.sum())


def ar_generate(model: Model, params: dict, prompts, max_new, **kw) -> GenResult:
    """Plain greedy autoregressive decoding of the target path (K = 0),
    through the same block code with a rank-1 all-zero draft adapter."""
    dev = prompts.device
    dvi_dummy = {"A": torch.zeros((model.cfg.d_model, 1), dtype=torch.float32, device=dev),
                 "B": torch.zeros((1, model.cfg.vocab_size), dtype=torch.float32, device=dev)}
    return speculative_generate(model, params, dvi_dummy, prompts, max_new,
                                k_spec=0, collect=False, **kw)


def serve_step(model: Model, params: dict, dvi_params: dict, pending, cache,
               k_spec: Optional[int] = None):
    """ONE greedy speculative step against an existing cache; a thin wrapper
    over ``spec_block_step``.  Returns (new_pending, commit_vec, accept,
    new_cache)."""
    blk = spec_block_step(model, params, dvi_params, pending, cache, k_spec=k_spec)
    return blk.pending, blk.commit_vec, blk.accept, blk.cache
