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
(``ar_generate``).  Temperature sampling (``rejection_commit``), per-lane
depth (``k_lane``) and ``spec_superstep`` are later slices and raise.
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
    lanes marked done are masked out (accept = 0, cache length unchanged,
    pending passed through); their eager K/V writes land past their length
    and are never read."""
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
    hks, toks = [], []
    for _ in range(K + 1):
        x = model.embed_block(params, pend[:, None])
        h_k, cache_c = model.step(params, x, cache_c, 0, k)
        dlog = draft_logits(model, params, dvi_params, h_k[:, 0])
        pend = torch.argmax(dlog, dim=-1).to(torch.int32)
        cache_c = model.commit(cache_c, draft_accept)
        hks.append(h_k[:, 0])
        toks.append(pend)
    hk_blk = torch.stack(hks, dim=1)                      # (B, K+1, d)
    d_blk = torch.stack(toks, dim=1)                      # (B, K+1)

    # ---- verify: one deep pass over the h_k block ----
    h_L_blk, cache_v = model.step(params, hk_blk, dict(cache_c, lengths=t0), k, L)
    y_star = verify_tokens(model, params, h_L_blk)        # (B, K+1)

    matches = (d_blk[:, :K] == y_star[:, :K]).to(torch.int32)
    m = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32)
    accept = torch.where(done, 0, m + 1).to(torch.int32)
    cache_new = model.commit(cache_v, accept)

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
    blocks, committed, accepted, drafted = zero, zero, zero, zero
    ar = torch.arange(K + 1, device=dev)
    steps = 0

    while not bool(done.all()):
        blk = spec_block_step(model, params, dvi_params, pending, cache,
                              k_spec=K, done=done)
        # the reference's dynamic_update_slice clamps its start index, so a
        # done lane's block may land before Tp + max_new: mirror the clamp
        start = torch.clamp(out_len, max=total - (K + 1))
        out.scatter_(1, (start[:, None] + ar[None, :]).long(), blk.commit_vec)
        emitted_eos = ((ar[None, :] < blk.accept[:, None])
                       & (blk.commit_vec == eos_id)).any(dim=1)
        out_len = out_len + blk.accept
        new_done = done | emitted_eos | (out_len >= Tp + max_new)
        if collect:
            buf = log_block_tuples(cfg, buf, blk, pending, done, k_spec=K)
        live = (~done).to(torch.int64)
        blocks = blocks + live.sum()
        committed = committed + blk.accept.sum()
        accepted = accepted + (blk.m * live).sum()
        drafted = drafted + K * live.sum()
        pending, done, cache = blk.pending, new_done, blk.cache
        steps += 1
    return GenResult(out, out_len, blocks, committed, accepted, drafted, buf, steps)


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
