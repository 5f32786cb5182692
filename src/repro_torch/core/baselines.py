"""The paper's Table 2 comparators: port of ``repro.core.baselines``.

* ``two_model_generate`` — classic speculative sampling (SpS, greedy): a
  separate small drafter LM proposes K tokens, one feed each through its own
  cache, and the target verifies ``[pending, d_1..d_K]`` in one pass over
  its cache.  Both models' greedy tokens come from the ``verify_argmax``
  kernel (``spec.verify_tokens``), as ``ar_generate``'s do, so greedy SpS
  commits exactly what the target's ``ar_generate`` commits.
* Medusa-lite — ``init_medusa_heads``, ``medusa_head_logits``,
  ``train_medusa_heads``, ``medusa_generate``: time-independent residual
  heads ``z_i = h + silu(h @ w1_i)`` on h_L read through the frozen head,
  sequential (non-tree) verification, heads trained offline with
  teacher-forced cross-entropy.

Each generator is split as ``spec.speculative_generate`` is: a block
function (``two_model_block``, ``medusa_block``) does ONE block and its
bookkeeping, writing the caches' K/V and the ``out`` stream in place, and
the functional loop over it tests ``all(done)`` on the host once a block.
``core.graphs`` replays the same block functions as one CUDA graph a block
(``TwoModelRunner``, ``MedusaRunner``).

Two behaviours of the reference are kept on purpose (ROADMAP §3): after a
fully accepted SpS block the drafter's cache never holds d_K (its scan feeds
``pending, d_1..d_{K-1}`` and the rollback clamps to ``min(accept, K)``), so
from then on the drafter's positions lag the target's by one, which costs
acceptance and never losslessness; and that rollback only truncates
``lengths``, so the drafter is meant to be attention-only.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import spec
from repro_torch.core.spec import GEN_COUNTERS, GenResult
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init, adamw_update


def init_state(prompts: torch.Tensor, K: int, max_new: int, caches: dict) -> dict:
    """A generation's state over prompts (B, Tp), Tp >= 2, whose first Tp-1
    tokens the `caches` (by name) already hold: the last prompt token
    pending, the stream ``out`` (B, Tp + max_new + K + 2) holding the
    prompts, and the ``GEN_COUNTERS`` at zero."""
    B, Tp = prompts.shape
    dev = prompts.device
    out = torch.zeros((B, Tp + max_new + K + 2), dtype=torch.int32, device=dev)
    out[:, :Tp] = prompts
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return dict(pending=prompts[:, Tp - 1].to(torch.int32),
                done=torch.zeros((B,), dtype=torch.bool, device=dev), out=out,
                out_len=torch.full((B,), Tp, dtype=torch.int32, device=dev),
                **caches, **{name: zero for name in GEN_COUNTERS})


def _commit(st: dict, commit_vec: torch.Tensor, accept: torch.Tensor, tok: torch.Tensor,
            accepted: torch.Tensor, drafted: int, limit: int, eos_id: int) -> dict:
    """The block's bookkeeping, shared by both baselines: `commit_vec`
    (B, W) lands in ``out`` at each lane's length (the reference's
    ``dynamic_update_slice``, whose start is clamped; done lanes too), the
    first `accept` of it count, a lane is done once it emits EOS or reaches
    `limit` tokens, `tok` becomes the live lanes' pending token, and the
    counters add the live lanes' blocks, accepts, `accepted` drafts and
    `drafted` proposals."""
    done, out, out_len = st["done"], st["out"], st["out_len"]
    W = commit_vec.shape[1]
    ar = torch.arange(W, device=done.device)
    start = torch.clamp(out_len, max=out.shape[1] - W)
    out.scatter_(1, (start[:, None] + ar[None, :]).long(), commit_vec)
    emitted_eos = ((ar[None, :] < accept[:, None]) & (commit_vec == eos_id)).any(dim=1)
    new_len = out_len + accept
    live = (~done).to(torch.int64)
    return dict(st, pending=torch.where(done, st["pending"], tok),
                done=done | emitted_eos | (new_len >= limit), out_len=new_len,
                blocks=st["blocks"] + live.sum(), committed=st["committed"] + accept.sum(),
                accepted_drafts=st["accepted_drafts"] + (accepted * live).sum(),
                drafted=st["drafted"] + drafted * live.sum())


def _loop(block, st: dict) -> GenResult:
    steps = 0
    while not bool(st["done"].all()):
        st = block(st)
        steps += 1
    return GenResult(st["out"], st["out_len"], *(st[name] for name in GEN_COUNTERS), None,
                     steps)


# ---------------------------------------------------------------------------
# Two-model speculative decoding (SpS)
# ---------------------------------------------------------------------------

def two_model_block(target: Model, t_params: dict, draft: Model, d_params: dict, st: dict, *,
                    k_spec: int, limit: int, eos_id: int) -> dict:
    """ONE SpS block with its bookkeeping, shared by ``two_model_generate``
    and the block-step graph (``graphs.TwoModelRunner``).

    st: ``init_state``'s keys with the caches "t_cache" (target) and
    "d_cache" (drafter).  The drafter makes K greedy feeds (``draft.step``
    and ``draft.commit``, one token each, every lane), the target verifies
    ``[pending, d_1..d_K]`` in one ``target.step``, and the longest agreeing
    prefix m plus the target's token at m are committed.  The target's
    cache advances by m + 1; the drafter's rolls back to its start plus
    min(m + 1, K) (done lanes: 0), by length alone.  Returns the state after
    the block as a new dict; the caches' K/V and "out" are written in place."""
    K = k_spec
    pending, done = st["pending"], st["done"]
    B = pending.shape[0]
    dev = pending.device
    t_cache, d_cache = st["t_cache"], st["d_cache"]
    t0d = d_cache["lengths"]
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    dc, pend, toks = d_cache, pending, []
    for _ in range(K):
        x = draft.embed_block(d_params, pend[:, None], dc["lengths"])
        h, dc, cands = draft.step(d_params, x, dc)
        pend = spec.verify_tokens(draft, d_params, h)[:, 0]
        dc = draft.commit(dc, cands, ones)
        toks.append(pend)
    d_blk = torch.stack(toks, dim=1)                             # (B, K)
    tok_blk = torch.cat([pending[:, None], d_blk], dim=1)        # (B, K+1)
    h, t_cache2, t_cands = target.step(
        t_params, target.embed_block(t_params, tok_blk, t_cache["lengths"]), t_cache)
    y_star = spec.verify_tokens(target, t_params, h)             # (B, K+1)
    matches = d_blk == y_star[:, :K]
    m = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    accept = torch.where(done, 0, m + 1).to(torch.int32)
    t_cache3 = target.commit(t_cache2, t_cands, accept)
    # the drafter consumed K feeds from t0d; the (K+1)-th token was never fed
    d_accept = torch.where(done, 0, torch.clamp(accept, max=K))
    d_cache3 = dict(dc, lengths=(t0d + d_accept).to(torch.int32))
    y_at_m = y_star.gather(1, m[:, None].long())[:, 0]
    ar = torch.arange(K + 1, device=dev)
    commit_vec = torch.where(ar[None, :] < m[:, None], F.pad(d_blk, (0, 1)), y_at_m[:, None])
    st = dict(st, t_cache=t_cache3, d_cache=d_cache3)
    return _commit(st, commit_vec, accept, y_at_m, m, K, limit, eos_id)


def two_model_generate(target: Model, t_params: dict, draft: Model, d_params: dict,
                       prompts: torch.Tensor, max_new: int, k_spec: int = 4, eos_id: int = 1,
                       cache_len: Optional[int] = None) -> GenResult:
    """Classic lossless greedy speculative decoding with a separate drafter
    LM of the target's vocabulary, on prompts (B, Tp), Tp >= 2.  Both models
    run their own KV cache: the system overhead DVI's single-model geometry
    removes (paper §1)."""
    K = k_spec
    B, Tp = prompts.shape
    prompts = prompts.to(torch.int32)
    cap = cache_len or (Tp + max_new + K + 2 + tfm.RING_SLACK)
    _, t_cache = target.prefill(t_params, prompts[:, :Tp - 1], max_len=cap)
    _, d_cache = draft.prefill(d_params, prompts[:, :Tp - 1], max_len=cap)
    st = init_state(prompts, K, max_new, dict(t_cache=t_cache, d_cache=d_cache))
    return _loop(lambda s: two_model_block(target, t_params, draft, d_params, s, k_spec=K,
                                           limit=Tp + max_new, eos_id=eos_id), st)


# ---------------------------------------------------------------------------
# Medusa-lite: extra time-independent heads on h_L, sequential verification
# ---------------------------------------------------------------------------

def init_medusa_heads(gen: torch.Generator, model: Model, num_heads: int = 3) -> dict:
    """{"w1": (num_heads, d, d) float32}, each head's W1 drawn from `gen`
    at scale 0.01 (the residual block ``W2 silu(W1 h) + h`` with W2 the
    identity, read through the frozen head)."""
    d = model.cfg.d_model
    return {"w1": torch.stack([dense_init(gen, (d, d), torch.float32, scale=0.01)
                               for _ in range(num_heads)])}


def medusa_hiddens(heads: dict, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) -> each head's residual hidden (num_heads, ..., d):
    ``h + silu(h.float() @ w1).to(h.dtype)``."""
    w1 = heads["w1"]
    u = torch.matmul(h.float().reshape(1, -1, h.shape[-1]), w1)   # (nh, N, d)
    return h + F.silu(u).reshape(w1.shape[0], *h.shape).to(h.dtype)


def medusa_head_logits(model: Model, params: dict, heads: dict, h: torch.Tensor):
    """h (..., d) -> the heads' logits (num_heads, ..., V) through the frozen
    verifier head (final norm + unembed)."""
    return model.logits(params, medusa_hiddens(heads, h))


def train_medusa_heads(model: Model, params: dict, heads: dict,
                       data_stream: Iterable, lr: float = 1e-3, log_every: int = 0,
                       on_step=None) -> dict:
    """Offline teacher-forced CE: head i predicts token t+2+i from h_L(t).
    The backbone is frozen and runs under ``torch.no_grad()``; only the heads
    get gradients, and AdamW (``optim.adamw_update``) writes them in place.
    `on_step(i, loss)` sees each step's loss as a device scalar.  Returns
    `heads`."""
    opt = adamw_init(heads)
    n_heads = heads["w1"].shape[0]
    for i, tokens in enumerate(data_stream):
        tokens = torch.as_tensor(tokens, device=model.device).long()
        with torch.no_grad():
            h, _ = model.hidden(params, model.embed(params, tokens))
        w1 = heads["w1"].detach().requires_grad_()
        with torch.enable_grad():
            losses = []
            for j in range(n_heads):
                off = 2 + j
                logits = medusa_head_logits(model, params, {"w1": w1[j:j + 1]},
                                            h[:, :-off])[0]
                logp = torch.log_softmax(logits.float(), dim=-1)
                losses.append(-logp.gather(-1, tokens[:, off:, None])[..., 0].mean())
            loss = sum(losses) / n_heads
            grad, = torch.autograd.grad(loss, [w1])
        adamw_update(heads, {"w1": grad}, opt, lr)
        loss = loss.detach()
        if on_step is not None:
            on_step(i, loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"[medusa] step {i + 1}: loss={float(loss):.4f}")
    return heads


def medusa_block(model: Model, params: dict, heads: dict, st: dict, *, limit: int,
                 eos_id: int) -> dict:
    """ONE Medusa-lite block with its bookkeeping, shared by
    ``medusa_generate`` and the block-step graph (``graphs.MedusaRunner``).

    st: ``init_state``'s keys with the cache "cache".  One step on the
    pending token gives h; ``[h; z_1..z_nh]`` (after the final norm) give
    the block ``d = [lm(h), head_1(h)..head_nh(h)]`` through one
    ``verify_argmax`` launch; one step over d verifies it (a second launch).
    d_1 is the target's own token, always accepted, so m >= 1 and a live
    lane commits m + 1 >= 2 tokens.  The cache ends at t0 + 1 + m (done
    lanes: t0).  Returns the state after the block as a new dict; the
    cache's K/V and "out" are written in place."""
    K = 1 + heads["w1"].shape[0]
    pending, done, cache = st["pending"], st["done"], st["cache"]
    B = pending.shape[0]
    t0 = cache["lengths"]
    h, cache1, cands1 = model.step(params, model.embed_block(params, pending[:, None], t0), cache)
    cache1 = model.commit(cache1, cands1, torch.ones((B,), dtype=torch.int32,
                                                     device=pending.device))
    h0 = h[:, 0]
    props = spec.verify_tokens(model, params, torch.cat([h0[None], medusa_hiddens(heads, h0)]))
    d_blk = props.T.contiguous()                                 # (B, K)
    hb, cache2, cands2 = model.step(params, model.embed_block(params, d_blk, cache1["lengths"]),
                                    cache1)
    y_star = spec.verify_tokens(model, params, hb)               # (B, K)
    matches = d_blk[:, 1:] == y_star[:, :K - 1]
    m = (1 + torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)).to(torch.int32)
    accept = torch.where(done, 0, m + 1).to(torch.int32)
    blk_accept = torch.where(done, 0, torch.clamp(m, max=K)).to(torch.int32)
    cache3 = model.commit(cache2, cands2, blk_accept)
    cache3 = dict(cache3, lengths=torch.where(done, t0, t0 + 1 + blk_accept).to(torch.int32))
    y_at = y_star.gather(1, (m - 1)[:, None].long())[:, 0]
    ar = torch.arange(K + 1, device=pending.device)
    commit_vec = torch.where(ar[None, :] < m[:, None], F.pad(d_blk, (0, 1)), y_at[:, None])
    return _commit(dict(st, cache=cache3), commit_vec, accept, y_at, m - 1, K - 1, limit,
                   eos_id)


def medusa_generate(model: Model, params: dict, heads: dict, prompts: torch.Tensor,
                    max_new: int, eos_id: int = 1,
                    cache_len: Optional[int] = None) -> GenResult:
    """Sequential (non-tree) Medusa decoding on prompts (B, Tp), Tp >= 2:
    a block is ``[lm(h), head_1(h)..head_nh(h)]``, verified in one pass."""
    K = 1 + heads["w1"].shape[0]
    B, Tp = prompts.shape
    prompts = prompts.to(torch.int32)
    cap = cache_len or (Tp + max_new + K + 2 + tfm.RING_SLACK)
    _, cache = model.prefill(params, prompts[:, :Tp - 1], max_len=cap)
    st = init_state(prompts, K, max_new, dict(cache=cache))
    return _loop(lambda s: medusa_block(model, params, heads, s, limit=Tp + max_new,
                                        eos_id=eos_id), st)
