"""Draft -> Verify -> commit (paper §3.2-3.3): port of ``repro.core.spec``.

One speculative block at committed length t:

1. **Draft** — K+1 shallow feeds through layers [0, k).  Feed j embeds the
   pending token, produces ``h_k(t+j)``, and the LoRA draft head
   (``lora_logits`` kernel) proposes the next token: greedily, or at
   temperature T > 0 by a Gumbel-max draw from ``softmax(logits / T)``.
2. **Verify** — one deep pass of layers [k, L) over the h_k block.  Greedy:
   the verifier's tokens come from the ``verify_argmax`` kernel on the
   normed h_L, so the (B, K+1, V) logits are never materialised.  Sampled:
   the float32 verifier logits (one head product) feed
   ``rejection_commit``, Leviathan-style speculative sampling.
3. **Commit** — the longest accepted prefix m plus the verifier's token at
   m (greedy: its argmax; sampled: a draw from the residual or, when every
   draft was accepted, from p): m+1 tokens per block, distributed exactly
   as the target path's decoding.  Drafted positions 1..K up to the first
   reject go to the replay buffer.

``k_spec=0`` is plain autoregressive decoding through the same code
(``ar_generate``).  ``spec_superstep`` fuses up to ``steps`` blocks into one
dispatch for the continuous serving engine.  ``k_lane`` gives each lane its
own depth <= K (positions at or past it can never be accepted), and with a
``schedule.DepthConfig`` the superstep runs the per-lane depth controller
after every block on the device.

Sampling draws only from an explicit ``torch.Generator`` on the tensors'
device, in the reference's key order: one (B, V) Gumbel draw a feed, then
the acceptance uniforms (B, K), then the correction's (B, V) Gumbel noise.
Gumbel-max makes no host sync.  ``Draws`` hands a block its noise
ready-made instead (the CPU parity tests feed JAX's draws through it).

The cache may be contiguous or paged (its block table rides in
``cache["tbl"]``): the block code is layout-agnostic.  Stateful (SSM and
RG-LRU) segments return per-token candidate states from every
``model.step``: each draft feed commits its shallow candidates with
``draft_accept`` (done lanes stay frozen), and the final commit selects
both the restacked shallow and the deep candidates at each lane's accepted
length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import buffer as buffer_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.lora import draft_logits
from repro_torch.core.losses import verifier_logits
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
    lane_drafted: torch.Tensor     # (B,) drafted tokens (sum of live-block depths)
    k_lane: torch.Tensor           # (B,) speculation depth after the last block
    accept_ema: torch.Tensor       # (B,) depth controller's acceptance EMA
    k_cool: torch.Tensor           # (B,) depth controller's cooldown counter
    accept_hist: torch.Tensor      # (K+1,) live blocks by accepted drafts m
    depth_hist: torch.Tensor       # (K+1,) live blocks by the depth they ran at
    cache: dict                    # advanced decode cache
    buffer: Optional[dict]         # replay buffer with this superstep's tuples
    iters: int                     # blocks run (the loop's iterations)


# the per-lane counters of a superstep, in SuperstepResult's order
LANE_COUNTERS = ("gen_count", "lane_blocks", "lane_committed", "lane_accepted",
                 "lane_drafted")
# the depth controller's per-lane state, in SuperstepResult's order
DEPTH_STATE = ("k_lane", "accept_ema", "k_cool")
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


class Draws(NamedTuple):
    """A block's noise, ready-made: what ``spec_block_step`` would draw from
    its generator, in the same order."""
    feeds: torch.Tensor            # (K+1, B, V) Gumbel noise of each draft feed
    u: torch.Tensor                # (B, K) acceptance uniforms on [0, 1)
    corr: torch.Tensor             # (B, V) Gumbel noise of the correction draw


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """float32 Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _check_sampling(temperature: float, generator, draws, device) -> None:
    if temperature <= 0.0 or draws is not None:
        return
    if generator is None:
        raise ValueError("temperature > 0 draws from an explicit torch.Generator: pass "
                         "generator= (or draws=)")
    if torch.device(generator.device).type != torch.device(device).type:
        raise ValueError(f"the generator is on {generator.device}, the tensors on {device}")


def rejection_commit(d_blk: torch.Tensor, dprobs: torch.Tensor, vprobs: torch.Tensor,
                     k_lane: Optional[torch.Tensor] = None, *,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None,
                     g: Optional[torch.Tensor] = None):
    """Speculative-sampling accept/reject (exact target distribution).

    d_blk (B, K+1) drafted tokens (position K is the bonus feed, unused for
    acceptance); dprobs / vprobs (B, K+1, V) drafter / verifier
    distributions.  Drafted token i is accepted while u_i < p(d_i)/q(d_i);
    at the first reject the correction is drawn from norm(max(p - q, 0)),
    and if every draft was accepted from p at position K.  Returns (m (B,),
    correction (B,)) int32.

    k_lane: optional (B,) per-lane depth <= K: positions at or past it are
    rejected and the bonus fires at m == k_lane.  The uniforms `u` (B, K)
    and the correction's Gumbel noise `g` (B, V) are drawn from `generator`
    in that order unless given."""
    B, K1, V = dprobs.shape
    K = K1 - 1
    dev = dprobs.device
    if generator is None and (u is None or g is None):
        raise ValueError("rejection_commit draws from an explicit torch.Generator: pass "
                         "generator= (or both u= and g=)")
    if u is None:
        u = torch.rand((B, K), generator=generator, dtype=torch.float32, device=dev)
    if g is None:
        g = gumbel((B, V), generator, dev)
    d = d_blk[:, :K, None].long()
    p_at = vprobs[:, :K].gather(-1, d)[..., 0]
    q_at = dprobs[:, :K].gather(-1, d)[..., 0]
    ratio = p_at / torch.clamp(q_at, min=1e-20)
    ok = (u < ratio).to(torch.int32)
    if k_lane is not None:
        ok = ok * (torch.arange(K, device=dev)[None, :] < k_lane[:, None]).to(torch.int32)
    m = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)
    # the correction's distribution at position m: the residual (reject) or p (bonus)
    at_m = m.long()[:, None, None].expand(B, 1, V)
    pm = vprobs.gather(1, at_m)[:, 0]
    qm = dprobs.gather(1, at_m)[:, 0]
    resid = torch.clamp(pm - qm, min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rsum > 1e-20, resid / torch.clamp(rsum, min=1e-20), pm)
    k_eff = K if k_lane is None else k_lane
    dist = torch.where((m == k_eff)[:, None], pm, resid)
    correction = torch.argmax(torch.log(torch.clamp(dist, min=1e-30)) + g, dim=-1)
    return m, correction.to(torch.int32)


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
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Draws] = None,
                    k_lane: Optional[torch.Tensor] = None) -> BlockStep:
    """ONE speculative block against a live cache.

    pending: (B,) the last committed token per lane.  done: (B,) bool —
    lanes marked done are masked out (accept = 0, cache length and SSM
    states unchanged, pending passed through); their eager K/V writes land
    past their length and are never read.

    k_lane: optional (B,) int32 per-lane depth in [0, K]: the draft still
    runs K+1 feeds, but a lane commits at most k_lane + 1 tokens (its extra
    eager writes roll back by length, as rejected drafts do).  With every
    lane at K the block is bit-identical to ``k_lane=None``.

    temperature == 0: greedy drafting and longest-agreeing-prefix
    verification.  temperature > 0: the drafter samples and the verifier
    runs ``rejection_commit``, from `generator` (on the tensors' device) or
    from the ready-made `draws`."""
    cfg = model.cfg
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    k, L = cfg.dvi.split_layer, cfg.num_layers
    B = pending.shape[0]
    dev = pending.device
    sampling = temperature > 0.0
    _check_sampling(temperature, generator, draws, dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev) if done is None else done
    t0 = cache["lengths"]
    draft_accept = (~done).to(torch.int32)

    cache_c, pend = cache, pending
    hks, toks, shallow, dprobs = [], [], [], []
    for j in range(K + 1):
        x = model.embed_block(params, pend[:, None], cache_c["lengths"])
        h_k, cache_c, cands = model.step(params, x, cache_c, 0, k)
        dlog = draft_logits(model, params, dvi_params, h_k[:, 0])
        if sampling:
            z = dlog / temperature
            dprobs.append(torch.softmax(z, dim=-1))
            g = draws.feeds[j] if draws is not None else gumbel(z.shape, generator, dev)
            pend = torch.argmax(z + g, dim=-1).to(torch.int32)
        else:
            pend = torch.argmax(dlog, dim=-1).to(torch.int32)
        cache_c = model.commit(cache_c, cands, draft_accept)
        hks.append(h_k[:, 0])
        toks.append(pend)
        shallow.append(cands)
    hk_blk = torch.stack(hks, dim=1)                      # (B, K+1, d)
    d_blk = torch.stack(toks, dim=1)                      # (B, K+1)

    # ---- verify: one deep pass over the h_k block ----
    h_L_blk, cache_v, deep = model.step(params, hk_blk, dict(cache_c, lengths=t0), k, L)
    if sampling:
        vprobs = torch.softmax(verifier_logits(model, params, h_L_blk) / temperature, dim=-1)
        m, y_at_m = rejection_commit(
            d_blk, torch.stack(dprobs, dim=1), vprobs, k_lane, generator=generator,
            u=None if draws is None else draws.u, g=None if draws is None else draws.corr)
    else:
        y_star = verify_tokens(model, params, h_L_blk)    # (B, K+1)
        matches = d_blk[:, :K] == y_star[:, :K]
        if k_lane is not None:
            matches = matches & (torch.arange(K, device=dev)[None, :] < k_lane[:, None])
        m = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        y_at_m = y_star.gather(1, m[:, None].long())[:, 0]
    accept = torch.where(done, 0, m + 1).to(torch.int32)
    cache_new = model.commit(cache_v, dict(_restack_cands(shallow), **deep), accept)

    ar = torch.arange(K + 1, device=dev)
    commit_vec = torch.where(ar[None, :] < m[:, None], d_blk, y_at_m[:, None])
    new_pending = torch.where(done, pending, y_at_m)
    return BlockStep(new_pending, commit_vec, accept, m, cache_new,
                     hk_blk, h_L_blk, d_blk)


def log_block_tuples(cfg, buf: dict, step: BlockStep, prev_pending: torch.Tensor,
                     done: torch.Tensor, k_spec: Optional[int] = None,
                     k_lane: Optional[torch.Tensor] = None) -> dict:
    """Append one block's accept/reject tuples to the replay buffer: drafted
    positions 1..K up to and including the first reject; lanes marked
    `done` are excluded, and so are positions past a lane's depth
    (`k_lane`), which were never proposed."""
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    if K == 0:
        return buf
    B = step.d_blk.shape[0]
    d = cfg.d_model
    dev = step.d_blk.device
    i_idx = torch.arange(1, K + 1, device=dev)            # (K,)
    lim = (torch.clamp(step.m + 1, max=K) if k_lane is None
           else torch.minimum(step.m + 1, k_lane.to(step.m.dtype)))
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
                   generator: Optional[torch.Generator] = None,
                   k_lane: Optional[torch.Tensor] = None,
                   depth_cfg: Optional[schedule_mod.DepthConfig] = None,
                   accept_ema: Optional[torch.Tensor] = None,
                   k_cool: Optional[torch.Tensor] = None,
                   k_cap: Optional[torch.Tensor] = None) -> SuperstepResult:
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
    a block with a live lane, as in the reference; a sampled superstep
    still draws their noise from the generator).  A caller may pass the
    largest remaining budget of a live lane as ``steps`` without a sync:
    every live block commits at least one token.

    Adaptive depth: ``k_lane`` (B,) gives each lane its own depth <= K; with
    ``depth_cfg`` the depth controller runs on the device after every block
    on the EMA ``accept_ema`` and the cooldown ``k_cool``, and the new (k,
    ema, cool) come back in the result.  ``k_cap`` (B,) is a per-lane
    ceiling the controller cannot rise past (the depth the engine
    provisioned pages for), clipped to K.  With ``k_lane=None`` and
    ``depth_cfg=None`` the blocks are those of the fixed-depth path.

    ``budget``: (B,) int32 REMAINING generation budget per lane."""
    if steps < 1:
        raise ValueError("spec_superstep needs steps >= 1")
    cfg = model.cfg
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    B = pending.shape[0]
    dev = pending.device
    _check_sampling(temperature, generator, None, dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev) if done is None else done
    budget = (torch.full((B,), torch.iinfo(torch.int32).max // 2, dtype=torch.int32,
                         device=dev)
              if budget is None else budget.to(torch.int32))
    if collect and buf is None:
        buf = buffer_mod.init_buffer(cfg, device=dev)
    cap = steps * (K + 1)
    # one spare slot past the buffer takes the writes the reference drops
    gen_flat = torch.zeros((B * cap + 1,), dtype=torch.int32, device=dev)

    def zeros(n, dtype=torch.int32):
        return torch.zeros((n,), dtype=dtype, device=dev)

    k0 = (torch.full((B,), K, dtype=torch.int32, device=dev) if k_lane is None
          else k_lane.to(torch.int32))
    st = dict(pending=pending, done=done, budget=budget, cache=cache, buf=buf,
              **{name: zeros(B) for name in LANE_COUNTERS},
              k_lane=k0,
              accept_ema=zeros(B, torch.float32) if accept_ema is None
              else accept_ema.to(torch.float32),
              k_cool=zeros(B) if k_cool is None else k_cool.to(torch.int32),
              accept_hist=zeros(K + 1), depth_hist=zeros(K + 1))
    k_hi = None if k_cap is None else torch.clamp(k_cap.to(torch.int32), max=K)
    for _ in range(steps):
        st = superstep_block(model, params, dvi_params, st, gen_flat, cap, k_spec=K,
                             eos_id=eos_id, collect=collect, ragged=k_lane is not None,
                             depth_cfg=depth_cfg, k_hi=k_hi, temperature=temperature,
                             generator=generator)
    return SuperstepResult(st["pending"], st["done"], gen_flat[:B * cap].view(B, cap),
                           *(st[name] for name in LANE_COUNTERS + DEPTH_STATE),
                           st["accept_hist"], st["depth_hist"], st["cache"], st["buf"], steps)


def superstep_block(model: Model, params: dict, dvi_params: dict, st: dict,
                    gen_flat: torch.Tensor, cap: int, *, k_spec: int, eos_id: int,
                    collect: bool, ragged: bool = False,
                    depth_cfg: Optional[schedule_mod.DepthConfig] = None,
                    k_hi: Optional[torch.Tensor] = None, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> dict:
    """ONE block of ``spec_superstep`` with its bookkeeping, shared by the
    functional superstep and the block-step graph (``core.graphs``).

    st: the superstep's state, {"pending", "done", "budget", "cache", "buf",
    the ``LANE_COUNTERS``, the ``DEPTH_STATE``, "accept_hist",
    "depth_hist"}.  The block runs at the lanes' depths ``st["k_lane"]``
    when `ragged`, and the controller `depth_cfg` (ceiling `k_hi`) moves
    them after it.  gen_flat: (B * cap + 1,) int32, lane b's committed
    tokens at [b * cap, (b + 1) * cap) and a spare last slot for the writes
    the reference drops.  The histograms may be longer than K+1.  Returns
    the state after the block as a new dict; gen_flat, the histograms, the
    cache's K/V and SSM states and the buffer's rows are written in place."""
    K = k_spec
    pending, done, budget, cache = st["pending"], st["done"], st["budget"], st["cache"]
    gen_count, buf, k = st["gen_count"], st["buf"], st["k_lane"]
    B = pending.shape[0]
    dev = pending.device
    ar = torch.arange(K + 1, device=dev)
    base = torch.arange(B, device=dev)[:, None] * cap
    live = (~done).to(torch.int32)
    blk = spec_block_step(model, params, dvi_params, pending, cache, k_spec=K, done=done,
                          temperature=temperature, generator=generator,
                          k_lane=k if ragged else None)
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
        buf = log_block_tuples(model.cfg, buf, blk, pending, done, k_spec=K,
                               k_lane=k if ragged else None)
        buf["gen"] = torch.where(live.any(), buf["gen"], gen0)
    # per live block: the accepted drafts m and the depth k it ran at
    st["accept_hist"].scatter_add_(0, blk.m.long(), live)
    st["depth_hist"].scatter_add_(0, k.long(), live)
    drafted = st["lane_drafted"] + k * live
    ema, cool = st["accept_ema"], st["k_cool"]
    if depth_cfg is not None:
        # the controller sees this block's (k, m) and sets the next block's
        # depth; masked lanes keep their state
        k, ema, cool = schedule_mod.depth_update(depth_cfg, k, ema, cool, blk.m, ~done,
                                                 k_hi=k_hi)
    return dict(st, pending=blk.pending, done=new_done, cache=blk.cache, buf=buf,
                gen_count=new_count, lane_blocks=st["lane_blocks"] + live,
                lane_committed=st["lane_committed"] + blk.accept,
                lane_accepted=st["lane_accepted"] + blk.m * live,
                lane_drafted=drafted, k_lane=k, accept_ema=ema, k_cool=cool)


def speculative_generate(model: Model, params: dict, dvi_params: dict,
                         prompts: torch.Tensor, max_new: int,
                         k_spec: Optional[int] = None,
                         cache_len: Optional[int] = None,
                         eos_id: int = 1,
                         collect: bool = False,
                         buf: Optional[dict] = None,
                         aux_inputs: Optional[dict] = None,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         live_mask: Optional[torch.Tensor] = None) -> GenResult:
    """Batched lossless speculative generation with optional tuple logging.
    prompts: (B, Tp) with Tp >= 2, one length for the batch.

    aux_inputs: the modality stubs the prefill takes (``Model.prefill``:
    an encoder's frame embeddings, a VLM's patch embeddings).  cache_len:
    the decode cache's capacity; by default the stream's worst case plus
    ``RING_SLACK`` and a VLM's patches, which the cache holds in front of
    the tokens (the reference's default leaves the patches out, so its
    prefill overflows the cache once P exceeds max_new + K + 131; ROADMAP
    §3).  The ``out`` buffer and the length limit count tokens only.

    temperature == 0 (the paper's setting): greedy drafting and
    longest-prefix verification.  temperature > 0: the drafter samples and
    the verifier runs ``rejection_commit``, from `generator` (on the
    prompts' device), so the stream is distributed as target sampling.

    live_mask: (B,) bool — lanes marked False (batch padding) generate
    nothing, log no tuples and count in no statistics.  The loop tests
    ``all(done)`` on the host once per block."""
    _check_sampling(temperature, generator, None, prompts.device)
    cfg = model.cfg
    K = cfg.dvi.k_spec if k_spec is None else k_spec
    B, Tp = prompts.shape
    if Tp < 2:
        raise ValueError("need at least 2 prompt tokens (one prefill + one pending)")
    dev = prompts.device
    prompts = prompts.to(torch.int32)
    total = Tp + max_new + K + 2
    cache_cap = cache_len or (total + tfm.RING_SLACK + model.prefix_len())

    # ---- prefill all but the last prompt token; it becomes `pending` ----
    _, cache = model.prefill(params, prompts[:, :Tp - 1], aux_inputs, max_len=cache_cap)
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
                            eos_id=eos_id, collect=collect, temperature=temperature,
                            generator=generator)
        steps += 1
    return GenResult(st["out"], st["out_len"], *(st[name] for name in GEN_COUNTERS),
                     st["buf"], steps)


def generate_block(model: Model, params: dict, dvi_params: dict, st: dict, *,
                   k_spec: int, limit: int, eos_id: int, collect: bool,
                   temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> dict:
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
                          done=done, temperature=temperature, generator=generator)
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
