"""Public model API, the port of ``repro.models.model`` (dense attention,
Mamba-2, the RecurrentGemma hybrid, the local/global MoE stacks and
DeepSeek-V3's MLA stack with its multi-token prediction head).

    model = build_model(cfg)                  # on the card; device="cpu" for tests
    params = model.init(torch.Generator(model.device).manual_seed(0))
    h, contribs = model.hidden(params, x, lo=0, hi=L)
    logits = model.logits(params, h)          # frozen head
    logits, aux = model.forward_train(params, tokens)   # training (autograd)
    h, cache = model.prefill(params, tokens, max_len=...)
    h, cache = model.prefill_chunk(params, chunk, cache, take)   # chunked prefill
    h, cache, cands = model.step(params, x_blk, cache, lo, hi)
    cache = model.commit(cache, cands, accept)
    logits2 = model.mtp_logits(params, h, tokens_next)   # MTP head (mtp_depth)

DVI composes these: the draft path is ``step`` with ``hi = k`` plus the LoRA
draft head (``repro_torch.core.lora``); the target path is ``lo = k`` and the
verifier head.  Parameters are plain dicts of tensors in the reference's
layout (``x @ W``, W stored (d_in, d_out), segments stacked on a layer axis).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init, rms_norm


def tie_head(cfg: ModelConfig, params: dict) -> dict:
    """For a tied head, store a contiguous (d, V) copy of ``embed.T`` under
    ``lm_head``, once, at load time: the head kernels take w (d, V) and must
    not be handed a strided view on every call.  A copy, not a new weight:
    training leaves it out (``trained_tree``) and refreshes it in place
    after every step (``refresh_head``)."""
    if cfg.tie_embeddings:
        params["lm_head"] = params["embed"].T.contiguous()
    return params


def refresh_head(cfg: ModelConfig, params: dict) -> None:
    """After `embed` changed, copy ``embed.T`` into a tied ``lm_head`` in
    place: the tensor keeps its address, which the serving path's CUDA
    graphs hold."""
    if cfg.tie_embeddings:
        params["lm_head"].copy_(params["embed"].T)


def trained_tree(cfg: ModelConfig, params: dict) -> dict:
    """The parameters training updates and checkpoints write: the
    reference's tree (with its ``mtp`` subtree, when the config has one),
    which for a tied head has no ``lm_head`` (its copy of ``embed.T`` is
    derived, not trained)."""
    if cfg.tie_embeddings:
        return {k: v for k, v in params.items() if k != "lm_head"}
    return params


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    # ---------------- init ----------------
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from `gen`, on the generator's device
        (which must be the model's)."""
        cfg = self.cfg
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        dtype = cfg.torch_dtype
        params = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, scale=0.02),
            "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=self.device),
            "segments": {},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype)
        for seg in tfm.model_segments(cfg):
            params["segments"][seg.name] = tfm.init_segment(gen, cfg, seg, dtype)
        if cfg.mtp_depth:
            # DeepSeek-V3's MTP: a projection of [h_t ; emb(t+1)] and one more
            # layer (the stack's attention, a dense FFN) predict token t+2
            params["mtp"] = {
                "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype),
                "norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=self.device),
                "layer": tfm.init_segment(gen, cfg, self._mtp_segment(), dtype),
            }
        return tie_head(cfg, params)

    def _mtp_segment(self) -> tfm.Segment:
        """The MTP head's one layer: attention with a dense FFN of
        ``d_ff_dense`` on an MoE config."""
        cfg = self.cfg
        return tfm.Segment(0, "attn", "dense", 0, 1, cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff)

    # ---------------- embeddings ----------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> x (B, T, d), scaled by sqrt(d_model) in the model
        dtype for RG-LRU configs (the gemma-style embedding scale)."""
        x = params["embed"][tokens.long()]
        if self.cfg.rglru is not None:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def embed_block(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Decode-block embedding (no position offset: RoPE is applied inside
        attention)."""
        return self.embed(params, tokens)

    # ---------------- full-sequence ----------------
    def hidden(self, params, x, lo: int = 0, hi: Optional[int] = None,
               collect: bool = False, remat: bool = False):
        """Layers [lo, hi) over a full causal sequence, each layer under
        ``torch.utils.checkpoint`` when `remat`.  Returns (h, contribs)."""
        hi = self.cfg.num_layers if hi is None else hi
        return tfm.forward_full(params["segments"], x, self.cfg, lo, hi, collect, remat)

    def logits(self, params, h):
        """Frozen verifier head (final norm + unembed), full (..., V) logits."""
        hn = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return hn @ self.head_matrix(params)

    def head_matrix(self, params) -> torch.Tensor:
        """The (d, V) unembedding, contiguous (a materialised copy of
        ``embed.T`` for tied heads, see ``tie_head``)."""
        return params["lm_head"]

    def forward_train(self, params, tokens: torch.Tensor, remat: bool = False):
        """Full-model LM forward for training: tokens (B, T) -> (logits
        (B, T, V), aux) with aux the MoE load-balance loss summed over the
        layers (a float32 zero without experts).  A tied head multiplies by
        ``embed.T`` itself, as the reference's ``head_matrix`` does, so
        autograd sends the head's gradient to ``embed``; `params` may be
        ``trained_tree``'s, without ``lm_head``."""
        x = self.embed(params, tokens)
        h, _, aux = tfm.forward_full(params["segments"], x, self.cfg, 0, self.cfg.num_layers,
                                     remat=remat, with_aux=True)
        hn = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return hn @ w, aux

    # ---------------- cache / decode ----------------
    def init_cache(self, B: int, max_len: int) -> dict:
        return tfm.init_cache(self.cfg, B, max_len, device=self.device)

    def init_paged_cache(self, B: int, num_pages: int, page_size: int,
                         max_pages_per_slot: int) -> dict:
        """Pooled paged cache (see ``transformer.init_paged_cache``)."""
        return tfm.init_paged_cache(self.cfg, B, num_pages, page_size,
                                    max_pages_per_slot, device=self.device)

    def prefill(self, params, tokens, cache=None, max_len: Optional[int] = None):
        """Process the prompt and build a decode cache (K/V of attention
        segments, the rings of local ones, conv windows and states of SSM
        and RG-LRU segments).  Returns (h, cache)."""
        T = tokens.shape[1]
        x = self.embed(params, tokens)
        if cache is None:
            cache = self.init_cache(x.shape[0], max_len or (T + 512))
        h, contribs = self.hidden(params, x, collect=True)
        return h, tfm.fill_cache_from_full(self.cfg, cache, contribs, T)

    def prefill_chunk(self, params, tokens, cache, take=None):
        """Resume a chunked prefill: process `tokens` (B, T) at positions
        ``cache["lengths"] .. +T-1`` against a partially built cache and
        commit ``take`` (B,) of them per lane (default: all T).  It runs the
        block-decode path over the whole stack, so it serves the contiguous
        and the paged layout, and SSM segments carry their conv window and
        state through it: a cache built by ``prefill`` of the first chunk
        and ``prefill_chunk`` of the rest decodes the streams of one-shot
        ``prefill``.

        ``take < T`` gives ragged chunks a fixed shape: positions past
        ``take`` are padding, whose eager K/V writes lie past the new
        length and are rolled back by length masking like rejected
        speculative tokens; ``take = 0`` leaves a lane as it was (a lane
        riding along in a batched chunk step).  The cache's K/V, SSM states
        and lengths change in place.  Returns (h, cache)."""
        B, T = tokens.shape
        take = (torch.full((B,), T, dtype=torch.int32, device=tokens.device) if take is None
                else take.to(torch.int32))
        x = self.embed_block(params, tokens)
        h, cache, _ = tfm.forward_step(params["segments"], x, self.cfg, cache, 0,
                                       self.cfg.num_layers, take=take)
        new = tfm.commit_cache(self.cfg, cache, {}, take)
        cache["lengths"].copy_(new["lengths"])
        return h, cache

    def step(self, params, x, cache, lo: int = 0, hi: Optional[int] = None):
        """Block-decode layers [lo, hi) on an embedded block x (B, T, d).
        Returns (h, cache, cands): the cache's K/V (and rings' positions)
        are written in place, and SSM and RG-LRU segments return their
        per-token candidate states in `cands`."""
        hi = self.cfg.num_layers if hi is None else hi
        return tfm.forward_step(params["segments"], x, self.cfg, cache, lo, hi)

    def commit(self, cache, cands, accept):
        """Advance by `accept` (B,) tokens; SSM states take the candidates
        at index accept-1 (unchanged where accept == 0)."""
        return tfm.commit_cache(self.cfg, cache, cands, accept)

    # ---------------- MTP auxiliary head (DeepSeek-V3) ----------------
    def mtp_logits(self, params, h, tokens_next):
        """Logits (B, T, V) for token t+2 from [norm(h_t) ; emb(t+1)]: the
        ``mtp`` projection, then its one layer over the sequence at
        positions 0..T-1, then the verifier head.  h (B, T, d) hidden
        states, tokens_next (B, T) the tokens that follow them."""
        cfg, mtp = self.cfg, params["mtp"]
        emb = params["embed"][tokens_next.long()]
        z = torch.cat([rms_norm(h, mtp["norm"], cfg.norm_eps), emb], dim=-1) @ mtp["proj"]
        B, T = z.shape[:2]
        pos = torch.arange(T, device=z.device)[None, :].expand(B, T)
        z = tfm.run_segment_full(mtp["layer"], z, cfg, self._mtp_segment(), pos)[0]
        return self.logits(params, z)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on `device`: the card unless the caller asks for the CPU."""
    cfg.validate()
    tfm.check_supported(cfg)
    return Model(cfg, resolve_device(device))
