"""Public model API, the port of ``repro.models.model`` (dense attention,
Mamba-2, the RecurrentGemma hybrid, the local/global MoE stacks,
DeepSeek-V3's MLA stack with its multi-token prediction head, Whisper's
encoder-decoder and PaliGemma's patch prefix).

    model = build_model(cfg)                  # on the card; device="cpu" for tests
    params = model.init(torch.Generator(model.device).manual_seed(0))
    h, contribs = model.hidden(params, x, lo=0, hi=L)
    logits = model.logits(params, h)          # frozen head
    logits, aux = model.forward_train(params, tokens, aux_inputs)   # training (autograd)
    h, cache = model.prefill(params, tokens, aux_inputs, max_len=...)
    h, cache = model.prefill_chunk(params, chunk, cache, take)   # chunked prefill
    h, cache, cands = model.step(params, x_blk, cache, lo, hi)
    cache = model.commit(cache, cands, accept)
    logits2 = model.mtp_logits(params, h, tokens_next)   # MTP head (mtp_depth)

DVI composes these: the draft path is ``step`` with ``hi = k`` plus the LoRA
draft head (``repro_torch.core.lora``); the target path is ``lo = k`` and the
verifier head.  Parameters are plain dicts of tensors in the reference's
layout (``x @ W``, W stored (d_in, d_out), segments stacked on a layer axis).

``aux_inputs`` carries the stubbed modality frontends, as in the reference:
{"frame_embeds": (B, F, d_enc)} for an encoder (Whisper), {"patch_embeds":
(B, P, d_embed)} for a vision prefix (PaliGemma).  They enter at prefill
(``encode``, ``embed``) and in training; the decode blocks read what the
prefill left in the cache (the cross K/V; the patches' K/V at positions
0..P-1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init, rms_norm, sinusoidal_at, sinusoidal_positions

# decode blocks clamp Whisper's absolute positions at the last row of the
# reference's table (``model.embed_block``: 2^16 rows)
MAX_POSITIONS = 1 << 16


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
        if cfg.encoder is not None:
            params["encoder"] = self._init_encoder(gen, dtype)
        if cfg.vision is not None:
            params["vision_proj"] = dense_init(gen, (cfg.vision.d_embed, cfg.d_model), dtype)
        if cfg.mtp_depth:
            # DeepSeek-V3's MTP: a projection of [h_t ; emb(t+1)] and one more
            # layer (the stack's attention, a dense FFN) predict token t+2
            params["mtp"] = {
                "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype),
                "norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=self.device),
                "layer": tfm.init_segment(gen, cfg, self._mtp_segment(), dtype),
            }
        return tie_head(cfg, params)

    def _encoder_segment(self) -> tfm.Segment:
        """The encoder's one segment: its layers of attention and the
        decoder's dense FFN width, without cross-attention."""
        return tfm.Segment(0, "attn", "dense", 0, self.cfg.encoder.num_layers, self.cfg.d_ff)

    def _init_encoder(self, gen: torch.Generator, dtype) -> dict:
        """The encoder's input projection (d_enc, d), its stacked layers and
        its final norm."""
        cfg = self.cfg
        d_enc = cfg.encoder.d_model or cfg.d_model
        return {"in_proj": dense_init(gen, (d_enc, cfg.d_model), dtype),
                "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                          device=self.device),
                "segments": {"s0": tfm.init_segment(gen, cfg, self._encoder_segment(), dtype)}}

    def _mtp_segment(self) -> tfm.Segment:
        """The MTP head's one layer: attention with a dense FFN of
        ``d_ff_dense`` on an MoE config."""
        cfg = self.cfg
        return tfm.Segment(0, "attn", "dense", 0, 1, cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff)

    # ---------------- embeddings ----------------
    def _token_embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> (B, T, d), scaled by sqrt(d_model) in the model
        dtype for a VLM or RG-LRU config (the gemma-style embedding scale)."""
        x = params["embed"][tokens.long()]
        if self.cfg.arch_type == "vlm" or self.cfg.rglru is not None:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def embed(self, params, tokens: torch.Tensor, aux_inputs: Optional[dict] = None
              ) -> torch.Tensor:
        """tokens (B, T) -> x (B, T', d).  A VLM puts the projected patch
        embeddings (unscaled) in front of the scaled tokens (T' = P + T); an
        "audio" config adds the sinusoidal positions 0..T-1 in the model
        dtype (its decoder has no RoPE)."""
        cfg = self.cfg
        x = self._token_embed(params, tokens)
        if cfg.vision is not None:
            patches = aux_inputs["patch_embeds"].to(device=x.device, dtype=x.dtype)
            x = torch.cat([patches @ params["vision_proj"], x], dim=1)
        if cfg.arch_type == "audio":
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
        return x

    def embed_block(self, params, tokens: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode-block embedding of tokens (B, T) at each lane's positions
        ``lengths .. lengths + T - 1`` (the cache's lengths, (B,)): no modality
        prefix (it lives in the cache after prefill); an "audio" config adds
        the sinusoidal rows at those positions, clamped at MAX_POSITIONS - 1
        as the reference's table is, and needs `lengths` (RoPE configs apply
        their positions inside attention)."""
        cfg = self.cfg
        x = self._token_embed(params, tokens)
        if cfg.arch_type == "audio":
            if lengths is None:
                raise ValueError(f"{cfg.name}: embed_block needs the cache's lengths")
            T = tokens.shape[1]
            pos = lengths.long()[:, None] + torch.arange(T, device=x.device)[None, :]
            rows = sinusoidal_at(torch.clamp(pos, max=MAX_POSITIONS - 1), cfg.d_model)
            x = x + rows.to(x.dtype)
        return x

    def encode(self, params, aux_inputs: dict, remat: bool = False) -> torch.Tensor:
        """Whisper's encoder over the stub frame embeddings (B, F, d_enc):
        the frames in the model dtype times ``in_proj``, plus the sinusoidal
        positions 0..F-1, then its layers bidirectionally at zero positions
        without RoPE (each under ``torch.utils.checkpoint`` when `remat`),
        then its final norm.  Returns (B, F, d)."""
        cfg, enc = self.cfg, params["encoder"]
        frames = aux_inputs["frame_embeds"].to(device=self.device, dtype=cfg.torch_dtype)
        x = frames @ enc["in_proj"]
        B, F = x.shape[:2]
        x = x + sinusoidal_positions(F, cfg.d_model, x.device)[None].to(x.dtype)
        zeros = torch.zeros((B, F), dtype=torch.int64, device=x.device)
        x = tfm.run_segment_full(enc["segments"]["s0"], x, cfg, self._encoder_segment(),
                                 zeros, remat=remat)[0]
        return rms_norm(x, enc["final_norm"], cfg.norm_eps)

    def _encode_if(self, params, aux_inputs, remat: bool = False):
        """The encoder's output for an encoder config, else None."""
        return self.encode(params, aux_inputs, remat) if self.cfg.encoder is not None else None

    def prefix_len(self) -> int:
        """Positions of the bidirectional prefix: a VLM's P patches, else 0."""
        return self.cfg.vision.num_patches if self.cfg.vision is not None else 0

    # ---------------- full-sequence ----------------
    def hidden(self, params, x, lo: int = 0, hi: Optional[int] = None,
               collect: bool = False, remat: bool = False, prefix_len: int = 0,
               enc_out=None):
        """Layers [lo, hi) over a full causal sequence (its first
        `prefix_len` positions bidirectional among themselves, cross layers
        attending `enc_out`), each layer under ``torch.utils.checkpoint``
        when `remat`.  Returns (h, contribs)."""
        hi = self.cfg.num_layers if hi is None else hi
        return tfm.forward_full(params["segments"], x, self.cfg, lo, hi, collect, remat,
                                prefix_len=prefix_len, enc_out=enc_out)

    def logits(self, params, h):
        """Frozen verifier head (final norm + unembed), full (..., V) logits."""
        hn = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return hn @ self.head_matrix(params)

    def head_matrix(self, params) -> torch.Tensor:
        """The (d, V) unembedding, contiguous (a materialised copy of
        ``embed.T`` for tied heads, see ``tie_head``)."""
        return params["lm_head"]

    def forward_train(self, params, tokens: torch.Tensor, aux_inputs: Optional[dict] = None,
                      remat: bool = False):
        """Full-model LM forward for training: tokens (B, T) -> (logits
        (B, T', V), aux) with aux the MoE load-balance loss summed over the
        layers (a float32 zero without experts); T' = P + T for a VLM (the
        patches' positions lead).  A tied head multiplies by ``embed.T``
        itself, as the reference's ``head_matrix`` does, so autograd sends
        the head's gradient to ``embed``; `params` may be
        ``trained_tree``'s, without ``lm_head``."""
        enc = self._encode_if(params, aux_inputs, remat)
        x = self.embed(params, tokens, aux_inputs)
        h, _, aux = tfm.forward_full(params["segments"], x, self.cfg, 0, self.cfg.num_layers,
                                     remat=remat, with_aux=True, prefix_len=self.prefix_len(),
                                     enc_out=enc)
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

    def prefill(self, params, tokens, aux_inputs: Optional[dict] = None, cache=None,
                max_len: Optional[int] = None):
        """Process the prompt (behind a VLM's patches; an encoder's frames
        encoded first) and build a decode cache (K/V of attention segments,
        the rings of local ones, conv windows and states of SSM and RG-LRU
        segments, the cross K/V of cross segments).  The cache's lengths
        count the patches.  Returns (h, cache)."""
        enc = self._encode_if(params, aux_inputs)
        x = self.embed(params, tokens, aux_inputs)
        T = x.shape[1]
        if cache is None:
            cache = self.init_cache(x.shape[0], max_len or (T + 512))
        h, contribs = self.hidden(params, x, collect=True, prefix_len=self.prefix_len(),
                                  enc_out=enc)
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
        x = self.embed_block(params, tokens, cache["lengths"])
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
    return Model(cfg, resolve_device(device))
