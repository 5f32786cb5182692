"""Public model API (dense slice), the port of ``repro.models.model``.

    model = build_model(cfg)                  # on the card; device="cpu" for tests
    params = model.init(torch.Generator(model.device).manual_seed(0))
    h, contribs = model.hidden(params, x, lo=0, hi=L)
    logits = model.logits(params, h)          # frozen head
    h, cache = model.prefill(params, tokens, max_len=...)
    h, cache = model.step(params, x_blk, cache, lo, hi)
    cache = model.commit(cache, accept)

DVI composes these: the draft path is ``step`` with ``hi = k`` plus the LoRA
draft head (``repro_torch.core.lora``); the target path is ``lo = k`` and the
verifier head.  Parameters are plain dicts of tensors in the reference's
layout (``x @ W``, W stored (d_in, d_out), segments stacked on a layer axis).
"""
from __future__ import annotations

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
    not be handed a strided view on every call.  A copy, not a new weight."""
    if cfg.tie_embeddings:
        params["lm_head"] = params["embed"].T.contiguous()
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
        return tie_head(cfg, params)

    # ---------------- embeddings ----------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> x (B, T, d)."""
        return params["embed"][tokens.long()]

    def embed_block(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Decode-block embedding (dense decoders need no position offset:
        RoPE is applied inside attention)."""
        return self.embed(params, tokens)

    # ---------------- full-sequence ----------------
    def hidden(self, params, x, lo: int = 0, hi: Optional[int] = None,
               collect: bool = False):
        """Layers [lo, hi) over a full causal sequence.  Returns (h, contribs)."""
        hi = self.cfg.num_layers if hi is None else hi
        return tfm.forward_full(params["segments"], x, self.cfg, lo, hi, collect)

    def logits(self, params, h):
        """Frozen verifier head (final norm + unembed), full (..., V) logits."""
        hn = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return hn @ self.head_matrix(params)

    def head_matrix(self, params) -> torch.Tensor:
        """The (d, V) unembedding, contiguous (a materialised copy of
        ``embed.T`` for tied heads, see ``tie_head``)."""
        return params["lm_head"]

    # ---------------- cache / decode ----------------
    def init_cache(self, B: int, max_len: int) -> dict:
        return tfm.init_cache(self.cfg, B, max_len, device=self.device)

    def prefill(self, params, tokens, cache=None, max_len: Optional[int] = None):
        """Process the prompt and build a decode cache.  Returns (h, cache)."""
        T = tokens.shape[1]
        x = self.embed(params, tokens)
        if cache is None:
            cache = self.init_cache(x.shape[0], max_len or (T + 512))
        h, contribs = self.hidden(params, x, collect=True)
        return h, tfm.fill_cache_from_full(self.cfg, cache, contribs, T)

    def step(self, params, x, cache, lo: int = 0, hi: Optional[int] = None):
        """Block-decode layers [lo, hi) on an embedded block x (B, T, d).
        Returns (h, cache); the cache's K/V are written in place."""
        hi = self.cfg.num_layers if hi is None else hi
        return tfm.forward_step(params["segments"], x, self.cfg, cache, lo, hi)

    def commit(self, cache, accept):
        return tfm.commit_cache(self.cfg, cache, accept)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on `device`: the card unless the caller asks for the CPU."""
    cfg.validate()
    tfm.check_supported(cfg)
    return Model(cfg, resolve_device(device))
