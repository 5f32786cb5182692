"""Config registry of the port: the architectures this slice runs.

vicuna-7b is the paper's Spec-Bench backbone and the configuration the card
runs; qwen3-0.6b and qwen3-1.7b (GQA, ``qk_norm``, tied heads, one vocabulary)
are the two-model speculative-decoding baseline's drafter and target;
qwen2.5-14b is a dense GQA decoder with ``qkv_bias``; llama3-405b is copied
for its tiny variant (its full size does not fit one card); mamba2-370m is the
attention-free Mamba-2 stack whose prefill runs the ``ssd_scan`` kernel;
recurrentgemma-9b is the hybrid of RG-LRU blocks and sliding-window
attention over per-lane ring caches (38 layers of (rglru, rglru, local));
llama4-scout-17b-a16e interleaves three ring layers with one global layer
and has a mixture-of-experts FFN on every layer (its full depth does not fit
one card: the card runs it cut in depth); deepseek-v3-671b attends through
multi-head latent attention over a latent cache, with three dense layers
before 256 routed experts (top 8) and a shared one, and a multi-token
prediction head (cut in depth on the card too); whisper-large-v3 is an
encoder-decoder whose decoder cross-attends the encoder's output over stub
frame embeddings, and paligemma-3b puts stub patch embeddings, projected,
in front of the text tokens under a bidirectional prefix mask (both take
``aux_inputs``).  These are all 11 of the reference's configs;
``ASSIGNED_ARCHS`` are the ten assigned to the paper (all but vicuna-7b),
in the reference's order, which the dry-run sweep walks.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, llama3_405b, llama4_scout_17b_a16e,
                                 mamba2_370m, paligemma_3b, qwen3_0_6b, qwen3_1_7b, qwen25_14b,
                                 recurrentgemma_9b, vicuna_7b, whisper_large_v3)
from repro_torch.configs.base import (INPUT_SHAPES, DVIConfig, EncoderConfig, InputShape,
                                      MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig,
                                      VisionStubConfig)

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "qwen3-1.7b": qwen3_1_7b,
    "qwen2.5-14b": qwen25_14b,
    "llama3-405b": llama3_405b,
    "vicuna-7b": vicuna_7b,
    "mamba2-370m": mamba2_370m,
    "recurrentgemma-9b": recurrentgemma_9b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "deepseek-v3-671b": deepseek_v3_671b,
    "whisper-large-v3": whisper_large_v3,
    "paligemma-3b": paligemma_3b,
}

ALL_ARCHS = list(_MODULES)
# the reference's registry order, without the paper's own vicuna-7b
ASSIGNED_ARCHS = ["llama3-405b", "recurrentgemma-9b", "qwen2.5-14b", "llama4-scout-17b-a16e",
                  "paligemma-3b", "whisper-large-v3", "qwen3-0.6b", "mamba2-370m",
                  "deepseek-v3-671b", "qwen3-1.7b"]


def get_config(name: str, *, tiny: bool = False) -> ModelConfig:
    base = name[:-5] if name.endswith("-tiny") else name
    if base not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    cfg = _MODULES[base].TINY if (tiny or name.endswith("-tiny")) else _MODULES[base].CONFIG
    cfg.validate()
    return cfg


__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "DVIConfig", "EncoderConfig", "INPUT_SHAPES",
           "InputShape", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
           "VisionStubConfig", "get_config"]
