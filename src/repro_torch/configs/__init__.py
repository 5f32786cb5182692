"""Config registry of the port: the architectures this slice runs.

vicuna-7b is the paper's Spec-Bench backbone and the configuration the card
runs; qwen3-0.6b is here so the CPU tests exercise GQA, ``qk_norm`` and a
tied head on the same path.
"""
from __future__ import annotations

from repro_torch.configs import qwen3_0_6b, vicuna_7b
from repro_torch.configs.base import DVIConfig, ModelConfig

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "vicuna-7b": vicuna_7b,
}

ALL_ARCHS = list(_MODULES)


def get_config(name: str, *, tiny: bool = False) -> ModelConfig:
    base = name[:-5] if name.endswith("-tiny") else name
    if base not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    cfg = _MODULES[base].TINY if (tiny or name.endswith("-tiny")) else _MODULES[base].CONFIG
    cfg.validate()
    return cfg


__all__ = ["ALL_ARCHS", "DVIConfig", "ModelConfig", "get_config"]
