"""Parameter trees to and from ``.npz``, in the reference's format: port of
``repro.checkpoint.ckpt``.

Keys are the leaves' pytree paths joined with "/" (``repro_torch.tree``),
shapes and dtypes are kept, and a bfloat16 leaf is written as the reference
writes one, as 2-byte void (``|V2``) holding the same bits, so one file
serves both packages (numpy has no bfloat16, and the port does not use
``ml_dtypes``).  ``save_lora`` writes only the drafter's adapters and the
trainer's scalars: the artifact of continual learning is a few MB whatever
the backbone's size.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten
from repro_torch.weights import is_bf16_bits

_BF16_BITS = np.dtype("V2")


def _array(t) -> np.ndarray:
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(_BF16_BITS)
    return t.numpy()


def _leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` as a tensor of `like`'s dtype on `like`'s device."""
    if is_bf16_bits(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, tree: Any) -> None:
    """Write the nested dicts of tensors (or numbers) `tree` to `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _array(v) for k, v in flatten(tree).items()})


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure, dtypes and devices of `like`, a tree of
    tensors: new tensors, `like` is not written."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        flat = {}
        for key, leaf in flatten(like).items():
            arr = data[key]
            assert arr.shape == tuple(leaf.shape), f"{key}: {arr.shape} vs {tuple(leaf.shape)}"
            flat[key] = _leaf(arr, leaf)
    return unflatten(flat)


def _meta(step, baseline, device) -> dict:
    return {"step": torch.tensor(int(step), dtype=torch.int32, device=device),
            "baseline": torch.tensor(float(baseline), dtype=torch.float32, device=device)}


def save_lora(path: str, dvi_params: dict, step=0, baseline=0.0) -> None:
    save_checkpoint(path, {"dvi": dvi_params, "meta": _meta(step, baseline, "cpu")})


def load_lora(path: str, like_dvi: dict):
    """(dvi params like `like_dvi`, step, baseline)."""
    dev = next(iter(like_dvi.values())).device
    tree = load_checkpoint(path, {"dvi": like_dvi, "meta": _meta(0, 0.0, dev)})
    return tree["dvi"], int(tree["meta"]["step"]), float(tree["meta"]["baseline"])
