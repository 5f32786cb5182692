"""Weight bridge: the reference's parameters into the port's tensors.

The port keeps the reference's layout (``x @ W``, W stored (d_in, d_out),
segment parameters stacked on a leading layer axis), so converting is a
straight copy of every leaf.  Two sources:

* a parameter pytree as nested dicts of numpy arrays (for the JAX package's
  params, ``jax.tree.map(np.asarray, params)``);
* a ``.npz`` written by ``repro.checkpoint.ckpt.save_checkpoint``, whose keys
  are the pytree paths joined with "/" (``segments/s1/wq``).

``bfloat16`` leaves arrive as ``ml_dtypes`` arrays, which torch cannot take
directly; they are reinterpreted bit for bit through ``uint16``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import tie_head


def _tensor(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    if not arr.flags.writeable:          # torch.from_numpy shares memory
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _convert(tree, device):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> dict:
    """Model parameters from a nested dict of numpy arrays (the reference's
    pytree), on `device` (the card unless the caller asks for the CPU)."""
    return tie_head(cfg, _convert(tree, resolve_device(device)))


def draft_params_from_numpy(tree: Mapping, device=None) -> dict:
    """LoRA draft parameters {"A": (d, r), "B": (r, V)} as float32."""
    dev = resolve_device(device)
    return {k: _tensor(tree[k], dev).float() for k in ("A", "B")}


def load_npz(cfg: ModelConfig, path: str, device=None) -> dict:
    """Model parameters from a ``save_checkpoint`` ``.npz`` ("/"-joined keys)."""
    tree: dict = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params_from_numpy(cfg, tree, device)
