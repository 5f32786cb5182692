"""Parameter trees as flat dicts keyed by the reference's pytree paths.

A tree is nested dicts of tensors; its flat form maps the path of every
leaf, joined with "/" (``segments/s0/wq``), to the leaf itself.  These are
the keys ``repro.checkpoint.ckpt`` writes into an ``.npz``, so one set of
keys serves the checkpoint, the weight bridge and the optimizer's flat
state.  Keys come in sorted order at every level, the order in which JAX
flattens a dict, so sums over the leaves (the global gradient norm) add in
the reference's order.
"""
from __future__ import annotations

from typing import Mapping


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """{"a/b/c": leaf} for every leaf of the nested dicts, keys sorted."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def unflatten(flat: Mapping) -> dict:
    """The nested dicts of a flat {"a/b/c": leaf} mapping."""
    tree: dict = {}
    for key, leaf in flat.items():
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
