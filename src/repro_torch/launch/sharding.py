"""Name-pattern parameter and activation partitioner (2D tensor parallel +
FSDP): counterpart of ``repro.launch.sharding``, rule for rule.

Logical rules (mesh axes: optional "pod" + "data" + "model"):

* weights: d_model-like dims shard over "data" (FSDP: gathered a layer at
  a time), head / FFN / vocab dims over "model" (tensor parallelism inside
  an HGX node's NVLink domain).  "pod" never shards weights (pure data
  parallelism: weights replicated across pods).
* MoE experts shard over "model" (expert parallelism) with the expert's
  d_model over "data".
* activations and caches: batch over ("pod", "data") when it divides; the
  KV cache's sequence dim over "model" (sequence-sharded flash-decode).
* anything small (norms, biases, scalars, LoRA A) replicates.

A spec is a tuple with one entry a dim: None, an axis name or a tuple of
names, so it compares with the reference's ``PartitionSpec`` entry by
entry.  Dims that do not divide their axis fall back to replication: every
leaf gets a valid spec.  Trees are the port's nested dicts, matched on
their flat "/"-joined paths (``repro_torch.tree``); ``placements`` turns a
spec into DTensor placements for ``distribute_tensor``.
"""
from __future__ import annotations

import re
from typing import Optional

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes


def _fit(dim: int, axis: Optional[str], sizes: dict):
    """axis if it divides dim else None."""
    if axis is None or axis not in sizes:
        return None
    return axis if dim % sizes[axis] == 0 else None


# (regex on the '/'-joined path, spec template for the trailing dims):
# 'D' -> data, 'M' -> model, '.' -> replicated; leading stack dims ('n') are
# always replicated.  The reference's table, in its order.
_PARAM_RULES = [
    (r"embed$",                 ("M", "D")),
    (r"lm_head$",               ("D", "M")),
    (r"vision_proj$",           (".", "D")),
    (r"(wq|wq_x)$",             (".", "D", "M")),
    (r"(wk|wv|wk_x|wv_x)$",     (".", "D", "M")),
    (r"(wo|wo_x)$",             (".", "M", "D")),
    (r"(wi|wg)$",               (".", "D", "M")),
    (r"wo_ff$",                 (".", "M", "D")),
    (r"moe/router$",            (".", "D", ".")),
    (r"moe/we_(gate|up)$",      (".", "M", "D", ".")),
    (r"moe/we_down$",           (".", "M", ".", "D")),
    (r"moe/ws_(gate|up)$",      (".", "D", "M")),
    (r"moe/ws_down$",           (".", "M", "D")),
    (r"w_dq$",                  (".", "D", ".")),
    (r"w_uq$",                  (".", ".", "M")),
    (r"w_dkv$",                 (".", "D", ".")),
    (r"(w_uk|w_uv)$",           (".", ".", "M")),
    (r"w_o$",                   (".", "M", "D")),
    (r"in_proj$",               (".", "D", ".")),
    (r"out_proj$",              (".", ".", "D")),
    (r"(w_gate|w_x)$",          (".", "D", "M")),
    (r"(w_a|w_i)$",             (".", "M", "M")),   # the second M never fits twice
    (r"w_o$",                   (".", "M", "D")),
    (r"mtp/proj$",              ("D", ".")),
    (r"(A)$",                   (".", ".")),        # LoRA A: replicated
    (r"(B)$",                   (".", "M")),        # LoRA B: vocab over model
]

_AXIS = {"D": ("data",), "M": ("model",), "DM": ("data", "model"), ".": ()}


def spec_for(path: str, shape, sizes: dict) -> tuple:
    """The spec of the leaf at `path` of `shape` on a mesh of axis `sizes`:
    the first matching rule's template over the trailing dims, each dim
    taking the template's axes jointly, then their prefixes, then none;
    replicated when no rule matches (norms, biases, scalars, conv weights)."""
    for pat, tmpl in _PARAM_RULES:
        if re.search(pat, path):
            tmpl = tmpl[-len(shape):] if len(tmpl) >= len(shape) else \
                (".",) * (len(shape) - len(tmpl)) + tuple(tmpl)
            used, spec = set(), []
            for dim, t in zip(shape, tmpl):
                choice = None
                cand = [a for a in _AXIS[t] if a in sizes and a not in used]
                while cand:
                    size = 1
                    for a in cand:
                        size *= sizes[a]
                    if dim % size == 0:
                        choice = tuple(cand) if len(cand) > 1 else cand[0]
                        used.update(cand)
                        break
                    cand = cand[:-1]
                spec.append(choice)
            return tuple(spec)
    return (None,) * len(shape)


def param_specs_flat(flat: dict, mesh) -> dict:
    """{path: spec} for a flat {path: tensor or shape} mapping."""
    sizes = axis_sizes(mesh)
    return {path: spec_for(path, tuple(getattr(leaf, "shape", leaf)), sizes)
            for path, leaf in flat.items()}


def param_specs(tree: dict, mesh) -> dict:
    """The specs of a nested parameter tree, in its structure."""
    return tree_mod.unflatten(param_specs_flat(tree_mod.flatten(tree), mesh))


# ---------------------------------------------------------------------------
# Activations / caches
# ---------------------------------------------------------------------------

def batch_axes(mesh, batch: int, include_model: bool = False):
    """Largest prefix of ("pod", "data"[, "model"]) that divides `batch`.

    include_model=True is the pure-FSDP training layout: the DVI train step
    has no backbone backward, so spending the model axis on batch (and
    gathering weights a layer at a time) beats tensor parallelism, whose
    activation all-reduces dominate."""
    sizes = axis_sizes(mesh)
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    total, use = 1, []
    for a in (a for a in names if a in sizes):
        if batch % (total * sizes[a]) == 0:
            use.append(a)
            total *= sizes[a]
    return tuple(use) if use else None


def _entry(axes):
    """A spec entry: one axis by its name, several as a tuple, as
    ``PartitionSpec`` normalises them."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def tokens_spec(mesh, batch: int, include_model: bool = False) -> tuple:
    return (_entry(batch_axes(mesh, batch, include_model)), None)


# leaves of a cache with no batch or sequence dim to shard: lengths, a ring's
# or an MLA segment's slot positions, the cross lengths, the block table
_CACHE_REPLICATED = ("lengths", "pos", "xlen", "tbl")


def cache_spec(path: str, shape, sizes: dict, seq_axis: Optional[str] = "model") -> tuple:
    """One cache leaf's spec: attention K/V (n, B, S, KV, hd) batch over
    the data axes and S over `seq_axis`, their int8 scales (n, B, S, KV)
    and MLA latents (n, B, S, r) likewise, cross K/V (n, B, F, H, hd) heads
    over "model", stateful leaves (conv windows, states) batch only."""
    if path.endswith(_CACHE_REPLICATED):
        return (None,) * len(shape)
    b_ax = _entry(batch_axes(sizes, shape[1])) if len(shape) >= 2 else None
    if path.endswith(("/k", "/v")) and len(shape) == 5:
        return (None, b_ax, _fit(shape[2], seq_axis, sizes), None, None)
    if path.endswith(("/ks", "/vs")) and len(shape) == 4:
        return (None, b_ax, _fit(shape[2], seq_axis, sizes), None)
    if path.endswith(("ckv", "krope")) and len(shape) == 4:
        return (None, b_ax, _fit(shape[2], seq_axis, sizes), None)
    if path.endswith(("xk", "xv")) and len(shape) == 5:
        return (None, b_ax, None, _fit(shape[3], "model", sizes), None)
    return (None, b_ax) + (None,) * (len(shape) - 2)


def cache_specs(cfg: ModelConfig, cache: dict, mesh, seq_axis: Optional[str] = "model") -> dict:
    """The specs of a decode cache (``transformer.init_cache``'s dict), in
    its structure."""
    sizes = axis_sizes(mesh)
    flat = tree_mod.flatten(cache)
    return tree_mod.unflatten({p: cache_spec(p, tuple(t.shape), sizes, seq_axis)
                               for p, t in flat.items()})


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of `spec` on a ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim d its axis shards, else ``Replicate()``.
    A tuple entry shards its dim over each of its axes, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def distribute(tree: dict, specs: dict, mesh) -> dict:
    """Each leaf of a nested tree placed on `mesh` by its spec
    (``distribute_tensor`` without moving data: every rank holds the same
    values, as a fake tensor or a seeded draw would)."""
    from torch.distributed.tensor import distribute_tensor
    flat, fspec = tree_mod.flatten(tree), tree_mod.flatten(specs)
    return tree_mod.unflatten({p: distribute_tensor(t, mesh, placements(fspec[p], mesh),
                                                    src_data_rank=None)
                               for p, t in flat.items()})


def constrain_cache_tree(cfg: ModelConfig, cache: dict) -> dict:
    """Every DTensor leaf of the cache redistributed to its canonical spec
    (a no-op without a hint mesh, and for plain tensors), in place of the
    dict: a prefill-built or step-updated cache stays batch- and
    sequence-sharded."""
    from repro_torch.launch import hints
    mesh = hints._MESH
    if mesh is None:
        return cache
    from torch.distributed.tensor import DTensor
    sizes = axis_sizes(mesh)
    flat = tree_mod.flatten(cache)
    out = {}
    for p, t in flat.items():
        if isinstance(t, DTensor):
            want = placements(cache_spec(p, tuple(t.shape), sizes), t.device_mesh)
            t = t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)
        out[p] = t
    return tree_mod.unflatten(out)


def replicated(mesh) -> tuple:
    """Placements of a replicated tensor on `mesh`."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(axis_sizes(mesh))
