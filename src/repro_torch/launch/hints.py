"""Opportunistic sharding hints: counterpart of ``repro.launch.hints``.

``hint(x, *axes)`` redistributes a DTensor to the placements its axes name
when a hint mesh is registered; a plain tensor (every run on one card, the
CPU tests) comes back unchanged, and without a hint mesh it returns before
looking at `x`.  Model code can therefore say "this dim wants to live on
that axis" without depending on a mesh.  ``hint_spec`` is the spec
computation alone, the reference's rules: axes absent from the mesh,
already used by an earlier dim, of size 1 or not dividing the dim are
dropped; a tuple of axes that does not fit whole falls back to its first
axis.

The mesh is registered explicitly (``set_hint_mesh`` / the ``hint_mesh``
context manager) by the launcher or the dry run.
"""
from __future__ import annotations

import contextlib

from repro_torch.launch.mesh import axis_sizes

_MESH = None


def set_hint_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


@contextlib.contextmanager
def hint_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def hint_spec(shape, axes, sizes: dict):
    """The spec (one entry a dim: None, an axis name or a tuple of names)
    that ``hint`` constrains a tensor of `shape` to on a mesh of axis
    `sizes`, or None when no dim is sharded (the hint is then a no-op)."""
    spec, used = [], set()

    def usable(ax_tuple, dim):
        size = 1
        for a in ax_tuple:
            if a not in sizes or a in used or sizes[a] <= 1:
                return False
            size *= sizes[a]
        return dim % size == 0

    for dim, ax in zip(shape, axes):
        if ax is None:
            spec.append(None)
            continue
        ax_t = ax if isinstance(ax, tuple) else (ax,)
        if usable(ax_t, dim):
            spec.append(ax)
            used.update(ax_t)
        elif isinstance(ax, tuple) and usable((ax[0],), dim):
            spec.append(ax[0])
            used.add(ax[0])
        else:
            spec.append(None)
    spec += [None] * (len(shape) - len(spec))
    return tuple(spec) if any(a is not None for a in spec) else None


def hint(x, *axes):
    """axes: one entry per dim, an axis name, a tuple of names (joint
    sharding) or None.  A DTensor is redistributed to the spec's placements
    (``sharding.placements``); anything else is returned as it is."""
    mesh = _MESH
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = hint_spec(tuple(x.shape), axes, axis_sizes(mesh))
    if spec is None:
        return x
    from repro_torch.launch.sharding import placements
    want = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def gathered(tree, x):
    """A layer's weights (a dict tree) all-gathered over the mesh axes that
    shard the batch (dim 0) of its input `x`, their other placements kept:
    FSDP, each weight gathered a layer at a time before the layer runs, as
    GSPMD gathers the reference's full-sequence path.  Without a hint mesh,
    or for anything but a DTensor `x`, `tree` comes back as it is."""
    if _MESH is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return tree
    dims = {i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == 0}

    def gather(t):
        if isinstance(t, dict):
            return {k: gather(v) for k, v in t.items()}
        if not isinstance(t, DTensor) or not any(isinstance(t.placements[i], Shard)
                                                 for i in dims):
            return t
        want = [Replicate() if i in dims else p for i, p in enumerate(t.placements)]
        return t.redistribute(t.device_mesh, want)
    return gather(tree)
