"""Per-device step analysis on fake tensors: the counterpart of
``repro.launch.hlo_analysis``.

The reference compiles a step for placeholder devices and reads the
post-SPMD HLO: matmul FLOPs and collectives of every loop body times its
trip count.  Here the step runs once, eagerly, in one process, on fake
tensors (``FakeTensorMode``: shapes, dtypes and aliasing, no memory) that
are the local shards of DTensors placed on a mesh over a ``"fake"`` process
group (``fake_group``).  DTensor runs each op on the local shards and
inserts the collectives its redistributions need; ``StepCounter`` (the fake
mode itself) sees exactly those local operations and records, per device:

* FLOPs: every op of ``torch.utils.flop_counter``'s table (the matmul
  family) on local shards, so replicated compute counts on every device;
* collectives: each functional collective, by kind, with its payload (the
  output's bytes) and the reference's wire-byte formula for its group size
  (``wire_bytes``), also by the mesh axis its group spans;
* memory: the bytes of the arguments' local shards, and the peak of the
  bytes of every live local storage while the step runs.

Sharding propagation also runs ops on global-shaped fake tensors to learn
output shapes; those are marked and not counted.  Loops: every loop of the
model goes through ``models.loops.scan`` (the layers of a segment,
``attend_full``'s query and key chunks), which here runs one iteration and
``repeat`` scales what it counts by the trip count, as the reference's
analysis weighs a scanned body.  Argument bytes stay exact at full depth,
since the parameters and caches are placed whole.

Ops DTensor has no sharding strategy for (and views it cannot shard) run in
``ReplicateFallback``: their DTensor inputs are redistributed to
``Replicate()`` (the all-gather is counted, as GSPMD would insert one), the
op runs on the full local copies, and the outputs come back replicated; an
in-place op writes its replicated result back into its input's own shard.
Three ops keep their shards instead, as GSPMD lowers them: an in-place
indexed write (``index_put_``: each device writes its own part of the
target, with the indices and values replicated), an indexed read of a
tensor sharded on its indexed dims (each device gathers from its shard and
the parts are summed, ``_shardwise_index``) and a slice from 0 of a sharded
dim (each device takes the same leading part of its shard, the write of a
prefill into a longer cache).  ``fallbacks`` counts each by op name.
Attention over a cache whose sequence dim is sharded runs as flash-decode
does across devices (``_flash_decode``): each device attends its own slots
and the partial outputs are summed over the sequence's axes.

What is checked, and what is not: on a 2 x 2 mesh (the tiny vicuna's
decode and prefill steps) the FLOPs a device and the argument bytes agree
with the reference's dry run within 1 %, but the collectives are DTensor's
eager redistributions, not GSPMD's plan: their wire bytes there are
0.5-1.5 times the reference's on torch 2.13, and they change with torch's
version (its ops' sharding strategies).  Each DTensor internal
patched here must exist (``_patched`` raises otherwise), and the record
names the torch version.

Nothing here launches a kernel: on fake tensors the kernel wrappers see a
CPU device and run their plain versions, as the reference's dry run lowers
``jnp`` and no Pallas.  This is an analysis entry point, not a fallback on
a served path.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.models import loops

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collectives by the reference's HLO kind
_KIND = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
         ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def wire_bytes(kind: str, out_bytes: float, gsize: int) -> float:
    """Estimated bytes a device sends for one collective of `kind` whose
    output has `out_bytes`, over a group of `gsize` (the reference's
    formula: ring all-reduce 2 (g-1)/g, all-gather (g-1)/g of the output,
    reduce-scatter g-1 times the output, all-to-all (g-1)/g)."""
    frac = (gsize - 1) / gsize
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * (gsize - 1)
    if kind == "all-to-all":
        return out_bytes * frac
    return out_bytes      # collective-permute


@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group as a ``"fake"`` group of `world_size`
    ranks (this process rank 0): collectives return at once and move
    nothing.  Destroyed on exit, so no later code finds a default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        s = t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None, 0
    return s._cdata, s.nbytes()


class StepCounter(FakeTensorMode):
    """A fake-tensor mode that counts what runs on local shards: FLOPs,
    collectives and live storage bytes (see the module's docstring).
    ``counting`` gates the records (off while inputs are built)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.counting = False
        self.mult = 1
        self.shadow = 0
        self.flops = 0.0
        self.per_kind = {}
        self.per_axis = {}
        self.axis_of = {}           # process group name -> mesh axis name
        self.live = {}              # storage key -> [bytes, tensor refs]
        self.pinned = set()
        self.current = 0
        self.peak = 0

    # -- scopes --
    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside `n` times (a loop body run once)."""
        self.mult *= n
        try:
            yield
        finally:
            self.mult //= n

    @contextlib.contextmanager
    def shadowed(self):
        """Ops that only derive shapes (sharding propagation): not counted."""
        self.shadow += 1
        try:
            yield
        finally:
            self.shadow -= 1

    def pin(self, tensors) -> int:
        """Mark the storages of `tensors` (local shards of the arguments) as
        live for the whole step; returns their bytes."""
        total = 0
        for t in tensors:
            key, nb = _storage_key(t)
            if key is None or key in self.pinned:
                continue
            self.pinned.add(key)
            total += nb
        self.current += total
        self.peak = max(self.peak, self.current)
        return total

    def live_bytes(self, tensors) -> int:
        """Bytes of the distinct unpinned storages of `tensors`."""
        seen, total = set(), 0
        for t in tensors:
            key, nb = _storage_key(t)
            if key is None or key in self.pinned or key in seen:
                continue
            seen.add(key)
            total += nb
        return total

    # -- accounting --
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":          # shapes only (cache templates)
            return
        key, nb = _storage_key(t)
        if key is None or key in self.pinned:
            return
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [nb, 0]
            self.current += nb
            self.peak = max(self.peak, self.current)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.current -= entry[0]
            del self.live[key]

    def _collective(self, func, args, kwargs, out) -> None:
        name = str(func)
        kind = next((k for frag, k in _KIND if frag in name), "collective-permute")
        names = [a.name for a in func._schema.arguments]
        group = kwargs.get("group_name", args[names.index("group_name")]
                           if "group_name" in names and names.index("group_name") < len(args)
                           else None)
        group = getattr(group, "group_name", group)
        # raises for a group it cannot name: a guessed size would misprice it
        gsize = dist.distributed_c10d._resolve_process_group(group).size()
        gsize = max(gsize, 2)           # as the reference reads replica groups
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        payload = float(sum(_nbytes(t) for t in outs)) * self.mult
        wire = wire_bytes(kind, payload, gsize)
        for table, key in ((self.per_kind, kind),
                           (self.per_axis, self.axis_of.get(group, "other"))):
            d = table.setdefault(key, {"count": 0.0, "payload_bytes": 0.0, "wire_bytes": 0.0})
            d["count"] += self.mult
            d["payload_bytes"] += payload
            d["wire_bytes"] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or not self.counting or self.shadow:
            return out
        name = str(func)
        if "c10d_functional" in name or "shard_dim_alltoall" in name:
            if "wait_tensor" not in name:
                self._collective(func, args, kwargs, out)
        else:
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(func.overloadpacket)
            if fn is not None:
                self.flops += float(fn(*args, **kwargs, out_val=out)) * self.mult
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def totals(self) -> dict:
        total = {k: sum(d[k] for d in self.per_kind.values())
                 for k in ("count", "payload_bytes", "wire_bytes")}
        return {"per_kind": self.per_kind, "per_axis": self.per_axis, "total": total}


class ReplicateFallback(TorchDispatchMode):
    """Runs the ops DTensor cannot shard (see the module's docstring) and
    counts them by name in ``fallbacks``."""

    def __init__(self):
        super().__init__()
        self.fallbacks = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        name = str(func)
        if name == "aten.slice.Tensor":
            out = _shardwise_slice(*args, **kwargs)
            if out is not None:
                self.fallbacks["aten.slice.Tensor (shard-wise)"] += 1
                return out
        if name in ("aten.index_put_.default", "aten._index_put_impl_.default") and \
                isinstance(args[0], DTensor):
            self.fallbacks[f"{name} (shard-wise)"] += 1
            return _shardwise_index_put(func, args, kwargs)
        if name == "aten.index.Tensor" and isinstance(args[0], DTensor):
            out = _shardwise_index(func, args)
            if out is not None:
                self.fallbacks[f"{name} (shard-wise)"] += 1
                return out
        try:
            return func(*args, **kwargs)
        except Exception:  # noqa: BLE001 -- no strategy, an unshardable view, or
            pass           # a sharded-dim reduction whose offsets need values
        self.fallbacks[name] += 1
        return _replicated_call(func, args, kwargs)


def _replicate(x):
    """The full tensor of a DTensor on every device (its all-gathers
    counted); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()


def _replicated_call(func, args, kwargs):
    """func on the full local copies of its DTensor inputs; outputs
    replicated; a mutated DTensor input gets its shard of the result."""
    from torch.distributed.tensor import DTensor, Replicate
    flat, spec = tree_flatten((args, kwargs))
    mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
    local = [_replicate(a) for a in flat]
    la, lk = tree_unflatten(local, spec)
    out = func(*la, **lk)
    mutated = [i for i, a in enumerate(func._schema.arguments)
               if a.alias_info is not None and a.alias_info.is_write
               and i < len(args) and isinstance(args[i], DTensor)]
    for i in mutated:
        full = DTensor.from_local(local[i], mesh, [Replicate()] * mesh.ndim, run_check=False)
        args[i]._local_tensor.copy_(full.redistribute(mesh, args[i].placements).to_local())
    if len(mutated) == 1:
        return args[mutated[0]]

    def wrap(t):
        if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t
    return tree_map(wrap, out)


def _shardwise_slice(x, dim=0, start=None, end=None, step=1):
    """x[..., 0:end] along a dim sharded over one mesh axis, taken as the
    same leading part of each shard, or None when it does not apply."""
    from torch.distributed.tensor import DTensor, Shard
    dim = dim % x.ndim
    shards = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    if len(shards) != 1 or step != 1 or (start or 0) != 0 or end is None:
        return None
    n = x.device_mesh.size(shards[0])
    end = min(end, x.shape[dim])
    if end == x.shape[dim] or end % n:
        return None
    local = x.to_local().narrow(dim, 0, end // n)
    shape = list(x.shape)
    shape[dim] = end
    return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _shardwise_index_put(func, args, kwargs):
    """self.index_put_(indices, values) with self sharded: the indices and
    values replicated, each device writing into its own shard (index
    positions past the shard land inside it: values are fake)."""
    self_, indices, values = args[0], args[1], args[2]
    local = self_._local_tensor

    def fit(ix, d):
        if ix is None:
            return None
        ix = _replicate(ix)
        return ix.clamp(max=local.shape[d] - 1) if ix.dtype != torch.bool else ix
    lidx = [fit(ix, d) for d, ix in enumerate(indices)]
    func(local, lidx, _replicate(values), *args[3:], **kwargs)
    return self_


def _shardwise_index(func, args):
    """self[indices] (an indexed read, a gather) with self sharded only on
    indexed dims: each device gathers from its own shard (indices
    replicated), and the partial results are summed over the mesh axes of
    those dims (GSPMD's masked gather and all-reduce); None when another dim
    of self is sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    self_, indices = args[0], args[1]
    sharded = {i: p.dim for i, p in enumerate(self_.placements) if isinstance(p, Shard)}
    indexed = {d for d, ix in enumerate(indices) if ix is not None}
    if not sharded or not set(sharded.values()) <= indexed:
        return None
    local = self_._local_tensor
    lidx = [None if ix is None else
            (_replicate(ix).clamp(max=local.shape[d] - 1) if ix.dtype != torch.bool
             else _replicate(ix)) for d, ix in enumerate(indices)]
    out = func(local, lidx)
    mesh = self_.device_mesh
    for i in sorted(sharded):
        out = torch.ops._c10d_functional.wait_tensor(torch.ops._c10d_functional.all_reduce(
            out, "sum", mesh.get_group(i).group_name))
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim, run_check=False)


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """`obj.name` replaced by `value` inside.  Raises when `obj` has no such
    attribute: the analysis relies on each of DTensor's internals it patches
    (present in torch 2.11 and 2.13), and a missing one would change what is
    counted."""
    if not hasattr(obj, name):
        raise AttributeError(f"torch {torch.__version__}: {obj.__name__} has no {name!r}, "
                             "which the step analysis patches")
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _flash_decode(dec0):
    """``ops.decode_attention`` over a cache whose sequence dim is sharded:
    each device attends its own slots with the plain version (the queries
    and lengths laid out as the cache's batch), then the partial outputs
    and their softmax statistics are summed over the sequence's mesh axes,
    the flash-decode layout the reference's hints ask GSPMD for.  Any other
    placement runs the plain version on the DTensors as they are."""
    def decode(q, k, v, lengths, pos=None, window=0, causal=True, k_scale=None,
               v_scale=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(k, DTensor) or not any(
                isinstance(p, Shard) and p.dim == 1 for p in k.placements):
            return dec0(q, k, v, lengths, pos=pos, window=window, causal=causal,
                        k_scale=k_scale, v_scale=v_scale)
        mesh = k.device_mesh
        seq = [i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1]
        batch = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in k.placements]

        def local(t, placements):
            if t is None:
                return None
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            return t.redistribute(mesh, placements).to_local()
        with_seq = [Shard(1) if i in seq else p for i, p in enumerate(batch)]
        ql, ll = local(q, batch), local(lengths, batch)
        out = dec0(ql, k.to_local(), v.to_local(), ll, pos=local(pos, with_seq),
                   window=window, causal=causal, k_scale=local(k_scale, with_seq),
                   v_scale=local(v_scale, with_seq))
        part = out.float()
        stats = part.new_empty(part.shape[:-1])          # the running max and sum
        for i in seq:
            group = mesh.get_group(i).group_name
            for t in (part, stats, stats):
                torch.ops._c10d_functional.wait_tensor(
                    torch.ops._c10d_functional.all_reduce(t, "sum", group))
        return DTensor.from_local(out.contiguous(), mesh, batch, run_check=False)
    return decode


def _one_iteration(counter: StepCounter):
    """The ``loops.scan`` runner: one iteration, its counts scaled by the
    trip count, its y standing for all n (``torch.stack`` or ``cat`` of the
    list then materialises the full-depth result)."""
    def run(body, carry, n):
        with counter.repeat(n):
            carry, y = body(carry, 0)
        return carry, [y] * n
    return run


@contextlib.contextmanager
def analysis_patches(counter: StepCounter):
    """Every loop of the model (``models.loops.scan``) runs one iteration
    scaled by its trip count; ``ops.decode_attention`` over a
    sequence-sharded cache runs flash-decode style (``_flash_decode``); and
    DTensor's internals behave as the module's docstring says: sharding
    propagation's shape-only ops uncounted, the greedy redistribution plan
    (the min-cost graph search over a 3-D mesh, the two-pod production
    mesh, takes tens of minutes an op), the shard-offset bookkeeping on
    real tensors, and the all-to-all as one collective."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, _utils as dtensor_utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.kernels import ops

    meta0 = ShardingPropagator._propagate_tensor_meta_non_cached

    def meta(self, *a, **kw):
        with counter.shadowed():
            return meta0(self, *a, **kw)

    def greedy(self, src_spec, dst_spec, *a, **kw):
        return self.generate_greedy_transform_infos(src_spec, dst_spec)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        # the all-to-all itself (DTensor turns it into a gather and a chunk on
        # a CPU mesh, which moves what an NCCL all-to-all does not)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)

    def real(fn):
        # DTensor's shard-offset bookkeeping builds index tensors and reads
        # them back: it runs on real tensors, outside the fake mode
        def run(*a, **kw):
            with unset_fake_temporarily():
                return fn(*a, **kw)
        return run

    planner = _redistribute.DTensorRedistributePlanner
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                                     meta))
        stack.enter_context(_patched(planner, "generate_graph_based_transform_infos", greedy))
        for obj, name in ((dtensor_utils, "_get_shard_size_and_offsets"),
                          (dtensor_utils, "_get_first_offset"),
                          (placement_types._StridedShard, "local_shard_size_and_offset")):
            stack.enter_context(_patched(obj, name, real(getattr(obj, name))))
        stack.enter_context(_patched(placement_types, "shard_dim_alltoall", alltoall))
        stack.enter_context(_patched(ops, "decode_attention", _flash_decode(ops.decode_attention)))
        stack.enter_context(loops.runner(_one_iteration(counter)))
        yield


def locals_of(tree) -> list:
    """The local shards of every DTensor leaf (and every plain tensor) of a
    nested structure of dicts, lists and tuples."""
    from torch.distributed.tensor import DTensor
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            out.append(t._local_tensor)
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def analyze(fn, args: list, counter: StepCounter, mesh) -> dict:
    """Run ``fn(*args)`` once under the counter (already entered, with the
    arguments built in it) and return the per-device record: memory
    {argument, output, temp, peak}_bytes, ``dot_flops_per_device``,
    collectives {per_kind, per_axis, total}, and ``fallbacks``."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter.axis_of = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    arg_bytes = counter.pin(locals_of(args))
    fallback = ReplicateFallback()
    counter.counting = True
    try:
        with analysis_patches(counter), implicit_replication(), fallback:
            out = fn(*args)
    finally:
        counter.counting = False
    out_bytes = counter.live_bytes(locals_of(out))
    peak = counter.peak
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(peak - arg_bytes - out_bytes, 0), "peak_bytes": peak},
        "dot_flops_per_device": counter.flops,
        "collectives": counter.totals(),
        "fallbacks": dict(fallback.fallbacks),
    }
