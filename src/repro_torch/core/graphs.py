"""One dispatch per block-step: the port's counterpart of the reference's
compiled decode loop.

The reference never runs its decode loop eagerly: ``repro.serving.engine``
jits ``speculative_generate`` (a ``while_loop`` over blocks) and the
continuous ``spec_superstep``, one compiled program a dispatch.  The port
captures one speculative block-step in a CUDA graph (``torch.cuda.CUDAGraph``)
and replays it, so the thousands of kernels of a block (about 4.4 k on
vicuna-7b, 12 k on mamba2-370m) reach the card in one launch.

A runner owns a static buffer for everything a block-step reads or
advances: the pending tokens, the done mask and the budgets; the cache (K/V
or the page pools, each ring and its slot positions, each SSM or RG-LRU
segment's conv window and state, the lengths,
the block table); the replay buffer (its rows and ``ptr`` / ``count`` /
``gen``); and the bookkeeping's counters and histograms.  Its body is one
block with its bookkeeping (``spec.superstep_block`` or
``spec.generate_block``) and ends by copying each advanced value back into
its static buffer (``write_back``), so a replay reads and writes only
tensors whose addresses the capture saw.  Callers change those buffers in
place, between replays, and never swap one for a new tensor.  The drafter's
A and B are such inputs too: the Improve loop writes them in place
(``core.online``), and every dispatch checks on the host, by address, that
they are still the tensors the runner was made with (``check_ptrs``).

* On CUDA with ``graphs=True`` the body first runs once eagerly on a side
  stream (torch's documented warm-up) with every lane done, which changes
  nothing a later block reads: the replay buffer's ``ptr`` and ``count``
  stay, its generation stays or is put back, and a depth controller's
  state stays.  So each kernel library's first-call setup (its
  attributes, occupancy, the TMA entry point, lazy module loading) happens
  before the capture.  Then the body is captured once per shape key (and
  per draft width with adaptive depth) and replayed.
* On the CPU, or with ``graphs=False``, the same body runs eagerly over the
  same buffers.

The sync scheduler and the paper's baselines (``core.baselines``) share one
runner, ``BlockRunner``: an eager prefill into its static caches, then one
graph a block per (batch, prompt length).  ``GenerateRunner`` runs
``spec.generate_block``, ``TwoModelRunner`` two-model SpS (the target's and
the drafter's caches in one pool), ``MedusaRunner`` Medusa-lite.

The continuous runner with chunked prefill holds a second step, the chunk
step (``Model.prefill_chunk`` over every lane at the fixed shape (lanes,
chunk), the reference's jitted ``chunk_step``), captured once beside the
block-step in the same pool and replayed once a tick that advances a
prefill.

A capture or a replay that fails raises; nothing falls back to the eager
body.

Launch accounting: ``ops.launches`` counts in Python where a wrapper
launches, so a capture counts launches that do not run and a replay counts
none.  The capture's counts are taken back out and added once per replay,
and ``ops.launches`` keeps meaning launches executed.

Memory: the graphs of one runner share one pool.  That is safe in any order
of replay because no value lives in the pool from one replay to the next:
every body ends by copying its results into static buffers allocated
outside the pool.
"""
from __future__ import annotations

import ctypes
import gc
import time
from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import baselines, spec
from repro_torch.core.schedule import DepthConfig
from repro_torch.core.spec import (DEPTH_STATE, GEN_COUNTERS, LANE_COUNTERS, GenResult,
                                   SuperstepResult)
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model


def write_back(static, new) -> None:
    """Copy each tensor of `new` into the static buffer at the same place
    in `static` (nested dicts of tensors), in place, unless it is that
    buffer already."""
    if isinstance(static, dict):
        for key, leaf in static.items():
            write_back(leaf, new[key])
    elif new is not static:
        static.copy_(new)


def upload(dst: torch.Tensor, arr) -> None:
    """Copy the host array `arr` into `dst` in place without blocking the
    host: on the card through pinned memory with ``non_blocking=True``
    (PyTorch's pinned-memory cache keeps the staging block until the copy
    has run).  The copy is a snapshot, so `arr` may change right away."""
    src = torch.from_numpy(np.array(arr))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class _Cuda:
    """Every CUDA call of capture and replay, in one place, so that the CPU
    tests can put a stand-in here."""

    @staticmethod
    def captures(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def new_graph():
        # keep the cudaGraph_t after the capture, to count its nodes
        return torch.cuda.CUDAGraph(keep_graph=True)

    @staticmethod
    def warm(fn: Callable[[], None]) -> None:
        """Run `fn` on a side stream, ordered after and before the current
        stream's work, then wait for it and release the cached blocks, so
        that the capture's pool growth can be read off."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    @staticmethod
    def capture(graph, pool, fn: Callable[[], None]) -> None:
        """Capture `fn` into `graph`, with Python's cyclic garbage collector
        held off: a collection inside the capture may destroy an earlier
        graph, and that CUDA call invalidates the capture
        (``scripts/torch_graph_capture.py`` repeats captures to show it).
        Cycles are collected just before instead."""
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                fn()
        finally:
            if enabled:
                gc.enable()

    @staticmethod
    def reserved() -> int:
        return torch.cuda.memory_reserved()

    @staticmethod
    def nodes(graph) -> tuple:
        """The captured graph's node count and its kernel nodes by function
        (mangled) name, from libcuda."""
        lib = ctypes.CDLL("libcuda.so.1")
        vp, ref = ctypes.c_void_p, ctypes.byref

        def call(fn, *args):
            err = getattr(lib, fn)(*args)
            if err != 0:
                raise RuntimeError(f"{fn}: libcuda error {err}")

        g, n = vp(graph.raw_cuda_graph()), ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, ref(n))
        nodes = (vp * n.value)()
        call("cuGraphGetNodes", g, nodes, ref(n))
        kernels: Counter = Counter()
        kind, p, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
        for node in nodes:
            call("cuGraphNodeGetType", vp(node), ref(kind))
            if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
                continue
            call("cuGraphKernelNodeGetParams_v2", vp(node), ref(p))
            if p.func:
                call("cuFuncGetName", ref(name), vp(p.func))
            else:
                call("cuKernelGetName", ref(name), vp(p.kern))
            kernels[name.value.decode()] += 1
        return n.value, dict(kernels)


_CU_GRAPH_NODE_TYPE_KERNEL = 0


class _KernelNodeParams(ctypes.Structure):
    """libcuda's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), *((f, ctypes.c_uint) for f in (
                    "gx", "gy", "gz", "bx", "by", "bz", "smem")),
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_cuda = _Cuda()


class StepGraph:
    """`body` (no arguments, works on static buffers) run by replaying one
    captured CUDA graph (`capture`), or eagerly.  `frame(run)` calls `run`
    (the body, or a replay) with every lane done and puts back what that
    changes and a later call reads; the warm-up before the capture is
    `warmup` if given, else ``frame(body)`` (else the body), and ``prime``
    replays inside `frame`.  `pool` is the memory pool the graph shares."""

    def __init__(self, body: Callable[[], None], *, capture: bool, pool=None,
                 warmup: Optional[Callable[[], None]] = None,
                 frame: Optional[Callable[[Callable[[], None]], None]] = None):
        self.body = body
        self.frame = frame or (lambda run: run())
        self.graph = None
        self.counts: Optional[dict] = None   # ops.counts() form: one replay's launches
        self.nodes = 0
        self.kernel_nodes: Dict[str, int] = {}   # kernel nodes by mangled function name
        self.capture_s = 0.0                 # warm-up and capture, host seconds
        self.instantiate_s = 0.0
        self.pool_bytes = 0                  # memory the capture reserved
        self.replays = 0
        self.replay_host_s = 0.0             # host seconds inside graph.replay()
        if capture:
            self._capture(pool, warmup or (lambda: self.frame(body)))

    def _capture(self, pool, warmup: Callable[[], None]) -> None:
        t0 = time.perf_counter()
        _cuda.warm(warmup)
        reserved = _cuda.reserved()
        saved = ops.counts()
        ops.reset_launches()
        graph = _cuda.new_graph()
        try:
            _cuda.capture(graph, pool, self.body)
        finally:                             # capturing launched nothing
            self.counts = ops.counts()
            ops.reset_launches()
            ops.add_counts(saved)
        self.nodes, self.kernel_nodes = _cuda.nodes(graph)
        t1 = time.perf_counter()
        graph.instantiate()
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = _cuda.reserved() - reserved
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.body()
            return
        t0 = time.perf_counter()
        self.graph.replay()
        self.replay_host_s += time.perf_counter() - t0
        self.replays += 1
        ops.add_counts(self.counts)

    def prime(self) -> int:
        """Replay the captured graph once inside `frame`, so that it changes
        nothing a later call reads; its launches count in ``ops.launches``,
        not in the replay statistics.  A torch.profiler window loses records
        of a graph's first replays in it and of its last replay's tail
        (``scripts/torch_profile_records.py``); a window that opens and
        closes with a primed replay of each graph puts those losses on
        replays that serve nothing.  Returns the replays made: 0 when
        nothing was captured."""
        if self.graph is None:
            return 0
        self.frame(self.graph.replay)
        ops.add_counts(self.counts)
        return 1


def graph_stats(steps) -> dict:
    """Captures, capture and instantiate seconds, node counts, the pools'
    memory, replays and host seconds in ``replay()`` over StepGraphs; and,
    per graph, the launches its capture recorded beside its kernel nodes by
    function name (``per_graph``)."""
    steps = list(steps)
    return {"captures": sum(s.graph is not None for s in steps),
            "capture_s": sum(s.capture_s for s in steps),
            "instantiate_s": sum(s.instantiate_s for s in steps),
            "nodes": [s.nodes for s in steps if s.graph is not None],
            "pool_bytes": sum(s.pool_bytes for s in steps),
            "replays": sum(s.replays for s in steps),
            "replay_host_s": sum(s.replay_host_s for s in steps),
            "per_graph": [(s.counts["launches"], s.kernel_nodes)
                          for s in steps if s.graph is not None]}


def tensor_ptrs(tree: dict) -> list:
    """The address of every tensor of nested dicts of tensors, in order."""
    out = []
    for leaf in tree.values():
        out.extend(tensor_ptrs(leaf) if isinstance(leaf, dict) else [leaf.data_ptr()])
    return out


drafter_ptrs = tensor_ptrs               # the drafter's A and B


def check_ptrs(tree: dict, ptrs: list) -> None:
    """Raise unless `tree` holds the tensors at the addresses `ptrs`
    (``tensor_ptrs`` when the runner was made): a graph replays with the
    addresses it captured, so a rebound tensor (the drafter's A or B, a
    baseline's parameter) would never be read."""
    if tensor_ptrs(tree) != ptrs:
        raise RuntimeError("a tensor the block-step reads was rebound since the block-step "
                           "was made: update A and B (and any parameter) in place (copy_), "
                           "never assign new tensors")


class SuperstepRunner:
    """The continuous scheduler's block-step over static buffers.
    ``dispatch`` runs a superstep of ``steps`` blocks as ``steps`` calls of
    one block-step, whose shape is the engine's lanes, its cache (capacity,
    or pages and table width), ``sync_every`` and the draft width: one
    graph at depth K, or with a depth controller (`depth`) one graph per
    draft width ``K_blk`` in [k_min, k_max] that a dispatch asks for
    (captured at its first use, or all at once by ``capture_all``), the
    port's counterpart of the reference re-specialising its jitted
    superstep on the static ``K_blk``.  All of them read and write the same
    static buffers and share one memory pool.

    `pending` (B,), `cache` and `buf` become static buffers as they are:
    the engine keeps the same tensors and edits them in place between
    dispatches.  So do the controller's per-lane depth, EMA, cooldown and
    ceiling (``DEPTH_STATE`` and "k_cap"), uploaded at each dispatch.  The
    counters, histograms (``k_max + 1`` buckets) and the committed-token
    buffer (``sync_every * (k_max + 1)`` a lane, plus a spare slot) are
    views of one int32 buffer, zeroed once a dispatch.

    With `chunk` > 0 (chunked prefill) the runner also holds the engine's
    chunk step (``prefill_chunk``): one more block-step at the fixed shape
    (lanes, `chunk`), captured once in the same pool, whose static inputs
    are ``chunk_state``'s tokens (B, chunk), take, finish_tok and finished
    (B,).  It advances every prefilling lane by its take in the engine's
    cache, in place, and sets the pending token of the lanes whose prefill
    it finishes."""

    def __init__(self, model: Model, params: dict, dvi_params: dict, pending: torch.Tensor,
                 cache: dict, buf: dict, *, sync_every: int, eos_id: int, graphs: bool,
                 depth: Optional[DepthConfig] = None, chunk: int = 0):
        K = model.cfg.dvi.k_spec
        B = pending.shape[0]
        dev = pending.device
        self.k_spec, self.depth = K, depth
        k_max = K if depth is None else depth.k_max
        self.dvi_params, self.drafter = dvi_params, tensor_ptrs(dvi_params)
        self.cap = cap = sync_every * (k_max + 1)
        sizes = [B] * len(LANE_COUNTERS) + [k_max + 1, k_max + 1, B * cap + 1]
        self.acc = torch.zeros((sum(sizes),), dtype=torch.int32, device=dev)
        *counters, a_hist, d_hist, self.gen_flat = self.acc.split(sizes)
        self.state = st = dict(
            pending=pending, done=torch.ones((B,), dtype=torch.bool, device=dev),
            budget=torch.zeros((B,), dtype=torch.int32, device=dev), cache=cache, buf=buf,
            **dict(zip(LANE_COUNTERS, counters)),
            k_lane=torch.full((B,), K if depth is None else depth.k_init, dtype=torch.int32,
                              device=dev),
            accept_ema=torch.zeros((B,), dtype=torch.float32, device=dev),
            k_cool=torch.zeros((B,), dtype=torch.int32, device=dev),
            k_cap=torch.full((B,), k_max, dtype=torch.int32, device=dev),
            accept_hist=a_hist, depth_hist=d_hist)
        gen_flat = self.gen_flat

        # the body holds the buffers, not the runner: no reference cycle
        def make_body(k_blk: int):
            def body():
                k_hi = None if depth is None else torch.clamp(st["k_cap"], max=k_blk)
                write_back(st, spec.superstep_block(
                    model, params, dvi_params, st, gen_flat, cap, k_spec=k_blk, eos_id=eos_id,
                    collect=True, ragged=depth is not None, depth_cfg=depth, k_hi=k_hi))

            def frame(run):              # no live lane: the buffer's gen stays
                st["done"].fill_(True)
                run()
            return body, frame

        self._make_body = make_body
        self._capture = graphs and _cuda.captures(dev)
        self._pool = _cuda.new_pool() if self._capture else None
        self.steps: Dict[int, StepGraph] = {}          # K_blk -> its block-step
        if depth is None:
            self.step_for(K)
        self.chunk_step: Optional[StepGraph] = None
        if chunk:
            cst = self.chunk_state = dict(
                tokens=torch.zeros((B, chunk), dtype=torch.int32, device=dev),
                take=torch.zeros((B,), dtype=torch.int32, device=dev),
                finish_tok=torch.zeros((B,), dtype=torch.int32, device=dev),
                finished=torch.zeros((B,), dtype=torch.bool, device=dev))

            def chunk_body():
                model.prefill_chunk(params, cst["tokens"], cache, cst["take"])
                pending.copy_(torch.where(cst["finished"], cst["finish_tok"], pending))

            def chunk_frame(run):        # take 0 everywhere: no lane advances
                cst["take"].zero_()
                cst["finished"].fill_(False)
                run()

            self.chunk_step = StepGraph(chunk_body, capture=self._capture, pool=self._pool,
                                        frame=chunk_frame)

    def step_for(self, k_blk: int) -> StepGraph:
        """The block-step at draft width `k_blk`, made (and captured) on
        first use.  Capturing runs a warm-up block with every lane done, so
        a dispatch asks for its step before it uploads the done mask."""
        if k_blk not in self.steps:
            lo, hi = ((self.k_spec, self.k_spec) if self.depth is None
                      else (self.depth.k_min, self.depth.k_max))
            if not lo <= k_blk <= hi:
                raise ValueError(f"draft width {k_blk} outside [{lo}, {hi}]")
            body, frame = self._make_body(k_blk)
            self.steps[k_blk] = StepGraph(body, capture=self._capture, pool=self._pool,
                                          frame=frame)
        return self.steps[k_blk]

    def capture_all(self) -> None:
        """Make every block-step the runner may dispatch: each draft width in
        [k_min, k_max] with a depth controller."""
        if self.depth is not None:
            for k_blk in range(self.depth.k_min, self.depth.k_max + 1):
                self.step_for(k_blk)

    def dispatch(self, done: np.ndarray, budget: np.ndarray, steps: int,
                 k_blk: Optional[int] = None, depth_state=None) -> SuperstepResult:
        """Upload the host's done mask and REMAINING budgets (and, with a
        controller, `depth_state`: the per-lane depth, EMA, cooldown and
        ceiling), zero the accumulators and run `steps` blocks at draft
        width `k_blk` (default K).  Returns without waiting for the device;
        the result's tensors are the static buffers, which the next dispatch
        overwrites; its histograms are their first ``k_blk + 1`` buckets."""
        st = self.state
        k_blk = self.k_spec if k_blk is None else k_blk
        step = self.step_for(k_blk)
        check_ptrs(self.dvi_params, self.drafter)
        upload(st["done"], done)
        upload(st["budget"], budget)
        if depth_state is not None:
            for name, arr in zip(DEPTH_STATE + ("k_cap",), depth_state):
                upload(st[name], arr)
        self.acc.zero_()
        for _ in range(steps):
            step()
        B = st["pending"].shape[0]
        return SuperstepResult(st["pending"], st["done"],
                               self.gen_flat[:B * self.cap].view(B, self.cap),
                               *(st[name] for name in LANE_COUNTERS + DEPTH_STATE),
                               st["accept_hist"][:k_blk + 1], st["depth_hist"][:k_blk + 1],
                               st["cache"], st["buf"], steps)

    def prefill_chunk(self, tokens: np.ndarray, take: np.ndarray, finish_tok: np.ndarray,
                      finished: np.ndarray) -> None:
        """Upload one chunk step's host arrays into ``chunk_state`` and run
        the chunk step once, without waiting for the device."""
        cst = self.chunk_state
        for name, arr in (("tokens", tokens), ("take", take), ("finish_tok", finish_tok),
                          ("finished", finished)):
            upload(cst[name], arr)
        self.chunk_step()

    def all_steps(self) -> list:
        """The block-steps and the chunk step."""
        return list(self.steps.values()) + ([self.chunk_step] if self.chunk_step else [])

    def graph_stats(self) -> dict:
        """``graph_stats`` over ``all_steps``."""
        return graph_stats(self.all_steps())

    def prime(self) -> int:
        """``StepGraph.prime`` of each step; the replays made."""
        return sum(step.prime() for step in self.all_steps())


class BlockRunner:
    """A decode loop over static buffers, as ``speculative_generate``'s:
    ``generate`` prefills a batch eagerly into the static caches of its
    shape, then runs one block-step a block and tests ``all(done)`` on the
    host after each.  One graph per (batch, prompt length).

    `caches` maps each static cache's name in the state to the (model,
    params) that prefill it; `block(st, limit)` is one block with its
    bookkeeping over the state ("pending", "done", "out", "out_len", the
    caches, the ``GEN_COUNTERS`` and `extra`), whose stream takes at most
    `width` + 1 tokens a block.  `extra` holds static entries every shape
    shares (the replay buffer); the warm-up puts the tensors `keep` back.
    `tensors` holds the trees the graphs read besides: every ``generate``
    checks on the host that they still hold the tensors the runner was made
    with (by address, ``check_ptrs``)."""

    def __init__(self, caches: dict, block: Callable, tensors: dict, *, width: int,
                 max_new: int, graphs: bool, device: torch.device, extra: Optional[dict] = None,
                 keep: tuple = ()):
        self.caches, self.block, self.tensors = caches, block, tensors
        self.ptrs = tensor_ptrs(tensors)
        self.width, self.max_new, self.device = width, max_new, device
        self.extra, self.keep = extra or {}, keep
        self.capture = graphs and _cuda.captures(device)
        self.pool = _cuda.new_pool() if self.capture else None
        self._shapes = {}                # (B, Tp) -> (static state, StepGraph)

    def prepare(self, B: int, Tp: int):
        """The static state and block-step of batches of B prompts of Tp
        tokens, made (and captured) on first use.  Each static cache holds
        the stream's worst case, ``RING_SLACK`` and a VLM's patches; "out"
        counts tokens only."""
        if (B, Tp) in self._shapes:
            return self._shapes[(B, Tp)]
        dev, block, keep = self.device, self.block, self.keep
        total = Tp + self.max_new + self.width + 2
        st = dict(pending=torch.zeros((B,), dtype=torch.int32, device=dev),
                  done=torch.ones((B,), dtype=torch.bool, device=dev),
                  out=torch.zeros((B, total), dtype=torch.int32, device=dev),
                  out_len=torch.zeros((B,), dtype=torch.int32, device=dev),
                  **{name: model.init_cache(B, total + tfm.RING_SLACK + model.prefix_len())
                     for name, (model, _) in self.caches.items()},
                  **self.extra,
                  **{name: torch.zeros((), dtype=torch.int64, device=dev)
                     for name in GEN_COUNTERS})
        limit = Tp + self.max_new

        # the body holds the buffers, not the runner: no reference cycle
        def body():
            write_back(st, block(st, limit))

        def frame(run):                  # every lane done; the block may still
            saved = [t.clone() for t in keep]    # advance what `keep` holds
            st["done"].fill_(True)
            run()
            for t, v in zip(keep, saved):
                t.copy_(v)

        self._shapes[(B, Tp)] = st, StepGraph(body, capture=self.capture, pool=self.pool,
                                              frame=frame)
        return self._shapes[(B, Tp)]

    def generate(self, prompts: torch.Tensor, live_mask: Optional[torch.Tensor] = None,
                 aux_inputs: Optional[dict] = None) -> GenResult:
        """``max_new`` tokens on prompts (B, Tp), Tp >= 2, through the
        block-step; lanes outside `live_mask` (default: none) start done;
        `aux_inputs` go to the prefills (an encoder's frames, whose cross
        K/V the prefill writes into the static cache in place; a VLM's
        patches).  The result's tensors are the static buffers of this
        shape, which the next batch of the shape overwrites."""
        B, Tp = prompts.shape
        if Tp < 2:
            raise ValueError("need at least 2 prompt tokens (one prefill + one pending)")
        check_ptrs(self.tensors, self.ptrs)
        st, step = self.prepare(B, Tp)
        prompts = prompts.to(torch.int32)
        # the prefills are eager: they fill the static caches in place
        for name, (model, params) in self.caches.items():
            _, pc = model.prefill(params, prompts[:, :Tp - 1], aux_inputs, cache=st[name])
            st[name]["lengths"].copy_(pc["lengths"])
        st["pending"].copy_(prompts[:, Tp - 1])
        st["out"].zero_()
        st["out"][:, :Tp] = prompts
        st["out_len"].fill_(Tp)
        if live_mask is None:
            st["done"].fill_(False)
        else:
            st["done"].copy_(~live_mask)
        for name in GEN_COUNTERS:
            st[name].zero_()
        steps = 0
        while not bool(st["done"].all()):
            step()
            steps += 1
        return GenResult(st["out"], st["out_len"], *(st[name] for name in GEN_COUNTERS),
                         st.get("buf"), steps)

    def all_steps(self) -> list:
        return [step for _, step in self._shapes.values()]

    def graph_stats(self) -> dict:
        return graph_stats(self.all_steps())

    def prime(self) -> int:
        """``StepGraph.prime`` of each shape's block-step; the replays made."""
        return sum(step.prime() for step in self.all_steps())


class GenerateRunner(BlockRunner):
    """The sync scheduler's ``speculative_generate(..., collect=True, buf,
    live_mask)`` through one block-step a block; the replay buffer `buf` is
    shared by every shape (the warm-up puts its generation back).
    ``generate(prompts, live_mask)``."""

    def __init__(self, model: Model, params: dict, dvi_params: dict, buf: dict, *,
                 max_new: int, graphs: bool, eos_id: int = 1):
        K = model.cfg.dvi.k_spec

        def block(st, limit):
            return spec.generate_block(model, params, dvi_params, st, k_spec=K, limit=limit,
                                       eos_id=eos_id, collect=True)
        super().__init__({"cache": (model, params)}, block, dvi_params, width=K,
                         max_new=max_new, graphs=graphs, device=model.device,
                         extra=dict(buf=buf), keep=(buf["gen"],))
        self.drafter = self.ptrs


class TwoModelRunner(BlockRunner):
    """``baselines.two_model_generate`` through one block-step a block: the
    target's and the drafter's static caches share the runner's pool."""

    def __init__(self, target: Model, t_params: dict, draft: Model, d_params: dict, *,
                 max_new: int, graphs: bool, k_spec: int = 4, eos_id: int = 1):
        def block(st, limit):
            return baselines.two_model_block(target, t_params, draft, d_params, st,
                                             k_spec=k_spec, limit=limit, eos_id=eos_id)
        super().__init__({"t_cache": (target, t_params), "d_cache": (draft, d_params)}, block,
                         dict(target=t_params, draft=d_params), width=k_spec,
                         max_new=max_new, graphs=graphs, device=target.device)


class MedusaRunner(BlockRunner):
    """``baselines.medusa_generate`` through one block-step a block; the
    heads are read where they lie (train them in place)."""

    def __init__(self, model: Model, params: dict, heads: dict, *, max_new: int, graphs: bool,
                 eos_id: int = 1):
        def block(st, limit):
            return baselines.medusa_block(model, params, heads, st, limit=limit, eos_id=eos_id)
        super().__init__({"cache": (model, params)}, block, dict(model=params, heads=heads),
                         width=1 + heads["w1"].shape[0], max_new=max_new, graphs=graphs,
                         device=model.device)
