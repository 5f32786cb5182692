"""Continual-learning serving engine: port of ``repro.serving.engine``,
greedy, at a fixed or an adaptive depth.

Two schedulers:

* ``scheduler="sync"``: requests are queued in prompt-length buckets; each
  ``step`` takes up to ``batch_size`` requests from the fullest bucket,
  pads their prompts to the bucket length (left, by repeating the first
  token), pads the batch with replays that are masked out of generation,
  logging and statistics, and decodes it to completion with
  ``speculative_generate``.
* ``scheduler="continuous"``: a fixed set of ``num_slots`` lanes over one
  persistent cache, each lane holding a request at its own committed
  length.  Arrivals are prefilled one by one (exact prompt) and spliced
  into a free lane (``transformer.insert_slot``).  Every tick dispatches
  ONE superstep of up to ``sync_every`` blocks (``spec_superstep``) with
  EOS detection, budget capping and tuple logging on the device, and
  harvests the previous one with a single packed device-to-host copy: the
  host syncs with the device once per superstep.  ``step()`` admits into
  already-free lanes first (those ops queue behind the in-flight
  superstep), then harvests, retires finished lanes, grows pages and
  dispatches.  Admission, retirement, preemption and cancellation happen
  only at superstep boundaries, and the committed streams are those of
  per-block ticking.

Every stack the port runs serves on both schedulers: a hybrid of RG-LRU
blocks and sliding-window rings (recurrentgemma-9b) on the contiguous
continuous engine, a local/global MoE stack (llama4-scout) paged, its rings
and recurrent states per lane in either layout and only its full-attention
layers in the pool.  The prefix cache refuses any stack with a segment
other than full attention, as the reference does.

With ``kv_pages > 0`` the continuous scheduler runs over a paged KV pool
(``serving.kv_pool``): lanes hold block-table rows instead of worst-case
contiguous regions; admission checks the free-page watermark; before every
superstep each live lane is topped up to the pages that superstep can
touch; when the pool runs dry the newest other lane is preempted (its pages
return to the pool, its prompt plus generated prefix is re-queued at the
front and replayed through prefill on re-admission, which is lossless for
greedy decoding); retirement frees the lane's pages.

Both schedulers run their block-steps through a runner of
``core.graphs``, which owns static buffers for everything a block reads or
advances and, on the card with ``graphs=True`` (the default), replays one
captured CUDA graph a block-step: one graph a continuous engine, one per
(batch, prompt bucket) on the sync path.  ``warmup()`` captures them ahead
of the traffic; ``graphs=False`` runs the same block-step eagerly, as the
CPU always does.  The engine's pending tokens, cache and replay buffer are
the runner's static buffers: admission, retirement, preemption,
cancellation and page growth edit them in place and never replace them.

Host-to-device uploads (prompts, block-table rows, the per-dispatch done
mask and budgets) are staged through pinned host memory and copied with
``non_blocking=True``, so no dispatch blocks the host; PyTorch's pinned
memory cache keeps each staging buffer until its copy has run.  Every
device op runs on PyTorch's current stream, which orders the in-place lane
edits of a tick after the superstep still running.

The engine takes an ``OnlineTrainerState`` (``core.online``): the
drafter's A and B, its optimizer state, the replay buffer, the baseline and
the step.  With ``learn=True`` (the default, as in the reference) the
drafter learns while it serves:

* sync: ``updates_per_batch`` updates after each batch, in place;
* continuous: an update is dispatched at the end of a harvest once
  ``update_every`` blocks have run since the last and the buffer holds
  tuples.  It is not waited for: it writes the new A and B into staging
  tensors, and the next harvest folds them into the live ones (``copy_``),
  so the superstep dispatched right after an update still decodes with the
  old drafter, as the reference's does.  The update runs on the current
  stream, after the superstep whose tuples it samples and before the next
  one writes the ring, and adds no host sync: the buffer's count and the
  staged update metrics ride the harvest's one packed copy, and the
  metrics reach the ``dvi_train_*`` gauges one harvest after their fold.

Every write of an update is in place: the block-step graphs hold the
addresses of A, B and the ring, and each dispatch checks that A and B were
not rebound.

With ``adaptive_k=True`` (continuous scheduler only) each lane has its own
speculation depth, moved by the verifier's accept/reject stream:

* each lane carries the controller's state (depth, acceptance EMA,
  cooldown; ``core.schedule.DepthConfig``), which the controller updates
  on the device after every block of a superstep; the host mirrors it,
  uploads it at each dispatch, reads it back with the harvest's one packed
  copy and resets it to ``k_init`` at every admission, so a recycled lane
  never inherits a depth;
* every dispatch drafts ``K_blk`` = the largest depth ceiling over the live
  lanes and replays the runner's graph of that draft width, so a batch
  that throttles down runs shallower, cheaper blocks (at most
  ``k_max - k_min + 1`` graphs);
* page math splits by purpose (the adaptive-depth contract):
  reservations (admission, the pre-admission reserve, prompt trimming,
  the cache's capacity) assume ``k_max``; growth provisions each lane for
  its live depth plus the rises the controller can make in one superstep
  (``schedule.max_depth_rises``), and that bound goes back to the device
  as the lane's ceiling ``k_cap``, so a rise never outruns its pages.

Greedy streams do not depend on the depth, so the controller changes the
work done, never the tokens.

With ``prefill_chunk > 0`` (continuous scheduler only) prompt prefill is
chunked and scheduled, so a long prompt does not stall every live lane for
its whole prefill:

* admission prefills only the first chunk, into a chunk-sized scratch
  spliced into the reset lane (paged: pages for that chunk alone), and
  parks the lane done-masked: it rides supersteps with its SSM state,
  length and pending frozen;
* every tick, one batched chunk step (``Model.prefill_chunk`` through the
  runner's chunk step, one CUDA graph replay on the card) advances every
  prefilling lane by up to ``prefill_chunk`` tokens in the live cache, so
  a tick's prefill work is at most ``num_slots * prefill_chunk`` tokens;
  the lanes that finish get their pending token on the device and decode
  in the same tick's superstep;
* paged lanes take their pages chunk by chunk (oldest first; a starved
  prefill lane evicts only strictly newer lanes), and a mid-prefill lane
  is preempted and cancelled like a decoding one;
* greedy streams are those of one-shot prefill.

With ``prefix_cache=True`` (a paged pool, ``prefill_chunk > 0`` and a stack
of attention segments only) page-aligned prompt prefixes are shared by
content (``serving.kv_pool``'s refcounts, content index and LRU eviction):

* admission looks the prompt (less its pending token) up in the pool's
  index; a hit maps the cached pages into the lane's table row, copies a
  partly matched page on write into the lane's first own page
  (``transformer.copy_page``) and sets the lane's length to the cached
  tokens (``insert_slot(src=None, shared_len=warm)``): no prefill runs and
  no shared K/V moves.  The uncached tail rides the chunk step from
  position ``warm``; a fully cached prompt gets its pending token at once
  and decodes in the same tick;
* a lane's prompt prefix is published once its whole prompt is in the
  cache (after a one-shot cold admission, or its finishing chunk);
* retirement, cancellation and preemption free through the refcounts, so
  shared and published pages stay cached, evictable oldest first;
* every write (the copy, the table row, the length, the pending token)
  is in place: the graphs hold their addresses.

``submit`` (deprecated), ``abort_pending``, ``write_trace`` and
``slot_acceptance`` complete the reference's engine surface;
``profile_dir`` opens a ``torch.profiler`` window over the first
``profile_steps`` dispatches and writes its Chrome trace there.
"""
from __future__ import annotations

import os
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import graphs as graphs_mod
from repro_torch.core import online as online_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serving.handles import QueueFull, RequestHandle, TenantQueue
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.telemetry import ServingTelemetry


# an update's metrics as the engine stages them: one float32 vector in this
# order, which rides the harvest's packed copy to the host
TRAIN_KEYS = ("loss", "kl", "l_pg", "pg_on", "lam_pg", "lam_kl", "beta", "acc_rate",
              "baseline_before", "baseline_after", "buffer_count", "gnorm")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (Tp,) int32
    max_new: int = 64
    tenant: str = "default"       # weighted-fair queue bucket
    priority: int = 0             # within-tenant ordering (higher first)


@dataclass
class Completion:
    uid: int
    tokens: np.ndarray            # full stream (prompt + generated)
    gen_tokens: np.ndarray        # generated tokens only
    mat: float                    # mean accepted tokens per block
    wall_s: float                 # engine time attributed to this request
    latency_s: float = 0.0        # submit -> completion


@dataclass
class _Slot:
    """Host-side bookkeeping for one live lane of the decode batch."""
    uid: int
    prompt: np.ndarray
    max_new: int
    gen: List[int] = field(default_factory=list)
    blocks: int = 0
    wall_s: float = 0.0
    cache_len: int = 0            # committed cache length (paged growth)
    admit_seq: int = 0            # admission order (paged preemption picks max)
    pf_prompt: Optional[np.ndarray] = None  # trimmed replay source (chunked)
    pf_pos: Optional[int] = None  # prompt tokens prefilled; None = decoding
    handle: Optional[RequestHandle] = None


@dataclass
class ServingEngine:
    model: Model
    params: dict
    state: online_mod.OnlineTrainerState
    scheduler: str = "sync"       # "sync" | "continuous"
    num_slots: int = 8            # continuous: lanes in the decode batch
    batch_size: int = 8           # sync: requests per batch
    max_new: int = 64             # default / cap for generation length
    buckets: tuple = (16, 32, 64, 128)
    updates_per_batch: int = 1    # sync: drafter updates after each batch
    update_every: int = 4         # continuous: blocks between drafter updates
    sync_every: int = 1           # continuous: blocks fused per device sync
    latency_window: int = 4096    # rolling window of completion latencies
    learn: bool = True
    lr: float = 1e-3
    mode: str = "full"            # the loss: "full" (KL->RL) | "kl" | "pg" | "ce"
    eos_id: int = 1               # continuous path (the sync path stops at 1)
    cache_len: int = 0            # continuous cache capacity (0 = derive)
    kv_pages: int = 0             # >0: paged KV pool with this many pages
    kv_page_size: int = 16        # tokens per page (paged mode)
    kv_watermark: int = 0         # pages kept free at admission (paged mode)
    prefix_cache: bool = False    # paged: share page-aligned prompt prefixes
    prefill_chunk: int = 0        # >0: prefill in chunks of this many tokens (continuous)
    adaptive_k: bool = False      # per-lane acceptance-driven depth (continuous)
    k_min: int = 1                # adaptive: depth floor
    k_max: int = 0                # adaptive: depth ceiling (0 = cfg.dvi.k_spec)
    depth_cfg: Optional[schedule_mod.DepthConfig] = None   # adaptive: full override
    clock: Callable[[], float] = time.monotonic
    telemetry: bool = False       # lifecycle tracer on (metrics always on)
    trace_limit: int = 200_000
    profile_dir: Optional[str] = None  # torch.profiler trace directory (optional)
    profile_steps: int = 32       # dispatches inside the profiler window
    max_queue: int = 0            # admission queue bound (0 = unbounded)
    tenant_weights: Optional[Dict[str, float]] = None
    graphs: bool = True           # replay a CUDA graph a block-step on the card
    stats: object = field(default=None, init=False)

    def __post_init__(self):
        cfg = self.model.cfg
        K = cfg.dvi.k_spec
        if self.scheduler not in ("sync", "continuous"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if not isinstance(self.state, online_mod.OnlineTrainerState):
            raise TypeError("the third argument is the drafter's OnlineTrainerState "
                            "(core.online.init_trainer)")
        if self.prefill_chunk and self.scheduler != "continuous":
            raise ValueError("chunked prefill requires scheduler='continuous'")
        # a chunk step writes eager K/V past every lane's length (rolled back
        # by length masking, like rejected speculative tokens), so the chunk
        # is clamped to the slack the caches keep for such writes
        self._chunk = min(max(0, int(self.prefill_chunk)), tfm.RING_SLACK)
        # adaptive depth: the controller, and the worst-case depth that every
        # reservation (cache capacity, prompt trimming, admission, the
        # pre-admission reserve) assumes; growth uses the live depth
        # (_lane_growth_k)
        if self.adaptive_k and self.scheduler != "continuous":
            raise ValueError("adaptive_k requires scheduler='continuous'")
        self._depth: Optional[schedule_mod.DepthConfig] = None
        if self.adaptive_k:
            kmax = self.k_max or K
            self._depth = self.depth_cfg or schedule_mod.DepthConfig(
                k_min=self.k_min, k_max=kmax, k_init=min(max(K, self.k_min), kmax))
        self._k_worst = K if self._depth is None else self._depth.k_max
        self._cap = self.cache_len or (max(self.buckets) + self.max_new + self._k_worst + 2
                                       + tfm.RING_SLACK)
        self.sync_every = max(1, int(self.sync_every))
        # the Improve loop: the update and its generator; the continuous
        # path's staging tensors for A and B, made on first use
        self._update_fn = online_mod.make_update_fn(self.model, self.mode, self.lr)
        self._gen = torch.Generator(device=self.model.device).manual_seed(1234)
        self._staging: Optional[dict] = None
        self._blocks_since_update = 0
        # (metrics vector, dispatch time, step) of an update not yet folded
        self._update_inflight: Optional[tuple] = None
        # host mirror of the optimizer step (drives the schedule gauges
        # without touching the device) and a bounded per-update history
        self._step_host = int(self.state.step)
        self.train_history: deque = deque(maxlen=1024)
        self._train_staged = None      # (metrics vector, t_disp, t_fold, step)

        # sync state: prompt-length buckets
        self._queue: Dict[int, List[Request]] = {}
        # continuous state: one persistent cache, host-side slot table
        self._slots: List[Optional[_Slot]] = [None] * self.num_slots
        self._done = np.ones((self.num_slots,), bool)
        self._pending = torch.zeros((self.num_slots,), dtype=torch.int32,
                                    device=self.model.device)
        self._cache: Optional[dict] = None
        # per-lane lifetime counters (adaptive_stats) and the host mirror of
        # the depth controller's state: uploaded at dispatch, read back at
        # the harvest, reset at admission; pinned at k_spec without a
        # controller
        n = self.num_slots
        self._slot_accepted, self._slot_drafted, self._slot_committed, self._slot_blocks = (
            np.zeros((n,), np.int64) for _ in range(4))
        d = self._depth
        self._k_host = np.full((n,), K if d is None else d.k_init, np.int32)
        self._ema_host = np.full((n,), 0.0 if d is None else d.ema_init, np.float32)
        self._cool_host = np.zeros((n,), np.int32)
        # the block-step runner (core.graphs), made on first use or warmup()
        self._runner = None
        self._submit_t: Dict[int, float] = {}
        self._tq = TenantQueue(max_queue=self.max_queue, weights=self.tenant_weights)
        self._handles: Dict[int, RequestHandle] = {}
        # metrics registry (and the legacy `stats` facade over it) always on;
        # the lifecycle tracer only with telemetry=True
        self.telem = ServingTelemetry(
            num_slots=self.num_slots, k_max=self._k_worst,
            latency_window=self.latency_window, clock=self.clock,
            trace=self.telemetry, trace_limit=self.trace_limit)
        self.stats = self.telem.stats
        # (SuperstepResult, engine-clock mark, occupied lanes, dispatch time)
        self._inflight: Optional[tuple] = None
        # engine-resident clock: time spent inside _step_continuous; per-request
        # wall_s is attributed from it, so caller time is never billed
        self._clock = 0.0
        self._tick_t0: Optional[float] = None

        self.paged = self.kv_pages > 0
        self._pool: Optional[KVPool] = None
        self._admit_seq = 0
        self._preempted: Dict[int, tuple] = {}   # uid -> (prompt, gen, blocks, wall, seq)
        if self.paged:
            if self.scheduler != "continuous":
                raise ValueError("paged KV requires scheduler='continuous'")
            if cfg.mla is not None:      # the reference fails at its first admission
                raise NotImplementedError("paged KV: MLA latent caches not supported "
                                          "(serve an MLA model with kv_pages=0)")
            self._pool = KVPool(self.kv_pages, self.kv_page_size)
            self._mps = self._pool.pages_for(self._cap)      # block-table width
            # host mirror of cache["tbl"]: a tick's row updates go to the
            # device in ONE push (set_block_tables)
            self._tbl_host = np.full((self.num_slots, self._mps), -1, np.int32)
            if self.kv_pages - self.kv_watermark < self._mps:
                raise ValueError(
                    f"kv_pages={self.kv_pages} minus watermark={self.kv_watermark} "
                    f"cannot hold one worst-case request ({self._mps} pages of "
                    f"{self.kv_page_size}): admission would livelock")
        # the prefix cache shares pages (the paged pool), prefills uncached
        # tails at an offset inside the live cache (the chunk step: a
        # scratch prefill encodes positions from 0) and needs every segment
        # to be attention (SSM and RG-LRU states and rings are per lane, not
        # shareable by content)
        if self.prefix_cache:
            if not self.paged:
                raise ValueError("prefix_cache requires a paged KV pool (kv_pages > 0)")
            if self._chunk <= 0:
                raise ValueError("prefix_cache requires prefill_chunk > 0: uncached "
                                 "prompt tails ride the chunked-prefill path")
            bad = [s.kind for s in tfm.model_segments(cfg) if s.kind != "attn"]
            if bad:
                raise ValueError(f"prefix_cache requires a pure full-attention stack; "
                                 f"got segment kinds {bad}")
        self._evict_seen = 0          # the pool's evictions folded into the stats
        self._profile = None          # the open torch.profiler window
        self._profile_left = 0

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit_request(self, req: Request) -> RequestHandle:
        """Accept `req` into the admission queue and return its handle
        (``deltas()`` streams tokens at superstep boundaries, ``result()``
        blocks for the Completion, ``cancel()`` asks for retirement at the
        next boundary).  A bounded queue (``max_queue``) that is full
        rejects: the handle finishes "rejected" and ``QueueFull`` is raised
        carrying it as ``exc.handle``."""
        now = self.clock()
        h = RequestHandle(req.uid, req.tenant, int(req.priority), clock=self.clock)
        h.t_submit = now
        self.stats["submitted"] += 1
        self.telem.c_tenant.inc(h.tenant)
        if self.scheduler == "continuous":
            try:
                self._tq.push(req)
            except QueueFull as e:
                self.stats["rejected"] += 1
                h.finish(None, "rejected", t_done=now)
                e.handle = h
                raise
        else:
            self._queue.setdefault(self._bucket(len(req.prompt)), []).append(req)
        self._handles[req.uid] = h
        self._submit_t[req.uid] = now
        tr = self.telem.tracer
        if tr is not None and self.scheduler == "continuous":
            tr.async_begin("request", req.uid, now,
                           args={"prompt_len": int(len(req.prompt)),
                                 "max_new": int(req.max_new), "tenant": h.tenant})
            tr.async_begin("queued", req.uid, now)
        if self.scheduler == "continuous":
            self.telem.g_queue.set(len(self._tq))
        return h

    def submit(self, req: Request) -> RequestHandle:
        """Deprecated submission, the surface before handles: a thin shim
        over ``submit_request`` with the same committed stream."""
        warnings.warn(
            "ServingEngine.submit(Request) is deprecated; use "
            "submit_request(Request) -> RequestHandle (deltas/result/"
            "cancel)", DeprecationWarning, stacklevel=2)
        return self.submit_request(req)

    def _pad(self, req: Request, bucket: int) -> np.ndarray:
        p = req.prompt[-bucket:]
        if len(p) < bucket:                      # left-pad by repeating BOS
            p = np.concatenate([np.full(bucket - len(p), p[0], p.dtype), p])
        return p

    @property
    def buf(self) -> dict:
        """The replay buffer (the trainer state's)."""
        return self.state.buf

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the model's device without blocking the host:
        copied into pinned memory, then to the card with non_blocking=True.
        The copy is a snapshot, so the host array may change right away."""
        t = torch.from_numpy(np.array(arr))
        dev = self.model.device
        if dev.type != "cuda":
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)

    # ------------------------------------------------------------------
    # completion, handles, cancellation (boundary-only)
    # ------------------------------------------------------------------

    def _complete(self, uid: int, tokens: np.ndarray, gen_tokens: np.ndarray,
                  mat: float, wall_s: float) -> Completion:
        now = self.clock()
        lat = now - self._submit_t.pop(uid, now)
        self.stats["latencies"].append(lat)
        self.telem.h_latency.observe(lat)
        tr = self.telem.tracer
        if tr is not None and self.scheduler == "continuous":
            tr.async_end("decode", uid, now, args={"gen_tokens": int(len(gen_tokens))})
            tr.async_end("request", uid, now, args={"latency_s": lat, "mat": mat})
        return Completion(uid=uid, tokens=tokens, gen_tokens=gen_tokens, mat=mat,
                          wall_s=wall_s, latency_s=lat)

    def _finish_handle(self, uid: int, comp: Completion) -> None:
        """Terminal handle transition: deliver the final tokens, observe TTFT
        on a first delivery, wake every waiter."""
        h = self._handles.pop(uid, None)
        if h is None:
            return
        if len(comp.gen_tokens):
            first = h.t_first_token is None
            h.feed(comp.gen_tokens)
            if first and h.t_first_token is not None:
                self.telem.h_ttft.observe(h.t_first_token - h.t_submit)
        h.finish(comp, "completed")

    def _finish_cancelled_queued(self, uid: int) -> None:
        """Cancel honoured while the request sat in the queue (or waited as
        a preemption replay): no lane, no pages, pure bookkeeping."""
        orig_prompt, gen0, blocks0, wall0, _ = self._preempted.pop(
            uid, (None, [], 0, 0.0, None))
        self._submit_t.pop(uid, None)
        self.stats["cancelled"] += 1
        now = self.clock()
        tr = self.telem.tracer
        if tr is not None and self.scheduler == "continuous":
            tr.async_end("queued", uid, now, args={"cancelled": True})
            tr.async_end("request", uid, now, args={"cancelled": True})
        h = self._handles.pop(uid, None)
        if h is not None:
            gen = np.asarray(gen0, np.int32)
            prompt = (np.asarray(orig_prompt, np.int32) if orig_prompt is not None
                      else np.zeros(0, np.int32))
            h.finish(Completion(uid=uid, tokens=np.concatenate([prompt, gen]),
                                gen_tokens=gen, mat=len(gen0) / max(blocks0, 1),
                                wall_s=wall0), "cancelled", t_done=now)

    def _cancel_lane(self, s: int) -> None:
        """Retire live lane `s` (decoding or mid-prefill) on a cancel request,
        at a superstep boundary only (no superstep in flight): free its
        pages, unmap its row, reset the lane, and finish the handle with the
        committed-so-far stream.
        Adds no host sync."""
        st = self._slots[s]
        uid, mid_prefill = st.uid, st.pf_pos is not None
        if self.paged:
            self._pool.free(uid)
            self._tbl_host[s] = -1
        tfm.reset_slot(self.model.cfg, self._cache, s)
        self._slots[s] = None
        self._done[s] = True
        self._preempted.pop(uid, None)
        self._submit_t.pop(uid, None)
        self.stats["cancelled"] += 1
        now = self.clock()
        tr = self.telem.tracer
        if tr is not None:
            tr.instant(s, "cancel", now, args={"uid": uid, "gen_len": len(st.gen),
                                               "mid_prefill": mid_prefill})
            tr.async_end("prefill" if mid_prefill else "decode", uid, now,
                         args={"cancelled": True})
            tr.async_end("request", uid, now, args={"cancelled": True})
        h = self._handles.pop(uid, None)
        if h is not None:
            gen = np.asarray(st.gen, np.int32)
            h.finish(Completion(uid=uid, tokens=np.concatenate([st.prompt, gen]),
                                gen_tokens=gen, mat=len(st.gen) / max(st.blocks, 1),
                                wall_s=st.wall_s), "cancelled", t_done=now)

    def _sweep_cancels(self) -> None:
        """Honour pending ``handle.cancel()`` flags right after the harvest,
        the one point of a tick with no superstep in flight.  Queued
        requests leave the tenant queue; live lanes are retired in place.
        Other lanes keep their state, so their streams are unchanged."""
        want = [uid for uid, h in self._handles.items()
                if h.cancel_requested and not h.finished]
        if not want:
            return
        in_slot = {st.uid: s for s, st in enumerate(self._slots) if st is not None}
        queued = set(want) - set(in_slot)
        if queued:
            for req in self._tq.drop(queued):
                self._finish_cancelled_queued(req.uid)
        for uid in want:
            s = in_slot.get(uid)
            if s is not None:
                self._cancel_lane(s)

    def abort_pending(self, reason: str) -> None:
        """Fail every unfinished handle (the engine's thread died, or a
        stop without drain): every blocked consumer wakes with outcome
        "error".  The engine's device state is not touched."""
        for h in list(self._handles.values()):
            h.abort(reason)
        self._handles.clear()

    # ------------------------------------------------------------------
    # drafter updates (the Improve loop)
    # ------------------------------------------------------------------

    @staticmethod
    def _pack(metrics: dict) -> torch.Tensor:
        return torch.stack([metrics[k].to(torch.float32) for k in TRAIN_KEYS])

    def _drafter_update(self, n: int) -> None:
        """Sync path: `n` updates after a batch, written into the live A and
        B in place.  The metrics stay on the device; ``train_telemetry()``
        materialises the last one off the hot path."""
        for _ in range(n):
            t_disp = self.clock()
            step_u = self._step_host
            m = self._update_fn(self.params, self.state, self._gen)
            self.stats["updates"] += 1
            self._note_update_dispatched()
            self._train_staged = (self._pack(m), t_disp, self.clock(), step_u)

    def _dispatch_update(self, buf_count: int) -> None:
        """Continuous path: dispatch one update without waiting for it.  The
        new A and B go to the staging tensors; the next harvest folds them
        in.  The optimizer's moments, the baseline and the step advance in
        place now: nothing reads them before the fold."""
        if self._staging is None:
            self._staging = {k: torch.empty_like(t) for k, t in self.state.dvi_params.items()}
        t_disp = self.clock()
        step_u = self._step_host
        m = self._update_fn(self.params, self.state, self._gen, out=self._staging)
        self._update_inflight = (self._pack(m), t_disp, step_u)
        self.stats["updates"] += 1
        self._note_update_dispatched()
        self.telem.g_buffer.set(buf_count)
        tr = self.telem.tracer
        if tr is not None:
            tr.instant(self.telem.tid_train, "update_dispatch", t_disp,
                       args={"step": step_u, "buffer": buf_count}, cat="train")

    def _fold_update(self):
        """Fold a dispatched update's A and B into the live tensors (queued
        behind the superstep that decoded with the old ones).  Returns its
        note (metrics vector, dispatch time, fold time, step), or None."""
        if self._update_inflight is None:
            return None
        m_vec, t_disp, step_u = self._update_inflight
        self._update_inflight = None
        for k, t in self.state.dvi_params.items():
            t.copy_(self._staging[k])
        t_fold = self.clock()
        # dispatch -> fold: how long the engine decoded on the old drafter
        self.telem.h_update_span.observe(t_fold - t_disp)
        tr = self.telem.tracer
        if tr is not None:
            tr.span(self.telem.tid_train, f"drafter_update t{step_u}", t_disp, t_fold,
                    args={"step": step_u}, cat="train")
        return m_vec, t_disp, t_fold, step_u

    def _note_update_dispatched(self) -> None:
        """Advance the host step mirror and the schedule gauges: host math
        (``schedule.phase_info``), no device touch."""
        self._step_host += 1
        ph = schedule_mod.phase_info(self._step_host, self.model.cfg.dvi)
        t = self.telem
        t.g_step.set(self._step_host)
        t.g_phase.set(ph["phase"])
        t.g_lambda_pg.set(ph["lambda_pg"])
        t.g_lambda_kl.set(ph["lambda_kl"])
        t.g_beta.set(ph["beta"])

    def _fold_train_metrics(self, m: dict, t_disp: float, t_fold: float,
                            step_u: int) -> None:
        """Publish one update's metrics (host floats) into the
        ``dvi_train_*`` gauges and the bounded history."""
        t = self.telem
        t.g_loss.set(m["loss"])
        t.g_loss_kl.set(m["kl"])
        t.g_loss_ce.set(m["l_pg"])       # reward-masked CE component
        t.g_loss_pg.set(m["pg_on"])      # on-policy policy-gradient term
        t.g_lambda_pg.set(m["lam_pg"])
        t.g_lambda_kl.set(m["lam_kl"])
        t.g_beta.set(m["beta"])
        t.g_acc_batch.set(m["acc_rate"])
        t.g_ema_before.set(m["baseline_before"])
        t.g_ema_after.set(m["baseline_after"])
        t.g_buffer.set(m["buffer_count"])
        t.g_gnorm.set(m["gnorm"])
        self.train_history.append({
            "step": step_u,
            "phase": schedule_mod.phase_info(step_u, self.model.cfg.dvi)["phase"],
            "loss": m["loss"], "loss_kl": m["kl"], "loss_ce": m["l_pg"],
            "loss_pg": m["pg_on"], "acceptance_batch": m["acc_rate"],
            "ema_before": m["baseline_before"], "ema_after": m["baseline_after"],
            "buffer_count": m["buffer_count"], "span_s": t_fold - t_disp})

    def train_telemetry(self) -> dict:
        """The training loop's telemetry: schedule phase, the loss
        components, the acceptance EMA around updates and the bounded
        per-update ``history``.  Materialises a still-staged update's
        metrics, which synchronises: call it off the serving hot path."""
        if self._train_staged is not None:
            m_vec, t_disp, t_fold, step_u = self._train_staged
            self._train_staged = None
            self._fold_train_metrics(dict(zip(TRAIN_KEYS, m_vec.cpu().tolist())),
                                     t_disp, t_fold, step_u)
        t = self.telem
        ph = schedule_mod.phase_info(self._step_host, self.model.cfg.dvi)
        return {
            "updates": int(self.stats["updates"]),
            "step": self._step_host,
            "phase": ph["phase"], "phase_name": ph["phase_name"],
            "lambda_pg": ph["lambda_pg"], "lambda_kl": ph["lambda_kl"],
            "beta": ph["beta"],
            "loss": t.g_loss.value, "loss_kl": t.g_loss_kl.value,
            "loss_ce": t.g_loss_ce.value, "loss_pg": t.g_loss_pg.value,
            "acceptance_batch": t.g_acc_batch.value,
            "acceptance_ema_before": t.g_ema_before.value,
            "acceptance_ema_after": t.g_ema_after.value,
            "buffer_count": t.g_buffer.value,
            "history": list(self.train_history),
        }

    # ------------------------------------------------------------------
    # the sync scheduler
    # ------------------------------------------------------------------

    def _step_sync(self) -> List[Completion]:
        """Serve one batch from the fullest bucket."""
        for b, lst in list(self._queue.items()):   # cancels leave at batch formation
            keep = []
            for r in lst:
                hc = self._handles.get(r.uid)
                if hc is not None and hc.cancel_requested:
                    self._finish_cancelled_queued(r.uid)
                else:
                    keep.append(r)
            self._queue[b] = keep
        if not any(self._queue.values()):
            return []
        bucket = max(self._queue, key=lambda b: len(self._queue[b]))
        reqs = self._queue[bucket][:self.batch_size]
        self._queue[bucket] = self._queue[bucket][self.batch_size:]
        n_real = len(reqs)
        while len(reqs) < self.batch_size:       # pad batch with replays
            reqs.append(reqs[-1])
        dev = self.model.device
        live = torch.arange(self.batch_size, device=dev) < n_real
        prompts = torch.as_tensor(np.stack([self._pad(r, bucket) for r in reqs]),
                                  dtype=torch.int32, device=dev)

        t0 = self.clock()
        runner = self._ensure_runner()
        graphs_mod.check_ptrs(self.state.dvi_params, runner.drafter)
        res = runner.generate(prompts, live)
        # copies: the result is the runner's static buffers, which the next
        # batch of this shape overwrites (on the CPU .cpu() would alias them)
        toks = res.tokens.cpu().numpy().copy()
        lens = res.lengths.cpu().numpy().copy()
        wall = self.clock() - t0

        blocks, committed = int(res.blocks), int(res.committed)
        mat = committed / max(blocks, 1)
        self.stats["requests"] += n_real
        self.stats["blocks"] += blocks
        self.stats["steps"] += res.steps
        self.stats["committed"] += committed
        self.stats["accepted"] += int(res.accepted_drafts)
        self.stats["drafted"] += int(res.drafted)
        if self.learn:                   # in place: the next batch drafts with it
            self._drafter_update(self.updates_per_batch)

        outs = []
        for i, r in enumerate(reqs[:n_real]):
            # the batch decodes to the engine-wide max_new (head-of-line cost
            # of sync scheduling) but the client only gets what it asked for
            gen = toks[i, bucket:lens[i]][:min(r.max_new, self.max_new)]
            comp = self._complete(r.uid, np.concatenate([toks[i, :bucket], gen]), gen,
                                  mat, wall / n_real)
            outs.append(comp)
            self._finish_handle(r.uid, comp)
        return outs

    # ------------------------------------------------------------------
    # the continuous scheduler
    # ------------------------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def _trim_prompt(self, req: Request, remaining_new: int) -> np.ndarray:
        """`remaining_new`: generation budget still outstanding (max_new, less
        the tokens a preempted replay already carries in its prompt)."""
        prompt = np.asarray(req.prompt, np.int32)
        if len(prompt) < 2:                  # need prefill + pending
            prompt = np.concatenate([np.full(2 - len(prompt), prompt[0], np.int32),
                                     prompt])
        # oversized prompts keep their suffix rather than crash the loop
        limit = self._cap - remaining_new - self._k_worst - 2
        if len(prompt) > limit:
            prompt = prompt[-limit:]
        return prompt

    def _superstep_horizon(self, remaining: int, k: Optional[int] = None) -> int:
        """Cache slots one superstep can touch beyond a lane's committed
        length: ``sync_every`` blocks of K+1 eager tokens, capped by the
        lane's remaining budget (r more blocks advance the cache at most
        r + K slots).  Shared by admission sizing and page growth.  `k`:
        the depth to assume, by default the worst case (``k_max`` with a
        controller), which every reservation uses; growth passes the lane's
        live bound (``_lane_growth_k``)."""
        K = self._k_worst if k is None else k
        return min(self.sync_every * (K + 1), remaining + K)

    def _pages_needed(self, cache_len: int, remaining: int, k: Optional[int] = None) -> int:
        """Pages covering `cache_len` committed slots plus one superstep
        horizon at depth `k` (+1 slack slot)."""
        return self._pool.pages_for(cache_len + self._superstep_horizon(remaining, k) + 1)

    def _lane_growth_k(self, s: int) -> int:
        """The depth lane `s` is provisioned for over its NEXT superstep: its
        live depth plus the rises the controller can make within
        ``sync_every`` blocks.  The same bound goes to the device as the
        lane's ceiling ``k_cap``, so a rise never outruns its pages."""
        if self._depth is None:
            return self.model.cfg.dvi.k_spec
        rises = schedule_mod.max_depth_rises(self._depth, self.sync_every,
                                             int(self._cool_host[s]))
        return min(self._depth.k_max, int(self._k_host[s]) + rises)

    def _growth_reserve(self) -> int:
        """Pages live lanes may still need for their NEXT growth pass,
        assuming the in-flight superstep commits its full horizon.
        Pre-admission keeps them free, so a new request never takes pages
        that older lanes would claw back by preempting it."""
        reserve = 0
        for st in self._slots:
            if st is None or st.pf_pos is not None:   # mid-prefill: counted by
                continue                              # _prefill_reserve
            remaining = st.max_new - len(st.gen)
            if remaining <= 0:
                continue
            inflight_cap = st.cache_len + self._superstep_horizon(remaining)
            need = self._pages_needed(inflight_cap, remaining)
            reserve += max(0, need - len(self._pool.owned(st.uid)))
        return reserve + self._prefill_reserve()

    def _first_chunk(self, prompt: np.ndarray) -> int:
        """Prompt tokens prefilled at admission: the whole prompt less the
        pending token when one-shot or when it fits one chunk, else one
        chunk, the rest advanced tick by tick."""
        n = len(prompt) - 1
        return min(self._chunk, n) if self._chunk else n

    def _prefill_extent(self, st: _Slot) -> tuple:
        """(take, finishing, cache extent) of lane `st`'s next chunk.  A
        finishing chunk also provisions the first superstep's horizon: the
        lane decodes this tick on that provisioning alone, as after a
        one-shot admission."""
        rest = len(st.pf_prompt) - 1 - st.pf_pos
        take = min(self._chunk, rest)
        extent = st.pf_pos + take
        finishing = take == rest
        if finishing:
            extent += self._superstep_horizon(st.max_new - len(st.gen)) + 1
        return take, finishing, extent

    def _prefill_reserve(self) -> int:
        """Pages mid-prefill lanes claim for their next chunk (with the
        finishing chunk's horizon).  Both admissions of a tick keep them
        free: ``_advance_prefill`` takes them right after the second, and a
        request admitted into them would be preempted by a senior prefill
        lane the same tick."""
        reserve = 0
        for st in self._slots:
            if st is None or st.pf_pos is None:
                continue
            _, _, extent = self._prefill_extent(st)
            need = self._pool.pages_for(extent)
            reserve += max(0, need - len(self._pool.owned(st.uid)))
        return reserve

    def _admit_waiting(self, reserve: int = 0) -> None:
        """Prefill-on-arrival: splice queued requests into free lanes.  Paged
        mode gates admission on the free-page watermark: the pool must cover
        the prompt plus the lane's first superstep.  `reserve`: pages kept
        free on top of the watermark.  With chunked prefill a prompt longer
        than one chunk is prefilled only up to its first chunk (into a
        chunk-sized scratch; paged: pages for that chunk alone) and its lane
        stays done-masked until ``_advance_prefill`` finishes it."""
        cfg = self.model.cfg
        tr = self.telem.tracer
        while self._tq and not all(s is not None for s in self._slots):
            t_a0 = self.clock()
            slot = next(i for i, s in enumerate(self._slots) if s is None)
            req = self._tq.peek()
            if req is None:
                break
            hq = self._handles.get(req.uid)
            if hq is not None and hq.cancel_requested:
                self._tq.take(req)               # cancelled while queued
                self._finish_cancelled_queued(req.uid)
                continue
            max_new = min(req.max_new, self.max_new)
            gen_carry = len(self._preempted.get(req.uid, (None, ()))[1])
            prompt = self._trim_prompt(req, max_new - gen_carry)
            c1 = self._first_chunk(prompt)
            chunked = c1 < len(prompt) - 1   # the rest advances tick by tick
            self._ensure_runner()
            hit = None
            if self.prefix_cache:
                # the longest cached prefix of the prompt (its pending token
                # is never cached), counted a lookup: an admission the
                # watermark holds back and retries next tick counts again
                hit = self._pool.acquire_prefix(req.uid, prompt[:-1])
                self.stats["prefix_lookups"] += 1
                if hit.hit_tokens > 0:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += hit.hit_tokens
                else:
                    self.stats["prefix_misses"] += 1
            if hit is not None and hit.hit_tokens > 0:
                # warm admission: the cached tokens are resident (shared full
                # pages and a partial page copied on write); the tail rides
                # the chunk step from position `warm`
                warm = hit.hit_tokens
                tail = len(prompt) - 1 - warm
                need = (self._pool.pages_for(warm + min(self._chunk, tail)) if tail > 0
                        else self._pages_needed(len(prompt) - 1, max_new - gen_carry))
                if not self._pool.can_alloc(need - len(hit.pages),
                                            self.kv_watermark + reserve):
                    if hit.pages:            # give the shared pages back
                        self._pool.free(req.uid)
                    self._watermark_wait(req.uid, need, reserve)
                    break
                self._tq.take(req)
                self._admit_warm(slot, req.uid, prompt, hit, need, live=tail == 0)
                c1, chunked = warm, tail > 0
            else:
                if self.paged:
                    # a mid-prefill lane holds pages for what it has cached;
                    # the rest comes chunk by chunk (_advance_prefill)
                    need = (self._pool.pages_for(c1) if chunked
                            else self._pages_needed(c1, max_new - gen_carry))
                    if not self._pool.can_alloc(need, self.kv_watermark + reserve):
                        self._watermark_wait(req.uid, need, reserve)
                        break
                    self._tq.take(req)
                    pages = self._pool.alloc(need, owner=req.uid)
                    row = np.full(self._mps, -1, np.int32)
                    row[:len(pages)] = pages
                    self._tbl_host[slot] = row
                    tfm.map_slot_pages(self._cache, slot, self._to_device(row))
                    # prompt-sized scratch: the splice through the table lands it
                    max_len = c1
                else:
                    self._tq.take(req)
                    max_len = c1 if chunked else self._cap   # chunked: chunk-sized scratch
                # prompt[:c1] prefilled; prompt[c1] is the pending token (a
                # placeholder when chunked: the finishing chunk step sets it)
                tokens = self._to_device(prompt[:c1 + 1])
                _, pc = self.model.prefill(self.params, tokens[None, :-1], max_len=max_len)
                tfm.insert_slot(cfg, self._cache, pc, slot)
                self._pending[slot] = tokens[-1]
                # a one-shot cold admission cached the whole prompt prefix:
                # publish it for the next request that shares it
                if self.prefix_cache and not chunked:
                    self._pool.publish_prefix(req.uid, prompt[:-1])
            orig_prompt, gen0, blocks0, wall0, seq0 = self._preempted.pop(
                req.uid, (prompt, [], 0, 0.0, None))
            if seq0 is None:             # fresh request; replays keep their
                self._admit_seq += 1     # original admission seniority
                seq0 = self._admit_seq
            self._slots[slot] = _Slot(uid=req.uid, prompt=orig_prompt, max_new=max_new,
                                      gen=list(gen0), blocks=blocks0, wall_s=wall0,
                                      cache_len=c1, admit_seq=seq0,
                                      pf_prompt=prompt if chunked else None,
                                      pf_pos=c1 if chunked else None, handle=hq)
            # a fresh controller state: a recycled lane must not inherit the
            # previous request's depth, nor a replay its pre-preemption EMA
            if self._depth is not None:
                self._k_host[slot] = self._depth.k_init
                self._ema_host[slot] = self._depth.ema_init
                self._cool_host[slot] = 0
            t_adm = self.clock()
            if hq is not None:
                if hq.t_admit is None:   # first admission only: a replay keeps
                    hq.t_admit = t_adm   # its original wait
                    self.telem.h_queue_wait.observe(t_adm - hq.t_submit)
                if not chunked and hq.t_prefill_done is None:
                    hq.t_prefill_done = t_adm
            # a mid-prefill lane rides supersteps done-masked until its
            # finishing chunk makes it live
            self._done[slot] = chunked
            if tr is not None:
                now = self.clock()
                tr.span(slot, f"admit u{req.uid}", t_a0, now,
                        args={"uid": req.uid, "chunked": chunked, "prefilled": c1})
                tr.async_end("queued", req.uid, now)
                tr.async_begin("prefill", req.uid, now, args={"slot": slot, "chunked": chunked})
                if not chunked:          # one-shot: the lane decodes from this tick
                    tr.async_end("prefill", req.uid, now)
                    tr.async_begin("decode", req.uid, now, args={"slot": slot})

    def _watermark_wait(self, uid: int, need: int, reserve: int) -> None:
        """An admission held back at the head of the queue: the pool cannot
        grant its pages above the watermark and the reserve."""
        self.telem.c_watermark.inc()
        tr = self.telem.tracer
        if tr is not None:
            tr.instant(self.telem.tid_engine, "pool_watermark",
                       args={"uid": uid, "need": need, "free": self._pool.available_pages,
                             "reserve": reserve})

    def _admit_warm(self, slot: int, uid: int, prompt: np.ndarray, hit, need: int,
                    live: bool) -> None:
        """Splice a prefix-cache hit into lane `slot`, in place and without a
        prefill: fresh pages up to `need`, the partly matched page copied on
        write into the first of them, the table row (cached pages first)
        mapped, and the lane's length set to the cached tokens.  `live` (a
        fully cached prompt): the pending token is written now, the lane
        decodes this tick, and its prefix is published (idempotent: pages
        already indexed are skipped)."""
        fresh = self._pool.ensure(uid, need) or []
        if hit.cow_tokens:
            tfm.copy_page(self._cache, hit.cow_page, fresh[0])
            self.stats["prefix_cow_copies"] += 1
        self._sync_row(slot, uid)
        tfm.map_slot_pages(self._cache, slot, self._to_device(self._tbl_host[slot]))
        tfm.insert_slot(self.model.cfg, self._cache, None, slot, shared_len=hit.hit_tokens)
        if live:
            graphs_mod.upload(self._pending[slot:slot + 1], prompt[-1:])
            self._pool.publish_prefix(uid, prompt[:-1])

    def _preempt(self, slot: int) -> None:
        """Evict lane `slot` mid-decode or mid-prefill: free its pages, unmap
        its row, and re-queue its progress (prompt + generated prefix) at the
        FRONT of the queue.  Re-admission replays the prefix through prefill, so
        greedy decoding continues where it stopped.  The victim keeps its
        admission seniority, so the oldest request always wins and two
        starved lanes cannot preempt each other forever."""
        st = self._slots[slot]
        self._pool.free(st.uid)
        self._tbl_host[slot] = -1
        self._preempted[st.uid] = (st.prompt, list(st.gen), st.blocks, st.wall_s,
                                   st.admit_seq)
        combined = np.concatenate([st.prompt, np.asarray(st.gen, np.int32)]).astype(np.int32)
        # replays bypass fairness and the max_queue bound: they won admission once
        self._tq.push_front(Request(
            uid=st.uid, prompt=combined, max_new=st.max_new,
            tenant=st.handle.tenant if st.handle is not None else "default",
            priority=st.handle.priority if st.handle is not None else 0))
        tfm.reset_slot(self.model.cfg, self._cache, slot)
        tr = self.telem.tracer
        if tr is not None:
            now = self.clock()
            tr.instant(slot, "preempt", now, args={"uid": st.uid, "gen_len": len(st.gen),
                                                   "mid_prefill": st.pf_pos is not None})
            tr.async_end("prefill" if st.pf_pos is not None else "decode", st.uid, now,
                         args={"preempted": True})
            tr.async_begin("queued", st.uid, now, args={"replay": True})
        self._slots[slot] = None
        self._done[slot] = True
        self.stats["preemptions"] += 1

    def _grow_pages(self) -> None:
        """Top every live lane up to the pages its NEXT superstep can touch
        at its live depth bound (``_lane_growth_k``), oldest first; on pool
        exhaustion preempt the newest other lane and retry.  All row updates
        of the tick go to the device in one push."""
        dirty = False
        for s in sorted((i for i, st in enumerate(self._slots) if st is not None),
                        key=lambda i: self._slots[i].admit_seq):
            st = self._slots[s]
            if st is None or st.pf_pos is not None:
                continue                 # preempted below, or grown by _advance_prefill
            remaining = st.max_new - len(st.gen)
            if remaining <= 0:           # retires at the next boundary
                continue
            while True:
                got = self._pool.ensure(st.uid, self._pages_needed(
                    st.cache_len, remaining, k=self._lane_growth_k(s)))
                if got is None:
                    victims = [i for i, v in enumerate(self._slots)
                               if v is not None and i != s]
                    if not victims:      # lone lane: admission sizing makes
                        break            # this unreachable
                    self._preempt(max(victims, key=lambda i: self._slots[i].admit_seq))
                    dirty = True         # preemption unmapped a row
                    continue
                if got:
                    self._sync_row(s, st.uid)
                    dirty = True
                break
        if dirty:                        # in place: the graph reads this table
            graphs_mod.upload(self._cache["tbl"], self._tbl_host)

    def _sync_row(self, s: int, uid: int) -> None:
        """Mirror lane `s`'s pool ownership into the host block table
        (allocation order == logical order)."""
        owned = self._pool.owned(uid)
        self._tbl_host[s] = -1
        self._tbl_host[s, :len(owned)] = owned

    def _advance_prefill(self) -> None:
        """One batched chunk step: every mid-prefill lane advances by up to
        ``prefill_chunk`` prompt tokens, directly in the live cache, through
        the runner's chunk step (one graph replay on the card).  Lanes that
        consume their last prompt token get their pending token set on the
        device and decode in this tick's superstep.  Paged lanes get the
        pages of their chunk right before it, oldest first; when the pool
        runs dry a starved lane evicts only strictly newer lanes (else it
        waits a tick).  A tick's prefill work is bounded: one chunk step of
        at most ``num_slots * prefill_chunk`` tokens, however long the
        prompts are."""
        lanes = [s for s, st in enumerate(self._slots)
                 if st is not None and st.pf_pos is not None]
        if not lanes:
            return
        B, T = self.num_slots, self._chunk
        tokens = np.zeros((B, T), np.int32)
        take = np.zeros((B,), np.int32)
        finish_tok = np.zeros((B,), np.int32)
        finished = np.zeros((B,), bool)
        dirty = False
        for s in sorted(lanes, key=lambda i: self._slots[i].admit_seq):
            st = self._slots[s]
            if st is None:               # preempted as a victim below
                continue
            tk, fin, extent = self._prefill_extent(st)
            if self.paged:
                while True:
                    got = self._pool.ensure(st.uid, self._pool.pages_for(extent))
                    if got is not None:
                        break
                    # evicting a senior here would livelock: a mid-prefill
                    # eviction loses all prefill progress, so two long
                    # prefills on a tight pool would wipe each other at the
                    # finish line.  Seniority is a total order, so the
                    # oldest prefill lane can always clear its path, and
                    # admission sizing makes it fit the pool alone.
                    victims = [i for i, v in enumerate(self._slots)
                               if v is not None and v.admit_seq > st.admit_seq]
                    if not victims:
                        break
                    self._preempt(max(victims, key=lambda i: self._slots[i].admit_seq))
                    dirty = True         # preemption unmapped a row
                if got is None:
                    continue             # starved: retry next tick
                if got:
                    self._sync_row(s, st.uid)
                    dirty = True
            tokens[s, :tk] = st.pf_prompt[st.pf_pos:st.pf_pos + tk]
            take[s] = tk
            if fin:
                finished[s] = True
                finish_tok[s] = st.pf_prompt[-1]
        if dirty:                        # in place: the graphs read this table
            graphs_mod.upload(self._cache["tbl"], self._tbl_host)
        if not take.any() and not finished.any():
            return
        t_c0 = self.clock()
        self._runner.prefill_chunk(tokens, take, finish_tok, finished)
        t_c1 = self.clock()
        tick_tokens = int(take.sum())
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += tick_tokens
        self.stats["max_tick_prefill_tokens"] = max(self.stats["max_tick_prefill_tokens"],
                                                    tick_tokens)
        tr = self.telem.tracer
        for s in lanes:
            st = self._slots[s]
            if st is None or (not take[s] and not finished[s]):
                continue
            st.pf_pos += int(take[s])
            st.cache_len += int(take[s])
            if tr is not None:
                tr.span(s, "prefill_chunk", t_c0, t_c1,
                        args={"uid": st.uid, "tokens": int(take[s]), "pos": int(st.pf_pos)})
            if finished[s]:
                # the whole prompt prefix is in the cache now: make it
                # hittable for the next request that shares it
                if self.prefix_cache:
                    self._pool.publish_prefix(st.uid, st.pf_prompt[:-1])
                st.pf_pos = None
                st.pf_prompt = None
                self._done[s] = False
                if st.handle is not None and st.handle.t_prefill_done is None:
                    st.handle.t_prefill_done = t_c1
                if tr is not None:
                    tr.async_end("prefill", st.uid, t_c1)
                    tr.async_begin("decode", st.uid, t_c1, args={"slot": s})

    def _profile_start(self):
        """The optional ``torch.profiler`` window (``profile_dir``): opened
        at the first dispatch, one ``record_function("superstep")`` range a
        dispatch, closed after ``profile_steps`` dispatches, at the harvest
        of the last (``_profile_finish``: stopping the profiler synchronises
        the device, which the harvest does anyway and a dispatch never
        may).  Best effort: a profiler failure never takes serving down.
        Returns the range to enter, or None."""
        if self.profile_dir and self._profile is None:
            try:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if self.model.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                self._profile = prof
                self._profile_left = max(1, int(self.profile_steps))
            except Exception:
                self.profile_dir = None
        if self._profile is None:
            return None
        try:
            return torch.profiler.record_function("superstep")
        except Exception:
            return None

    def _profile_finish(self) -> None:
        """After the window's last dispatch has been harvested: stop the
        profiler and write its Chrome trace into ``profile_dir``."""
        if self._profile is None or self._profile_left > 0:
            return
        prof, self._profile = self._profile, None
        try:
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.profile_dir, "superstep_trace.json"))
        except Exception:
            pass
        self.profile_dir = None          # the window is spent: never reopened

    def _dispatch_superstep(self) -> None:
        """Dispatch one superstep over the live lanes and return without
        waiting for it (``_harvest`` does, one tick later).  It runs the
        largest remaining budget of a live lane in blocks, at most
        ``sync_every``: after that many every lane is done."""
        budget = np.ones((self.num_slots,), np.int32)
        for s, st in enumerate(self._slots):
            if st is not None:
                budget[s] = st.max_new - len(st.gen)
        steps = min(self.sync_every, int(budget[~self._done].max()))
        # the runner advances the engine's pending tokens, cache and replay
        # buffer in place; every later device op of the engine is queued
        # behind the superstep on the same stream
        graphs_mod.check_ptrs(self.state.dvi_params, self._runner.drafter)
        rng = self._profile_start()
        if rng is not None:
            rng.__enter__()
        if self._depth is None:
            res = self._runner.dispatch(self._done, budget, steps)
        else:
            # each decoding lane's ceiling is the depth growth provisioned
            # for; the draft width K_blk is the largest of them (lanes are
            # admitted, and finish their prefill, only before the dispatch,
            # so this is exact)
            kcap = np.full((self.num_slots,), self._k_worst, np.int32)
            kblk = self._depth.k_min
            for s, st in enumerate(self._slots):
                if st is not None and st.pf_pos is None:
                    kcap[s] = self._lane_growth_k(s)
                    kblk = max(kblk, int(kcap[s]))
            res = self._runner.dispatch(
                self._done, budget, steps, k_blk=kblk,
                depth_state=(self._k_host, self._ema_host, self._cool_host, kcap))
        if rng is not None:
            rng.__exit__(None, None, None)
        if self._profile is not None:
            self._profile_left -= 1
        lanes = [s for s, st in enumerate(self._slots) if st is not None]
        now = self.clock()
        mark = self._clock + (now - self._tick_t0)
        self._inflight = (res, mark, lanes, now)
        self.stats["dispatches"] += 1
        self.stats["peak_live_slots"] = max(self.stats["peak_live_slots"], len(lanes))

    def _harvest(self) -> List[Completion]:
        """Bring the in-flight superstep's summary to the host in ONE packed
        device-to-host copy (the only sync of the continuous hot path), fold
        it into the host bookkeeping, retire finished lanes and manage the
        drafter's updates.  A dispatched update is folded first, even with
        no superstep in flight, so the last update of a burst is never
        dropped; the buffer's count and a staged update's metrics ride the
        same copy (they are materialised one harvest after their fold, when
        the update has run)."""
        fold_note = self._fold_update()
        if self._inflight is None:
            if fold_note is not None:
                self._train_staged = fold_note
            return []
        res, clock_mark, lanes, t_disp_wall = self._inflight
        self._inflight = None
        staged = self._train_staged
        B, nh = self.num_slots, res.accept_hist.shape[0]    # K_blk + 1 buckets
        parts = [p.reshape(-1).to(torch.int32) for p in (
            res.done, res.gen_count, res.lane_blocks, res.lane_committed, res.lane_accepted,
            res.lane_drafted, res.k_lane)]
        parts.append(res.accept_ema.view(torch.int32))      # float32 bits
        parts += [p.reshape(-1).to(torch.int32) for p in (
            res.k_cool, res.accept_hist, res.depth_hist, res.buffer["count"])]
        n_train = 0 if staged is None else len(TRAIN_KEYS)
        if staged is not None:           # float32 bits, read back as float32
            parts.append(staged[0].view(torch.int32))
        parts.append(res.gen_buf.reshape(-1))
        tr = self.telem.tracer
        t0 = self.clock()
        flat = torch.cat(parts).cpu().numpy()
        now = self.clock()
        self._profile_finish()
        (done_np, cnt_np, blocks_np, committed_np, accepted_np, drafted_np, k_np, ema_np,
         cool_np, ahist_np, dhist_np, count_np, train_np, gen_np) = np.split(
            flat, np.cumsum([B] * 9 + [nh, nh, 1, n_train]))
        ema_np = ema_np.view(np.float32)
        gen_np = gen_np.reshape(B, -1)
        buf_count = int(count_np[0])
        self.stats["host_syncs"] += 1
        self.stats["sync_wait_s"] += now - t0
        self.telem.h_sync_wait.observe(now - t0)
        if tr is not None:
            tr.span(self.telem.tid_engine, "sync_wait", t0, now)
        if staged is not None:
            self._fold_train_metrics(dict(zip(TRAIN_KEYS, train_np.view(np.float32).tolist())),
                                     *staged[1:])
            self._train_staged = None
        for i, n in enumerate(ahist_np):
            self.telem.h_block_accept.add(int(i), int(n))
        for i, n in enumerate(dhist_np):
            self.telem.h_block_depth.add(int(i), int(n))
        # blocks with a live lane: the longest-lived lane saw all of them
        self.stats["steps"] += int(blocks_np.max(initial=0))
        wall = self._clock + (now - self._tick_t0) - clock_mark
        wall_share = wall / max(int(blocks_np.sum()), 1)

        outs: List[Completion] = []
        k_seen: List[int] = []
        for s in lanes:                  # lanes admitted since the dispatch rode
            st = self._slots[s]          # along masked and carry no results
            if st is None or st.pf_pos is not None:   # mid-prefill lanes too
                continue
            nb = int(blocks_np[s])
            st.blocks += nb
            st.wall_s += wall_share * nb
            st.cache_len += int(committed_np[s])
            st.gen.extend(int(t) for t in gen_np[s, :int(cnt_np[s])])
            if st.handle is not None and int(cnt_np[s]) > 0:
                # stream the fresh chunk to the handle at the boundary
                first = st.handle.t_first_token is None
                st.handle.feed(st.gen)
                if first and st.handle.t_first_token is not None:
                    self.telem.h_ttft.observe(st.handle.t_first_token - st.handle.t_submit)
            self.stats["blocks"] += nb
            self.stats["committed"] += int(committed_np[s])
            self.stats["accepted"] += int(accepted_np[s])
            # drafted: the sum of the depths the lane's live blocks ran at
            self.stats["drafted"] += int(drafted_np[s])
            self._slot_accepted[s] += int(accepted_np[s])
            self._slot_drafted[s] += int(drafted_np[s])
            self._slot_committed[s] += int(committed_np[s])
            self._slot_blocks[s] += nb
            k_seen.append(int(k_np[s]))
            if tr is not None:
                tr.span(s, "superstep", t_disp_wall, now,
                        args={"uid": st.uid, "blocks": nb,
                              "committed": int(committed_np[s]),
                              "accepted": int(accepted_np[s]), "k": int(k_np[s])})
                if self._depth is not None and int(k_np[s]) != int(self._k_host[s]):
                    tr.instant(s, f"depth {int(self._k_host[s])}->{int(k_np[s])}", now,
                               args={"uid": st.uid, "ema": float(ema_np[s])})
            # the lane's controller state after the superstep (masked lanes
            # came back unchanged)
            if self._depth is not None:
                self._k_host[s] = k_np[s]
                self._ema_host[s] = ema_np[s]
                self._cool_host[s] = cool_np[s]
            if done_np[s]:               # EOS or budget, detected on the device
                gen = np.asarray(st.gen, np.int32)
                comp = self._complete(st.uid, np.concatenate([st.prompt, gen]), gen,
                                      len(st.gen) / max(st.blocks, 1), st.wall_s)
                outs.append(comp)
                self._finish_handle(st.uid, comp)
                self.stats["requests"] += 1
                if self.paged:
                    self._pool.free(st.uid)   # copy-free eviction: pages
                    self._tbl_host[s] = -1    # recycle host-side
                tfm.reset_slot(self.model.cfg, self._cache, s)
                self._slots[s] = None
                self._done[s] = True
        if k_seen:
            km = float(np.mean(k_seen))
            self.stats["k_mean"].append(km)
            self.telem.g_depth_mean.set(km)
        # the drafter's update cadence: dispatched now, folded at the next
        # harvest; the superstep dispatched this tick decodes on the old A, B
        self._blocks_since_update += int(blocks_np.max(initial=0))
        if self.learn and self._blocks_since_update >= self.update_every and buf_count > 0:
            self._blocks_since_update = 0
            self._dispatch_update(buf_count)
        if fold_note is not None:
            self._train_staged = fold_note
        return outs

    def _step_continuous(self) -> List[Completion]:
        """One tick: pre-admit arrivals into already-free lanes (queued behind
        the in-flight superstep), harvest it, honour cancels, grow paged
        lanes (preempting if the pool runs dry), admit into freshly freed
        lanes, advance mid-prefill lanes by one chunk, and dispatch the next
        superstep over the decoding lanes."""
        self._tick_t0 = tick0 = self.clock()
        tr = self.telem.tracer
        tid_e = self.telem.tid_engine if tr is not None else 0

        def _phase(name, fn, *a):
            if tr is None:
                return fn(*a)
            p0 = self.clock()
            try:
                return fn(*a)
            finally:
                tr.span(tid_e, name, p0, self.clock())

        try:
            # the reserve holds the live lanes' growth and the mid-prefill
            # lanes' next chunk (paged)
            _phase("pre_admit", self._admit_waiting,
                   self._growth_reserve() if self.paged else 0)
            # the harvest reads the last superstep's outputs, the runner's
            # static buffers, before the dispatch below rewrites them
            outs = _phase("harvest", self._harvest)
            _phase("sweep_cancels", self._sweep_cancels)
            if self.paged:               # grow BEFORE admitting: admission then
                _phase("grow_pages", self._grow_pages)   # sees the true residue
            _phase("admit", self._admit_waiting, self._prefill_reserve() if self.paged else 0)
            # one bounded chunk step a tick, then the superstep over the
            # decoding lanes (those whose prefill finished just now included)
            _phase("prefill_chunk", self._advance_prefill)
            if any(st is not None and st.pf_pos is None for st in self._slots):
                _phase("dispatch", self._dispatch_superstep)
        finally:
            dt = self.clock() - self._tick_t0
            self._clock += dt
            self.stats["tick_s"].append(dt)
            self.telem.h_tick.observe(dt)
            t = self.telem
            t.g_live.set(self.active_slots)
            t.g_queue.set(len(self._tq))
            if self.paged:
                t.g_kv_used.set(self._pool.used_pages)
                t.g_kv_free.set(self._pool.available_pages)
                t.g_kv_cached.set(self._pool.cached_pages)
                ev = self._pool.evictions
                if ev != self._evict_seen:
                    self.stats["prefix_evictions"] += ev - self._evict_seen
                    self._evict_seen = ev
            if tr is not None:
                tr.span(tid_e, "tick", tick0, tick0 + dt,
                        args={"live": self.active_slots, "queued": len(self._tq)})
            self._tick_t0 = None
        return outs

    # ------------------------------------------------------------------
    # the block-step runner
    # ------------------------------------------------------------------

    def _ensure_runner(self):
        """The block-step runner, made on first use: the continuous one with
        the engine's one cache (its graph captured now), or the sync one
        (graphs captured per batch shape as they come)."""
        if self._runner is not None:
            return self._runner
        if self.scheduler == "sync":
            self._runner = graphs_mod.GenerateRunner(
                self.model, self.params, self.state.dvi_params, self.state.buf,
                max_new=int(self.max_new), graphs=self.graphs)
            return self._runner
        self._cache = (self.model.init_paged_cache(self.num_slots, self.kv_pages,
                                                   self.kv_page_size, self._mps)
                       if self.paged else self.model.init_cache(self.num_slots, self._cap))
        self._runner = graphs_mod.SuperstepRunner(
            self.model, self.params, self.state.dvi_params, self._pending, self._cache,
            self.state.buf, sync_every=self.sync_every, eos_id=self.eos_id,
            graphs=self.graphs, depth=self._depth, chunk=self._chunk)
        return self._runner

    def warmup(self, buckets=None) -> None:
        """Make the block-step runner and capture its graphs now, ahead of
        the traffic (capturing synchronises with the device): the continuous
        engine's one graph (with adaptive depth, one per draft width in
        [k_min, k_max]; with chunked prefill, the chunk step's too), or the
        sync engine's graph for a full batch of each prompt bucket in
        `buckets` (default: all of ``self.buckets``)."""
        runner = self._ensure_runner()
        if self.scheduler == "sync":
            for b in self.buckets if buckets is None else buckets:
                runner.prepare(self.batch_size, b)
        else:
            runner.capture_all()

    def graph_stats(self) -> dict:
        """The runner's captures, capture and instantiate seconds, graph
        nodes, pool memory, replays and host seconds in ``replay()``
        (``core.graphs.graph_stats``); all zero before the runner is made."""
        return (graphs_mod.graph_stats([]) if self._runner is None
                else self._runner.graph_stats())

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------

    def step(self) -> List[Completion]:
        if self.scheduler == "continuous":
            return self._step_continuous()
        return self._step_sync()

    @property
    def busy(self) -> bool:
        # a dispatched update keeps the engine busy, so that run() steps
        # once more and the burst's last update is folded
        return (bool(self._tq) or self.active_slots > 0 or self._inflight is not None
                or self._update_inflight is not None or any(self._queue.values()))

    def run(self, max_steps: int = 10**9) -> List[Completion]:
        done: List[Completion] = []
        for _ in range(max_steps):
            if not self.busy:
                break
            done.extend(self.step())
        return done

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero every registry metric, rolling window, per-lane counter and
        the training history (e.g. after a warm-up run); live lanes, the
        depth controller's state and the drafter's state are untouched."""
        self.telem.registry.reset()
        self.stats.reset()
        self.train_history.clear()
        for a in (self._slot_accepted, self._slot_drafted, self._slot_committed,
                  self._slot_blocks):
            a[:] = 0

    @property
    def acceptance(self) -> float:
        return self.stats["accepted"] / max(self.stats["drafted"], 1)

    def adaptive_stats(self) -> dict:
        """The depth controller's state per lane (depth, acceptance EMA), each
        lane's mean depth over its live blocks, and the draft efficiency:
        committed tokens per drafted token, what adaptive depth exists to
        raise.  Reported (depth pinned at k_spec) without a controller too."""
        drafted = max(self.stats["drafted"], 1)
        recent = list(self.stats["k_mean"])
        d = self._depth
        return {
            "adaptive": d is not None,
            "k_min": d.k_min if d is not None else self.model.cfg.dvi.k_spec,
            "k_max": self._k_worst,
            "k_lane": self._k_host.copy(),
            "accept_ema": self._ema_host.copy(),
            "slot_mean_depth": self._slot_drafted / np.maximum(self._slot_blocks, 1),
            "slot_draft_efficiency": self._slot_committed / np.maximum(self._slot_drafted, 1),
            "mean_depth": self.stats["drafted"] / max(self.stats["blocks"], 1),
            "draft_efficiency": self.stats["committed"] / drafted,
            "k_mean_recent": float(np.mean(recent)) if recent else 0.0,
        }

    def metrics_snapshot(self) -> dict:
        """JSON-able snapshot of every registry metric (schema: telemetry.py)."""
        return self.telem.snapshot()

    def render_prometheus(self) -> str:
        return self.telem.render_prometheus()

    def write_metrics(self, path: str) -> None:
        self.telem.write_metrics(path)

    def trace_dict(self) -> Optional[dict]:
        """The Chrome-trace dict (``telemetry=True`` runs only)."""
        tr = self.telem.tracer
        return tr.to_dict() if tr is not None else None

    def write_trace(self, path: str) -> None:
        tr = self.telem.tracer
        if tr is None:
            raise ValueError("tracing is off — construct the engine with "
                             "telemetry=True to record a trace")
        tr.write(path)

    @property
    def slot_acceptance(self) -> np.ndarray:
        """(num_slots,) lifetime acceptance rate per lane."""
        return self._slot_accepted / np.maximum(self._slot_drafted, 1)

    def kv_stats(self) -> dict:
        """Paged-pool observability: utilization and fragmentation, plus
        preemption and concurrency counters."""
        if not self.paged:
            return {"paged": False}
        live_tokens = sum(st.cache_len for st in self._slots if st is not None)
        out = self._pool.utilization(live_tokens)
        out.update(paged=True, preemptions=self.stats["preemptions"],
                   peak_live_slots=self.stats["peak_live_slots"])
        return out

    def latency_percentiles(self) -> dict:
        """Percentiles over the most recent ``latency_window`` completions."""
        lats = np.asarray(self.stats["latencies"], np.float64)
        if lats.size == 0:
            return {"p50_s": 0.0, "p95_s": 0.0, "mean_s": 0.0, "count": 0}
        return {"p50_s": float(np.percentile(lats, 50)),
                "p95_s": float(np.percentile(lats, 95)),
                "mean_s": float(np.mean(lats)), "count": int(lats.size)}

    def tick_percentiles(self) -> dict:
        """Tick wall-time percentiles over the most recent ``latency_window``
        ticks: the cadence jitter that chunked prefill bounds (a one-shot
        prefill of a long prompt is one fat tick; chunking spreads it)."""
        ts = np.asarray(self.stats["tick_s"], np.float64)
        if ts.size == 0:
            return {"p50_s": 0.0, "p95_s": 0.0, "max_s": 0.0, "count": 0}
        return {"p50_s": float(np.percentile(ts, 50)),
                "p95_s": float(np.percentile(ts, 95)),
                "max_s": float(ts.max()), "count": int(ts.size)}

    def dispatch_stats(self) -> dict:
        """Host/device interplay on the continuous hot path: host syncs, the
        host's time blocked on them, the dispatches that covered the
        executed block-steps (``steps``: blocks with a live lane), and the
        chunk steps of chunked prefill."""
        steps = max(self.stats["steps"], 1)
        return {"sync_every": self.sync_every, "steps": self.stats["steps"],
                "dispatches": self.stats["dispatches"],
                "host_syncs": self.stats["host_syncs"],
                "host_syncs_per_100_blocks": 100.0 * self.stats["host_syncs"] / steps,
                "host_wait_s": self.stats["sync_wait_s"],
                "prefill_chunk": self._chunk,
                "prefill_chunks": self.stats["prefill_chunks"],
                "prefill_tokens": self.stats["prefill_tokens"],
                "max_tick_prefill_tokens": self.stats["max_tick_prefill_tokens"]}
