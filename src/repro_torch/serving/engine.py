"""Serving engine, batch-synchronous scheduler: port of the ``scheduler="sync"``
path of ``repro.serving.engine``.

Requests are queued in prompt-length buckets; each ``step`` takes up to
``batch_size`` requests from the fullest bucket, pads their prompts to the
bucket length (left, by repeating the first token), pads the batch with
replays that are masked out of generation, logging and statistics, and
decodes it to completion with ``speculative_generate``, logging accept/reject
tuples to the replay buffer.

Where the reference engine takes an ``OnlineTrainerState``, this one takes
the drafter's ``dvi_params`` and an optional replay buffer until the Improve
loop is ported.  The continuous scheduler, request handles, telemetry, the
paged pool and online learning are later slices and raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import buffer as buffer_mod
from repro_torch.core import spec as spec_mod
from repro_torch.models.model import Model


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (Tp,) int32
    max_new: int = 64


@dataclass
class Completion:
    uid: int
    tokens: np.ndarray            # full stream (prompt + generated)
    gen_tokens: np.ndarray        # generated tokens only
    mat: float                    # mean accepted tokens per block of its batch
    wall_s: float                 # engine time attributed to this request
    latency_s: float = 0.0        # submit -> completion


@dataclass
class ServingEngine:
    model: Model
    params: dict
    dvi_params: dict
    buf: Optional[dict] = None    # replay buffer (made on first use if None)
    scheduler: str = "sync"
    batch_size: int = 8           # requests per batch
    max_new: int = 64             # default / cap for generation length
    buckets: tuple = (16, 32, 64, 128)
    learn: bool = False
    stats: Dict[str, object] = field(default_factory=dict, init=False)

    def __post_init__(self):
        if self.scheduler != "sync":
            raise NotImplementedError("the continuous scheduler is a later slice "
                                      "of the port (ROADMAP item 12)")
        if self.learn:
            raise NotImplementedError("online drafter updates (the Improve loop) "
                                      "are a later slice of the port (ROADMAP item 7)")
        if self.buf is None:
            self.buf = buffer_mod.init_buffer(self.model.cfg, device=self.model.device)
        self._queue: Dict[int, List[Request]] = {}
        self._submit_t: Dict[int, float] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats.update(requests=0, blocks=0, steps=0, committed=0, accepted=0,
                          drafted=0, latencies=[])

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit_request(self, req: Request) -> None:
        """Queue `req` in its prompt-length bucket.  (The reference returns
        a RequestHandle; handles are a later slice.)"""
        self._queue.setdefault(self._bucket(len(req.prompt)), []).append(req)
        self._submit_t[req.uid] = time.monotonic()

    def _pad(self, req: Request, bucket: int) -> np.ndarray:
        p = req.prompt[-bucket:]
        if len(p) < bucket:                      # left-pad by repeating BOS
            p = np.concatenate([np.full(bucket - len(p), p[0], p.dtype), p])
        return p

    # ------------------------------------------------------------------
    # the sync scheduler
    # ------------------------------------------------------------------

    def step(self) -> List[Completion]:
        """Serve one batch from the fullest bucket."""
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

        t0 = time.monotonic()
        res = spec_mod.speculative_generate(
            self.model, self.params, self.dvi_params, prompts, int(self.max_new),
            collect=True, buf=self.buf, live_mask=live)
        toks = res.tokens.cpu().numpy()
        lens = res.lengths.cpu().numpy()
        wall = time.monotonic() - t0
        self.buf = res.buffer

        blocks, committed = int(res.blocks), int(res.committed)
        mat = committed / max(blocks, 1)
        self.stats["requests"] += n_real
        self.stats["blocks"] += blocks
        self.stats["steps"] += res.steps
        self.stats["committed"] += committed
        self.stats["accepted"] += int(res.accepted_drafts)
        self.stats["drafted"] += int(res.drafted)

        outs = []
        for i, r in enumerate(reqs[:n_real]):
            # the batch decodes to the engine-wide max_new (head-of-line cost
            # of sync scheduling) but the client only gets what it asked for
            gen = toks[i, bucket:lens[i]][:min(r.max_new, self.max_new)]
            now = time.monotonic()
            lat = now - self._submit_t.pop(r.uid, now)
            self.stats["latencies"].append(lat)
            outs.append(Completion(uid=r.uid, tokens=np.concatenate([toks[i, :bucket], gen]),
                                   gen_tokens=gen, mat=mat, wall_s=wall / n_real,
                                   latency_s=lat))
        return outs

    @property
    def busy(self) -> bool:
        return any(self._queue.values())

    def run(self, max_steps: int = 10**9) -> List[Completion]:
        done: List[Completion] = []
        for _ in range(max_steps):
            if not self.busy:
                break
            done.extend(self.step())
        return done

    @property
    def acceptance(self) -> float:
        return self.stats["accepted"] / max(self.stats["drafted"], 1)
