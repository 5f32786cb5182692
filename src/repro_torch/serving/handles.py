"""Async request surface for the serving engine: handles + tenant queue.

The port's copy of ``repro.serving.handles`` (standard library only), kept
line for line so the two engines share one request contract.

The engine's historical ``submit(Request) -> None`` gave callers nothing
back: no way to stream tokens, no way to cancel, no identity beyond the
uid they invented.  This module is the redesigned surface:

* ``RequestHandle`` — returned by ``ServingEngine.submit_request``.  It
  carries the request's identity (uid / tenant / priority), its lifecycle
  timestamps (submit / admit / prefill-done / first-token / done, all on
  the engine's injected clock), and a thread-safe incremental token
  stream: the engine ``feed``s the authoritative generated-token total at
  each superstep harvest, and any number of consumer threads iterate
  ``deltas()`` (incremental chunks), block on ``result()``, or call
  ``cancel()``.  Cancellation is a flag the engine honours at the next
  superstep boundary (the only place lanes may be retired — see the
  superstep contract in engine.py); the handle then finishes with
  ``outcome == "cancelled"`` and whatever tokens were committed first.

* ``TenantQueue`` — the continuous scheduler's admission queue, upgraded
  from a plain FIFO to per-tenant start-time-fair queuing: each tenant
  has a virtual-time tag advanced by ``1/weight`` per dequeue, the
  next admission comes from the eligible tenant with the smallest tag
  (idle tenants re-enter at the current virtual time, so parking never
  accrues credit), and within a tenant entries order by (priority desc,
  arrival).  Preemption replays bypass fairness via ``push_front`` —
  they already won admission once and re-queue at the global front (the
  no-livelock argument in engine._preempt depends on this).  A bounded
  queue (``max_queue``) rejects with ``QueueFull`` at submit time
  instead of queuing without bound — backpressure is explicit.

Everything here is pure host-side bookkeeping: no torch, no device work.
The lock scope is the submit/harvest thread boundary the HTTP front-end
relies on (the reference's serving/http.py): ``push``/``QueueFull`` from any thread,
``peek``/``take`` only from the engine thread.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional


class QueueFull(RuntimeError):
    """Admission queue at ``max_queue``: the request was REJECTED, not
    queued.  Callers (e.g. the HTTP layer's 429) decide retry policy."""


class RequestHandle:
    """Caller-facing view of one in-flight request.

    Engine-side entry points (called only from the engine thread):
    ``feed`` / ``finish`` / ``abort``.  Everything else is safe from any
    thread.  Token delivery is monotone: ``feed`` receives the
    authoritative generated-token TOTAL (the engine's ``_Slot.gen``,
    which survives preemption/replay), so a replayed lane can never
    un-deliver or re-deliver tokens.
    """

    def __init__(self, uid: int, tenant: str = "default", priority: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.uid = uid
        self.tenant = tenant
        self.priority = priority
        self._clock = clock
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._completion = None
        self.outcome: Optional[str] = None   # completed|cancelled|rejected|error
        self.error: Optional[str] = None
        self._cancel = False
        # lifecycle timestamps on the ENGINE's clock (None until reached)
        self.t_submit: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_prefill_done: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None

    # -- engine side ---------------------------------------------------

    def feed(self, total_gen) -> int:
        """Publish the authoritative generated-token total; returns how
        many NEW tokens this call delivered.  Idempotent for replays."""
        with self._cond:
            n = len(self._tokens)
            if len(total_gen) > n:
                self._tokens.extend(int(t) for t in total_gen[n:])
                if self.t_first_token is None:
                    self.t_first_token = self._clock()
                self._cond.notify_all()
            return len(self._tokens) - n

    def finish(self, completion, outcome: str = "completed",
               t_done: Optional[float] = None) -> None:
        """Terminal transition (engine thread): record the completion (or
        the partial one for a cancel), stamp ``t_done``, wake waiters."""
        with self._cond:
            if self.outcome is not None:
                return
            if completion is not None:
                gen = completion.gen_tokens
                n = len(self._tokens)
                if len(gen) > n:                 # final flush, same stream
                    self._tokens.extend(int(t) for t in gen[n:])
                    if self.t_first_token is None and self._tokens:
                        self.t_first_token = self._clock()
            self._completion = completion
            self.outcome = outcome
            self.t_done = t_done if t_done is not None else self._clock()
            self._cond.notify_all()

    def abort(self, reason: str) -> None:
        """Engine died / shut down without serving this request: unblock
        every waiter with ``outcome == "error"``."""
        with self._cond:
            if self.outcome is not None:
                return
            self.error = reason
            self.outcome = "error"
            self.t_done = self._clock()
            self._cond.notify_all()

    # -- caller side ---------------------------------------------------

    @property
    def finished(self) -> bool:
        return self.outcome is not None

    @property
    def cancel_requested(self) -> bool:
        return self._cancel

    @property
    def status(self) -> str:
        if self.outcome is not None:
            return "done"
        return "queued" if self.t_admit is None else "running"

    def cancel(self) -> bool:
        """Request cancellation; honoured at the next superstep boundary.
        Returns False when the request already finished (nothing to do)."""
        with self._cond:
            if self.outcome is not None:
                return False
            self._cancel = True
            return True

    def tokens(self) -> List[int]:
        with self._cond:
            return list(self._tokens)

    def deltas(self, timeout: Optional[float] = None) -> Iterator[List[int]]:
        """Yield incremental generated-token chunks as the engine harvests
        them (one chunk per superstep boundary that committed tokens for
        this lane), ending when the request finishes.  ``timeout`` bounds
        the wait for EACH chunk; expiry raises ``TimeoutError``."""
        pos = 0
        while True:
            with self._cond:
                while len(self._tokens) == pos and self.outcome is None:
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            f"request {self.uid}: no tokens within "
                            f"{timeout}s")
                chunk = self._tokens[pos:]
                pos = len(self._tokens)
                done = self.outcome is not None
            if chunk:
                yield chunk
            if done:
                if self.outcome == "error":
                    raise RuntimeError(
                        f"request {self.uid} aborted: {self.error}")
                return

    def result(self, timeout: Optional[float] = None):
        """Block until the request finishes; returns the ``Completion``
        (partial for ``outcome == "cancelled"``)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.outcome is not None,
                                       timeout):
                raise TimeoutError(f"request {self.uid}: not finished "
                                   f"within {timeout}s")
            if self.outcome == "error":
                raise RuntimeError(f"request {self.uid} aborted: "
                                   f"{self.error}")
            return self._completion

    def timings(self) -> Dict[str, Optional[float]]:
        """The latency split ``Completion.latency_s`` folded into: queue
        wait (submit -> admit), prefill (admit -> prefill done), decode
        (prefill done -> done), plus TTFT and end-to-end.  Entries are
        None until the corresponding lifecycle edge happened."""
        def span(a, b):
            return None if a is None or b is None else b - a

        return {
            "queue_wait_s": span(self.t_submit, self.t_admit),
            "prefill_s": span(self.t_admit, self.t_prefill_done),
            "decode_s": span(self.t_prefill_done, self.t_done),
            "ttft_s": span(self.t_submit, self.t_first_token),
            "e2e_s": span(self.t_submit, self.t_done),
        }


class TenantQueue:
    """Per-tenant weighted start-time-fair admission queue.

    * ``push`` (any thread): enqueue under the request's tenant; raises
      ``QueueFull`` once ``max_queue`` entries wait (0 = unbounded).
    * ``peek``/``take`` (engine thread): ``peek`` returns the request the
      fair scheduler would admit next WITHOUT removing it (admission may
      be watermark-blocked and retried next tick); ``take(req)`` removes
      exactly that request and charges its tenant's virtual-time tag.
    * ``push_front``: preemption replay — global front of the queue,
      bypassing both fairness and the bound (the request was already
      admitted once; dropping it would lose committed work).
    * ``drop(uids)``: remove cancelled entries wherever they sit.

    Fairness: tenant ``t`` holds a virtual finish tag ``F[t]``; a dequeue
    charges ``F[t] = max(F[t], V) + 1/weight[t]`` and advances the global
    virtual time ``V`` to the start tag.  ``max(F[t], V)`` re-enters idle
    tenants at the current virtual time, so a parked tenant resumes
    sharing from NOW rather than burning accumulated credit.  Within a
    tenant: (priority desc, arrival order).
    """

    def __init__(self, max_queue: int = 0,
                 weights: Optional[Dict[str, float]] = None):
        self.max_queue = int(max_queue)
        self._weights = dict(weights or {})
        self._heaps: Dict[str, list] = {}
        self._tags: Dict[str, float] = {}
        self._v = 0.0
        self._front: deque = deque()
        self._entry: Dict[int, tuple] = {}     # uid -> (tenant, seq)
        self._dead: set = set()                # seqs removed out of order
        self._seq = 0
        self._n = 0
        self._lock = threading.Lock()

    def _weight(self, tenant: str) -> float:
        w = float(self._weights.get(tenant, 1.0))
        return w if w > 0 else 1.0

    def push(self, req) -> None:
        with self._lock:
            if self.max_queue and self._n >= self.max_queue:
                raise QueueFull(
                    f"admission queue full ({self._n}/{self.max_queue}); "
                    f"request uid={req.uid} tenant={req.tenant!r} rejected")
            self._seq += 1
            tenant = getattr(req, "tenant", "default")
            heapq.heappush(self._heaps.setdefault(tenant, []),
                           (-int(getattr(req, "priority", 0)), self._seq,
                            req))
            self._entry[req.uid] = (tenant, self._seq)
            self._n += 1

    def push_front(self, req) -> None:
        with self._lock:
            self._front.appendleft(req)
            self._n += 1

    def _prune(self, tenant: str) -> None:
        h = self._heaps.get(tenant)
        while h and h[0][1] in self._dead:
            self._dead.discard(heapq.heappop(h)[1])

    def _select(self) -> Optional[str]:
        best = None
        for t in sorted(self._heaps):          # deterministic tiebreak
            self._prune(t)
            if not self._heaps[t]:
                continue
            s = max(self._tags.get(t, 0.0), self._v)
            if best is None or s < best[0]:
                best = (s, t)
        return None if best is None else best[1]

    def peek(self):
        """The request ``take`` would admit next (None when empty)."""
        with self._lock:
            if self._front:
                return self._front[0]
            t = self._select()
            return None if t is None else self._heaps[t][0][2]

    def take(self, req) -> None:
        """Remove exactly `req` (normally the last ``peek`` result) and,
        if it came through the fair queue, charge its tenant's tag."""
        with self._lock:
            for i, r in enumerate(self._front):
                if r.uid == req.uid:
                    del self._front[i]
                    self._n -= 1
                    return
            tenant, seq = self._entry.pop(req.uid)
            self._prune(tenant)
            h = self._heaps.get(tenant)
            if h and h[0][1] == seq:
                heapq.heappop(h)
            else:                              # displaced head: lazy-delete
                self._dead.add(seq)
            s = max(self._tags.get(tenant, 0.0), self._v)
            self._v = s
            self._tags[tenant] = s + 1.0 / self._weight(tenant)
            self._n -= 1

    def drop(self, uids) -> list:
        """Remove every queued entry whose uid is in `uids` (cancelled
        requests); returns the removed Request objects.  No tenant charge
        — cancelled-before-admission work consumed nothing."""
        out = []
        with self._lock:
            keep = deque()
            while self._front:
                r = self._front.popleft()
                (out if r.uid in uids else keep).append(r)
            self._front = keep
            for uid in list(uids):
                ent = self._entry.get(uid)
                if ent is None:
                    continue
                tenant, seq = self._entry.pop(uid)
                self._prune(tenant)
                h = self._heaps.get(tenant)
                if h and h[0][1] == seq:
                    out.append(heapq.heappop(h)[2])
                else:
                    for k, (_, sq, r) in enumerate(h or ()):
                        if sq == seq:
                            out.append(r)
                            h[k] = h[-1]
                            h.pop()
                            heapq.heapify(h)
                            break
            self._n -= len(out)
        return out

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0
