"""Unified serving + training telemetry: metrics registry and lifecycle tracer.

The port's copy of ``repro.serving.telemetry`` (standard library only), kept
line for line so the metric names stay the ones
``scripts/check_metrics_schema.py`` checks.

This module is the **normative schema reference** for the repo's
observability layer.  It provides three independent pieces that the
serving engine wires together:

1. A **metrics registry** (`MetricsRegistry`) of counters, gauges, and
   histograms with snapshot/delta semantics and Prometheus text-format
   rendering (`render_prometheus` / `parse_prometheus_text` round-trip).
   Histograms are log-bucketed for durations (`log_buckets`) and
   exact-integer-bucketed for discrete quantities (per-block accepted
   drafts, per-block speculation depth), so bucket counts reconcile
   EXACTLY with the flat counters they shadow.

2. A **lifecycle tracer** (`Tracer`) that emits Chrome-trace / Perfetto
   JSON ("trace event format", ``{"traceEvents": [...]}``).  Tracks map
   to decode lanes plus three synthetic tracks (queue / engine / train);
   spans are complete ``ph="X"`` events and point events are ``ph="i"``
   instants.  Open the output at https://ui.perfetto.dev (or
   chrome://tracing) — see ROADMAP "Observability".

3. `ServingTelemetry`: the canonical **metric declarations** for the
   serving engine — the single place the engine's legacy ``stats`` key
   set is defined (`StatsView` is a dict-compatible facade over the
   registry, so ``engine.stats["blocks"] += n`` keeps working while the
   registry is the source of truth, and ``reset_stats`` can never drift
   from the declaration table).

Metric namespace
----------------

``dvi_serving_*`` — scheduler / decode-path metrics:

=============================================  =========  =====================================
name                                           type       meaning
=============================================  =========  =====================================
dvi_serving_requests_total                     counter    completed requests
dvi_serving_blocks_total                       counter    per-live-lane speculative blocks
dvi_serving_steps_total                        counter    scheduler iterations (batch steps)
dvi_serving_committed_tokens_total             counter    tokens committed by the verifier
dvi_serving_accepted_drafts_total              counter    drafted tokens accepted
dvi_serving_drafted_tokens_total               counter    drafted tokens proposed
dvi_serving_preemptions_total                  counter    paged-pool preempt-or-queue events
dvi_serving_host_syncs_total                   counter    device->host syncs on the hot path
dvi_serving_sync_wait_seconds_total            counter    host time blocked on the device
dvi_serving_dispatches_total                   counter    superstep dispatches
dvi_serving_prefill_chunks_total               counter    batched prefill chunk steps
dvi_serving_prefill_tokens_total               counter    prompt tokens prefilled via chunks
dvi_serving_kv_watermark_hits_total            counter    admissions blocked on pool headroom
dvi_serving_prefix_lookups_total               counter    prefix-cache admission lookups
dvi_serving_prefix_hits_total                  counter    lookups matching >=1 cached token
dvi_serving_prefix_misses_total                counter    lookups matching nothing
                                                          (hits + misses == lookups, EXACT)
dvi_serving_prefix_hit_tokens_total            counter    prompt tokens skipped via cached
                                                          prefixes (>= hits when hits > 0)
dvi_serving_prefix_cow_copies_total            counter    copy-on-write page copies performed
                                                          at warm admission (<= hits)
dvi_serving_prefix_evictions_total             counter    cached pages lazily reclaimed (LRU)
dvi_serving_submitted_total                    counter    requests submitted (incl. rejected)
dvi_serving_cancelled_total                    counter    requests cancelled (any stage)
dvi_serving_rejected_total                     counter    submissions rejected (QueueFull)
dvi_serving_requests_by_tenant                 counter    per-tenant submissions, label
                                                          tenant="..." (values sum to
                                                          submitted_total, EXACT)
dvi_serving_peak_live_slots                    gauge      high-water concurrent lanes
dvi_serving_live_slots                         gauge      currently occupied lanes
dvi_serving_queue_depth                        gauge      requests waiting for a lane
dvi_serving_max_tick_prefill_tokens            gauge      largest single-tick prefill budget
dvi_serving_kv_used_pages                      gauge      pool pages live (refcount > 0)
dvi_serving_kv_free_pages                      gauge      pool pages free + evictable cached
dvi_serving_kv_cached_pages                    gauge      evictable prefix-cached pages
dvi_serving_depth_mean                         gauge      mean live-lane speculation depth
dvi_serving_request_latency_seconds            histogram  submit -> completion (log buckets)
dvi_serving_queue_wait_seconds                 histogram  submit -> first admission
dvi_serving_ttft_seconds                       histogram  submit -> first committed token
dvi_serving_tick_seconds                       histogram  engine tick wall time (log buckets)
dvi_serving_sync_wait_seconds                  histogram  per-harvest device wait (log buckets)
dvi_serving_block_accepted_drafts              histogram  PER-BLOCK accepted drafted tokens m
                                                          (exact integer buckets 0..k_max;
                                                          count==blocks_total,
                                                          sum==accepted_drafts_total)
dvi_serving_block_depth                        histogram  PER-BLOCK speculation depth k
                                                          (exact integer buckets;
                                                          count==blocks_total,
                                                          sum==drafted_tokens_total)
=============================================  =========  =====================================

The two per-block histograms are folded from the continuous superstep
harvest; under the legacy sync scheduler (no superstep dispatches) they
stay empty, and the reconciliation identities above apply only when
``dvi_serving_dispatches_total > 0`` (enforced by
``scripts/check_metrics_schema.py``).

``dvi_train_*`` — DVI drafter training-loop metrics (the paper's
feedback loop made measurable):

=============================================  =========  =====================================
dvi_train_updates_total                        counter    optimizer steps taken
dvi_train_step                                 gauge      optimizer step t (drives KL->RL)
dvi_train_phase                                gauge      0=warmup 1=ramp 2=rl (schedule phase)
dvi_train_lambda_pg / dvi_train_lambda_kl      gauge      KL->RL schedule weights at t
dvi_train_beta                                 gauge      on-policy KL coefficient beta(t)
dvi_train_loss                                 gauge      last composite loss
dvi_train_loss_kl                              gauge      KL(p_theta || p_phi^tau) term
dvi_train_loss_ce                              gauge      reward-masked CE term (L_pg)
dvi_train_loss_pg                              gauge      on-policy policy-gradient term
dvi_train_acceptance_batch                     gauge      minibatch acceptance rate
dvi_train_acceptance_ema_before / _after       gauge      reward-EMA baseline around the update
dvi_train_buffer_count                         gauge      replay-buffer occupancy (tuples)
dvi_train_gnorm                                gauge      LoRA grad norm of the last update
dvi_train_update_span_seconds                  histogram  dispatch -> fold staleness window
=============================================  =========  =====================================

The zero-host-sync contract
---------------------------

Telemetry must never add a device->host synchronization to the serving
hot path.  Every device-side observation (per-block histogram buckets,
training-loss components) rides the compact summary the engine ALREADY
materializes once per superstep (the one packed device-to-host copy in ``_harvest``) —
in-graph counters are folded into ``SuperstepResult`` and update metrics
are staged at fold time and materialized inside the NEXT harvest's
device_get.  Host-side work (registry increments, trace events) uses the
engine's injected monotonic clock and host mirrors only.  Enforced by
``tests/test_telemetry.py``: with telemetry on, committed streams are
bit-identical and ``host_syncs`` is unchanged.
"""
from __future__ import annotations

import bisect
import json
import math
import time
from collections import deque
from collections.abc import MutableMapping
from typing import Callable, Dict, List, Optional, Sequence


# ---------------------------------------------------------------------------
# metrics: counters, gauges, log/exact-bucketed histograms
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic accumulator.  ``set`` exists only for the legacy
    ``stats["key"] += n`` facade (read-modify-write) and for resets."""
    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self.value = 0

    def inc(self, v=1):
        self.value += v

    def set(self, v):
        self.value = v

    def reset(self):
        self.value = 0

    def to_snapshot(self) -> dict:
        return {"type": "counter", "help": self.help, "value": self.value}


class Gauge(Counter):
    """Point-in-time value (may go down)."""
    kind = "gauge"

    def set_max(self, v):
        self.value = max(self.value, v)

    def to_snapshot(self) -> dict:
        return {"type": "gauge", "help": self.help, "value": self.value}


class LabeledCounter:
    """Counter with ONE label dimension (e.g. ``tenant``): a dict of
    monotone per-label-value series.  The snapshot carries both the
    per-label ``values`` map and their total under ``value`` so scrapers
    that only understand flat counters still see the aggregate; the
    schema checker asserts the per-tenant values sum to
    ``dvi_serving_submitted_total`` exactly."""
    kind = "counter"

    def __init__(self, name: str, help: str, label: str):
        self.name, self.help, self.label = name, help, label
        self.values: Dict[str, float] = {}

    @property
    def value(self):
        return sum(self.values.values())

    def inc(self, label_value: str, v=1):
        self.values[label_value] = self.values.get(label_value, 0) + v

    def reset(self):
        self.values = {}

    def to_snapshot(self) -> dict:
        return {"type": "counter", "help": self.help, "label": self.label,
                "values": dict(self.values), "value": self.value}


def log_buckets(lo: float, hi: float, base: float = 2.0) -> List[float]:
    """Geometric bucket upper bounds from `lo` to >= `hi` (for durations:
    resolution proportional to magnitude, O(log(hi/lo)) buckets)."""
    if not (lo > 0 and hi > lo and base > 1):
        raise ValueError(f"need 0 < lo < hi and base > 1, got "
                         f"({lo}, {hi}, {base})")
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= base
    out.append(b)
    return out


class Histogram:
    """Prometheus-style histogram: per-bucket counts + sum + count.

    `buckets`: ascending upper bounds (a "+Inf" bucket is implicit).  Use
    ``observe`` for continuous values and ``add`` to fold exact integer
    bucket counts (e.g. the superstep's in-graph per-block histograms) —
    ``add(value, n)`` keeps ``sum`` exact, so the histogram reconciles
    to the flat counter it shadows with no rounding."""
    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Sequence[float]):
        bs = list(buckets)
        if bs != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             f"ascending, got {bs}")
        self.name, self.help = name, help
        self.bounds = bs                       # upper bounds, +Inf implicit
        self.counts = [0] * (len(bs) + 1)      # last slot = overflow (+Inf)
        self.sum = 0
        self.count = 0

    def observe(self, v, n: int = 1):
        self.counts[bisect.bisect_left(self.bounds, v)] += n
        self.sum += v * n
        self.count += n

    def add(self, value, n: int):
        """Fold `n` pre-counted observations of exact `value`."""
        if n:
            self.observe(value, n)

    def reset(self):
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0
        self.count = 0

    def to_snapshot(self) -> dict:
        cum, c = [], 0
        for b, n in zip(self.bounds + ["+Inf"], self.counts):
            c += n
            cum.append([b, c])
        return {"type": "histogram", "help": self.help, "buckets": cum,
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Named metrics with snapshot/delta semantics and Prometheus text
    rendering.  One flat namespace; re-registering a name is an error."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = ()) -> Histogram:
        return self._register(Histogram(name, help, buckets))

    def labeled_counter(self, name: str, help: str = "",
                        label: str = "tenant") -> LabeledCounter:
        return self._register(LabeledCounter(name, help, label))

    def _register(self, m):
        if m.name in self._metrics:
            raise ValueError(f"metric {m.name!r} already registered")
        self._metrics[m.name] = m
        return m

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self):
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> dict:
        """JSON-able point-in-time view of every metric."""
        return {n: self._metrics[n].to_snapshot() for n in self.names()}

    def render_prometheus(self) -> str:
        return render_prometheus(self.snapshot())


def snapshot_delta(cur: dict, prev: dict) -> dict:
    """Counter/histogram difference between two snapshots (gauges keep the
    current value — a gauge has no meaningful rate)."""
    out = {}
    for name, c in cur.items():
        p = prev.get(name)
        if p is None or c["type"] == "gauge":
            out[name] = dict(c)
        elif c["type"] == "counter":
            out[name] = dict(c, value=c["value"] - p["value"])
            if "values" in c:
                pv = p.get("values", {})
                out[name]["values"] = {k: v - pv.get(k, 0)
                                       for k, v in c["values"].items()}
        else:
            pb = {tuple([b]): n for b, n in p["buckets"]}
            out[name] = dict(
                c, sum=c["sum"] - p["sum"], count=c["count"] - p["count"],
                buckets=[[b, n - pb.get(tuple([b]), 0)]
                         for b, n in c["buckets"]])
    return out


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


def _unescape_label(v: str) -> str:
    return v.replace(r"\n", "\n").replace(r'\"', '"').replace(r"\\", "\\")


def render_prometheus(snapshot: dict) -> str:
    """Prometheus exposition text format (round-trips through
    ``parse_prometheus_text``)."""
    lines = []
    for name in sorted(snapshot):
        m = snapshot[name]
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        if m["type"] in ("counter", "gauge"):
            if "values" in m:                  # one-label counter series
                lab = m.get("label", "tenant")
                for lv in sorted(m["values"]):
                    lines.append(f'{name}{{{lab}="{_escape_label(lv)}"}} '
                                 f'{_fmt(m["values"][lv])}')
            else:
                lines.append(f"{name} {_fmt(m['value'])}")
        else:
            for b, cum in m["buckets"]:
                le = "+Inf" if b == "+Inf" else _fmt(b)
                lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{name}_sum {_fmt(m['sum'])}")
            lines.append(f"{name}_count {m['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser: returns the same snapshot shape
    ``MetricsRegistry.snapshot`` produces (numbers parsed back as
    int where exact).  Used by the round-trip test and as a reference
    for scrapers."""
    def num(s):
        f = float(s)
        return int(f) if f == int(f) and "inf" not in s.lower() else f

    out: dict = {}
    types: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            out[name] = ({"type": kind, "help": out.get(name, {}).get("help", ""),
                          "buckets": [], "sum": 0, "count": 0}
                         if kind == "histogram"
                         else {"type": kind,
                               "help": out.get(name, {}).get("help", ""),
                               "value": 0})
            continue
        if line.startswith("# HELP "):
            _, _, name, help_ = line.split(None, 3)
            out.setdefault(name, {})["help"] = help_
            continue
        if line.startswith("#"):
            continue
        key, val = line.rsplit(None, 1)
        if key.endswith('"}') and "_bucket{le=" in key:
            base = key[:key.index("_bucket{")]
            le = key[key.index('le="') + 4:-2]
            out[base]["buckets"].append(
                ["+Inf" if le == "+Inf" else num(le), num(val)])
        elif key.endswith('"}') and "{" in key:
            base = key[:key.index("{")]
            lab, _, lv = key[key.index("{") + 1:-2].partition('="')
            m = out[base]
            m["label"] = lab
            m.setdefault("values", {})[_unescape_label(lv)] = num(val)
            m["value"] = sum(m["values"].values())
        elif key.endswith("_sum") and key[:-4] in types \
                and types[key[:-4]] == "histogram":
            out[key[:-4]]["sum"] = num(val)
        elif key.endswith("_count") and key[:-6] in types \
                and types[key[:-6]] == "histogram":
            out[key[:-6]]["count"] = num(val)
        else:
            out[key]["value"] = num(val)
    return out


# ---------------------------------------------------------------------------
# legacy stats facade
# ---------------------------------------------------------------------------

class StatsView(MutableMapping):
    """dict-compatible facade over registry metrics plus rolling deques.

    ``view["blocks"]`` reads the bound metric's value; ``view["blocks"]
    = v`` writes it (so the engine's historical ``stats[k] += n``
    read-modify-write idiom keeps working); deque-valued entries
    (``latencies`` / ``tick_s`` / ``k_mean``) are returned as the live
    deque object.  The key set is fixed at construction — the canonical
    schema — so ad-hoc keys can no longer appear in one place and not
    another."""

    def __init__(self, metrics: Dict[str, object], deques: Dict[str, deque]):
        self._metrics = dict(metrics)
        self._deques = dict(deques)

    def __getitem__(self, k):
        if k in self._deques:
            return self._deques[k]
        return self._metrics[k].value

    def __setitem__(self, k, v):
        if k in self._deques:
            self._deques[k] = v
        elif k in self._metrics:
            self._metrics[k].set(v)
        else:
            raise KeyError(f"{k!r} is not a declared stats key "
                           f"(see ServingTelemetry)")

    def __delitem__(self, k):
        raise TypeError("stats keys are fixed by the telemetry schema")

    def __iter__(self):
        yield from self._metrics
        yield from self._deques

    def __len__(self):
        return len(self._metrics) + len(self._deques)

    def reset(self):
        for m in self._metrics.values():
            m.reset()
        for d in self._deques.values():
            d.clear()


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto lifecycle tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Collects Chrome trace events ("trace event format").  Timestamps
    are microseconds on the injected monotonic clock, zeroed at tracer
    construction.  ``span`` appends a complete ``ph="X"`` event (events
    may be appended out of order — viewers sort by ts), ``instant`` a
    point event.  The event list is capped; overflow increments
    ``dropped`` instead of growing without bound."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 process: str = "dvi-serving", limit: int = 200_000):
        self._clock = clock
        self._t0 = clock()
        self._limit = limit
        self.dropped = 0
        self.events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": process}}]

    def now(self) -> float:
        return self._clock()

    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _emit(self, ev: dict):
        if len(self.events) >= self._limit:
            self.dropped += 1
            return
        self.events.append(ev)

    def name_track(self, tid: int, name: str):
        self._emit({"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                    "args": {"name": name}})

    def span(self, tid: int, name: str, t0: float, t1: float,
             args: Optional[dict] = None, cat: str = "serving"):
        self._emit({"name": name, "ph": "X", "pid": 0, "tid": tid,
                    "cat": cat, "ts": self._ts(t0),
                    "dur": max(self._ts(t1) - self._ts(t0), 0.0),
                    "args": args or {}})

    def instant(self, tid: int, name: str, t: Optional[float] = None,
                args: Optional[dict] = None, cat: str = "serving"):
        self._emit({"name": name, "ph": "i", "pid": 0, "tid": tid,
                    "cat": cat, "ts": self._ts(t if t is not None
                                               else self.now()),
                    "s": "t", "args": args or {}})

    # request lifecycles are ASYNC event pairs (ph "b"/"e", grouped by
    # (cat, id)): unlike per-track X spans they may overlap freely —
    # many requests sit queued at once — and Perfetto renders each id as
    # its own async row.  Phases of one request (queued / prefill /
    # decode) share its id and nest within the outer "request" pair.
    def async_begin(self, name: str, id: int, t: Optional[float] = None,
                    args: Optional[dict] = None, cat: str = "request"):
        self._emit({"name": name, "ph": "b", "pid": 0, "tid": 0,
                    "cat": cat, "id": id,
                    "ts": self._ts(t if t is not None else self.now()),
                    "args": args or {}})

    def async_end(self, name: str, id: int, t: Optional[float] = None,
                  args: Optional[dict] = None, cat: str = "request"):
        self._emit({"name": name, "ph": "e", "pid": 0, "tid": 0,
                    "cat": cat, "id": id,
                    "ts": self._ts(t if t is not None else self.now()),
                    "args": args or {}})

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


def validate_trace(trace: dict) -> dict:
    """Schema-check a Chrome trace dict: required event keys, span
    durations, monotone span NESTING per track (two complete events on
    one track must either nest or be disjoint — a half-overlap means the
    emitting code attributed time to two phases at once), and balanced
    async begin/end pairing per (cat, id, name) with non-negative phase
    durations.  Returns ``{tid: [events]}`` grouped per track; raises
    ``ValueError`` on any violation."""
    evs = trace["traceEvents"]
    tracks: Dict[int, List[dict]] = {}
    opens: Dict[tuple, list] = {}
    for ev in evs:
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event missing {k!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"non-metadata event missing ts: {ev}")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"X event needs dur >= 0: {ev}")
        if ev["ph"] in ("b", "e"):
            if "id" not in ev:
                raise ValueError(f"async event needs id: {ev}")
            k = (ev.get("cat"), ev["id"], ev["name"])
            if ev["ph"] == "b":
                opens.setdefault(k, []).append(ev["ts"])
            else:
                if not opens.get(k):
                    raise ValueError(f"async end without begin: {k}")
                t0 = opens[k].pop()
                if ev["ts"] < t0:
                    raise ValueError(
                        f"async pair {k} ends before it begins "
                        f"({t0:.1f} -> {ev['ts']:.1f})")
        tracks.setdefault(ev["tid"], []).append(ev)
    dangling = [k for k, v in opens.items() if v]
    if dangling:
        raise ValueError(f"unclosed async pairs: {dangling}")
    eps = 1e-6
    for tid, track in tracks.items():
        spans = sorted((e for e in track if e["ph"] == "X"),
                       key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for e in spans:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack:
                enc = stack[-1]
                if e["ts"] + e["dur"] > enc["ts"] + enc["dur"] + eps:
                    raise ValueError(
                        f"track {tid}: span {e['name']!r} "
                        f"[{e['ts']:.1f}, {e['ts'] + e['dur']:.1f}] half-"
                        f"overlaps {enc['name']!r} "
                        f"[{enc['ts']:.1f}, {enc['ts'] + enc['dur']:.1f}]")
            stack.append(e)
    return tracks


# ---------------------------------------------------------------------------
# the serving engine's canonical metric declarations
# ---------------------------------------------------------------------------

# legacy stats key -> (metric name, kind, help).  THE schema: the engine's
# stats facade, reset_stats, and the Prometheus snapshot all derive from
# this one table, so the key sets cannot drift.
LEGACY_STATS = {
    "requests": ("dvi_serving_requests_total", "counter",
                 "completed requests"),
    "submitted": ("dvi_serving_submitted_total", "counter",
                  "requests submitted (accepted + rejected)"),
    "cancelled": ("dvi_serving_cancelled_total", "counter",
                  "requests cancelled at any lifecycle stage"),
    "rejected": ("dvi_serving_rejected_total", "counter",
                 "submissions rejected with QueueFull backpressure"),
    "blocks": ("dvi_serving_blocks_total", "counter",
               "per-live-lane speculative blocks"),
    "steps": ("dvi_serving_steps_total", "counter",
              "scheduler iterations (batch block-steps)"),
    "committed": ("dvi_serving_committed_tokens_total", "counter",
                  "tokens committed by the verifier"),
    "accepted": ("dvi_serving_accepted_drafts_total", "counter",
                 "drafted tokens accepted by the verifier"),
    "drafted": ("dvi_serving_drafted_tokens_total", "counter",
                "drafted tokens proposed"),
    "updates": ("dvi_train_updates_total", "counter",
                "drafter optimizer steps"),
    "preemptions": ("dvi_serving_preemptions_total", "counter",
                    "paged-pool preempt-or-queue events"),
    "host_syncs": ("dvi_serving_host_syncs_total", "counter",
                   "device->host syncs on the serving hot path"),
    "sync_wait_s": ("dvi_serving_sync_wait_seconds_total", "counter",
                    "host seconds blocked on device results"),
    "dispatches": ("dvi_serving_dispatches_total", "counter",
                   "superstep dispatches"),
    "prefill_chunks": ("dvi_serving_prefill_chunks_total", "counter",
                       "batched prefill chunk steps"),
    "prefill_tokens": ("dvi_serving_prefill_tokens_total", "counter",
                       "prompt tokens prefilled via chunk steps"),
    "prefix_lookups": ("dvi_serving_prefix_lookups_total", "counter",
                       "prefix-cache admission lookups"),
    "prefix_hits": ("dvi_serving_prefix_hits_total", "counter",
                    "prefix lookups matching >=1 cached token"),
    "prefix_misses": ("dvi_serving_prefix_misses_total", "counter",
                      "prefix lookups matching nothing"),
    "prefix_hit_tokens": ("dvi_serving_prefix_hit_tokens_total", "counter",
                          "prompt tokens skipped via cached prefixes"),
    "prefix_cow_copies": ("dvi_serving_prefix_cow_copies_total", "counter",
                          "copy-on-write page copies at warm admission"),
    "prefix_evictions": ("dvi_serving_prefix_evictions_total", "counter",
                         "prefix-cached pages lazily reclaimed (LRU)"),
    "peak_live_slots": ("dvi_serving_peak_live_slots", "gauge",
                        "high-water concurrent live lanes"),
    "max_tick_prefill_tokens": ("dvi_serving_max_tick_prefill_tokens",
                                "gauge",
                                "largest single-tick prefill token count"),
}

# rolling-deque stats keys (windowed raw observations for percentiles;
# each shadows a registry histogram fed at the same call sites)
DEQUE_STATS = ("latencies", "tick_s", "k_mean")

# lane/queue/engine/train track layout: lanes take tids [0, num_slots)
QUEUE_TRACK = "queue"
ENGINE_TRACK = "engine"
TRAIN_TRACK = "train"


class ServingTelemetry:
    """Registry + declared metrics + (optional) tracer for one engine.

    Everything here is host-side: the engine feeds it from its single
    per-superstep harvest and its injected monotonic clock.  Attributes
    are the declared metric objects (``h_*`` histograms, ``g_*`` gauges,
    ``c_*`` counters) so engine call sites stay cheap and explicit."""

    def __init__(self, num_slots: int, k_max: int, latency_window: int,
                 clock: Callable[[], float] = time.monotonic,
                 trace: bool = False, trace_limit: int = 200_000):
        self.registry = MetricsRegistry()
        reg = self.registry
        legacy = {key: (reg.counter(name, help) if kind == "counter"
                        else reg.gauge(name, help))
                  for key, (name, kind, help) in LEGACY_STATS.items()}
        deques = {k: deque(maxlen=latency_window) for k in DEQUE_STATS}
        self.stats = StatsView(legacy, deques)

        dur = log_buckets(1e-4, 64.0)          # 100us .. 64s log2 buckets
        self.h_latency = reg.histogram(
            "dvi_serving_request_latency_seconds",
            "request submit -> completion latency", dur)
        self.h_tick = reg.histogram(
            "dvi_serving_tick_seconds", "engine tick wall time", dur)
        self.h_sync_wait = reg.histogram(
            "dvi_serving_sync_wait_seconds",
            "per-harvest host wait on the device", dur)
        self.h_queue_wait = reg.histogram(
            "dvi_serving_queue_wait_seconds",
            "request submit -> first lane admission", dur)
        self.h_ttft = reg.histogram(
            "dvi_serving_ttft_seconds",
            "request submit -> first committed token", dur)
        self.c_tenant = reg.labeled_counter(
            "dvi_serving_requests_by_tenant",
            "requests submitted per tenant (values sum to submitted_total)",
            label="tenant")
        kb = list(range(k_max + 1))            # exact integer buckets 0..k
        self.h_block_accept = reg.histogram(
            "dvi_serving_block_accepted_drafts",
            "accepted drafted tokens per speculative block "
            "(count==blocks_total, sum==accepted_drafts_total)", kb)
        self.h_block_depth = reg.histogram(
            "dvi_serving_block_depth",
            "speculation depth per live block "
            "(count==blocks_total, sum==drafted_tokens_total)", kb)
        self.c_watermark = reg.counter(
            "dvi_serving_kv_watermark_hits_total",
            "admissions blocked on pool watermark/reserve headroom")
        self.g_live = reg.gauge("dvi_serving_live_slots",
                                "currently occupied lanes")
        self.g_queue = reg.gauge("dvi_serving_queue_depth",
                                 "requests waiting for a lane")
        self.g_kv_used = reg.gauge("dvi_serving_kv_used_pages",
                                   "pool pages live (refcount > 0)")
        self.g_kv_free = reg.gauge("dvi_serving_kv_free_pages",
                                   "pool pages free or evictable")
        self.g_kv_cached = reg.gauge("dvi_serving_kv_cached_pages",
                                     "evictable prefix-cached pages")
        self.g_depth_mean = reg.gauge(
            "dvi_serving_depth_mean", "mean live-lane speculation depth")

        self.g_step = reg.gauge("dvi_train_step",
                                "drafter optimizer step t")
        self.g_phase = reg.gauge("dvi_train_phase",
                                 "KL->RL schedule phase: 0=warmup 1=ramp 2=rl")
        self.g_lambda_pg = reg.gauge("dvi_train_lambda_pg",
                                     "policy-loss weight at step t")
        self.g_lambda_kl = reg.gauge("dvi_train_lambda_kl",
                                     "KL-distillation weight at step t")
        self.g_beta = reg.gauge("dvi_train_beta",
                                "on-policy KL coefficient beta(t)")
        self.g_loss = reg.gauge("dvi_train_loss", "last composite loss")
        self.g_loss_kl = reg.gauge("dvi_train_loss_kl",
                                   "KL(p_theta || p_phi^tau) component")
        self.g_loss_ce = reg.gauge("dvi_train_loss_ce",
                                   "reward-masked CE component (L_pg)")
        self.g_loss_pg = reg.gauge("dvi_train_loss_pg",
                                   "on-policy policy-gradient component")
        self.g_acc_batch = reg.gauge("dvi_train_acceptance_batch",
                                     "acceptance rate of the update minibatch")
        self.g_ema_before = reg.gauge(
            "dvi_train_acceptance_ema_before",
            "reward-EMA baseline entering the update")
        self.g_ema_after = reg.gauge(
            "dvi_train_acceptance_ema_after",
            "reward-EMA baseline after the update")
        self.g_buffer = reg.gauge("dvi_train_buffer_count",
                                  "replay-buffer occupancy (tuples)")
        self.g_gnorm = reg.gauge("dvi_train_gnorm",
                                 "LoRA grad norm of the last update")
        self.h_update_span = reg.histogram(
            "dvi_train_update_span_seconds",
            "drafter update dispatch -> fold staleness window", dur)

        self.tracer = Tracer(clock, limit=trace_limit) if trace else None
        if self.tracer is not None:
            for s in range(num_slots):
                self.tracer.name_track(s, f"lane {s}")
            self.tid_queue = num_slots
            self.tid_engine = num_slots + 1
            self.tid_train = num_slots + 2
            self.tracer.name_track(self.tid_queue, QUEUE_TRACK)
            self.tracer.name_track(self.tid_engine, ENGINE_TRACK)
            self.tracer.name_track(self.tid_train, TRAIN_TRACK)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()

    def write_metrics(self, path: str):
        """Write the snapshot as JSON (``*.json``) or Prometheus text."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.snapshot(), f, indent=1)
        else:
            with open(path, "w") as f:
                f.write(self.render_prometheus())
