#!/usr/bin/env python
"""The PyTorch port's copy of ``scripts/check_metrics_schema.py``: the same
gate, importing ``repro_torch.serving.telemetry`` (the port's line-for-line
copy of the schema module, standard library only), so it runs where JAX is
not installed, as on the machine with the card.

Metrics-artifact schema gate: validate a telemetry snapshot and FAIL (exit
1) when the ``dvi_serving_*`` / ``dvi_train_*`` contract (the normative
reference is ``src/repro/serving/telemetry.py``'s docstring, copied in
``src/repro_torch/serving/telemetry.py``) is broken:

* a required metric is missing, or a metric's declared type is wrong,
* a counter or histogram carries a negative value,
* a histogram's cumulative bucket counts are not non-decreasing, its +Inf
  cumulative count != its ``count``, or ``count``/``sum`` are inconsistent
  with the buckets,
* the in-graph per-block histograms do not reconcile EXACTLY with the flat
  counters they shadow:
    - ``dvi_serving_block_accepted_drafts``: count == blocks_total,
      sum == accepted_drafts_total
    - ``dvi_serving_block_depth``: count == blocks_total,
      sum == drafted_tokens_total
  (integer identities — the histograms are computed inside the fused
  superstep and folded from the SAME device_get as the counters, so any
  drift means the zero-host-sync accounting is wrong, not "sampling
  noise"),
* the prefix-cache counters do not reconcile EXACTLY:
    - ``prefix_hits_total + prefix_misses_total == prefix_lookups_total``
      (every lookup is classified exactly once),
    - ``prefix_hit_tokens_total >= prefix_hits_total`` (a hit splices at
      least one token),
    - ``prefix_cow_copies_total <= prefix_hits_total`` (copy-on-write
      only ever rides a hit),
* the request-lifecycle counters do not reconcile EXACTLY (artifacts are
  written AFTER the engine drains, so no request may be unaccounted):
    - ``submitted_total == requests_total + cancelled_total +
      rejected_total + queue_depth + live_slots`` (every submission ends
      completed, cancelled, or rejected once the engine is idle),
    - the per-tenant label values of ``requests_by_tenant`` sum to
      ``submitted_total`` (every submission is attributed to exactly one
      tenant, including rejected ones).

Accepted inputs:

* a snapshot JSON written by ``--metrics-out foo.json``,
* a Prometheus text file written by ``--metrics-out foo.prom`` (any
  non-.json suffix),
* a full ``serving_bench.py --json`` artifact (schema v4: every arm's
  ``metrics`` snapshot is validated; drift artifacts validate each drift
  arm's snapshot).

Usage, on a port engine's ``write_metrics`` output:

  python scripts/torch_check_metrics_schema.py metrics.json
  python scripts/torch_check_metrics_schema.py metrics.prom
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.serving.telemetry import parse_prometheus_text  # noqa: E402

# (name, type) pairs every engine snapshot must expose, regardless of
# scheduler / paging / learning configuration — the registry declares the
# full schema up front so dashboards never see keys flicker in and out
REQUIRED = {
    "dvi_serving_requests_total": "counter",
    "dvi_serving_submitted_total": "counter",
    "dvi_serving_cancelled_total": "counter",
    "dvi_serving_rejected_total": "counter",
    "dvi_serving_requests_by_tenant": "counter",
    "dvi_serving_blocks_total": "counter",
    "dvi_serving_steps_total": "counter",
    "dvi_serving_committed_tokens_total": "counter",
    "dvi_serving_accepted_drafts_total": "counter",
    "dvi_serving_drafted_tokens_total": "counter",
    "dvi_serving_preemptions_total": "counter",
    "dvi_serving_host_syncs_total": "counter",
    "dvi_serving_sync_wait_seconds_total": "counter",
    "dvi_serving_dispatches_total": "counter",
    "dvi_serving_prefill_chunks_total": "counter",
    "dvi_serving_prefill_tokens_total": "counter",
    "dvi_serving_kv_watermark_hits_total": "counter",
    "dvi_serving_prefix_lookups_total": "counter",
    "dvi_serving_prefix_hits_total": "counter",
    "dvi_serving_prefix_misses_total": "counter",
    "dvi_serving_prefix_hit_tokens_total": "counter",
    "dvi_serving_prefix_cow_copies_total": "counter",
    "dvi_serving_prefix_evictions_total": "counter",
    "dvi_serving_peak_live_slots": "gauge",
    "dvi_serving_live_slots": "gauge",
    "dvi_serving_queue_depth": "gauge",
    "dvi_serving_max_tick_prefill_tokens": "gauge",
    "dvi_serving_kv_used_pages": "gauge",
    "dvi_serving_kv_free_pages": "gauge",
    "dvi_serving_kv_cached_pages": "gauge",
    "dvi_serving_depth_mean": "gauge",
    "dvi_serving_request_latency_seconds": "histogram",
    "dvi_serving_queue_wait_seconds": "histogram",
    "dvi_serving_ttft_seconds": "histogram",
    "dvi_serving_tick_seconds": "histogram",
    "dvi_serving_sync_wait_seconds": "histogram",
    "dvi_serving_block_accepted_drafts": "histogram",
    "dvi_serving_block_depth": "histogram",
    "dvi_train_updates_total": "counter",
    "dvi_train_step": "gauge",
    "dvi_train_phase": "gauge",
    "dvi_train_lambda_pg": "gauge",
    "dvi_train_lambda_kl": "gauge",
    "dvi_train_beta": "gauge",
    "dvi_train_loss": "gauge",
    "dvi_train_loss_kl": "gauge",
    "dvi_train_loss_ce": "gauge",
    "dvi_train_loss_pg": "gauge",
    "dvi_train_acceptance_batch": "gauge",
    "dvi_train_acceptance_ema_before": "gauge",
    "dvi_train_acceptance_ema_after": "gauge",
    "dvi_train_buffer_count": "gauge",
    "dvi_train_gnorm": "gauge",
    "dvi_train_update_span_seconds": "histogram",
}

# histogram -> (count must equal, sum must equal): the exact-integer
# reconciliation identities between the in-graph per-block histograms and
# the flat counters harvested from the same device_get
RECONCILE = {
    "dvi_serving_block_accepted_drafts": (
        "dvi_serving_blocks_total", "dvi_serving_accepted_drafts_total"),
    "dvi_serving_block_depth": (
        "dvi_serving_blocks_total", "dvi_serving_drafted_tokens_total"),
}


def check_snapshot(snap: dict, label: str) -> list:
    errs = []

    def err(msg):
        errs.append(f"[{label}] {msg}")

    for name, kind in REQUIRED.items():
        m = snap.get(name)
        if m is None:
            err(f"missing required metric {name}")
            continue
        if m.get("type") != kind:
            err(f"{name}: type {m.get('type')!r} != declared {kind!r}")

    for name, m in snap.items():
        kind = m.get("type")
        if kind == "counter":
            if m.get("value", 0) < 0:
                err(f"{name}: negative counter value {m['value']}")
            vals = m.get("values")
            if vals is not None:
                if any(v < 0 for v in vals.values()):
                    err(f"{name}: negative labeled counter value {vals}")
                if sum(vals.values()) != m.get("value", 0):
                    err(f"{name}: label values sum {sum(vals.values())} "
                        f"!= total {m.get('value', 0)}")
        elif kind == "histogram":
            buckets = m.get("buckets", [])
            if not buckets:
                err(f"{name}: histogram has no buckets")
                continue
            cums = [c for _, c in buckets]
            if any(c < 0 for c in cums) or m.get("count", 0) < 0:
                err(f"{name}: negative bucket/count")
            if any(a > b for a, b in zip(cums, cums[1:])):
                err(f"{name}: cumulative bucket counts decrease: {cums}")
            if buckets[-1][0] != "+Inf":
                err(f"{name}: last bucket bound is {buckets[-1][0]}, "
                    f"not +Inf")
            elif cums[-1] != m.get("count"):
                err(f"{name}: +Inf cumulative {cums[-1]} != count "
                    f"{m.get('count')}")

    # the per-block histograms are folded from the continuous superstep
    # harvest; the legacy sync scheduler never dispatches supersteps, so
    # there they must simply stay empty (dispatches_total == 0)
    superstep_ran = snap.get("dvi_serving_dispatches_total",
                             {}).get("value", 0) > 0
    for hname, (count_of, sum_of) in RECONCILE.items():
        h = snap.get(hname)
        if h is None or count_of not in snap or sum_of not in snap:
            continue                         # missing keys reported above
        if not superstep_ran:
            if h["count"] != 0:
                err(f"{hname}: nonzero count {h['count']} with no "
                    f"superstep dispatches")
            continue
        if h["count"] != snap[count_of]["value"]:
            err(f"{hname}: count {h['count']} != "
                f"{count_of} {snap[count_of]['value']}")
        if h["sum"] != snap[sum_of]["value"]:
            err(f"{hname}: sum {h['sum']} != "
                f"{sum_of} {snap[sum_of]['value']}")

    # prefix-cache counter identities (exact — every acquire_prefix call
    # increments lookups and EXACTLY ONE of hits/misses): hits + misses ==
    # lookups; a hit splices at least one token (hit_tokens >= hits); a COW
    # copy only ever rides a hit (cow_copies <= hits)
    def cval(name):
        m = snap.get(name)
        return None if m is None else m.get("value", 0)

    lookups = cval("dvi_serving_prefix_lookups_total")
    hits = cval("dvi_serving_prefix_hits_total")
    misses = cval("dvi_serving_prefix_misses_total")
    hit_toks = cval("dvi_serving_prefix_hit_tokens_total")
    cows = cval("dvi_serving_prefix_cow_copies_total")
    if None not in (lookups, hits, misses):
        if hits + misses != lookups:
            err(f"prefix counters do not reconcile: hits {hits} + misses "
                f"{misses} != lookups {lookups}")
        if hit_toks is not None and hit_toks < hits:
            err(f"prefix_hit_tokens {hit_toks} < prefix_hits {hits} "
                f"(every hit splices >= 1 token)")
        if cows is not None and cows > hits:
            err(f"prefix_cow_copies {cows} > prefix_hits {hits} "
                f"(COW only rides a hit)")

    # request-lifecycle reconciliation: artifacts are written after the
    # engine drains, so every submission must be accounted for — completed
    # (requests_total), cancelled, rejected, or still parked in the queue /
    # a live lane (both zero when drained; kept in the identity so the
    # check is also meaningful on mid-run snapshots)
    submitted = cval("dvi_serving_submitted_total")
    completed = cval("dvi_serving_requests_total")
    cancelled = cval("dvi_serving_cancelled_total")
    rejected = cval("dvi_serving_rejected_total")
    qdepth = (snap.get("dvi_serving_queue_depth") or {}).get("value")
    live = (snap.get("dvi_serving_live_slots") or {}).get("value")
    if None not in (submitted, completed, cancelled, rejected, qdepth, live):
        accounted = completed + cancelled + rejected + qdepth + live
        if submitted != accounted:
            err(f"lifecycle counters do not reconcile: submitted "
                f"{submitted} != completed {completed} + cancelled "
                f"{cancelled} + rejected {rejected} + queue_depth "
                f"{qdepth} + live_slots {live} = {accounted}")
        tenants = (snap.get("dvi_serving_requests_by_tenant") or
                   {}).get("values")
        if tenants is not None and sum(tenants.values()) != submitted:
            err(f"requests_by_tenant values {tenants} sum to "
                f"{sum(tenants.values())} != submitted_total {submitted}")
    return errs


def extract_snapshots(path: str) -> dict:
    """{label: snapshot} from a snapshot JSON / Prometheus text / bench
    artifact."""
    if not path.endswith(".json"):
        with open(path) as f:
            return {path: parse_prometheus_text(f.read())}
    with open(path) as f:
        doc = json.load(f)
    if "arms" in doc and isinstance(doc["arms"], list):      # bench artifact
        return {a["scheduler"]: a["metrics"] for a in doc["arms"]
                if "metrics" in a}
    if "drift" in doc:                                       # drift artifact
        return {f"drift:{k}": v["metrics"]
                for k, v in doc["drift"]["arms"].items() if "metrics" in v}
    return {path: doc}                                       # bare snapshot


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact", help="metrics snapshot (.json / Prometheus "
                                     "text) or serving_bench --json output")
    args = ap.parse_args()

    snaps = extract_snapshots(args.artifact)
    if not snaps:
        raise SystemExit(f"{args.artifact}: no metrics snapshots found "
                         f"(pre-v4 bench artifact?)")
    errs = []
    for label, snap in snaps.items():
        errs.extend(check_snapshot(snap, label))
    for e in errs:
        print(f"FAIL: {e}")
    if errs:
        raise SystemExit(1)
    print(f"OK: {len(snaps)} snapshot(s) in {args.artifact} conform to the "
          f"dvi_serving_*/dvi_train_* schema "
          f"({len(REQUIRED)} required metrics, per-block histograms "
          f"reconcile exactly)")


if __name__ == "__main__":
    main()
