"""llmperf-style open-loop load generator for the port's DVI API server.
The port's own copy of ``benchmarks/load_gen.py``, run as
``python -m repro_torch.launch.load_gen``.

Drives ``repro_torch.launch.api_server`` over HTTP with OPEN-LOOP arrivals —
requests fire on a Poisson (or bursty on/off) schedule regardless of how
fast the server drains, which is what exposes queueing collapse (a
closed loop self-throttles and hides it).  Per-request knobs are drawn
from a seeded RNG: lognormal prompt/output lengths (quantized to keep
the jit compile-cache small — admission prefill specializes per prompt
length), a weighted tenant mix, and a cancel fraction (the client closes
the SSE socket mid-stream; the server must cancel the lane and reclaim
its pages at the next superstep boundary).

Reports TTFT / TPOT / E2E p50/p95/p99, throughput, and goodput against
an SLO (completed requests meeting BOTH the TTFT and E2E bounds), plus
completed/cancelled/rejected/error counts per tenant.

``--verify-direct`` replays every finished prompt through an in-process
port engine built from the same ``ModelSpec`` (on the card unless
``--device cpu``) and hard-asserts the SSE token
streams are bit-identical (completed) or an exact prefix (cancelled).
The direct engine deliberately uses a DIFFERENT scheduler config than
the server: greedy committed streams are schedule/drafter/depth
independent (the engine's losslessness contract), so any mismatch is a
transport or engine bug, not nondeterminism.  Cross-process determinism
needs PYTHONHASHSEED pinned to the server's (the synthetic pretrain
stream salts per-step seeds with ``hash()``).

  # terminal 1
  PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.launch.api_server \\
      --port 8000 --tiny --max-queue 32
  # terminal 2
  PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.launch.load_gen \\
      --port 8000 --requests 64 --rate 8 --tenants gold:3,free:1 \\
      --cancel-fraction 0.15 --verify-direct

``--smoke`` shrinks everything to a tiny deterministic run.
"""
from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# workload synthesis
# ---------------------------------------------------------------------------

def arrival_times(n: int, rate: float, pattern: str,
                  rng: np.random.Generator) -> list:
    """Cumulative arrival offsets (s).  ``poisson``: exponential gaps at
    `rate` req/s.  ``bursty``: on/off modulation — bursts of 6 requests
    at 3x rate, gaps at 0.3x — same mean load, heavier queue tails."""
    t, out = 0.0, []
    for i in range(n):
        r = rate
        if pattern == "bursty":
            r = rate * (3.0 if (i // 6) % 2 == 0 else 0.3)
        t += float(rng.exponential(1.0 / max(r, 1e-6)))
        out.append(t)
    return out


def draw_len(rng: np.random.Generator, mean: float, sigma: float,
             lo: int, hi: int, quantum: int = 4) -> int:
    """Lognormal length, clamped to [lo, hi] and rounded to `quantum`
    (every distinct prompt length is a separate prefill jit
    specialization — the palette keeps compile count bounded)."""
    v = float(rng.lognormal(np.log(max(mean, 1.0)), sigma))
    v = int(max(lo, min(hi, v)))
    return max(lo, (v // quantum) * quantum)


def parse_mix(spec: str) -> dict:
    out = {}
    for part in spec.split(","):
        name, _, w = part.partition(":")
        out[name.strip()] = float(w) if w else 1.0
    return out


# ---------------------------------------------------------------------------
# one HTTP request (SSE streaming client)
# ---------------------------------------------------------------------------

def run_request(host: str, port: int, rec: dict, timeout: float) -> dict:
    """Stream one completion; fills `rec` with outcome + timings.  A
    ``cancel_after`` mark closes the socket once that many tokens
    arrived — the server notices on its next SSE write and cancels."""
    body = json.dumps({
        "prompt": rec["prompt"], "max_tokens": rec["max_new"],
        "stream": True, "user": rec["tenant"],
        "priority": rec.get("priority", 0)})
    t_sub = time.monotonic()
    rec.update(outcome="error", tokens=[], t_submit=t_sub,
               ttft_s=None, tpot_s=None, e2e_s=None, status=0)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        rec["status"] = resp.status
        if resp.status == 429:
            rec["outcome"] = "rejected"
            return rec
        if resp.status != 200:
            rec["error"] = resp.read(200).decode(errors="replace")
            return rec
        toks, t_first, t_last, finish = [], None, None, None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                break
            obj = json.loads(payload)
            if "error" in obj:
                rec["error"] = obj["error"].get("message", "?")
                return rec
            ch = obj["choices"][0]
            ids = ch.get("token_ids") or []
            if ids:
                now = time.monotonic()
                t_first = t_first if t_first is not None else now
                t_last = now
                toks.extend(ids)
            if ch.get("finish_reason"):
                finish = ch["finish_reason"]
            if (rec.get("cancel_after") is not None
                    and len(toks) >= rec["cancel_after"]):
                conn.close()
                rec.update(outcome="cancelled", tokens=toks,
                           finish_reason="client_closed")
                _fill_times(rec, t_first, t_last, toks)
                return rec
        rec.update(outcome="completed" if finish in ("stop", "length")
                   else ("cancelled" if finish == "cancelled" else "error"),
                   tokens=toks, finish_reason=finish)
        _fill_times(rec, t_first, t_last, toks)
        return rec
    except (OSError, http.client.HTTPException) as e:
        rec["error"] = repr(e)
        return rec
    finally:
        conn.close()


def _fill_times(rec: dict, t_first, t_last, toks) -> None:
    t_sub = rec["t_submit"]
    now = time.monotonic()
    if t_first is not None:
        rec["ttft_s"] = t_first - t_sub
        if len(toks) > 1 and t_last is not None and t_last > t_first:
            rec["tpot_s"] = (t_last - t_first) / (len(toks) - 1)
    rec["e2e_s"] = now - t_sub


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _pcts(vals: list) -> dict:
    xs = np.asarray([v for v in vals if v is not None], np.float64)
    if xs.size == 0:
        return {"p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0, "mean_s": 0.0,
                "count": 0}
    return {"p50_s": float(np.percentile(xs, 50)),
            "p95_s": float(np.percentile(xs, 95)),
            "p99_s": float(np.percentile(xs, 99)),
            "mean_s": float(np.mean(xs)), "count": int(xs.size)}


def build_report(args, recs: list, wall_s: float) -> dict:
    by = lambda o: [r for r in recs if r["outcome"] == o]  # noqa: E731
    completed = by("completed")
    gen_tokens = sum(len(r["tokens"]) for r in recs)
    good = [r for r in completed
            if r["ttft_s"] is not None and r["ttft_s"] <= args.slo_ttft
            and r["e2e_s"] is not None and r["e2e_s"] <= args.slo_e2e]
    tenants = {}
    for r in recs:
        t = tenants.setdefault(r["tenant"], {"submitted": 0, "completed": 0,
                                             "cancelled": 0, "rejected": 0,
                                             "error": 0})
        t["submitted"] += 1
        t[r["outcome"]] += 1
    return {
        "schema_version": SCHEMA_VERSION,
        "config": {
            "requests": args.requests, "rate": args.rate,
            "arrivals": args.arrivals, "tenants": args.tenants,
            "cancel_fraction": args.cancel_fraction,
            "slo_ttft_s": args.slo_ttft, "slo_e2e_s": args.slo_e2e,
            "workload_seed": args.workload_seed, "smoke": args.smoke,
        },
        "counts": {
            "submitted": len(recs), "completed": len(completed),
            "cancelled": len(by("cancelled")),
            "rejected": len(by("rejected")), "error": len(by("error")),
        },
        "wall_s": wall_s,
        "throughput_rps": len(completed) / max(wall_s, 1e-9),
        "gen_tokens": gen_tokens,
        "gen_tokens_per_s": gen_tokens / max(wall_s, 1e-9),
        "ttft": _pcts([r["ttft_s"] for r in completed]),
        "tpot": _pcts([r["tpot_s"] for r in completed]),
        "e2e": _pcts([r["e2e_s"] for r in completed]),
        "goodput": {
            "slo_ttft_s": args.slo_ttft, "slo_e2e_s": args.slo_e2e,
            "good_requests": len(good),
            "good_fraction": len(good) / max(len(completed), 1),
            "good_rps": len(good) / max(wall_s, 1e-9),
        },
        "tenants": tenants,
    }


def print_report(rep: dict) -> None:
    c = rep["counts"]
    print(f"[load] {c['submitted']} submitted: {c['completed']} completed, "
          f"{c['cancelled']} cancelled, {c['rejected']} rejected (429), "
          f"{c['error']} errors in {rep['wall_s']:.1f}s "
          f"({rep['gen_tokens_per_s']:.1f} tok/s)")
    for name in ("ttft", "tpot", "e2e"):
        p = rep[name]
        print(f"[load] {name:>4}: p50={p['p50_s']*1e3:8.1f}ms "
              f"p95={p['p95_s']*1e3:8.1f}ms p99={p['p99_s']*1e3:8.1f}ms "
              f"(n={p['count']})")
    g = rep["goodput"]
    print(f"[load] goodput: {g['good_requests']} requests within "
          f"SLO(ttft<={g['slo_ttft_s']}s, e2e<={g['slo_e2e_s']}s) = "
          f"{100 * g['good_fraction']:.1f}% of completed, "
          f"{g['good_rps']:.2f} req/s")
    for t, row in sorted(rep["tenants"].items()):
        print(f"[load] tenant {t!r}: {row}")


# ---------------------------------------------------------------------------
# engine-direct stream verification
# ---------------------------------------------------------------------------

def verify_direct(args, recs: list) -> dict:
    """Replay finished prompts through an in-process engine and compare
    token streams.  Greedy committed streams are schedule-independent, so
    the direct engine's config need not match the server's."""
    from repro_torch.serving.config import ModelSpec, build_model_bundle
    from repro_torch.serving.engine import Request, ServingEngine

    if os.environ.get("PYTHONHASHSEED") is None:
        print("[load] WARNING: PYTHONHASHSEED unset — the server and this "
              "process may have pretrained different params; pin it on "
              "both for --verify-direct", file=sys.stderr)
    spec = ModelSpec.from_args(args)
    print(f"[load] verify-direct: building {spec} ...", flush=True)
    _cfg, model, params, _tasks, state = build_model_bundle(spec)
    eng = ServingEngine(model, params, state, scheduler="continuous",
                        num_slots=4, max_new=args.output_max, learn=True,
                        sync_every=2)
    todo = [r for r in recs if r["outcome"] in ("completed", "cancelled")]
    handles = {}
    for i, r in enumerate(todo):
        handles[i] = eng.submit_request(Request(
            uid=i, prompt=np.asarray(r["prompt"], np.int32),
            max_new=r["max_new"]))
    eng.run(max_steps=100_000)
    mismatches = []
    for i, r in enumerate(todo):
        want = [int(t) for t in handles[i].tokens()]
        got = [int(t) for t in r["tokens"]]
        ok = (got == want if r["outcome"] == "completed"
              else got == want[:len(got)])   # cancelled: exact prefix
        if not ok:
            mismatches.append({"prompt": r["prompt"], "sse": got,
                               "direct": want, "outcome": r["outcome"]})
    out = {"checked": len(todo), "mismatches": len(mismatches),
           "detail": mismatches[:5]}
    if mismatches:
        print(f"[load] VERIFY FAILED: {len(mismatches)}/{len(todo)} "
              f"streams diverged from engine-direct decode",
              file=sys.stderr)
    else:
        print(f"[load] verify-direct: {len(todo)} streams bit-identical "
              f"to in-process decode")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="open-loop load generator")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrival rate, req/s (open loop)")
    ap.add_argument("--arrivals", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--prompt-mean", type=float, default=24.0)
    ap.add_argument("--prompt-sigma", type=float, default=0.5)
    ap.add_argument("--prompt-max", type=int, default=64)
    ap.add_argument("--output-mean", type=float, default=16.0)
    ap.add_argument("--output-sigma", type=float, default=0.4)
    ap.add_argument("--output-max", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=64,
                    help="prompt token ids drawn from [2, vocab)")
    ap.add_argument("--tenants", default="default:1",
                    help='traffic mix, e.g. "gold:3,free:1"')
    ap.add_argument("--cancel-fraction", type=float, default=0.0,
                    help="fraction of requests that close the socket "
                         "mid-stream (client-side cancel)")
    ap.add_argument("--slo-ttft", type=float, default=2.0)
    ap.add_argument("--slo-e2e", type=float, default=30.0)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--workload-seed", type=int, default=0,
                    help="arrivals/lengths/tenant-mix RNG (--seed is the MODEL seed)")
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny deterministic run")
    ap.add_argument("--verify-direct", action="store_true",
                    help="hard-assert SSE streams == in-process decode")
    from repro_torch.serving.config import ModelSpec
    ModelSpec.add_args(ap)
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 10)
        args.rate = max(args.rate, 20.0)
        args.prompt_mean, args.prompt_max = 12.0, 16
        args.output_mean, args.output_max = 8.0, 12
        if args.tenants == "default:1":
            args.tenants = "smoke-a:2,smoke-b:1"
        if args.cancel_fraction == 0.0:
            args.cancel_fraction = 0.2

    rng = np.random.default_rng(args.workload_seed)
    mix = parse_mix(args.tenants)
    names = sorted(mix)
    weights = np.asarray([mix[n] for n in names], np.float64)
    weights /= weights.sum()
    arrivals = arrival_times(args.requests, args.rate, args.arrivals, rng)
    recs = []
    for i in range(args.requests):
        plen = draw_len(rng, args.prompt_mean, args.prompt_sigma, 4,
                        args.prompt_max)
        maxn = draw_len(rng, args.output_mean, args.output_sigma, 4,
                        args.output_max, quantum=1)
        cancel = rng.random() < args.cancel_fraction
        recs.append({
            "idx": i, "at": arrivals[i],
            "prompt": [int(t) for t in
                       rng.integers(2, args.vocab, size=plen)],
            "max_new": maxn,
            "tenant": names[int(rng.choice(len(names), p=weights))],
            "cancel_after": (max(1, maxn // 3) if cancel else None),
        })

    print(f"[load] open-loop: {args.requests} requests @ {args.rate} req/s "
          f"({args.arrivals}), tenants={args.tenants}, "
          f"cancel_fraction={args.cancel_fraction}", flush=True)
    threads = []
    t0 = time.monotonic()
    for r in recs:
        delay = t0 + r["at"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=run_request,
                              args=(args.host, args.port, r, args.timeout))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = time.monotonic() - t0

    rep = build_report(args, recs, wall)
    print_report(rep)
    ok = rep["counts"]["completed"] > 0 and rep["counts"]["error"] == 0
    if args.verify_direct:
        rep["verify"] = verify_direct(args, recs)
        ok = ok and rep["verify"]["mismatches"] == 0
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"[load] report written to {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
