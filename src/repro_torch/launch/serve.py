"""Serving launcher: continual-learning speculative serving demo.  Port of
``repro.launch.serve``.

Streams synthetic requests (optionally with a mid-run task-distribution
shift) through the port's ServingEngine and reports acceptance / MAT /
latency: the paper's deployment story end to end with a tiny backbone, on
the card unless ``--device cpu`` is given.

Engine knobs (scheduler, slots, paged KV, prefix cache, adaptive K,
telemetry, ...) come from the shared ``serving.config.EngineConfig`` flag
set; the backbone recipe (and ``--device``) from ``ModelSpec``, both shared
with ``launch.api_server`` and ``launch.load_gen``.  Launcher-specific
flags:

  --requests N       how many synthetic requests to stream
  --prompt-len L     synthetic prompt length (also the sync-path bucket)
  --shift-at N       switch task category after N requests (drift demo)
  --trace-out PATH   write the Chrome/Perfetto lifecycle trace
  --metrics-out PATH write the final metrics snapshot (.json or .prom)

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vicuna-7b --tiny \\
      --requests 64 --shift-at 32 --scheduler continuous --num-slots 8
"""
from __future__ import annotations

import argparse
import time

from repro_torch.serving.config import (EngineConfig, ModelSpec, build_engine,
                                        build_model_bundle)
from repro_torch.serving.engine import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--shift-at", type=int, default=0,
                    help="switch task category after N requests (drift demo)")
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome/Perfetto trace JSON here "
                         "(implies --telemetry)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot here (.json = "
                         "snapshot JSON, else Prometheus text format)")
    ModelSpec.add_args(ap)
    EngineConfig.add_args(ap, EngineConfig(max_new=24))
    args = ap.parse_args(argv)
    spec = ModelSpec.from_args(args)
    econf = EngineConfig.from_args(args)
    econf.bucket = args.prompt_len      # sync path: bucket == prompt length
    if args.trace_out:
        econf.telemetry = True

    cfg, model, params, tasks, state = build_model_bundle(spec)
    eng = build_engine(econf, model, params, state)
    t0 = time.monotonic()
    done, handles = [], []
    for i in range(args.requests):
        cat = "qa" if (not args.shift_at or i < args.shift_at) else "math"
        prompt = tasks.sample(cat, 1, args.prompt_len, seed=1000 + i)[0]
        handles.append(eng.submit_request(
            Request(uid=i, prompt=prompt, max_new=econf.max_new)))
        if (i + 1) % econf.batch_size == 0:
            done.extend(eng.step())
            mat = done[-1].mat if done else 0.0
            print(f"[serve] {i+1:4d} reqs  acceptance={eng.acceptance:.3f} "
                  f"MAT={mat:.2f}  updates={eng.stats['updates']}")
    done.extend(eng.run())
    dt = time.monotonic() - t0
    toks = sum(len(c.gen_tokens) for c in done)
    lat = eng.latency_percentiles()
    print(f"[serve] {len(done)} completions, {toks} gen tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s); final acceptance={eng.acceptance:.3f}; "
          f"latency p50={lat['p50_s']:.2f}s p95={lat['p95_s']:.2f}s")
    # handle timestamps split each request's wall time into phases (the
    # old Completion.latency_s only had the lump sum)
    spans = [h.timings() for h in handles if h.finished]
    if spans:
        n = len(spans)
        mean = lambda k: sum(s[k] or 0.0 for s in spans) / n  # noqa: E731
        print(f"[serve] request phases (mean over {n}): "
              f"queue_wait={mean('queue_wait_s')*1e3:.0f}ms "
              f"prefill={mean('prefill_s')*1e3:.0f}ms "
              f"decode={mean('decode_s')*1e3:.0f}ms "
              f"ttft={mean('ttft_s')*1e3:.0f}ms "
              f"e2e={mean('e2e_s')*1e3:.0f}ms")
    if econf.scheduler == "continuous":
        d = eng.dispatch_stats()
        print(f"[serve] dispatch: sync_every={d['sync_every']} "
              f"host_syncs/100blk={d['host_syncs_per_100_blocks']:.1f} "
              f"host_wait={d['host_wait_s']:.2f}s "
              f"dispatches={d['dispatches']}")
        if econf.prefill_chunk:
            tk = eng.tick_percentiles()
            print(f"[serve] chunked prefill: chunk={d['prefill_chunk']} "
                  f"chunk_steps={d['prefill_chunks']} "
                  f"prefill_tokens={d['prefill_tokens']} "
                  f"max_tick_prefill_tokens={d['max_tick_prefill_tokens']} "
                  f"tick p50={tk['p50_s']*1e3:.0f}ms "
                  f"p95={tk['p95_s']*1e3:.0f}ms max={tk['max_s']*1e3:.0f}ms")
    if econf.kv_pages:
        kv = eng.kv_stats()
        print(f"[serve] paged KV: peak_util={kv['peak_utilization']:.2f} "
              f"preemptions={kv['preemptions']} "
              f"peak_live={kv['peak_live_slots']}")
        if econf.prefix_cache:
            print(f"[serve] prefix cache: hits={kv['prefix_hits']}/"
                  f"{kv['prefix_lookups']} lookups, "
                  f"tokens_spliced={kv['prefix_hit_tokens']} "
                  f"cow={eng.stats['prefix_cow_copies']} "
                  f"evictions={kv['prefix_evictions']} "
                  f"cached_pages={kv['cached_pages']} "
                  f"indexed={kv['indexed_pages']}")
    if econf.adaptive_k:
        ak = eng.adaptive_stats()
        print(f"[serve] adaptive K in [{ak['k_min']},{ak['k_max']}]: "
              f"mean_depth={ak['mean_depth']:.2f} "
              f"recent={ak['k_mean_recent']:.2f} "
              f"draft_efficiency={ak['draft_efficiency']:.2f} "
              f"k_lane={ak['k_lane'].tolist()}")
    if econf.learn and econf.scheduler == "continuous":
        tt = eng.train_telemetry()
        if tt["updates"]:
            print(f"[serve] DVI train: updates={tt['updates']} "
                  f"step={tt['step']} phase={tt['phase_name']} "
                  f"loss={tt['loss']:.4f} kl={tt['loss_kl']:.4f} "
                  f"ce={tt['loss_ce']:.4f} pg={tt['loss_pg']:.4f} "
                  f"acc_ema {tt['acceptance_ema_before']:.3f}->"
                  f"{tt['acceptance_ema_after']:.3f}")
    if args.trace_out:
        eng.write_trace(args.trace_out)
        print(f"[serve] trace written to {args.trace_out} "
              f"(open in Perfetto / chrome://tracing)")
    if args.metrics_out:
        eng.write_metrics(args.metrics_out)
        print(f"[serve] metrics written to {args.metrics_out}")


if __name__ == "__main__":
    main()
