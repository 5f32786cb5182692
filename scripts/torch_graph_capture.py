#!/usr/bin/env python3
"""Capture the port's block-step graphs again and again on the card, and
count the captures that fail.

    python3 scripts/torch_graph_capture.py [--rounds 10] [--collector-on]

Each round serves seven requests through a tiny engine eagerly, then
through a graphed one (capturing its graphs), for three engines: vicuna-7b
sync, vicuna-7b continuous over a tight paged pool, and mamba2-370m
continuous.  Each engine is left in a reference cycle (as a caller's
bookkeeping may leave it, say a wrapper of one of its methods), so only
the cyclic garbage collector frees it and its graphs.  By default the
captures run as ``core.graphs`` runs them, with the collector held off;
``--collector-on`` lets it run during the capture instead, where a
collection can destroy an earlier round's graph inside the capture.
Prints the captures made, the failures and where each was raised.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CELLS = {
    "vicuna_sync": ("vicuna-7b", dict(scheduler="sync", batch_size=3, max_new=16,
                                      buckets=(8, 16))),
    "vicuna_paged": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                       cache_len=40, kv_pages=14, kv_page_size=4,
                                       sync_every=3)),
    "mamba2_continuous": ("mamba2-370m", dict(scheduler="continuous", num_slots=3,
                                              max_new=16, cache_len=64, sync_every=3)),
}


def serve(name: str, kw: dict, graphs_on: bool):
    from repro_torch.configs import get_config
    from repro_torch.core import lora, online
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(name, tiny=True)
    if name == "vicuna-7b":
        cfg = cfg.replace(dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    rng = np.random.default_rng(0)
    eng = ServingEngine(model, params, online.init_trainer(model, dvi_params=dvi),
                        graphs=graphs_on, learn=False, **kw)
    eng.warmup()
    for i in range(7):
        eng.submit_request(Request(i, rng.integers(2, cfg.vocab_size,
                                                   size=int(rng.choice([6, 9, 12])))
                                   .astype(np.int32), max_new=int(rng.choice([6, 10, 16]))))
    eng.run(max_steps=1000)
    eng.cycle = eng
    return eng


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--collector-on", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_graph_capture: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import graphs
    if args.collector_on:
        def capture(graph, pool, fn):
            with torch.cuda.graph(graph, pool=pool):
                fn()
        graphs._cuda.capture = capture
    captures, fails = 0, []
    t0 = time.perf_counter()
    for rnd in range(args.rounds):
        for cell, (name, kw) in CELLS.items():
            serve(name, kw, False)
            try:
                eng = serve(name, kw, True)
                captures += eng.graph_stats()["captures"]
            except Exception as e:                       # report and go on
                where = [f"{os.path.basename(f.filename)}:{f.lineno}"
                         for f in traceback.extract_tb(e.__traceback__)[-3:]]
                fails.append((rnd, cell, str(e).splitlines()[0][:90], where))
                torch.cuda.synchronize()
    mode = "collector on during capture" if args.collector_on else "collector held off"
    print(f"{torch.cuda.get_device_name(0)}, {mode}: {captures} captures made, "
          f"{len(fails)} failed, {args.rounds} rounds in {time.perf_counter() - t0:.1f} s")
    for f in fails:
        print("  failed:", f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
