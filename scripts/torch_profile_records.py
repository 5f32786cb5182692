#!/usr/bin/env python3
"""chip_smoke.py's profile reader, ``device_events`` (the device records of
a torch.profiler run, read from its Kineto records), held against the
profiler's own FunctionEvents (``prof.events()``) on one profile of mixed
device work: 2000 eager product + add + sum triples, four host copies and
50 replays of a CUDA graph of 200 product + add pairs.

    python3 scripts/torch_profile_records.py

Prints the records each reader saw and its host seconds, the device busy ms
both give (``covered_ms``), and each kernel's count and summed microseconds
side by side; exits 1 unless every name's count is equal, its time within
0.1 % + 1 us, and the busy ms within 0.1 % + 0.01 ms.  Needs one card.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def by_name(items) -> dict:
    """{name: (count, summed us)} of (name, us) pairs."""
    out: dict = {}
    for name, us in items:
        n, total = out.get(name, (0, 0.0))
        out[name] = (n + 1, total + us)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_records: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    print(cs.card_line(), flush=True)
    x = torch.randn(256, 256, device="cuda")
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            (x @ x).add_(1)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(200):
            (x @ x).add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(2000):
            z = x @ x
            z.add_(1)
            z.sum()
            if i % 500 == 0:
                z.cpu()
        for _ in range(50):
            graph.replay()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = cs.device_events(prof)
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    t_evs = time.perf_counter() - t0
    a = by_name((name, end - start) for name, start, end in raw)
    b = by_name((e.name, e.time_range.elapsed_us()) for e in evs)
    ok = a.keys() == b.keys() and all(a[k][0] == b[k][0]
                                      and abs(a[k][1] - b[k][1]) <= 1e-3 * b[k][1] + 1
                                      for k in a)
    busy_a = cs.covered_ms([(start, end) for _, start, end in raw])
    busy_b = cs.covered_ms([(e.time_range.start, e.time_range.end) for e in evs])
    ok = ok and abs(busy_a - busy_b) <= 1e-3 * busy_b + 0.01
    print(f"records {len(raw)} (device_events) / {len(evs)} (prof.events()); host seconds "
          f"{t_raw:.3f} / {t_evs:.3f}; device busy ms {busy_a:.4f} / {busy_b:.4f}; agree: {ok}")
    for k in sorted(b):
        print(f"  {k[:70]}: {a.get(k)} / {b[k]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
