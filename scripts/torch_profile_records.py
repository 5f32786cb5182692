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

    python3 scripts/torch_profile_records.py --stress [--burn P]
    python3 scripts/torch_profile_records.py --engine n [--burn P]

look for the profiler's lost records.  ``--stress`` profiles 150 replays
of a CUDA graph of 3776 small kernels (a fill that marks the replay, then a
tensor's add_ and mul_ in turn, about 2 us each: graph replay's dense
launch rate) 6 times bare and 6 times primed (one more replay at each end
of the window, as chip_smoke.py's ``profile_batch`` primes each graph), in
turn, and prints the records each profile saw against the launches in its
window, the share lost, the replay marks seen and the replays short of
records (which of them lost how many: 0 and the last are the primed ones),
the largest gap between consecutive records and the profile's wall
seconds.  ``--engine`` builds
vicuna-7b at full size and runs chip_smoke.py's phase 8 profile
(``profile_batch``, primed: its 16 requests once more on the graphed
continuous engine over the ample pool) n times, printing the records each
saw against ``ops.launches``.  ``--burn P`` keeps P processes spinning on
the host's cores during each profile (the host of a shared machine is
busy).  Both print CUPTI's device buffer attributes and its count of
dropped records.  Exit 1 if a profile missed more than chip_smoke.py's
gate allows: 10 % of the launches besides the primed ones.
"""
from __future__ import annotations

import argparse
import os
import subprocess
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


# CUPTI's activity attributes (cupti_activity.h, CUpti_ActivityAttribute)
CUPTI_ATTRS = {"device_buffer_size": 0, "device_buffer_pool_limit": 2,
               "device_buffer_pre_allocate": 6}


def cupti_lib():
    """The libcupti the profiler loaded (Kineto loads it at its first
    profile), through ctypes; one tiny profile first if it is not loaded."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    def loaded():
        with open("/proc/self/maps") as f:
            return next((line.split()[-1] for line in f if "libcupti" in line), None)
    if loaded() is None:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    path = loaded()
    if path is None:
        raise RuntimeError("the profiler loaded no libcupti")
    lib = ctypes.CDLL(path)
    size_p, vp = ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p
    for fn, args in (("cuptiActivityGetAttribute", [ctypes.c_int, size_p, vp]),
                     ("cuptiActivityGetNumDroppedRecords", [vp, ctypes.c_uint32, size_p])):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, ctypes.c_int
    return lib


def cupti_attributes() -> dict:
    """CUPTI's device buffer attributes, read back."""
    import ctypes
    lib, out = cupti_lib(), {}
    for name, attr in CUPTI_ATTRS.items():
        size, value = ctypes.c_size_t(8), ctypes.c_size_t(0)
        err = lib.cuptiActivityGetAttribute(attr, ctypes.byref(size), ctypes.byref(value))
        out[name] = value.value if err == 0 else f"error {err}"
    return out


def cupti_dropped() -> int:
    """CUPTI's count of activity records it dropped (all contexts)."""
    import ctypes
    n = ctypes.c_size_t(0)
    err = cupti_lib().cuptiActivityGetNumDroppedRecords(None, 0, ctypes.byref(n))
    return n.value if err == 0 else -err


class Burn:
    """P host processes spinning while the block runs."""

    def __init__(self, procs: int):
        self.procs, self.live = procs, []

    def __enter__(self):
        self.live = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                     for _ in range(self.procs)]
        return self

    def __exit__(self, *exc):
        for p in self.live:
            p.kill()
            p.wait()
        return False


# the stress graph's kernels, its replays a profile, and the profiles of
# each kind (bare, primed)
NODES, REPLAYS, REPEATS = 3776, 150, 6


def stress(burn: int) -> int:
    """Kernel records that profiles of REPLAYS replays of a graph of NODES
    kernels saw, bare and primed in turn."""
    from torch.profiler import ProfilerActivity, profile
    x, mark = torch.zeros(4096, device="cuda"), torch.zeros(1, device="cuda")
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
        x.mul_(0.5)
        mark.fill_(0.0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):          # a fill kernel marks each replay's start
        mark.fill_(0.0)
        for i in range(NODES - 1):
            x.add_(1.0) if i % 2 == 0 else x.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    worst = 0
    for rep in range(2 * REPEATS):
        primed = rep % 2 == 1
        replays = REPLAYS + 2 * primed
        with Burn(burn):
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(replays):
                    graph.replay()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        raw = sorted(cs.device_events(prof), key=lambda e: e[1])
        seen = len(raw)
        gap = max((b[1] - a[2] for a, b in zip(raw, raw[1:])), default=0.0)
        lost = NODES * replays - seen
        worst = max(worst, lost)
        # records between consecutive replay marks: where the lost ones were
        marks = [i for i, (name, _, _) in enumerate(raw) if "fill" in name.lower()]
        per = [b - a for a, b in zip(marks, marks[1:] + [len(raw)])]
        short = [(i, NODES - n) for i, n in enumerate(per) if n != NODES]
        print(f"stress run {rep // 2} ({'primed' if primed else 'bare'}, burn {burn}): "
              f"device records {seen} of {NODES * replays} launched, lost {lost} "
              f"({100 * lost / (NODES * REPLAYS):.2f} % of the {REPLAYS} counted replays'), "
              f"largest gap {gap:.1f} us, {wall:.2f} s; replay marks seen {len(marks)} of "
              f"{replays}; replays short of "
              f"records (index, records lost) {short[:12]}{' ...' if len(short) > 12 else ''}; "
              f"CUPTI dropped {cupti_dropped()}", flush=True)
        del prof, raw
    return 1 if worst > NODES * REPLAYS // 10 else 0


def engine(repeats: int, burn: int) -> int:
    """chip_smoke.py's phase 8 profile of the graphed continuous path,
    `repeats` times; the records it missed each time."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.build_all()
    cfg = get_config("vicuna-7b")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device="cuda") * 0.05
    reqs = cs.continuous_requests(cfg)
    eng = cs.continuous_engine(model, params, dvi, cs.C_PAGES_AMPLE, True)
    for r in reqs:
        eng.submit_request(r)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    bad = 0
    for rep in range(repeats):
        with Burn(burn):
            try:
                cs.profile_batch(eng, reqs, wall, n=8, expect={
                    "paged_decode_attention": 1.0, "verify_argmax": 1.0, "lora_logits": 1.0})
            except RuntimeError as err:
                bad += 1
                print(f"engine run {rep} (burn {burn}): {err}", flush=True)
        print(f"engine run {rep} (burn {burn}) done; CUPTI dropped {cupti_dropped()}",
              flush=True)
    return 1 if bad else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_records: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--stress", action="store_true")
    ap.add_argument("--engine", type=int, default=0)
    ap.add_argument("--burn", type=int, default=0)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile
    print(cs.card_line(), flush=True)
    if args.stress or args.engine:
        torch.zeros(1, device="cuda")
        print(f"CUPTI attributes {cupti_attributes()}", flush=True)
        if args.stress:
            return stress(args.burn)
        return engine(args.engine, args.burn)
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
