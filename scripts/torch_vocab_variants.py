#!/usr/bin/env python3
"""Time variants of the two vocab kernels' streaming body on the card, to
choose the constants of ``csrc/vocab_tile.cuh``.

    python3 scripts/torch_vocab_variants.py [VARIANT,VARIANT,...]

A variant is ``<cols>x<stages>`` with optional letters: ``n`` leaves the
products out (the ring streams w and nothing is computed: the loads'
ceiling; the results are wrong and are not checked), ``b`` doubles the
k-chunk of a bf16 stage (128 rows, 256 bytes of k).  Each variant's
sources are copied into ``build/variants/`` with those constants changed
and built with the port's nvcc flags, one nvcc per source, all at once.  At vicuna-7b's and
mamba2-370m's vocab shapes (bf16, the 16-byte loader; verify T = 40, LoRA
T = 8 and r = 64) each variant is checked against the plain versions and
timed by device time (``chip_smoke.time_ms``) twice, in order and in
reverse order, beside cuBLAS's h @ w.  Prints the card's name and power
limit, one line per shape and variant, and a JSON line.  Needs one card.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DEFAULT = "128x3,128x4,128x6,256x3,256x4,128x3b,128x3n,128x4n,256x3n"
KERNELS = ("verify_argmax", "lora_logits")
SHAPES = (("vicuna-7b", 4096, 32000), ("mamba2-370m", 1024, 50280))


def parse(var: str):
    cols, rest = var.split("x")
    stages = rest.rstrip("nb")
    return int(cols), int(stages), set(rest[len(stages):])


def build_variant(var: str, build) -> dict:
    """Copy csrc/ with the variant's constants; start nvcc on each source."""
    cols, stages, flags = parse(var)
    out = os.path.join(build.BUILD_DIR, "variants", var)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    edits = {"vocab_tile.cuh": [("constexpr int COLS = 128;", f"constexpr int COLS = {cols};"),
                                ("constexpr int STAGES = 3;", f"constexpr int STAGES = {stages};")]}
    if "n" in flags:
        edits["vocab_tile.cuh"].append(("stage_products<NT>(acc,",
                                        "if (p.T < 0) stage_products<NT>(acc,"))
    if "b" in flags:
        edits["vocab_tile.cuh"].append(("CH = 8, BK = 64,", "CH = 8, BK = 128,"))
    for name, subs in edits.items():
        path = os.path.join(out, name)
        text = open(path).read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{var}: '{old}' not found in {name}")
            text = text.replace(old, new)
        open(path, "w").write(text)
    procs = {}
    for k in KERNELS:
        so = os.path.join(out, f"{k}.so")
        procs[k] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                                          os.path.join(out, f"{k}.cu")],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True))
    return procs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_vocab_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    variants = (sys.argv[1] if len(sys.argv) > 1 else DEFAULT).split(",")
    jobs = {var: build_variant(var, build) for var in variants}
    fns = {}
    for var, procs in jobs.items():
        for k, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {var} {k}:\n{log}")
            f = getattr(ctypes.CDLL(so), f"dvi_{k}")
            f.argtypes, f.restype = ops._ARGTYPES[k], ctypes.c_int
            fns[var, k] = f
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for label, d, V in SHAPES:
        h = torch.randn((40, d), generator=gen, device=cs.DEV).to(torch.bfloat16)
        w = (torch.randn((d, V), generator=gen, device=cs.DEV) / d ** 0.5).to(torch.bfloat16)
        hl = h[:8].contiguous()
        a = torch.randn((d, 64), generator=gen, device=cs.DEV) / d ** 0.5
        b = torch.randn((64, V), generator=gen, device=cs.DEV) * 0.05
        arg_r, mx_r = ref.verify_argmax(h, w)
        lo_r = ref.lora_logits(hl, w, a, b, 2.0)
        times = {var: [] for var in variants}
        for order in (variants, variants[::-1]):
            for var in order:
                nblk = -(-V // parse(var)[0])
                pm = torch.empty((40, nblk), device=cs.DEV)
                pa = torch.empty((40, nblk), dtype=torch.int32, device=cs.DEV)
                arg = torch.empty((40,), dtype=torch.int32, device=cs.DEV)
                mx = torch.empty((40,), device=cs.DEV)
                u = torch.empty((8, 64), device=cs.DEV)
                out = torch.empty((8, V), device=cs.DEV)

                def verify(f=fns[var, "verify_argmax"], nblk=nblk, pm=pm, pa=pa, arg=arg, mx=mx):
                    cs.check(f(h.data_ptr(), w.data_ptr(), 40, d, V, 1, 1, pm.data_ptr(),
                               pa.data_ptr(), nblk, arg.data_ptr(), mx.data_ptr(), stream) == 0,
                             "verify_argmax launch refused")

                def lora(f=fns[var, "lora_logits"], u=u, out=out):
                    cs.check(f(hl.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), 2.0, 8,
                               d, V, 64, 1, 1, u.data_ptr(), out.data_ptr(), stream) == 0,
                             "lora_logits launch refused")

                verify()
                lora()
                torch.cuda.synchronize()
                if "n" not in parse(var)[2]:
                    cs.check(torch.equal(arg, arg_r) and cs.close("verify_argmax", mx, mx_r)[2]
                             and cs.close("lora_logits", out, lo_r)[2],
                             f"{var} disagrees with the plain versions")
                times[var].append((cs.time_ms(verify)[0], cs.time_ms(lora)[0]))
        gemm_ms = cs.time_ms(lambda: torch.matmul(h, w))[0]
        for var in variants:
            tv, tl = [t[0] for t in times[var]], [t[1] for t in times[var]]
            print(f"{label} {var}: verify_argmax {' '.join(f'{t:.4f}' for t in tv)} ms, "
                  f"lora_logits {' '.join(f'{t:.4f}' for t in tl)} ms"
                  + (" (products left out)" if "n" in parse(var)[2] else ""), flush=True)
            results.append(dict(shape=label, variant=var, verify_ms=tv, lora_ms=tl))
        print(f"{label} cuBLAS h @ w (T = 40) {gemm_ms:.4f} ms", flush=True)
        results.append(dict(shape=label, variant="cublas_matmul", verify_ms=[gemm_ms]))
    print(json.dumps({"vocab_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
