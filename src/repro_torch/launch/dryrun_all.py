"""Sweep driver: every (arch x shape x mesh) dry run as a subprocess of its
own (``repro_torch.launch.dryrun``: one fake process group and one case a
process), counterpart of ``repro.launch.dryrun_all``.  A case whose record
is already ``ok`` or ``skip`` under `--out` is read back, not rerun.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--out experiments/dryrun_torch]
      [--mesh single|multi|both] [--archs a,b,c] [--shapes s1,s2]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro_torch.launch.mesh import mesh_label, production_shape

TIMEOUT_S = 3000


def run_one(arch: str, shape: str, multipod: bool, out: str) -> dict:
    mesh = mesh_label(production_shape(multi_pod=multipod))
    tag = f"{arch}_{shape}_{mesh}"
    path = os.path.join(out, tag + ".json")
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skip"):
            print(f"[sweep] {tag}: cached ({rec['status']})")
            return rec
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if multipod:
        cmd.append("--multipod")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S)
        ok = r.returncode == 0
        tail = [line for line in r.stdout.splitlines() if line.startswith("[dryrun]")][-1:] \
            or (r.stdout + r.stderr).strip().splitlines()[-1:] or [""]
        print(f"[sweep] {tag}: {'ok' if ok else 'FAIL'} ({time.time() - t0:.0f}s) "
              f"{tail[0][:150]}", flush=True)
    except subprocess.TimeoutExpired:
        print(f"[sweep] {tag}: TIMEOUT after {TIMEOUT_S}s", flush=True)
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh, "status": "fail",
                       "error": "timeout"}, f)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"status": "fail", "arch": arch, "shape": shape, "mesh": mesh}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--archs", default=",".join(ASSIGNED_ARCHS))
    ap.add_argument("--shapes", default=",".join(INPUT_SHAPES))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results = [run_one(arch, shape, mp, args.out)
               for shape in args.shapes.split(",")
               for arch in args.archs.split(",")
               for mp in meshes]
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skip" for r in results)
    print(f"[sweep] done: {n_ok} ok, {n_skip} skip, {len(results) - n_ok - n_skip} fail "
          f"of {len(results)}")


if __name__ == "__main__":
    main()
