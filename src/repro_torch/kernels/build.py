"""Build and load the port's CUDA kernels: nvcc into one shared library per
source, with a plain C interface, loaded with ``ctypes``.

Each library lands in ``build/`` at the repo root, named by a hash of its
sources and flags, so it is compiled at first use (all sources at once, one
``nvcc`` each) and reused until a source changes.  A missing ``nvcc`` or a
failed build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("verify_argmax", "lora_logits", "decode_attention")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source on the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns {name: {"path", "seconds", "log"}}; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, out = {}, {}
    t0 = time.perf_counter()
    for name in KERNELS:
        so = _target(name)
        log = so.with_suffix(".log")
        if so.exists():
            out[name] = {"path": so, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (so, tmp, log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, tmp, log, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
        log.write_text(text)
        os.replace(tmp, so)
        out[name] = {"path": so, "seconds": time.perf_counter() - t0, "log": text}
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    if name not in _libs:
        so = _target(name)
        if not so.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(so))
    return _libs[name]
