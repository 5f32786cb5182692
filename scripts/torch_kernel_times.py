#!/usr/bin/env python3
"""Phase 3 of chip_smoke.py alone: every kernel of the port against its
plain version on the card, then timed (device ms, per-call ms, plain
version, library call, bound) at the paths' shapes.

    python3 scripts/torch_kernel_times.py

It drives no serving path, so its rows carry no launch counts.  Run it in
two trees in one call (parent, change, change, parent) to compare kernels
on one card.  Prints the card's name and power limit, phase 3's lines and a
JSON line {"kernels": [...]}.  Needs one card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    build.build_all()
    print(cs.card_line(), flush=True)
    rows = cs.kernels_phase(get_config("vicuna-7b"), get_config(cs.M_NAME))
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
