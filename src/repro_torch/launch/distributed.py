"""Multi-node runtime initialization: counterpart of
``repro.launch.distributed``.

Each process of a job runs the same program on one card; ``init_runtime()``
joins the default process group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over NCCL,
sets the process's card and returns the job's devices.  Without those
variables it joins nothing.  A production mesh needs 256 or 512 cards; below
that, ``production_mesh_or_dryrun()`` points to the dry run, which checks a
configuration against the production meshes on fake tensors in one process.

Typical launch (one line per node of 8 cards):

    torchrun --nnodes 32 --nproc-per-node 8 --rdzv-endpoint $LEADER:29500 \\
        -m repro_torch.launch.train --arch llama3-405b --mode dvi-batch ...
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_production_mesh

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def device_count() -> int:
    """Devices of the job: the default group's world size once it exists,
    else this process's cards (1 without a card)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def init_runtime(require_cuda: bool = False) -> list:
    """Join the default process group (NCCL on a card, gloo without one)
    when torchrun's variables are set and no group exists yet, set this
    process's card to ``LOCAL_RANK``, and return the job's devices, one a
    rank.  With `require_cuda` and no card it raises, as the reference does
    without a TPU."""
    cuda = torch.cuda.is_available()
    if require_cuda and not cuda:
        raise RuntimeError("CUDA required, no card is visible; use the dry-run path "
                           "(python -m repro_torch.launch.dryrun) on the CPU")
    env = {k: os.environ.get(k) for k in ENV}
    local = int(env["LOCAL_RANK"] or 0)
    if cuda:
        torch.cuda.set_device(local)
    if all(v is not None for v in env.values()) and not dist.is_initialized():
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                                rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    if not cuda:
        return [torch.device("cpu")] * device_count()
    per_node = torch.cuda.device_count()
    return [torch.device("cuda", r % per_node) for r in range(device_count())]


def production_mesh_or_dryrun():
    """The production mesh on 512 or 256 cards; below that, an error that
    names the dry run."""
    n = device_count()
    if n >= 512:
        return make_production_mesh(multi_pod=True)
    if n >= 256:
        return make_production_mesh(multi_pod=False)
    raise RuntimeError(
        f"{n} devices < 256: not a production slice. For configuration validation run "
        "`python -m repro_torch.launch.dryrun` (the production mesh on fake tensors in one "
        "process).")
