"""Online replay ring buffer (paper §3.3), port of ``repro.core.buffer``.

Each logged tuple is one drafted position up to and including the first
reject: (h_k, h_L, action, reward, block_pos, prev_id).  Everything stays on
the device: logging and sampling need no host sync, and both work on the
ring in place (a CUDA graph of the block-step holds its tensors' addresses).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

_ROWS = ("h_k", "h_L", "action", "reward", "pos", "prev")
# the fields of a sampled minibatch, besides its mask
_BATCH = _ROWS + ("age",)


def init_buffer(cfg: ModelConfig, slots: int = 0, dtype=torch.float32,
                device=None) -> dict:
    S = slots or cfg.dvi.buffer_slots
    d = cfg.d_model
    device = resolve_device(device)

    def zeros(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "h_k": zeros(S, d, dt=dtype),
        "h_L": zeros(S, d, dt=dtype),
        "action": zeros(S),
        "reward": zeros(S, dt=torch.float32),
        "pos": zeros(S),             # i: 1-indexed block position
        "prev": zeros(S),
        "age": zeros(S),             # write generation (freshness)
        "ptr": zeros(),
        "count": zeros(),
        "gen": zeros(),
    }


def add_block(buf: dict, h_k, h_L, action, reward, pos, prev, valid) -> dict:
    """Append the rows where `valid`, in order, at the ring pointer.  All
    inputs flat (N, ...) / (N,).  The rows' tensors are written in place;
    the returned dict carries the advanced ptr/count/gen.

    The reference scatters with ``mode="drop"``; here the N ring slots from
    the pointer on are rewritten under a mask instead: slot ptr+i takes the
    i-th valid row (found by a prefix sum and a search) if there are more
    than i valid rows, and keeps its content otherwise."""
    S = buf["h_k"].shape[0]
    N = valid.shape[0]
    if N > S:
        raise ValueError(f"block of {N} rows does not fit a ring of {S} slots")
    csum = torch.cumsum(valid.to(torch.int64), 0)           # valid rows up to i
    total = csum[-1]
    rank = torch.arange(N, device=valid.device)
    write = rank < total
    row = torch.searchsorted(csum, rank + 1).clamp(max=N - 1)  # rank-th valid row
    slot = (buf["ptr"].long() + rank) % S
    src = dict(h_k=h_k, h_L=h_L, action=action, reward=reward, pos=pos, prev=prev)
    for name in _ROWS:
        dst = buf[name]
        new = src[name][row].to(dst.dtype)
        mask = write.reshape(-1, *([1] * (dst.ndim - 1)))
        dst[slot] = torch.where(mask, new, dst[slot])
    buf["age"][slot] = torch.where(write, buf["gen"], buf["age"][slot])
    out = dict(buf)
    out["ptr"] = ((buf["ptr"] + total) % S).to(torch.int32)
    out["count"] = torch.clamp(buf["count"] + total, max=S).to(torch.int32)
    out["gen"] = buf["gen"] + 1
    return out


def rows_at(buf: dict, idx: torch.Tensor) -> dict:
    """The tuples of rank `idx` (N,) counted back from the newest (rank 0 is
    the last row written), gathered from the ring; rows with ``idx >= count``
    are masked invalid."""
    S = buf["h_k"].shape[0]
    slot = (buf["ptr"].long() - 1 - idx) % S
    batch = {k: buf[k][slot] for k in _BATCH}
    batch["mask"] = (idx < buf["count"]).to(torch.float32)
    return batch


def sample(buf: dict, gen: torch.Generator, batch_size: int) -> dict:
    """Uniform sample (with replacement) of `batch_size` logged tuples,
    drawn from `gen` without a host sync: rank floor(u * max(count, 1)) for
    u uniform in [0, 1).  Rows are masked invalid when the buffer is empty,
    as in the reference (``jax.random.randint(key, (n,), 0, max(count, 1))``;
    the two generators give different numbers)."""
    cnt = torch.clamp(buf["count"].long(), min=1)
    u = torch.rand((batch_size,), generator=gen, dtype=torch.float64,
                   device=buf["count"].device)
    idx = torch.minimum((u * cnt).long(), cnt - 1)
    return rows_at(buf, idx)


def fresh_batch(buf: dict, batch_size: int) -> dict:
    """The most recently written tuples (the on-policy slice, the paper's
    'fresh'): ranks 0..batch_size-1, valid where written by the last block."""
    offs = torch.arange(batch_size, device=buf["count"].device)
    batch = rows_at(buf, offs)
    fresh = batch["age"] == buf["gen"] - 1
    batch["mask"] = (fresh & (offs < buf["count"])).to(torch.float32)
    return batch
