"""Online replay ring buffer (paper §3.3), port of ``repro.core.buffer``
(``init_buffer`` and ``add_block``; sampling comes with the Improve loop).

Each logged tuple is one drafted position up to and including the first
reject: (h_k, h_L, action, reward, block_pos, prev_id).  Everything stays on
the device and logging needs no host sync.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

_ROWS = ("h_k", "h_L", "action", "reward", "pos", "prev")


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
