"""The single dispatch point of the port's kernels.

Each wrapper dispatches on the device of its tensors: on the CPU it runs the
kernel's plain version (``ref``); on a CUDA device it checks what the kernel
takes, allocates outputs and scratch, launches the kernel on PyTorch's
current stream and counts the launch in ``launches``.  There is no fallback:
a CUDA tensor never reaches a plain version here, and a tensor the kernel
does not take, a failed build or a refused launch raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build, ref

# Launches of each kernel since the last reset_launches(); plain CPU calls
# never count.  chip_smoke.py reads them to show the main path ran the kernels.
launches: Dict[str, int] = {name: 0 for name in build.KERNELS}

_VOID, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # h, w, T, d, V, is_bf16, part_max, part_arg, nblk, out_arg, out_max, stream
    "verify_argmax": [_VOID, _VOID, _INT, _INT, _INT, _INT, _VOID, _VOID, _INT,
                      _VOID, _VOID, _VOID],
    # h, w, a, b, gamma, T, d, V, r, is_bf16, u_part, ksplit, out, stream
    "lora_logits": [_VOID, _VOID, _VOID, _VOID, _FLOAT, _INT, _INT, _INT, _INT,
                    _INT, _VOID, _INT, _VOID, _VOID],
    # q, k, v, lengths, out, B, Tq, H, KV, hd, S, scale, is_bf16, stream
    "decode_attention": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                         _INT, _INT, _INT, _FLOAT, _INT, _VOID],
}
# vocab columns per block of the two vocab-streaming kernels, and the number
# of d-slices of the LoRA down-projection pre-pass (both fixed in csrc/)
VOCAB_COLS = 64
LORA_KSPLIT = 16
LORA_MAX_RANK = 512       # u rows of a pass must fit in shared memory
ATTN_MAX_ROWS = 64        # Tq * G query rows one attention block holds
ATTN_MAX_HD = 256


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_fns: Dict[str, ctypes._CFuncPtr] = {}


def _fn(name: str):
    if name not in _fns:
        f = getattr(build.library(name), f"dvi_{name}")
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return _fns[name]


def _launch(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1


def _device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_dtype(dtype: torch.dtype) -> int:
    _need(dtype in (torch.float32, torch.bfloat16),
          f"kernels take float32 or bfloat16, got {dtype}")
    return int(dtype == torch.bfloat16)


def _contig(**ts: torch.Tensor) -> None:
    for n, t in ts.items():
        _need(t.is_contiguous(), f"{n} must be contiguous")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return _VOID(torch.cuda.current_stream(dev).cuda_stream)


def verify_argmax(h: torch.Tensor, w: torch.Tensor):
    """h (T, d), w (d, V) -> (argmax (T,) int32, max (T,) f32) of h @ w,
    ties to the lowest index, without materialising the (T, V) logits."""
    if _device(h, w).type == "cpu":
        return ref.verify_argmax(h, w)
    _need(h.ndim == 2 and w.ndim == 2 and h.shape[1] == w.shape[0],
          f"verify_argmax: h {tuple(h.shape)} and w {tuple(w.shape)} must be (T,d), (d,V)")
    _need(h.dtype == w.dtype, "verify_argmax: h and w must share a dtype")
    is_bf16 = _check_dtype(h.dtype)
    _contig(h=h, w=w)
    T, d = h.shape
    V = w.shape[1]
    nblk = -(-V // VOCAB_COLS)
    part_max = torch.empty((T, nblk), dtype=torch.float32, device=h.device)
    part_arg = torch.empty((T, nblk), dtype=torch.int32, device=h.device)
    arg = torch.empty((T,), dtype=torch.int32, device=h.device)
    mx = torch.empty((T,), dtype=torch.float32, device=h.device)
    _launch("verify_argmax", h.data_ptr(), w.data_ptr(), T, d, V, is_bf16,
            part_max.data_ptr(), part_arg.data_ptr(), nblk, arg.data_ptr(),
            mx.data_ptr(), _stream(h.device))
    return arg, mx


def lora_logits(h: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                gamma: float) -> torch.Tensor:
    """h (T, d), w (d, V) in the model dtype; a (d, r), b (r, V) float32 ->
    float32 logits h@w + gamma*(h@a)@b.  u = h@a is formed once per call."""
    if _device(h, w, a, b).type == "cpu":
        return ref.lora_logits(h, w, a, b, gamma)
    _need(h.ndim == 2 and w.ndim == 2 and a.ndim == 2 and b.ndim == 2,
          "lora_logits: all operands are 2-D")
    T, d = h.shape
    V, r = w.shape[1], a.shape[1]
    _need(w.shape[0] == d and a.shape[0] == d and b.shape == (r, V),
          f"lora_logits: shapes h {tuple(h.shape)} w {tuple(w.shape)} "
          f"a {tuple(a.shape)} b {tuple(b.shape)} do not chain")
    _need(r <= LORA_MAX_RANK, f"lora_logits: rank {r} > {LORA_MAX_RANK}")
    _need(h.dtype == w.dtype, "lora_logits: h and w must share a dtype")
    _need(a.dtype == torch.float32 and b.dtype == torch.float32,
          "lora_logits: a and b must be float32")
    is_bf16 = _check_dtype(h.dtype)
    _contig(h=h, w=w, a=a, b=b)
    u_part = torch.empty((LORA_KSPLIT, T, r), dtype=torch.float32, device=h.device)
    out = torch.empty((T, V), dtype=torch.float32, device=h.device)
    _launch("lora_logits", h.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            float(gamma), T, d, V, r, is_bf16, u_part.data_ptr(), LORA_KSPLIT,
            out.data_ptr(), _stream(h.device))
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Flash-decode GQA over a contiguous cache, visiting only live slots.

    q (B, H, hd) attends slots j < lengths[b]; q (B, Tq, H, hd) is a block
    whose query t attends j < lengths[b] - (Tq-1-t), with ``lengths`` the
    cache length after the block's own write.  k/v (B, S, KV, hd);
    lengths (B,) int32.  Returns q's shape and dtype.  A query with no live
    slot is not defined (the kernel gives 0, the plain version a uniform
    average); the model path never has one."""
    if _device(q, k, v, lengths).type == "cpu":
        return ref.decode_attention(q, k, v, lengths)
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    _need(q4.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
          f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Tq, H, hd = q4.shape
    S, KV = k.shape[1], k.shape[2]
    _need(k.shape[0] == B and k.shape[3] == hd and H % KV == 0,
          "decode_attention: k/v must be (B, S, KV, hd) with H a multiple of KV")
    _need(Tq * (H // KV) <= ATTN_MAX_ROWS and hd <= ATTN_MAX_HD and hd % 4 == 0,
          f"decode_attention: needs Tq*G <= {ATTN_MAX_ROWS}, hd <= {ATTN_MAX_HD}, "
          f"hd % 4 == 0")
    _need(q.dtype == k.dtype == v.dtype, "decode_attention: q, k, v must share a dtype")
    _need(lengths.dtype == torch.int32 and lengths.shape == (B,),
          "decode_attention: lengths must be (B,) int32")
    is_bf16 = _check_dtype(q.dtype)
    q4 = q4.contiguous() if single else q4
    _contig(q=q4, k=k, v=v, lengths=lengths)
    out = torch.empty_like(q4)
    _launch("decode_attention", q4.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Tq, H, KV, hd, S, 1.0 / math.sqrt(hd),
            is_bf16, _stream(q.device))
    return out[:, 0] if single else out
