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
# never count.  A launch counts where the wrapper makes it; a CUDA graph
# replay adds the launches its capture recorded (``add_counts``), so the
# counts keep meaning launches executed.  chip_smoke.py reads them to show
# the main path ran the kernels.
launches: Dict[str, int] = {name: 0 for name in build.KERNELS}

_VOID, _INT, _FLOAT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    # h, w, T, d, V, is_bf16, fast, part_max, part_arg, nblk, out_arg, out_max, stream
    "verify_argmax": [_VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _VOID, _VOID, _INT,
                      _VOID, _VOID, _VOID],
    # h, w, a, b, gamma, T, d, V, r, is_bf16, fast, u, out, stream
    "lora_logits": [_VOID, _VOID, _VOID, _VOID, _FLOAT, _INT, _INT, _INT, _INT,
                    _INT, _INT, _VOID, _VOID, _VOID],
    # q, k, v, lengths, out, B, Tq, H, KV, hd, S, scale, splits, is_bf16,
    # pos (or null), window, causal, k_scale, v_scale (or null), kv_int8, stream
    "decode_attention": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                         _INT, _INT, _INT, _FLOAT, _INT, _INT, _VOID, _INT, _INT, _VOID,
                         _VOID, _INT, _VOID],
    # q, k_pages, v_pages, lengths, block_tables, out, B, Tq, H, KV, hd, ps,
    # MPS, scale, splits, is_bf16, page_counts (or null), k_scale, v_scale
    # (or null), kv_int8, stream
    "paged_decode_attention": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT,
                               _INT, _INT, _INT, _INT, _INT, _FLOAT, _INT, _INT, _VOID,
                               _VOID, _VOID, _INT, _VOID],
    # xh, Bc, Cc, dt, A, h0, sxb, sxt, sbb, sbt, scb, sct, B, T, H, hd, ds, Q,
    # is_bf16, splits, y, hout, stream
    "ssd_scan": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _I64, _I64, _I64, _I64, _I64,
                 _I64, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOID, _VOID, _VOID],
}
# vocab columns of a strip of the two vocab-streaming kernels (fixed in
# csrc/vocab_tile.cuh): verify_argmax writes one partial per row and strip
VOCAB_COLS = 128
LORA_MAX_RANK = 512       # the main pass stages u's rows in shared memory
ATTN_MAX_ROWS = 64        # query rows one attention CTA holds: a row tile
ATTN_MAX_TQ = 128         # queries a call takes: a prefill chunk's bound (RING_SLACK)
ATTN_MAX_HD = 256
PAGED_MAX_PAGES = 8192    # block-table row of a paged attention call
SSD_MAX_CHUNK = 128       # chunk rows one scan CTA stages: 8 tiles of 16
SSD_MAX_DIM = 128         # hd and ds bounds of the scan kernel
SSD_DIM_STEP = 8          # hd and ds come in whole multiples of 8
# the scan splits each (head, lane) over P CTAs of hd / P columns
SSD_SLICE_WIDTHS = (32, 16, 8)   # columns of a CTA's slice, widest first
SSD_MIN_CTAS = 128        # narrower slices until about one CTA per SM
# the attention kernels split a lane's live slots over a cluster of C CTAs
ATTN_SPLITS = (1, 2, 4, 8)
ATTN_SMS = 132            # SMs of an H100: a split stops at one CTA per SM
ATTN_SPLIT_SLOTS = 128    # fewest capacity slots a CTA of a split lane takes
ATTN_SUBTILE = 16         # slots of one warp's sub-tile; shares are multiples


# Launches of the vocab kernels by loader since the last reset_launches():
# "fast" (TMA boxes of w in bf16, 16-byte cp.async copies otherwise) or
# "element" (one element a load), as ``vocab_fast`` chose it.
vocab_paths: Dict[str, Dict[str, int]] = {name: {"fast": 0, "element": 0}
                                          for name in ("verify_argmax", "lora_logits")}
# Launches of decode_attention by form since the last reset_launches():
# "causal" (a block over a contiguous cache), "ring" (the ring form) or
# "cross" (the non-causal form over an encoder's K/V).
attn_forms: Dict[str, int] = {"causal": 0, "ring": 0, "cross": 0}
# Launches of both attention kernels by the storage of the K/V they read
# since the last reset_launches(): "model" (the query's dtype) or "int8"
# (the int8 KV cache, with its scales).
attn_kv: Dict[str, int] = {"model": 0, "int8": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for paths in vocab_paths.values():
        paths.update(fast=0, element=0)
    attn_forms.update(causal=0, ring=0, cross=0)
    attn_kv.update(model=0, int8=0)


def counts() -> dict:
    """A copy of ``launches``, ``vocab_paths``, ``attn_forms`` and ``attn_kv``."""
    return {"launches": dict(launches),
            "vocab_paths": {name: dict(v) for name, v in vocab_paths.items()},
            "attn_forms": dict(attn_forms), "attn_kv": dict(attn_kv)}


def add_counts(delta: dict) -> None:
    """Add `delta` (``counts()``'s form) to the counters: a CUDA graph's
    replay adds the launches its capture recorded."""
    for name, n in delta["launches"].items():
        launches[name] += n
    for name, paths in delta["vocab_paths"].items():
        for path, n in paths.items():
            vocab_paths[name][path] += n
    for form, n in delta.get("attn_forms", {}).items():
        attn_forms[form] += n
    for kind, n in delta.get("attn_kv", {}).items():
        attn_kv[kind] += n


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


def _check_attn_shape(name: str, Tq: int, hd: int, dtype: torch.dtype,
                      kv_int8: bool = False) -> None:
    """What the attention kernels take: at most ATTN_MAX_TQ queries a lane
    (their Tq * G rows a kv head cut into row tiles of ATTN_MAX_ROWS), and
    hd up to ATTN_MAX_HD in whole mma k-steps (16) for bf16 or 16-byte
    float32 copies (4); int8 K/V rows in whole 16-byte copies (16)."""
    step = 16 if dtype == torch.bfloat16 or kv_int8 else 4
    _need(Tq <= ATTN_MAX_TQ, f"{name}: needs Tq <= {ATTN_MAX_TQ}, got Tq={Tq}")
    _need(hd <= ATTN_MAX_HD and hd % step == 0,
          f"{name}: needs hd <= {ATTN_MAX_HD} and hd % {step} == 0 for {dtype}"
          f"{' with int8 K/V' if kv_int8 else ''}, got hd={hd}")


def _check_kv(name: str, q, k, v, k_scale, v_scale, scale_shape: tuple) -> bool:
    """K/V without scales (the kernel needs them in q's dtype), or int8 with
    float32 scales of `scale_shape` (one a slot and kv head).  Returns
    whether they are int8."""
    if k.dtype != torch.int8 and v.dtype != torch.int8:
        _need(k_scale is None and v_scale is None,
              f"{name}: k_scale / v_scale go with int8 K/V only")
        return False
    _need(k.dtype == v.dtype == torch.int8, f"{name}: int8 K needs int8 V")
    _need(k_scale is not None and v_scale is not None, f"{name}: int8 K/V need their scales")
    for n, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _need(t.dtype == torch.float32 and tuple(t.shape) == scale_shape,
              f"{name}: {n} must be {scale_shape} float32, got {tuple(t.shape)} {t.dtype}")
        _need(t.device == q.device, f"{name}: {n} on {t.device}, q on {q.device}")
    return True


def attn_row_tiles(rows: int) -> int:
    """Row tiles of a call whose kv heads each hold `rows` = Tq * G query
    rows: one CTA (or cluster) a tile, side by side on the grid."""
    return -(-rows // ATTN_MAX_ROWS)


def _aligned(name: str, **ts: torch.Tensor) -> None:
    for n, t in ts.items():
        _need(t.data_ptr() % 16 == 0, f"{name}: {n} must start on 16 bytes (cp.async)")


def attn_splits(capacity: int, pairs: int) -> int:
    """C, the CTAs of one cluster that share a (lane, kv head) of the
    attention kernels, from host integers alone: the lane's capacity (S, or
    MPS * ps) and the number of (lane, kv head, row tile) triples B * KV *
    ``attn_row_tiles(Tq * G)`` (B * KV pairs for a decode block).  The host never
    reads ``lengths``, so the choice costs no sync.  The largest C that keeps
    the grid within one CTA per SM and gives each CTA at least
    ATTN_SPLIT_SLOTS slots of capacity; non-decreasing in the capacity.  The
    thresholds come from ``scripts/torch_attn_splits.py`` on an H100 (PERF.md):
    with the paths' 8 lanes of 32 kv heads (256 pairs) C = 1 is fastest at
    every capacity; with 2 lanes (64 pairs) C = 2 wins from about 256 slots
    and C = 4 never does."""
    splits = 1
    for c in ATTN_SPLITS[1:]:
        if pairs * c > ATTN_SMS or capacity < c * ATTN_SPLIT_SLOTS:
            break
        splits = c
    return splits


def attn_share(n_live: int, splits: int) -> int:
    """Slots of each CTA's share of a lane with `n_live` live slots, as the
    kernels compute it on the card: whole sub-tiles, split evenly; CTA c
    takes slots [c * share, min((c+1) * share, n_live))."""
    tiles = -(-n_live // ATTN_SUBTILE)
    return ATTN_SUBTILE * -(-tiles // splits)


def ssd_plan(B: int, H: int, hd: int, ds: int, T: int, Q: int) -> int:
    """P, the CTAs that split each (head, lane) of the scan by slices of hd /
    P columns, from host integers alone.  The widest slice of
    SSD_SLICE_WIDTHS that divides hd, narrowed while the grid B * H * P
    stays under SSD_MIN_CTAS (about one CTA per SM): the paths' B = 8
    prefill (256 pairs) takes 32 columns, a B = 1 admission 16, the
    fastest widths at those shapes in ``scripts/torch_ssd_variants.py`` on
    an H100 (PERF.md).  ds, T and Q do not change the choice: every CTA
    stages the chunk's C and B rows whatever its slice."""
    widths = [w for w in SSD_SLICE_WIDTHS if hd % w == 0]
    _need(bool(widths), f"ssd_scan: hd={hd} is not a multiple of {min(SSD_SLICE_WIDTHS)}")
    splits = hd // widths[0]
    for w in widths[1:]:
        if B * H * splits >= SSD_MIN_CTAS:
            break
        splits = hd // w
    return splits


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return _VOID(torch.cuda.current_stream(dev).cuda_stream)


def vocab_fast(h: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the vocab kernels take h (T, d) and w (d, V) through their
    fast loader (TMA and 16-byte copies): both start on 16 bytes and their
    rows are whole multiples of 16 bytes.  Decided from host integers alone
    (pointers and shapes), as the kernel's own check does; any other
    operands take the element loader."""
    elt = h.element_size()
    return (h.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and h.shape[1] * elt % 16 == 0 and w.shape[1] * elt % 16 == 0)


def _count_path(name: str, fast: bool) -> None:
    vocab_paths[name]["fast" if fast else "element"] += 1


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
    fast = vocab_fast(h, w)
    nblk = -(-V // VOCAB_COLS)
    part_max = torch.empty((T, nblk), dtype=torch.float32, device=h.device)
    part_arg = torch.empty((T, nblk), dtype=torch.int32, device=h.device)
    arg = torch.empty((T,), dtype=torch.int32, device=h.device)
    mx = torch.empty((T,), dtype=torch.float32, device=h.device)
    _launch("verify_argmax", h.data_ptr(), w.data_ptr(), T, d, V, is_bf16, int(fast),
            part_max.data_ptr(), part_arg.data_ptr(), nblk, arg.data_ptr(),
            mx.data_ptr(), _stream(h.device))
    _count_path("verify_argmax", fast)
    return arg, mx


def lora_logits(h: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                gamma: float) -> torch.Tensor:
    """h (T, d), w (d, V) in the model dtype; a (d, r), b (r, V) float32 ->
    float32 logits h@w + gamma*(h@a)@b.  u = h@a is formed once per call.

    Differentiable in a and b (``LoraLogits``) when autograd records and
    either requires a gradient; h and w are frozen and get none."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return LoraLogits.apply(h, w, a, b, gamma)
    return _lora_forward(h, w, a, b, gamma)[0]


def _lora_forward(h, w, a, b, gamma):
    """(logits, u): the kernel on the card, which leaves u = h@a (T, r)
    float32 in its scratch; the plain version on the CPU, with u None."""
    if _device(h, w, a, b).type == "cpu":
        return ref.lora_logits(h, w, a, b, gamma), None
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
    fast = vocab_fast(h, w)
    u = torch.empty((T, r), dtype=torch.float32, device=h.device)
    out = torch.empty((T, V), dtype=torch.float32, device=h.device)
    _launch("lora_logits", h.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            float(gamma), T, d, V, r, is_bf16, int(fast), u.data_ptr(), out.data_ptr(),
            _stream(h.device))
    _count_path("lora_logits", fast)
    return out, u


class LoraLogits(torch.autograd.Function):
    """``lora_logits`` with a backward in the LoRA factors only, as the
    reference's loss differentiates its draft logits (h and w frozen).  The
    forward is ``_lora_forward``: the hand-written kernel on the card.  With
    g = dL/dlogits and u = h@a (kept from the kernel's scratch):

        dB = gamma * u^T g        dA = gamma * h^T (g B^T)

    Both are small float32 products outside any kernel, as the JAX package
    computes them in plain jnp."""

    @staticmethod
    def forward(ctx, h, w, a, b, gamma):
        out, u = _lora_forward(h, w, a, b, gamma)
        ctx.gamma = gamma
        ctx.save_for_backward(h, a, b, u if u is not None else torch.empty(0))
        return out

    @staticmethod
    def backward(ctx, g):
        h, a, b, u = ctx.saved_tensors
        hf = h.float()
        if u.numel() == 0:               # the plain version kept no u
            u = hf @ a
        gamma = ctx.gamma
        da = gamma * (hf.T @ (g @ b.T)) if ctx.needs_input_grad[2] else None
        db = gamma * (u.T @ g) if ctx.needs_input_grad[3] else None
        return None, None, da, db, None


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, pos=None, window: int = 0,
                     causal: bool = True, k_scale=None, v_scale=None) -> torch.Tensor:
    """Flash-decode GQA over a contiguous cache, visiting only live slots.

    q (B, H, hd) attends slots j < lengths[b]; q (B, Tq, H, hd) is a block
    (Tq <= ATTN_MAX_TQ: a speculative block or a prefill chunk) whose query t
    attends j < lengths[b] - (Tq-1-t), with ``lengths`` the cache length
    after the block's own write.  k/v (B, S, KV, hd);
    lengths (B,) int32.  Returns q's shape and dtype.  A query with no live
    slot is not defined (the kernel gives 0, the plain version a uniform
    average); the model path never has one.

    The ring form: `pos` (B, S) int32 gives the position each slot holds
    (-1: empty; a sliding-window layer's ring keeps position p at slot
    p % S), and query t, at qpos = lengths[b] - Tq + t, attends slot j iff
    0 <= pos[b, j] <= qpos and, with `window` > 0, pos[b, j] > qpos -
    window.

    The non-causal form, ``causal=False`` (cross-attention over an
    encoder's K/V, lengths all F): every query of the block attends the
    slots j < lengths[b].  The ring form is causal.

    The int8 KV cache: k/v int8 with `k_scale` / `v_scale` (B, S, KV)
    float32, one scale a slot and kv head.  Slot j's K row is read as
    ``(k[b, j].float() * k_scale[b, j, :, None]).to(q.dtype)``, rounded
    once to the query's dtype as ``kv_dequantize`` rounds it, and V the
    same; the kernel does this itself, per staged tile, for the contiguous
    and the ring form (hd a multiple of 16).  The non-causal form takes no
    int8 K/V: cross K/V stay in the model dtype."""
    _need(q.ndim in (3, 4) and k.ndim == 4 and k.shape == v.shape,
          f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    kv_int8 = _check_kv("decode_attention", q, k, v, k_scale, v_scale, tuple(k.shape[:3]))
    _need(causal or not kv_int8,
          "decode_attention: the non-causal form takes no int8 K/V (cross K/V stay in "
          "the model dtype)")
    tensors = (q, k, v, lengths) + ((pos,) if pos is not None else ())
    if _device(*tensors).type == "cpu":
        return ref.decode_attention(q, k, v, lengths, pos=pos, window=window, causal=causal,
                                    k_scale=k_scale, v_scale=v_scale)
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    B, Tq, H, hd = q4.shape
    S, KV = k.shape[1], k.shape[2]
    _need(k.shape[0] == B and k.shape[3] == hd and H % KV == 0,
          "decode_attention: k/v must be (B, S, KV, hd) with H a multiple of KV")
    _need(kv_int8 or q.dtype == k.dtype == v.dtype,
          "decode_attention: q, k, v must share a dtype, or k, v be int8 with scales")
    _need(lengths.dtype == torch.int32 and lengths.shape == (B,),
          "decode_attention: lengths must be (B,) int32")
    _need(window >= 0 and (pos is not None or window == 0),
          "decode_attention: a window needs the ring's pos")
    _need(causal or pos is None, "decode_attention: the ring form is causal")
    if pos is not None:
        _need(pos.dtype == torch.int32 and pos.shape == (B, S),
              "decode_attention: pos must be (B, S) int32")
        _contig(pos=pos)
    is_bf16 = _check_dtype(q.dtype)
    _check_attn_shape("decode_attention", Tq, hd, q.dtype, kv_int8)
    q4 = q4.contiguous() if single else q4
    _contig(q=q4, k=k, v=v, lengths=lengths)
    _aligned("decode_attention", q=q4, k=k, v=v)
    if kv_int8:
        _contig(k_scale=k_scale, v_scale=v_scale)
    out = torch.empty_like(q4)
    _launch("decode_attention", q4.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Tq, H, KV, hd, S, 1.0 / math.sqrt(hd),
            attn_splits(S, B * KV * attn_row_tiles(Tq * (H // KV))), is_bf16,
            pos.data_ptr() if pos is not None else None, int(window), int(causal),
            k_scale.data_ptr() if kv_int8 else None, v_scale.data_ptr() if kv_int8 else None,
            int(kv_int8), _stream(q.device))
    attn_forms["ring" if pos is not None else "causal" if causal else "cross"] += 1
    attn_kv["int8" if kv_int8 else "model"] += 1
    return out[:, 0] if single else out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           lengths: torch.Tensor, block_tables: torch.Tensor,
                           page_counts=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Flash-decode GQA over pooled pages read through per-lane block tables,
    visiting only each lane's live mapped slots.

    q (B, H, hd) or a block (B, Tq, H, hd), masked as in ``decode_attention``
    (``lengths`` counts the block's own write); k_pages/v_pages (P, ps, KV,
    hd) with physical page 0 the null page; block_tables (B, MPS) int32,
    -1 = unmapped; lengths (B,) int32; page_counts (B,) int32 or None: only
    the lane's first clip(page_counts[b], 1, MPS) logical pages take part
    (None: ceil(lengths[b] / ps), which the length mask implies).  Returns
    q's shape and dtype.  A query with no live slot (an idle lane) is not
    defined: the kernel gives 0, the plain version the reference's uniform
    average.

    The int8 KV cache: int8 pages with `k_scale` / `v_scale` (P, ps, KV)
    float32, read and rounded to the query's dtype as in
    ``decode_attention``, by the kernel itself (hd a multiple of 16)."""
    _need(q.ndim in (3, 4) and k_pages.ndim == 4 and k_pages.shape == v_pages.shape,
          f"paged_decode_attention: q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
          f"v_pages {tuple(v_pages.shape)}")
    kv_int8 = _check_kv("paged_decode_attention", q, k_pages, v_pages, k_scale, v_scale,
                        tuple(k_pages.shape[:3]))
    tensors = (q, k_pages, v_pages, lengths, block_tables) + (
        (page_counts,) if page_counts is not None else ())
    if _device(*tensors).type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, lengths, block_tables,
                                          page_counts=page_counts, k_scale=k_scale,
                                          v_scale=v_scale)
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    B, Tq, H, hd = q4.shape
    _, ps, KV, _ = k_pages.shape
    _need(k_pages.shape[3] == hd and H % KV == 0,
          "paged_decode_attention: pages must be (P, ps, KV, hd) with H a multiple of KV")
    _need(kv_int8 or q.dtype == k_pages.dtype == v_pages.dtype,
          "paged_decode_attention: q and the pages must share a dtype, or the pages be int8 "
          "with scales")
    _need(lengths.dtype == torch.int32 and lengths.shape == (B,),
          "paged_decode_attention: lengths must be (B,) int32")
    _need(block_tables.dtype == torch.int32 and block_tables.ndim == 2
          and block_tables.shape[0] == B and 0 < block_tables.shape[1] <= PAGED_MAX_PAGES,
          f"paged_decode_attention: block_tables must be (B, MPS) int32, "
          f"MPS <= {PAGED_MAX_PAGES}")
    if page_counts is not None:
        _need(page_counts.dtype == torch.int32 and page_counts.shape == (B,),
              "paged_decode_attention: page_counts must be (B,) int32")
        _contig(page_counts=page_counts)
    is_bf16 = _check_dtype(q.dtype)
    _check_attn_shape("paged_decode_attention", Tq, hd, q.dtype, kv_int8)
    q4 = q4.contiguous() if single else q4
    _contig(q=q4, k_pages=k_pages, v_pages=v_pages, lengths=lengths,
            block_tables=block_tables)
    _aligned("paged_decode_attention", q=q4, k_pages=k_pages, v_pages=v_pages)
    if kv_int8:
        _contig(k_scale=k_scale, v_scale=v_scale)
    mps = block_tables.shape[1]
    out = torch.empty_like(q4)
    _launch("paged_decode_attention", q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(), B, Tq, H, KV, hd,
            ps, mps, 1.0 / math.sqrt(hd),
            attn_splits(mps * ps, B * KV * attn_row_tiles(Tq * (H // KV))), is_bf16,
            page_counts.data_ptr() if page_counts is not None else None,
            k_scale.data_ptr() if kv_int8 else None, v_scale.data_ptr() if kv_int8 else None,
            int(kv_int8), _stream(q.device))
    attn_kv["int8" if kv_int8 else "model"] += 1
    return out[:, 0] if single else out


def ssd_scan(xh: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, chunk: int, h0=None):
    """Mamba-2 chunked SSD scan with a carried float32 state (G = 1 on the
    card).  xh (B,T,H,hd), Bc/Cc (B,T,1,ds) in one dtype, dt (B,T,H) after
    softplus and A (H,) < 0 in float32, h0 (B,H,hd,ds) float32 or None;
    any 1 <= chunk <= 128 with T % chunk == 0.  Returns (y (B,T,H,hd)
    float32, final state (B,H,hd,ds) float32).

    xh, Bc and Cc may be strided views of the conv output: the kernel takes
    their batch and time strides, so only their inner dimensions must be
    packed; dt, A and h0 must be contiguous.  hd and ds are multiples of 8
    up to 128; ``ssd_plan`` splits each (head, lane) over P CTAs.

    Differentiable in every input (``SsdScan``) when autograd records and
    one of them requires a gradient; otherwise exactly the call below."""
    tensors = (xh, Bc, Cc, dt, A) + ((h0,) if h0 is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return SsdScan.apply(xh, Bc, Cc, dt, A, chunk, h0)
    return _ssd_forward(xh, Bc, Cc, dt, A, chunk, h0)


def _ssd_forward(xh, Bc, Cc, dt, A, chunk, h0):
    """(y, final state): the kernel on the card, the plain version on the
    CPU."""
    tensors = (xh, Bc, Cc, dt, A) + ((h0,) if h0 is not None else ())
    if _device(*tensors).type == "cpu":
        return ref.ssd_scan(xh, Bc, Cc, dt, A, chunk, h0=h0)
    _need(xh.ndim == 4 and Bc.ndim == 4 and Bc.shape == Cc.shape,
          f"ssd_scan: xh {tuple(xh.shape)}, Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    B, T, H, hd = xh.shape
    ds = Bc.shape[3]
    _need(Bc.shape[:3] == (B, T, 1), "ssd_scan: the kernel takes G = 1 (Bc/Cc (B,T,1,ds))")
    _need(dt.shape == (B, T, H) and A.shape == (H,), "ssd_scan: dt must be (B,T,H), A (H,)")
    _need(1 <= chunk <= SSD_MAX_CHUNK and T % chunk == 0,
          f"ssd_scan: needs 1 <= chunk <= {SSD_MAX_CHUNK} and T % chunk == 0, "
          f"got T={T} chunk={chunk}")
    _need(0 < hd <= SSD_MAX_DIM and 0 < ds <= SSD_MAX_DIM and hd % SSD_DIM_STEP == 0
          and ds % SSD_DIM_STEP == 0,
          f"ssd_scan: needs hd, ds <= {SSD_MAX_DIM} in multiples of {SSD_DIM_STEP}, "
          f"got hd={hd} ds={ds}")
    _need(xh.dtype == Bc.dtype == Cc.dtype, "ssd_scan: xh, Bc and Cc must share a dtype")
    _need(dt.dtype == A.dtype == torch.float32, "ssd_scan: dt and A must be float32")
    is_bf16 = _check_dtype(xh.dtype)
    _need(xh.stride(3) == 1 and xh.stride(2) == hd and Bc.stride(3) == 1
          and Cc.stride(3) == 1, "ssd_scan: xh, Bc and Cc need packed inner dimensions")
    _contig(dt=dt, A=A)
    if h0 is not None:
        _need(h0.shape == (B, H, hd, ds) and h0.dtype == torch.float32,
              "ssd_scan: h0 must be (B,H,hd,ds) float32")
        _contig(h0=h0)
    splits = ssd_plan(B, H, hd, ds, T, chunk)
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=xh.device)
    hout = torch.empty((B, H, hd, ds), dtype=torch.float32, device=xh.device)
    _launch("ssd_scan", xh.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), dt.data_ptr(),
            A.data_ptr(), h0.data_ptr() if h0 is not None else None,
            xh.stride(0), xh.stride(1), Bc.stride(0), Bc.stride(1), Cc.stride(0),
            Cc.stride(1), B, T, H, hd, ds, chunk, is_bf16, splits, y.data_ptr(), hout.data_ptr(),
            _stream(xh.device))
    return y, hout


class SsdScan(torch.autograd.Function):
    """``ssd_scan`` with a backward in xh, Bc, Cc, dt, A and h0, for
    training through a Mamba-2 layer.  The forward is ``_ssd_forward``: the
    hand-written kernel on the card, unchanged.  The backward recomputes
    the scan from the saved inputs with the plain version (``ref.ssd_scan``,
    in float32, its decay masked inside the exp so the gradient stays
    finite) and differentiates that with autograd.

    There is no backward kernel: the reference has none either (JAX
    differentiates its jnp ``ssd_chunked``).  The recomputation holds one
    chunk's (B, Q, Q, H) decay tensors at a time per step of its graph."""

    @staticmethod
    def forward(ctx, xh, Bc, Cc, dt, A, chunk, h0):
        y, h = _ssd_forward(xh, Bc, Cc, dt, A, chunk, h0)
        ctx.chunk = chunk
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(xh, Bc, Cc, dt, A, h0 if h0 is not None else torch.empty(0))
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        *inputs, h0 = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need[:5])]
            leaves.append(h0.detach().requires_grad_(need[6]) if ctx.has_h0 else None)
            y, h = ref.ssd_scan(*leaves[:5], ctx.chunk, h0=leaves[5])
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            outs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
            got = iter(torch.autograd.grad([o for o, _ in outs], wanted, [g for _, g in outs],
                                           allow_unused=True) if outs else [None] * len(wanted))
        grads = [next(got) if t is not None and t.requires_grad else None for t in leaves]
        return (*grads[:5], None, grads[5])
