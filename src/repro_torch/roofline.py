"""Three-term roofline (NVIDIA H100 SXM) from dry-run records and analytic
byte / FLOP models: counterpart of ``repro.roofline``.

    compute term    = FLOPs_per_card / peak FLOPs          (989 TFLOP/s dense bf16)
    memory term     = HBM_bytes_per_card / HBM rate         (3.35 TB/s HBM3)
    collective term = wire bytes per card / link rate       (NVLink 450 GB/s a
                      direction over "model", inside an HGX node; one NDR
                      InfiniBand link, 50 GB/s, over the axes that cross nodes)

FLOPs and wire bytes come from the dry run's step analysis
(``launch.dryrun``, ``launch.step_analysis``: per-device, loops at their
trip counts).  HBM bytes are analytic (weights, caches and activations per
the execution plan): the fake-tensor step sees the bytes that live, not the
bytes a fused kernel moves.  HBM per card is the card's
``torch.cuda.get_device_properties(0).total_memory`` when one is visible,
else ``HBM_PER_CARD``, the figure ``chip_smoke.py`` phase 20 printed on an
H100 80GB HBM3.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import InputShape, ModelConfig

PEAK_FLOPS = 989e12          # dense bf16 a card (H100 SXM)
HBM_BW = 3.35e12             # bytes/s a card (HBM3)
NVLINK_BW = 450e9            # bytes/s a card and direction, inside an HGX node
NET_BW = 50e9                # bytes/s: one NDR InfiniBand link between nodes
HBM_PER_CARD = 85_017_493_504   # total_memory of an H100 80GB HBM3 (700 W)
# the mesh axis that stays inside a node's NVLink domain
NVLINK_AXES = ("model",)


def hbm_per_card() -> int:
    """The visible card's memory, else the H100 80GB's."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return HBM_PER_CARD


def _cache_bytes(cfg: ModelConfig, S: int, B: int) -> int:
    """Decode-cache bytes (global) for capacity S, batch B."""
    from repro_torch.models.transformer import RING_SLACK, model_segments
    by = 0
    for seg in model_segments(cfg):
        n = seg.n
        if seg.kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            H = d_in // s.head_dim
            conv_dim = d_in + 2 * s.ngroups * s.d_state
            by += n * B * ((s.d_conv - 1) * conv_dim * 2
                           + H * s.head_dim * s.d_state * 4)
        elif seg.kind == "rglru":
            w = cfg.rglru.lru_width or cfg.d_model
            by += n * B * ((cfg.rglru.d_conv - 1) * w * 2 + w * 4)
        elif cfg.mla is not None:
            by += n * B * S * (cfg.mla.kv_lora_rank
                               + cfg.mla.qk_rope_head_dim) * 2
        else:
            C = (cfg.rglru.local_window if cfg.rglru is not None else
                 cfg.sliding_window) + RING_SLACK if seg.kind == "local" else S
            by += n * B * C * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
        if seg.cross:
            by += n * B * cfg.encoder.num_frames * 2 * cfg.num_heads \
                * cfg.resolved_head_dim * 2
    return by


def analytic_hbm_bytes(cfg: ModelConfig, shape: InputShape, n_chips: int) -> float:
    """Per-card HBM traffic estimate for one step of the shape's workload."""
    B, S = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, cfg.num_layers
    K = cfg.dvi.k_spec
    wbytes = cfg.param_count() * 2                      # bf16 resident
    if shape.kind == "decode":
        # weight-stationary: every (active) weight shard read once, the
        # drafter's shallow layers K + 1 times, the whole cache once
        k = cfg.dvi.split_layer
        shallow_frac = k / L
        w_read = cfg.active_param_count() * 2 * (1 + shallow_frac * K)
        c_read = _cache_bytes(cfg, S, B) * (K + 2) / (K + 2)
        act = B * (K + 1) * d * L * 4 * 2
        return (w_read + c_read + act) / n_chips
    tokens = B * S
    # weights once; activations ~6 reads and writes of (tokens, d) a layer;
    # the blockwise attention's chunked K/V re-reads; the cache written once
    act = 6 * L * tokens * d * 2
    nq = max(S // 256, 1)
    kv_bytes = L * tokens * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    flash_reread = min(nq, 32) * kv_bytes * 0.1
    total = wbytes + act + kv_bytes + flash_reread
    if shape.kind == "train":
        total += wbytes                                  # the LoRA-only backward's reads
    return total / n_chips


def model_flops(cfg: ModelConfig, shape: InputShape) -> dict:
    """Ideal useful FLOPs: 2 N_active tokens forward (+ attention)."""
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    if shape.kind == "decode":
        K = cfg.dvi.k_spec
        toks = B * (K + 1)
        k_frac = cfg.dvi.split_layer / cfg.num_layers
        fwd = 2 * N * toks * (1 + k_frac * 1.0)          # the drafter re-walks the shallow layers
        attn = 2 * 2 * toks * S * cfg.num_heads * hd * (1 - k_frac)
        return {"forward": fwd + attn, "six_nd": 6 * N * toks}
    toks = B * S
    causal = 0.5
    attn_ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
    attn = (0 if cfg.arch_type == "ssm" else
            4 * cfg.num_layers * toks * attn_ctx * cfg.num_heads * hd * causal)
    fwd = 2 * N * toks + attn
    return {"forward": fwd, "six_nd": 6 * N * toks}


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def collective_seconds(collectives: dict) -> float:
    """Wire bytes over their link: each mesh axis's at its rate
    (``per_axis``: NVLink for "model", the network for the rest), or, in a
    record without ``per_axis`` (the reference's), the total at the
    network's rate."""
    per_axis = collectives.get("per_axis")
    if not per_axis:
        return collectives["total"]["wire_bytes"] / NET_BW
    return sum(d["wire_bytes"] / (NVLINK_BW if axis in NVLINK_AXES else NET_BW)
               for axis, d in per_axis.items())


def roofline_from_record(rec: dict, cfg: ModelConfig, shape: InputShape) -> dict:
    n_chips = rec.get("n_devices", 256)
    flops_dev = rec["cost"]["dot_flops_per_device"]
    hbm_dev = analytic_hbm_bytes(cfg, shape, n_chips)
    r = Roofline(compute_s=flops_dev / PEAK_FLOPS,
                 memory_s=hbm_dev / HBM_BW,
                 collective_s=collective_seconds(rec["collectives"]))
    mf = model_flops(cfg, shape)
    useful_ratio = mf["forward"] / max(flops_dev * n_chips, 1.0)
    return {
        "compute_s": r.compute_s,
        "memory_s": r.memory_s,
        "collective_s": r.collective_s,
        "dominant": r.dominant,
        "bound_s": r.bound_s,
        "hbm_bytes_per_chip": hbm_dev,
        "model_flops_fwd": mf["forward"],
        "model_flops_6nd": mf["six_nd"],
        "useful_flops_ratio": useful_ratio,
        "peak_mem_gib": rec["memory"]["peak_bytes"] / 2**30,
        "fits_hbm": rec["memory"]["peak_bytes"] < hbm_per_card(),
    }


def suggestion(rl: dict) -> str:
    if rl["dominant"] == "collective":
        return ("cut NVLink / InfiniBand volume: keep tensor parallelism inside the node's "
                "NVLink domain ('model'), overlap the FSDP gathers with compute, reduce the "
                "sequence-sharded attention's partial results instead of gathering the cache")
    if rl["dominant"] == "memory":
        return ("cut HBM traffic: the verify_argmax kernel avoids the (T, V) logits round "
                "trip, the int8 KV cache halves the cache's bytes, a larger decode batch "
                "raises the arithmetic intensity")
    if rl["useful_flops_ratio"] < 0.5:
        return ("compute beyond the model's useful FLOPs: remove replicated (head-unsharded) "
                "attention compute and recomputation; then raise tensor-core use with "
                "wgmma-sized tiles (multiples of 64 rows)")
    return "near the compute roof: tune the tile shapes for Hopper's wgmma"
