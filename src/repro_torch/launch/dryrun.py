"""Multi-node dry run: every (arch x input shape x mesh) step on fake
tensors, counterpart of ``repro.launch.dryrun``.

The proof, without the cards, that a configuration is coherent on the
production mesh: a sharding that cannot be placed, a step that does not fit
a card's HBM or an op that cannot run sharded surfaces here.  Each case
runs in one process: a ``"fake"`` process group of the mesh's world size,
the parameters (and draft parameters, optimizer state, caches) drawn as
fake tensors and placed by the partitioner (``sharding.param_specs``,
``distribute_tensor``), and the step run once on them
(``step_analysis.analyze``).  The record is the reference's schema:

* ``memory``: per-device argument / output / temp / peak bytes;
* ``cost.dot_flops_per_device``: matmul FLOPs on the local shards, loops
  counted at their trip counts;
* ``collectives.per_kind`` / ``total`` ({count, payload_bytes,
  wire_bytes}) and ``per_axis``, which the roofline prices by link;
* ``params_total``, ``params_active``.

The steps are the reference's ``build_case``: the DVI train step with
AdamW, prefill, and one ``serve_step`` against a full cache updated in
place.  Nothing launches a kernel (the plain versions run on fake tensors);
this is an analysis entry point, not a served path.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
          --shape train_4k [--multipod] [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import roofline, tree as tree_mod
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import hints
from repro_torch.launch import sharding as shd
from repro_torch.launch import step_analysis as sa
from repro_torch.launch.mesh import MeshShape, axis_sizes, mesh_label, production_shape

# ---------------------------------------------------------------------------
# Shape adaptation policy (the reference's)
# ---------------------------------------------------------------------------

SWA_FALLBACK = {"llama3-405b", "qwen2.5-14b", "qwen3-0.6b", "qwen3-1.7b",
                "vicuna-7b"}
LONG_NATIVE = {"mamba2-370m", "recurrentgemma-9b", "llama4-scout-17b-a16e"}
LONG_SKIP = {"deepseek-v3-671b": "pure full-attention (MLA); no SWA variant claimed",
             "paligemma-3b": "pure full-attention (gemma-1); no SWA variant",
             "whisper-large-v3": "enc-dec with 448-token decoder context"}


def adapt_config(arch: str, shape: InputShape, kv_quant: bool = False):
    """Returns (cfg, note) or (None, skip_reason)."""
    cfg = get_config(arch)
    note = ""
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
        note = "int8 KV cache variant (§Perf H5)"
    if shape.name == "long_500k":
        if arch in LONG_SKIP:
            return None, LONG_SKIP[arch]
        if arch in SWA_FALLBACK:
            cfg = cfg.replace(sliding_window=8192, global_attn_every=0)
            note = "sliding-window 8192 variant (not the paper config)"
    return cfg, note


def make_aux_specs(cfg: ModelConfig, B: int):
    """The modality stubs' shapes as meta tensors (float32), or None."""
    aux = {}
    if cfg.vision is not None:
        aux["patch_embeds"] = torch.empty((B, cfg.vision.num_patches, cfg.vision.d_embed),
                                          dtype=torch.float32, device="meta")
    if cfg.encoder is not None:
        aux["frame_embeds"] = torch.empty(
            (B, cfg.encoder.num_frames, cfg.encoder.d_model or cfg.d_model),
            dtype=torch.float32, device="meta")
    return aux or None


def decode_cap(cfg: ModelConfig, S: int) -> int:
    """A decode case's cache capacity: S plus a block's worst case, rounded
    up to 256 so the sequence dim divides the mesh's "model" axis."""
    return -(-(S + cfg.dvi.k_spec + 8) // 256) * 256


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _placed(tree: dict, specs: dict, mesh) -> dict:
    """A tree of global fake tensors placed by `specs`; each local shard a
    storage of its own (not a view of the global tensor)."""
    placed = shd.distribute(tree, specs, mesh)
    flat = tree_mod.flatten(placed)
    for t in flat.values():
        local = t._local_tensor
        if local.untyped_storage().nbytes() != local.numel() * local.element_size():
            t._local_tensor = local.clone()
    return placed


def _fill(path: str, cfg: ModelConfig) -> int:
    """The value ``transformer.init_cache`` fills a cache leaf with."""
    if path.endswith("pos"):
        return -1
    if path.endswith("xlen"):
        return cfg.encoder.num_frames
    return 0


def sharded_cache(model, B: int, cap: int, mesh) -> dict:
    """``init_cache(B, cap)``'s tree with each leaf made directly as its
    local shard (``torch.distributed.tensor.full``), placed by
    ``cache_specs``: no global copy is ever made."""
    from torch.distributed.tensor import full

    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    shapes = tree_mod.flatten(tfm.init_cache(cfg, B, cap, device="meta"))
    sizes = axis_sizes(mesh)
    out = {}
    for p, t in shapes.items():
        spec = shd.cache_spec(p, tuple(t.shape), sizes)
        out[p] = full(tuple(t.shape), _fill(p, cfg), dtype=t.dtype, device_mesh=mesh,
                      placements=shd.placements(spec, mesh))
    return tree_mod.unflatten(out)


def _tokens(B: int, S: int, mesh, include_model: bool = False):
    from torch.distributed.tensor import distribute_tensor
    spec = shd.tokens_spec(mesh, B, include_model)
    return distribute_tensor(torch.zeros((B, S), dtype=torch.int32), mesh,
                             shd.placements(spec, mesh), src_data_rank=None)


def _aux(cfg: ModelConfig, B: int, mesh):
    from torch.distributed.tensor import distribute_tensor
    specs = make_aux_specs(cfg, B)
    if specs is None:
        return None
    spec = shd.tokens_spec(mesh, B)
    return {k: distribute_tensor(torch.zeros(m.shape, dtype=m.dtype), mesh,
                                 shd.placements(spec + (None,) * (m.ndim - 2), mesh),
                                 src_data_rank=None)
            for k, m in specs.items()}


# ---------------------------------------------------------------------------
# Step construction per shape kind
# ---------------------------------------------------------------------------

def build_case(cfg: ModelConfig, shape: InputShape, mesh, cache_len: Optional[int] = None):
    """(fn, args): the step of the shape's kind and its inputs, placed on
    `mesh` (inside a fake-tensor mode).  `cache_len` overrides a decode
    case's cache capacity."""
    from repro_torch.core import lora, losses as losses_mod, spec as spec_mod
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init, adamw_update

    model = build_model(cfg, device="cpu")
    B, S = shape.global_batch, shape.seq_len
    gen = torch.Generator()
    params_g = model.init(gen)
    params = _placed(params_g, shd.param_specs(params_g, mesh), mesh)
    del params_g
    dvi_g = lora.init_draft_params(gen, cfg)
    dvi = _placed(dvi_g, shd.param_specs(dvi_g, mesh), mesh)
    aux = _aux(cfg, B, mesh)

    if shape.kind == "train":
        opt = adamw_init(dvi)            # m and v mirror the draft parameters' placements
        tokens = _tokens(B, S, mesh, include_model=True)

        def fn(params, dvi_params, opt_state, tokens, aux):
            leaves = {k: p.detach().requires_grad_() for k, p in dvi_params.items()}
            with torch.enable_grad():
                loss, _ = losses_mod.dense_train_losses(model, params, leaves, tokens, 100,
                                                        0.5, "full", aux, True)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            adamw_update(dvi_params, grads, opt_state, 1e-3)
            return dvi_params, opt_state, loss.detach()

        return fn, [params, dvi, opt, tokens, aux]

    if shape.kind == "prefill":
        tokens = _tokens(B, S, mesh)
        P_extra = cfg.vision.num_patches if cfg.vision is not None else 0
        cap = -(-(S + P_extra + cfg.dvi.k_spec + 8) // 256) * 256

        def fn(params, dvi_params, tokens, aux):
            cache = sharded_cache(model, B, cap, mesh)
            h, cache = model.prefill(params, tokens, aux, cache=cache)
            cache = shd.constrain_cache_tree(cfg, cache)
            vlog = model.logits(params, h[:, -1])
            dlog = lora.draft_logits(model, params, dvi_params, h[:, -1])
            return torch.argmax(vlog, -1), torch.argmax(dlog, -1), cache

        return fn, [params, dvi, tokens, aux]

    # decode: one DVI speculative serve step against a full cache of
    # seq_len committed tokens, updated in place (as serving does)
    cap = cache_len or decode_cap(cfg, S)
    cache = sharded_cache(model, B, cap, mesh)
    from torch.distributed.tensor import distribute_tensor
    pending = distribute_tensor(torch.zeros((B,), dtype=torch.int32), mesh,
                                shd.placements((shd.batch_axes(mesh, B),), mesh),
                                src_data_rank=None)

    def fn(params, dvi_params, pending, cache):
        cache["lengths"].fill_(S)
        y, commit_vec, accept, cache2 = spec_mod.serve_step(model, params, dvi_params,
                                                            pending, cache)
        return y, commit_vec, accept, shd.constrain_cache_tree(cfg, cache2)

    return fn, [params, dvi, pending, cache]


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_case(arch: str, shape_name: str, multi_pod: bool = False, kv_quant: bool = False,
             mesh_shape: Optional[MeshShape] = None, shape: Optional[InputShape] = None,
             cfg: Optional[ModelConfig] = None, cache_len: Optional[int] = None) -> dict:
    """One case's record.  `mesh_shape` replaces the production mesh (the
    card's 1 x 1, a test's 2 x 2), `shape` the named input shape, `cfg` the
    adapted config (a depth cut), `cache_len` a decode cache's capacity."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = shape or INPUT_SHAPES[shape_name]
    note = ""
    if cfg is None:
        cfg, note = adapt_config(arch, shape, kv_quant)
    mshape = mesh_shape or production_shape(multi_pod=multi_pod)
    rec = {"arch": arch + ("+kvq" if kv_quant else ""), "shape": shape.name,
           "mesh": mesh_label(mshape), "note": note}
    if cfg is None:
        rec["status"] = "skip"
        return rec
    t0 = time.time()
    sizes = axis_sizes(mshape)
    counter = sa.StepCounter()
    with sa.fake_group(mshape.size):
        mesh = init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
        with hints.hint_mesh(mesh), counter:
            fn, args = build_case(cfg, shape, mesh, cache_len)
            t_build = time.time() - t0
            res = sa.analyze(fn, args, counter, mesh)
            del fn, args
    rec.update({
        "status": "ok",
        "build_s": round(t_build, 1),
        "seconds": round(time.time() - t0, 1),
        "n_devices": mshape.size,
        "torch": torch.__version__,
        "memory": res["memory"],
        "cost": {"dot_flops_per_device": res["dot_flops_per_device"]},
        "collectives": res["collectives"],
        "fallbacks": res["fallbacks"],
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    })
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache variant")
    args = ap.parse_args()
    label = mesh_label(production_shape(multi_pod=args.multipod))
    try:
        rec = run_case(args.arch, args.shape, args.multipod, kv_quant=args.kv_quant)
    except Exception as e:  # noqa: BLE001 -- record the failure for the table
        rec = {"arch": args.arch, "shape": args.shape, "mesh": label,
               "status": "fail", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    os.makedirs(args.out, exist_ok=True)
    tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
    with open(os.path.join(args.out, tag), "w") as f:
        json.dump(rec, f, indent=2)
    status = rec["status"]
    mem = rec.get("memory", {}).get("peak_bytes", 0)
    fits = mem < roofline.hbm_per_card()
    print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: {status}"
          + (f"  peak={mem / 2**30:.2f} GiB/dev (fits an H100: {fits})"
             f"  dot_flops/dev={rec['cost']['dot_flops_per_device']:.3g}"
             f"  wire={rec['collectives']['total']['wire_bytes'] / 2**30:.2f} GiB/dev"
             f"  {rec['seconds']} s" if status == "ok" else "")
          + (f"  ({rec.get('note') or rec.get('error', '')})"
             if rec.get("note") or rec.get("error") else ""))
    if status == "fail":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
