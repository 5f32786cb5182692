"""One config surface for the port's serving engine: EngineConfig and
ModelSpec.  Port of ``repro.serving.config``.

* ``EngineConfig``: a dataclass of the engine's tunable knobs, with
  ``add_args(parser)`` / ``from_args(args)`` so every launcher shares ONE
  flag set (``--num-slots``, ``--kv-pages``, ...), ``engine_kwargs()`` to
  splat into ``ServingEngine``, and ``to_argv()``, which gives a config
  back as flags (the round trip is tested).  Its fields and defaults are
  the reference's, field by field; the port's own engine knob ``graphs``
  goes through ``build_engine``'s overrides.

* ``ModelSpec`` + ``build_model_bundle``: the tiny-backbone recipe the
  launchers share (config -> init -> synthetic pretraining -> online
  trainer state), so the HTTP server and the load generator's direct
  check build bit-identical models from the same (arch, tiny, seed,
  pretrain_steps) tuple.  ``device`` (``--device``) picks where: the card
  unless ``cpu`` is asked for.

Keep the knob names in lockstep with ``ServingEngine``'s fields: the tests
(tests/test_torch_config.py) map every EngineConfig field onto an engine
parameter.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields
from typing import Dict, Optional


def parse_tenant_weights(spec: str) -> Optional[Dict[str, float]]:
    """``"a:2,b:1"`` -> ``{"a": 2.0, "b": 1.0}`` (empty/None -> None)."""
    if not spec:
        return None
    out: Dict[str, float] = {}
    for part in spec.split(","):
        name, _, w = part.partition(":")
        if not name:
            raise ValueError(f"bad tenant-weights spec {spec!r}")
        out[name.strip()] = float(w) if w else 1.0
    return out


def format_tenant_weights(weights: Optional[Dict[str, float]]) -> str:
    if not weights:
        return ""
    return ",".join(f"{k}:{v:g}" for k, v in sorted(weights.items()))


@dataclass
class EngineConfig:
    """Every tunable ``ServingEngine`` knob, CLI-addressable.

    Field names match the engine's constructor parameters 1:1; the flag
    for field ``kv_page_size`` is ``--kv-page-size``.
    """
    scheduler: str = "continuous"
    num_slots: int = 8
    batch_size: int = 8
    max_new: int = 64
    bucket: int = 64              # sync-path prompt bucket (buckets=(bucket,))
    update_every: int = 4
    updates_per_batch: int = 1
    sync_every: int = 1
    latency_window: int = 4096
    learn: bool = True
    lr: float = 1e-3
    mode: str = "full"
    eos_id: int = 1
    cache_len: int = 0
    kv_pages: int = 0
    kv_page_size: int = 16
    kv_watermark: int = 0
    prefix_cache: bool = False
    prefill_chunk: int = 0
    adaptive_k: bool = False
    k_min: int = 1
    k_max: int = 0
    max_queue: int = 0
    tenant_weights: Optional[Dict[str, float]] = None
    telemetry: bool = False
    trace_limit: int = 200_000
    profile_dir: Optional[str] = None
    profile_steps: int = 32

    # -- CLI plumbing --------------------------------------------------

    @classmethod
    def add_args(cls, ap: argparse.ArgumentParser,
                 defaults: Optional["EngineConfig"] = None) -> None:
        """Register one ``--flag`` per field (bools become on/off pairs
        only where the default is False; True-default bools get a
        ``--no-...`` switch)."""
        d = defaults or cls()
        g = ap.add_argument_group("engine", "ServingEngine knobs "
                                  "(serving/config.py EngineConfig)")
        g.add_argument("--scheduler", choices=("sync", "continuous"),
                       default=d.scheduler)
        g.add_argument("--num-slots", type=int, default=d.num_slots,
                       help="decode lanes (continuous scheduler)")
        g.add_argument("--batch-size", "--batch", dest="batch_size",
                       type=int, default=d.batch_size,
                       help="requests per batch (sync scheduler)")
        g.add_argument("--max-new", type=int, default=d.max_new)
        g.add_argument("--bucket", type=int, default=d.bucket,
                       help="sync-path prompt-length bucket")
        g.add_argument("--update-every", type=int, default=d.update_every,
                       help="blocks between drafter updates (continuous)")
        g.add_argument("--updates-per-batch", type=int,
                       default=d.updates_per_batch)
        g.add_argument("--sync-every", type=int, default=d.sync_every,
                       help="speculative blocks fused per device sync")
        g.add_argument("--latency-window", type=int, default=d.latency_window)
        g.add_argument("--no-learn", action="store_true",
                       default=not d.learn,
                       help="freeze the drafter (no online updates)")
        g.add_argument("--lr", type=float, default=d.lr)
        g.add_argument("--mode", default=d.mode)
        g.add_argument("--eos-id", type=int, default=d.eos_id)
        g.add_argument("--cache-len", type=int, default=d.cache_len)
        g.add_argument("--kv-pages", type=int, default=d.kv_pages,
                       help=">0: paged KV cache with this many pool pages")
        g.add_argument("--kv-page-size", type=int, default=d.kv_page_size)
        g.add_argument("--kv-watermark", type=int, default=d.kv_watermark)
        g.add_argument("--prefix-cache", action="store_true",
                       default=d.prefix_cache,
                       help="share page-aligned prompt prefixes (paged)")
        g.add_argument("--prefill-chunk", type=int, default=d.prefill_chunk,
                       help=">0: chunked prefill of this many tokens/tick")
        g.add_argument("--adaptive-k", action="store_true",
                       default=d.adaptive_k,
                       help="per-lane acceptance-driven speculation depth")
        g.add_argument("--k-min", type=int, default=d.k_min)
        g.add_argument("--k-max", type=int, default=d.k_max)
        g.add_argument("--max-queue", type=int, default=d.max_queue,
                       help="admission queue bound; submissions past it "
                            "are rejected with QueueFull (0 = unbounded)")
        g.add_argument("--tenant-weights",
                       default=format_tenant_weights(d.tenant_weights),
                       help='weighted-fair shares, e.g. "gold:3,free:1"')
        g.add_argument("--telemetry", action="store_true",
                       default=d.telemetry,
                       help="record the per-request lifecycle trace")
        g.add_argument("--trace-limit", type=int, default=d.trace_limit)
        g.add_argument("--profile-dir", default=d.profile_dir)
        g.add_argument("--profile-steps", type=int, default=d.profile_steps)

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "EngineConfig":
        kw = {}
        for f in fields(cls):
            if f.name == "learn":
                kw["learn"] = not getattr(args, "no_learn")
            elif f.name == "tenant_weights":
                tw = getattr(args, "tenant_weights")
                kw["tenant_weights"] = (parse_tenant_weights(tw)
                                        if isinstance(tw, str) else tw)
            else:
                kw[f.name] = getattr(args, f.name)
        return cls(**kw)

    def engine_kwargs(self) -> dict:
        """Keyword arguments for ``ServingEngine(model, params, state,
        **kwargs)``."""
        kw = {f.name: getattr(self, f.name) for f in fields(self)
              if f.name != "bucket"}
        kw["buckets"] = (self.bucket,)
        return kw

    def to_argv(self) -> list:
        """Flags that reproduce this config through ``add_args`` +
        ``from_args`` (the round-trip contract)."""
        out = []
        for f in fields(self):
            v = getattr(self, f.name)
            flag = "--" + f.name.replace("_", "-")
            if f.name == "learn":
                if not v:
                    out.append("--no-learn")
            elif f.name == "tenant_weights":
                if v:
                    out += ["--tenant-weights", format_tenant_weights(v)]
            elif isinstance(v, bool):
                if v:
                    out.append(flag)
            elif v is None:
                continue
            else:
                out += [flag, str(v)]
        return out


def build_engine(config: EngineConfig, model, params, state, **overrides):
    """``ServingEngine`` from one config object (+ keyword overrides)."""
    from repro_torch.serving.engine import ServingEngine
    kw = config.engine_kwargs()
    kw.update(overrides)
    return ServingEngine(model, params, state, **kw)


# ---------------------------------------------------------------------------
# shared model-build recipe
# ---------------------------------------------------------------------------

@dataclass
class ModelSpec:
    """The (arch, tiny, seed, pretrain_steps) tuple that pins a serving
    model bit for bit, and the device it is built on: two processes
    building the same spec on one device (with the same PYTHONHASHSEED for
    the synthetic task stream) decode identical streams, which is what the
    load generator's --verify-direct checks."""
    arch: str = "vicuna-7b"
    tiny: bool = True
    seed: int = 0
    pretrain_steps: int = 200
    device: Optional[str] = None  # the card unless "cpu" is asked for

    @classmethod
    def add_args(cls, ap: argparse.ArgumentParser,
                 defaults: Optional["ModelSpec"] = None) -> None:
        d = defaults or cls()
        g = ap.add_argument_group("model", "backbone spec (ModelSpec)")
        g.add_argument("--arch", default=d.arch)
        g.add_argument("--tiny", action="store_true", default=d.tiny)
        g.add_argument("--full-size", action="store_true",
                       help="disable --tiny (full-size backbone)")
        g.add_argument("--seed", type=int, default=d.seed)
        g.add_argument("--pretrain-steps", type=int, default=d.pretrain_steps)
        g.add_argument("--device", default=d.device,
                       help="torch device (default: the card; 'cpu' runs the plain path)")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ModelSpec":
        return cls(arch=args.arch,
                   tiny=args.tiny and not getattr(args, "full_size", False),
                   seed=args.seed, pretrain_steps=args.pretrain_steps,
                   device=getattr(args, "device", None))


def build_model_bundle(spec: ModelSpec):
    """(cfg, model, params, tasks, state): the launchers' recipe — config
    in float32 -> init -> synthetic pretraining at lr 2e-3 -> a fresh online
    trainer state, its generators ``torch.Generator`` seeds on the model's
    device."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import online as online_mod
    from repro_torch.data import SyntheticTasks, TASK_CATEGORIES
    from repro_torch.models.model import build_model
    from repro_torch.training import pretrain

    cfg = get_config(spec.arch, tiny=spec.tiny).replace(dtype="float32")
    model = build_model(cfg, device=spec.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(spec.seed))
    tasks = SyntheticTasks(cfg.vocab_size, seed=spec.seed)
    params, _ = pretrain(
        model, params,
        tasks.stream(TASK_CATEGORIES, spec.pretrain_steps, 8, 32,
                     seed=spec.seed + 1), lr=2e-3)
    state = online_mod.init_trainer(model, torch.Generator(device=dev).manual_seed(spec.seed + 7))
    return cfg, model, params, tasks, state
