"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.launch.step_analysis``, ``repro_torch.roofline``) against
``repro.launch.dryrun``, ``repro.launch.hlo_analysis`` and
``repro.roofline``, and the repaired ``dense_train_losses`` signature.

* ``adapt_config`` (the configs and notes, the skips) for every arch and
  input shape, and ``make_aux_specs``' shapes;
* the wire-byte formula for every kind and group size, and the roofline's
  functions on one record: the reference's functions and the port's given
  the same record, with the reference's TPU constants put into the port's
  module for the comparison (the constants differ by design);
* vicuna-7b-tiny's serve step and prefill on a 2 x 2 mesh over a fake
  process group: the reference's record schema, nonzero FLOPs and
  collectives, argument bytes equal to the local shards' bytes; the same
  two cases held against the reference's own dry run (``build_case``
  compiled for 4 placeholder CPU devices in a subprocess, read by
  ``hlo_analysis``): FLOPs a device and argument bytes within 1 % (the
  reference keeps slot positions in every attention cache, 0.3 % of the
  decode case's arguments), collective wire bytes within a factor of 4
  (DTensor's eager redistributions are not GSPMD's plan: 0.5-1.5 times the
  reference's at this size); no default process group is left behind for
  the next test file of the same worker;
* the loop seam: ``loops.scan`` run one iteration a loop and scaled by the
  trip count counts the FLOPs of the full loops exactly (the layers and
  ``attend_full``'s blockwise chunk pairs of a prefill);
* ``dense_train_losses(..., "full", None, True)``: the positional call
  binds ``remat`` as the reference's does and gives the reference's loss;
  bound to ``max_positions`` (the signature before the repair) it does not.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro import roofline as jroof  # noqa: E402
from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core.lora import init_draft_params as jax_init_draft  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import roofline as troof, weights  # noqa: E402
from repro_torch.configs import INPUT_SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import step_analysis as sa  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ASSIGNED_ARCHS + ["vicuna-7b"]


def _same_cfg(cj, ct):
    if cj is None or ct is None:
        return cj is None and ct is None
    return all((dataclasses.asdict(getattr(cj, f.name)) == dataclasses.asdict(getattr(ct, f.name))
                if dataclasses.is_dataclass(getattr(cj, f.name))
                else getattr(cj, f.name) == getattr(ct, f.name))
               for f in dataclasses.fields(ct))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_adapt_config_and_aux_specs_match_reference(shape):
    for arch in ARCHS:
        for kvq in (False, True):
            cj, nj = jdry.adapt_config(arch, INPUT_SHAPES[shape], kvq)
            ct, nt = tdry.adapt_config(arch, T_SHAPES[shape], kvq)
            assert nj == nt and _same_cfg(cj, ct), (arch, shape, kvq)
        cfg = jax_get_config(arch)
        B = INPUT_SHAPES[shape].global_batch
        aj, at = jdry.make_aux_specs(cfg, B), tdry.make_aux_specs(get_config(arch), B)
        assert (aj is None) == (at is None)
        if aj is not None:
            assert {k: tuple(v.shape) for k, v in aj.items()} == \
                {k: tuple(v.shape) for k, v in at.items()}
            assert all(v.dtype == torch.float32 for v in at.values())


def test_wire_bytes_match_reference():
    for kind in sa.COLLECTIVES:
        for g in (1, 2, 8, 16, 32, 256):
            for b in (0.0, 4096.0, 3.5e9):
                assert sa.wire_bytes(kind, b, g) == jhlo._wire_bytes(kind, b, g)


RECORD = {"n_devices": 256, "cost": {"dot_flops_per_device": 3.1e14},
          "collectives": {"total": {"count": 900.0, "payload_bytes": 2.0e10,
                                    "wire_bytes": 1.7e10}},
          "memory": {"argument_bytes": 9e9, "output_bytes": 1e6, "temp_bytes": 3e9,
                     "peak_bytes": 1.2e10}}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_roofline_matches_reference_with_its_constants(shape, monkeypatch):
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(troof, "NET_BW", jroof.ICI_BW)
    monkeypatch.setattr(troof, "NVLINK_BW", jroof.ICI_BW)
    monkeypatch.setattr(troof, "hbm_per_card", lambda: jroof.HBM_PER_CHIP)
    for arch in ARCHS:
        cj, ct = jax_get_config(arch), get_config(arch)
        sj, st = INPUT_SHAPES[shape], T_SHAPES[shape]
        for S, B in ((sj.seq_len, sj.global_batch), (4096, 8)):
            assert troof._cache_bytes(ct, S, B) == jroof._cache_bytes(cj, S, B), arch
        assert troof.analytic_hbm_bytes(ct, st, 256) == jroof.analytic_hbm_bytes(cj, sj, 256)
        assert troof.model_flops(ct, st) == jroof.model_flops(cj, sj)
        rj = jroof.roofline_from_record(RECORD, cj, sj)
        rt = troof.roofline_from_record(RECORD, ct, st)
        assert rt == rj, arch
        assert troof.suggestion(rt)
    # with a per-axis split, each axis is priced by its link
    rec = dict(RECORD, collectives=dict(RECORD["collectives"], per_axis={
        "model": {"wire_bytes": 4.5e9}, "data": {"wire_bytes": 5e9}}))
    monkeypatch.setattr(troof, "NVLINK_BW", 450e9)
    assert troof.collective_seconds(rec["collectives"]) == pytest.approx(
        4.5e9 / 450e9 + 5e9 / jroof.ICI_BW)


# the reference's dry run of the same two cases, compiled for 4
# placeholder CPU devices (a process of its own: the flag must precede
# jax's first import)
_REFERENCE_2X2 = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import dryrun, hlo_analysis
from repro.launch.hints import set_hint_mesh
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
set_hint_mesh(mesh)
out = {}
for kind in ("decode", "prefill"):
    cfg = get_config("vicuna-7b", tiny=True)
    fn, args, shards = dryrun.build_case(cfg, InputShape("tiny_" + kind, 64, 4, kind), mesh)
    with mesh:
        c = jax.jit(fn, in_shardings=shards,
                    donate_argnums=getattr(fn, "donate", ())).lower(*args).compile()
    deep = hlo_analysis.analyze(c.as_text())
    out[kind] = {"argument_bytes": c.memory_analysis().argument_size_in_bytes,
                 "dot_flops_per_device": deep["dot_flops_per_device"],
                 "wire_bytes": deep["collectives_total"]["wire_bytes"]}
print(json.dumps(out))
"""
TINY_MESH = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def tiny_records():
    """The port's records of vicuna-7b-tiny's serve step and prefill (B 4,
    64 tokens) on a 2 x 2 mesh, and the reference's of the same cases."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_2X2], env=env, cwd=root,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    assert not dist.is_initialized()
    try:
        cfg = get_config("vicuna-7b", tiny=True)
        port = {kind: tdry.run_case("vicuna-7b", None, mesh_shape=MeshShape(TINY_MESH),
                                    shape=InputShape("tiny_" + kind, 64, 4, kind), cfg=cfg)
                for kind in ("decode", "prefill")}
        # a failed case must not leak its group into the next test file
        assert not dist.is_initialized(), "the dry run left a default process group behind"
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, stderr[-3000:]
    return port, json.loads(stdout.strip().splitlines()[-1])


def test_tiny_case_writes_the_reference_schema(tiny_records):
    cfg = get_config("vicuna-7b", tiny=True)
    rec = tiny_records[0]["decode"]
    assert rec["status"] == "ok" and rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    assert rec["torch"] == torch.__version__
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert rec["cost"]["dot_flops_per_device"] > 0
    coll = rec["collectives"]
    for table in (coll["per_kind"], coll["per_axis"], {"total": coll["total"]}):
        for d in table.values():
            assert set(d) == {"count", "payload_bytes", "wire_bytes"}
    assert coll["total"]["count"] > 0 and set(coll["per_kind"]) <= set(sa.COLLECTIVES)
    assert set(coll["per_axis"]) <= {"data", "model"}
    assert rec["params_total"] == cfg.param_count()
    assert rec["params_active"] == cfg.active_param_count()
    # argument bytes: each leaf's local shard (params 2-D tensor parallel,
    # the cache batch over "data" and sequence over "model")
    cap = tdry.decode_cap(cfg, 64)
    model = build_model(cfg, device="cpu")
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import tree
    from repro_torch.core import lora
    from repro_torch.launch import sharding as shd
    mesh = MeshShape(TINY_MESH)
    with FakeTensorMode():
        params = tree.flatten(model.init(torch.Generator()))
        dvi = tree.flatten(lora.init_draft_params(torch.Generator(), cfg))
    cache = tree.flatten(model.init_cache(4, cap))

    def local_bytes(t, spec):
        n = t.numel() * t.element_size()
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                n //= mesh.shape[a]
        return n
    want = sum(local_bytes(t, shd.spec_for(p, tuple(t.shape), mesh.shape))
               for p, t in {**params, **dvi}.items())
    want += sum(local_bytes(t, shd.cache_spec(p, tuple(t.shape), mesh.shape))
                for p, t in cache.items())
    want += 4 * 4 // 2                    # pending (B,) int32, batch over "data"
    assert mem["argument_bytes"] == want


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_tiny_sharded_case_against_the_reference_dry_run(tiny_records, kind):
    port, ref = tiny_records[0][kind], tiny_records[1][kind]
    assert port["cost"]["dot_flops_per_device"] == pytest.approx(
        ref["dot_flops_per_device"], rel=1e-2)
    assert port["memory"]["argument_bytes"] == pytest.approx(ref["argument_bytes"], rel=1e-2)
    wire = port["collectives"]["total"]["wire_bytes"]
    assert ref["wire_bytes"] / 4 <= wire <= ref["wire_bytes"] * 4, (wire, ref["wire_bytes"])


def test_one_iteration_loops_count_the_full_loops():
    from repro_torch.models import layers, loops
    cfg = get_config("vicuna-7b", tiny=True)
    model = build_model(cfg, device="cpu")
    T = 1100                              # past attend_full's blockwise threshold
    assert T * T > layers._FLASH_THRESHOLD

    def flops(one_iteration: bool):
        counter = sa.StepCounter()
        with counter:
            params = model.init(torch.Generator())
            tokens = torch.zeros((2, T), dtype=torch.long)
            counter.counting = True
            with (loops.runner(sa._one_iteration(counter)) if one_iteration
                  else contextlib.nullcontext()):
                model.prefill(params, tokens, max_len=T + 8)
        return counter.flops
    assert flops(True) == flops(False) > 0


def test_dense_train_losses_takes_remat_where_the_reference_does():
    name = "vicuna-7b"
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    # weights drawn with numpy in the reference's tree (faster than its init)
    rng = np.random.default_rng(0)
    params_j = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.05),
        jax.eval_shape(lambda: model_j.init(jax.random.PRNGKey(0))))
    dvi_j = {k: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.05)
             for k, s in jax.eval_shape(lambda: jax_init_draft(jax.random.PRNGKey(1),
                                                               cfg_j)).items()}
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = {k: torch.from_numpy(np.array(v)) for k, v in dvi_j.items()}
    tokens = np.random.default_rng(3).integers(2, cfg_t.vocab_size, (2, 12)).astype(np.int32)
    lj, _ = jax.jit(lambda p, d, t: jlosses.dense_train_losses(
        model_j, p, d, t, 350, jnp.float32(0.2), "full", None, True))(
            params_j, dvi_j, jnp.asarray(tokens))
    lt, _ = tlosses.dense_train_losses(model_t, params_t, dvi_t, torch.from_numpy(tokens), 350,
                                       torch.tensor(0.2), "full", None, True)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-5)
    # the signature before the repair bound True to max_positions: one position
    l_old, _ = tlosses.dense_train_losses(model_t, params_t, dvi_t, torch.from_numpy(tokens),
                                          350, torch.tensor(0.2), "full", None,
                                          max_positions=True)
    assert abs(float(l_old) - float(lj)) > 1e-4
