"""The port's partitioner and hints (``repro_torch.launch.sharding``,
``repro_torch.launch.hints``) against ``repro.launch.sharding`` and
``repro.launch.hints``, and the MoE FFN's token groups against the
reference's.

* parameter specs, leaf for leaf, for all 11 configs on the reference
  tests' 16 x 16 and 2 x 16 x 16 meshes, at 2 x 2 and at the port's
  production 32 x 8 and 2 x 32 x 8: the port's tree (drawn as fake
  tensors) has the reference's paths and shapes (plus a tied head's
  ``lm_head`` copy), and every spec equals the reference's
  ``PartitionSpec`` entry by entry;
* ``cache_specs`` on the tiny configs' caches, ``batch_axes`` and
  ``tokens_spec``;
* ``hint``'s spec: the reference's is captured by replacing
  ``NamedSharding`` and ``with_sharding_constraint`` in
  ``repro.launch.hints`` (nothing else is touched);
* ``moe_ffn`` at 2 token groups (the port's under a hint mesh of 2 "data"
  shards, the reference's with ``_num_groups`` patched to 2 and no hint
  mesh), float32, with capacity drops, rtol 1e-5.

No process group is made here: the meshes are shapes only (``MeshShape``).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import hints as jhints  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.launch import hints, sharding as shd  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_shape  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

MESHES = (MeshShape({"data": 16, "model": 16}), MeshShape({"pod": 2, "data": 16, "model": 16}),
          MeshShape({"data": 2, "model": 2}), production_shape(), production_shape(multi_pod=True))


def _ref_flat(tree_, is_leaf=None):
    return {jshd._path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree_, is_leaf=is_leaf)[0]}


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_specs_match_reference(name):
    jcfg = jax_get_config(name)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    ref_shapes = {p: tuple(s.shape) for p, s in _ref_flat(shapes).items()}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        port = tree.flatten(build_model(get_config(name), device="cpu").init(torch.Generator()))
    port_shapes = {p: tuple(t.shape) for p, t in port.items()}
    extra = set(port_shapes) - set(ref_shapes)
    assert extra <= ({"lm_head"} if jcfg.tie_embeddings else set()), extra
    assert {p: port_shapes[p] for p in ref_shapes} == ref_shapes
    for mesh in MESHES:
        want = _ref_flat(jshd.param_specs(shapes, mesh), is_leaf=lambda x: isinstance(x, P))
        got = shd.param_specs_flat(port, mesh)
        assert tree.unflatten(got).keys() == shd.param_specs(
            tree.unflatten(port), mesh).keys()
        for p, spec in want.items():
            assert got[p] == _padded(spec, len(ref_shapes[p])), (name, mesh, p)
        if "lm_head" in extra:          # the tied copy: the reference's untied rule
            assert got["lm_head"] == shd.spec_for("lm_head", port_shapes["lm_head"],
                                                  mesh.shape)


@pytest.mark.parametrize("name", ["vicuna-7b", "recurrentgemma-9b", "deepseek-v3-671b",
                                  "whisper-large-v3", "mamba2-370m"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_specs_match_reference(name, kv_quant):
    jcfg = tiny_cfg(name).replace(kv_quant=kv_quant)
    tcfg = get_config(name, tiny=True).replace(dtype="float32", kv_quant=kv_quant)
    B, S = 4, 64
    jcache = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(B, S))
    tcache = tfm.init_cache(tcfg, B, S, device="meta")
    jflat, tflat = _ref_flat(jcache), tree.flatten(tcache)
    shared = set(jflat) & set(tflat)
    # the port keeps no "pos" for full caches and adds the cross lengths
    assert set(tflat) - set(jflat) <= {"xlen"} and all(
        p.endswith("pos") for p in set(jflat) - set(tflat))
    for mesh in (MeshShape({"data": 2, "model": 2}), MeshShape({"pod": 2, "data": 2, "model": 4}),
                 MeshShape({"data": 16, "model": 16})):
        want = _ref_flat(jshd.cache_specs(jcfg, jcache, mesh), is_leaf=lambda x: isinstance(x, P))
        got = tree.flatten(shd.cache_specs(tcfg, tcache, mesh))
        for p in shared:
            assert got[p] == _padded(want[p], len(jflat[p].shape)), (name, mesh, p)
        assert got.get("xlen", (None,)) == (None,)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_batch_axes_and_tokens_spec(mesh):
    for batch in (1, 2, 4, 16, 32, 64, 128, 256, 512):
        for include_model in (False, True):
            assert shd.batch_axes(mesh, batch, include_model) == jshd.batch_axes(
                mesh, batch, include_model)
            assert shd.tokens_spec(mesh, batch, include_model) == tuple(
                jshd.tokens_spec(mesh, batch, include_model))


# (shape, axes) at the reference's call sites: the decode flow's activations
# and q / k / v, the cache, the prefill contributions, the blocked attention,
# the MoE buffers, MLA's concatenated heads
HINT_CASES = [
    ((8, 5, 4096), (None, None, "data")),
    ((8, 5, 32, 128), ("data", None, None, None)),
    ((8, 294, 32, 128), ("data", "model", None, None)),
    ((32, 32768, 8, 128), ("data", "model", None, None)),
    ((32, 4096, 16384), (("data", "model"), None, None)),
    ((3, 4096, 16384), (("data", "model"), None, None)),
    ((16, 4096, 16384), (("data", "model"), None, None)),
    ((256, 16, 256, 8, 16, 128), (("data", "model"), None, None, "model", "model", None)),
    ((8, 128, 256, 8, 2, 128), (("data", "model"), None, None, "model", "model", None)),
    ((32, 64, 1024, 1, 128), (("data", "model"), None, None, "model", None)),
    ((16, 40, 7168), ("data", None, None)),
    ((16, 320, 7168), ("data", None, "model")),
    ((16, 256, 40, 7168), ("data", None, None, "model")),
    ((16, 256, 40, 2048), ("data", "model", None, None)),
    ((8, 128, 128, 192), ("data", None, "model", None)),
    ((1, 5, 4096), (None, None, "data")),
    ((4, 100, 8), ("data", "model", None)),
]


@pytest.mark.parametrize("mesh", MESHES[:3] + MESHES[3:4], ids=str)
def test_hint_spec_matches_reference(mesh, monkeypatch):
    jax_ns = types.SimpleNamespace(lax=types.SimpleNamespace(
        with_sharding_constraint=lambda x, s: ("constrained", s)))
    monkeypatch.setattr(jhints, "jax", jax_ns)
    monkeypatch.setattr(jhints, "NamedSharding", lambda m, spec: spec)
    for shape, axes in HINT_CASES:
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        with jhints.hint_mesh(mesh):
            ref = jhints.hint(x, *axes)
        got = hints.hint_spec(shape, axes, mesh.shape)
        if ref is x:
            assert got is None, (mesh, shape, axes, got)
        else:
            assert got == _padded(ref[1], len(shape)), (mesh, shape, axes)
    # a plain tensor passes through any hint mesh untouched
    t = torch.zeros(8, 5, 4096)
    with hints.hint_mesh(mesh):
        assert hints.hint(t, None, None, "data") is t


@pytest.fixture(scope="module")
def moe_layer():
    """One MoE FFN of llama4-scout-17b-a16e-tiny drawn with numpy (float32),
    for both packages."""
    cfg = tiny_cfg("llama4-scout-17b-a16e")
    mo, d = cfg.moe, cfg.d_model
    fe, E = mo.d_ff_expert, mo.num_experts
    fs = (mo.d_ff_shared or fe) * mo.num_shared_experts
    rng = np.random.default_rng(5)
    shapes = {"router": (d, E), "we_gate": (E, d, fe), "we_up": (E, d, fe),
              "we_down": (E, fe, d), "ws_gate": (d, fs), "ws_up": (d, fs), "ws_down": (fs, d)}
    p = {k: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32)
         for k, sh in shapes.items() if fs or not k.startswith("ws")}
    return cfg, p


@pytest.mark.parametrize("dropless,capacity_factor", [(False, 0.5), (True, 1.25)])
def test_moe_two_groups_match_reference(moe_layer, dropless, capacity_factor, monkeypatch):
    cfg, p = moe_layer
    mj = dataclasses.replace(cfg.moe, top_k=2, capacity_factor=capacity_factor)
    mt = MoEConfig(**dataclasses.asdict(mj))
    x = np.random.default_rng(7).standard_normal((4, 9, cfg.d_model)).astype(np.float32)
    monkeypatch.setattr(jmoe, "_num_groups", lambda N: 2)
    ref = jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, x_, mj, cfg.act, cfg.glu, dropless))
    y_j, aux_j = ref({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    p_t = {k: torch.from_numpy(v) for k, v in p.items()}
    with hints.hint_mesh(MeshShape({"data": 2, "model": 1})):
        assert tmoe.num_groups(36) == 2 and tmoe.num_groups(35) == 1
        y_t, aux_t = tmoe.moe_ffn(p_t, torch.from_numpy(x), mt, cfg.act, cfg.glu, dropless)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    # one group (no hint mesh) routes differently when capacity drops rows
    y_1, _ = tmoe.moe_ffn(p_t, torch.from_numpy(x), mt, cfg.act, cfg.glu, dropless)
    assert tmoe.num_groups(36) == 1
    if not dropless:
        assert not torch.allclose(y_1, y_t)
