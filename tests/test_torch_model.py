"""The port's config copy, weight bridge and model (prefill, a draft step and
a verify step) against the JAX Model, for vicuna-7b-tiny (MHA) and
qwen3-0.6b-tiny (GQA, qk_norm, tied head), in float32.  Hiddens and logits
within rtol 1e-5 / atol 2e-5, caches likewise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.checkpoint.ckpt import save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import buffer as tbuffer  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

NAMES = ["vicuna-7b", "qwen3-0.6b"]
RTOL, ATOL = 1e-5, 2e-5
NORMS = ("ln1", "ln2", "final_norm", "qn", "kn")


def _perturb_norms(tree, rng):
    """Random norm gains, so the (1 + w) convention is exercised."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                    if k in NORMS else _perturb_norms(v, rng)) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    params_j = _perturb_norms(model_j.init(jax.random.PRNGKey(0)), np.random.default_rng(1))
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, model_j, params_j, cfg_t, model_t, params_t


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("tiny", [False, True])
def test_config_copy_matches_reference(name, tiny):
    cj, ct = jax_get_config(name, tiny=tiny), get_config(name, tiny=tiny)
    for f in dataclasses.fields(ct):
        vj, vt = getattr(cj, f.name), getattr(ct, f.name)
        if f.name == "dvi":
            assert dataclasses.asdict(vj) == dataclasses.asdict(vt)
        else:
            assert vj == vt, f.name
    assert {f.name for f in dataclasses.fields(cj)} == {f.name for f in dataclasses.fields(ct)}
    assert ct.resolved_head_dim == cj.resolved_head_dim
    assert ct.layer_pattern == cj.layer_pattern
    assert ct.torch_dtype == getattr(torch, cj.jnp_dtype.name)


def test_unported_architectures_raise():
    cfg = get_config("vicuna-7b", tiny=True)
    for kw in (dict(sliding_window=64), dict(kv_quant=True), dict(moe=object())):
        with pytest.raises(NotImplementedError):
            build_model(cfg.replace(**kw), device="cpu")


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("vicuna-7b", tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuffer.init_buffer(cfg, 4)
    assert tbuffer.init_buffer(cfg, 4, device="cpu")["h_k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_cache(cfg, 2, 16)
    assert tfm.init_cache(cfg, 2, 16, device="cpu")["lengths"].device.type == "cpu"


def test_weight_bridge(pair):
    cfg_j, _, params_j, cfg_t, _, params_t = pair
    flat_j = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(params_j)[0]}
    assert len(flat_j) >= 10
    for key, arr in flat_j.items():
        node = params_t
        for part in key.strip("[]'").split("']['"):
            node = node[part]
        assert node.dtype == torch.float32 and tuple(node.shape) == arr.shape, key
        np.testing.assert_array_equal(node.numpy(), arr)
    head = params_t["lm_head"]
    assert head.is_contiguous() and tuple(head.shape) == (cfg_t.d_model, cfg_t.vocab_size)
    if cfg_t.tie_embeddings:
        assert "lm_head" not in params_j
        np.testing.assert_array_equal(head.numpy(), np.asarray(params_j["embed"]).T)


def test_load_npz_roundtrip(pair, tmp_path):
    _, _, params_j, cfg_t, _, params_t = pair
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params_j)
    loaded = weights.load_npz(cfg_t, path, "cpu")
    got = jax.tree_util.tree_leaves(jax.tree.map(lambda t: t.numpy(), loaded))
    want = jax.tree_util.tree_leaves(jax.tree.map(lambda t: t.numpy(), params_t))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bf16_leaves_are_bit_exact():
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 5)).astype(jnp.bfloat16)
    t = weights.params_from_numpy(get_config("vicuna-7b", tiny=True),
                                  {"w": np.asarray(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))
    d = weights.draft_params_from_numpy({"A": np.asarray(x), "B": np.ones((2, 2))}, "cpu")
    assert d["A"].dtype == d["B"].dtype == torch.float32


def _prefill(pair, B=2, T=7, C=40, seed=3):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = pair
    tokens = np.random.default_rng(seed).integers(2, cfg_t.vocab_size, size=(B, T)).astype(np.int32)
    h_j, cache_j, _ = model_j.prefill(params_j, jnp.asarray(tokens), max_len=C)
    h_t, cache_t = model_t.prefill(params_t, torch.from_numpy(tokens), max_len=C)
    return tokens, h_j, cache_j, h_t, cache_t


def _close_cache(cache_j, cache_t, names=None):
    np.testing.assert_array_equal(cache_t["lengths"].numpy(), np.asarray(cache_j["lengths"]))
    for name, seg in cache_t["segs"].items():
        if names is not None and name not in names:
            continue
        _close(cache_j["segs"][name]["k"], seg["k"])
        _close(cache_j["segs"][name]["v"], seg["v"])


def test_prefill_hidden_logits_and_cache(pair):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = pair
    _, h_j, cache_j, h_t, cache_t = _prefill(pair)
    _close(h_j, h_t)
    _close(model_j.logits(params_j, h_j), model_t.logits(params_t, h_t))
    _close_cache(cache_j, cache_t)


def test_draft_step_and_verify_step(pair):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = pair
    k, L, K = cfg_t.dvi.split_layer, cfg_t.num_layers, cfg_t.dvi.k_spec
    tokens, _, cache_j, _, cache_t = _prefill(pair)
    shallow = [s.name for s in tfm.segments_in_range(cfg_t, 0, k)]
    # one draft feed: the pending token through layers [0, k)
    pend = tokens[:, -1:]
    h_j, cache_j, _, _ = model_j.step(params_j, model_j.embed_block(params_j, jnp.asarray(pend)),
                                      cache_j, 0, k)
    h_t, cache_t = model_t.step(params_t, model_t.embed_block(params_t, torch.from_numpy(pend)),
                                cache_t, 0, k)
    _close(h_j, h_t)
    _close_cache(cache_j, cache_t, shallow)
    # a verify block: K+1 hiddens through layers [k, L), then the head
    x = np.random.default_rng(4).standard_normal((2, K + 1, cfg_t.d_model)).astype(np.float32)
    hL_j, cache_j, _, _ = model_j.step(params_j, jnp.asarray(x), cache_j, k, L)
    hL_t, cache_t = model_t.step(params_t, torch.from_numpy(x), cache_t, k, L)
    _close(hL_j, hL_t)
    _close(model_j.logits(params_j, hL_j), model_t.logits(params_t, hL_t))
    _close_cache(cache_j, cache_t)
    # commit advances lengths only
    acc = np.array([1, 3], np.int32)
    np.testing.assert_array_equal(
        model_t.commit(cache_t, torch.from_numpy(acc))["lengths"].numpy(),
        np.asarray(model_j.commit(cache_j, {}, jnp.asarray(acc))["lengths"]))


def test_step_past_capacity_drops_writes(pair):
    """Eager writes past the cache capacity are dropped (the reference's
    spread_write(wrap=False)), and attention sees every filled slot."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = pair
    K = cfg_t.dvi.k_spec
    T, C = 7, 9                                      # K+1 = 5 writes, 2 fit
    _, _, cache_j, _, cache_t = _prefill(pair, T=T, C=C)
    x = np.random.default_rng(5).standard_normal((2, K + 1, cfg_t.d_model)).astype(np.float32)
    h_j, cache_j, _, _ = model_j.step(params_j, jnp.asarray(x), cache_j)
    h_t, cache_t = model_t.step(params_t, torch.from_numpy(x), cache_t)
    _close(h_j, h_t)
    _close_cache(cache_j, cache_t)
