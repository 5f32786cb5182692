"""The port's sync ServingEngine against the JAX ServingEngine(scheduler="sync",
learn=False): same requests, same weights -> equal completions, statistics
and replay buffer (vicuna-7b-tiny, float32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import online  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

# prompt lengths across two buckets (one padded batch, one prompt truncated
# to the largest bucket) and per-request budgets below the engine's cap
PROMPTS = [(5, 10), (7, 6), (12, 10), (16, 4), (3, 10), (9, 10), (20, 8)]
KW = dict(batch_size=4, max_new=10, buckets=(8, 16))


@pytest.fixture(scope="module")
def engines():
    cfg_j = tiny_cfg("vicuna-7b")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    state = online.init_trainer(model_j, jax.random.PRNGKey(7))
    state.dvi_params = dict(state.dvi_params, B=jax.random.normal(
        jax.random.PRNGKey(3), state.dvi_params["B"].shape) * 0.02)
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, state.dvi_params), "cpu")
    eng_j = JEngine(model_j, params_j, state, scheduler="sync", learn=False, **KW)
    eng_t = ServingEngine(model_t, params_t, tonline.init_trainer(model_t, dvi_params=dvi_t),
                          learn=False, **KW)
    rng = np.random.default_rng(1)
    for uid, (n, max_new) in enumerate(PROMPTS):
        prompt = rng.integers(2, cfg_t.vocab_size, size=n).astype(np.int32)
        eng_j.submit_request(JRequest(uid, prompt, max_new=max_new))
        eng_t.submit_request(Request(uid, prompt, max_new=max_new))
    return eng_j, eng_j.run(), eng_t, eng_t.run()


def test_completions_equal(engines):
    _, comps_j, _, comps_t = engines
    assert [c.uid for c in comps_t] == [c.uid for c in comps_j]
    assert len(comps_t) == len(PROMPTS)
    for cj, ct in zip(comps_j, comps_t):
        np.testing.assert_array_equal(ct.tokens, cj.tokens)
        np.testing.assert_array_equal(ct.gen_tokens, cj.gen_tokens)
        assert ct.mat == pytest.approx(cj.mat, rel=0, abs=0)
        assert len(ct.gen_tokens) <= PROMPTS[ct.uid][1]


def test_stats_and_buffer_equal(engines):
    eng_j, _, eng_t, _ = engines
    for key in ("requests", "blocks", "committed", "accepted", "drafted"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.acceptance == eng_j.acceptance
    assert eng_t.stats["steps"] >= 2 and not eng_t.busy
    buf_j, buf_t = eng_j.state.buf, eng_t.buf
    for name in ("ptr", "count", "gen", "action", "reward", "pos", "prev", "age"):
        np.testing.assert_array_equal(buf_t[name].numpy(), np.asarray(buf_j[name]), err_msg=name)
    np.testing.assert_allclose(buf_t["h_L"].numpy(), np.asarray(buf_j["h_L"]),
                               rtol=1e-5, atol=2e-5)


def test_later_slices_raise():
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dvi = {"A": torch.zeros(cfg.d_model, 1), "B": torch.zeros(1, cfg.vocab_size)}
    state = tonline.init_trainer(model, dvi_params=dvi)
    # the prefix cache is ported: without chunked prefill it refuses, as the
    # reference does (tests/test_torch_prefix_cache.py holds the rest)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(model, params, state, scheduler="continuous", kv_pages=64,
                      prefix_cache=True)
    # chunked prefill is ported: the continuous scheduler takes it, the sync
    # one refuses it as the reference does
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(model, params, state, prefill_chunk=8)
    eng = ServingEngine(model, params, state, scheduler="continuous", kv_pages=64,
                        prefill_chunk=8)
    assert eng._chunk == 8 and eng.dispatch_stats()["prefill_chunk"] == 8
    # adaptive depth is ported: the continuous scheduler takes it, the sync
    # one refuses it as the reference does
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(model, params, state, adaptive_k=True)
    eng = ServingEngine(model, params, state, scheduler="continuous", kv_pages=64,
                        adaptive_k=True, k_min=2)
    assert eng._depth.k_min == 2 and eng._k_worst == cfg.dvi.k_spec
    with pytest.raises(TypeError):           # the drafter comes in a trainer state
        ServingEngine(model, params, dvi)
    eng = ServingEngine(model, params, state, batch_size=2, max_new=3)
    assert eng.step() == [] and eng.run() == []
