"""The hybrid and MoE decoders end to end on the port against the JAX
package, in float32: recurrentgemma-9b-tiny ((rglru, rglru, local), the
gemma embedding scale) and llama4-scout-17b-a16e-tiny (three local layers
and a global one, an MoE FFN on every layer).  Prefill logits, one
speculative block (hiddens, commits, the advanced cache),
``speculative_generate``, the continuous engine's streams against the JAX
engine's (contiguous for recurrentgemma, paged for llama4: rings per lane,
the global layer pooled), and chunked prefill on recurrentgemma-tiny ==
one-shot (and == the JAX chunked engine).

Weights are made once and handed to both packages; the deep blocks' output
projections are scaled down (x0.1) so drafts are accepted often.  Hiddens,
logits and caches are held to rtol 1e-5 / atol 1e-4 (the measured gap is
under 3e-5 on values up to 9: RG-LRU's scan and the MoE's sums run in
other float32 orders), tokens and counts to equality."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import online  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

NAMES = ["recurrentgemma-9b", "llama4-scout-17b-a16e"]
RTOL, ATOL = 1e-5, 1e-4
OUT_PROJ = ("wo", "w_o", "wo_ff", "we_down", "ws_down")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _scaled(tree):
    return {k: _scaled(v) if isinstance(v, dict) else (v * 0.1 if k in OUT_PROJ else v)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _make_pair(name):
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = dict(params_j["segments"])
    for s in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        segs[s.name] = _scaled(segs[s.name])
    params_j = dict(params_j, segments=segs)
    state = online.init_trainer(model_j, jax.random.PRNGKey(3))
    state.dvi_params = dict(state.dvi_params, B=jax.random.normal(
        jax.random.PRNGKey(11), state.dvi_params["B"].shape) * 0.01)
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, state.dvi_params), "cpu")
    return dict(name=name, cfg=cfg_t, model_j=model_j, params_j=params_j, state=state,
                model_t=model_t, params_t=params_t, dvi_t=dvi_t)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return _make_pair(request.param)


def _prompts(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (B, T)).astype(np.int32)


def _close_cache(cj, ct):
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name, seg in ct["segs"].items():
        for key, leaf in seg.items():
            if key == "pos":
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(cj["segs"][name][key]))
            else:
                _close(cj["segs"][name][key], leaf)


def test_prefill_logits(pair):
    s = pair
    toks = _prompts(s["cfg"], 2, 20, 1)
    h_j, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=40)
    h_t, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=40)
    _close(s["model_j"].logits(s["params_j"], h_j), s["model_t"].logits(s["params_t"], h_t))
    _close_cache(cj, ct)


def test_spec_block_matches_jax(pair):
    """One speculative block from a prefilled cache, lane 1 done: drafted
    and committed tokens, accepts and pending equal, hiddens and the
    advanced cache (rings, RG-LRU states selected at accept-1) close."""
    s = pair
    toks = _prompts(s["cfg"], 3, 12, 2)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks[:, :-1]), max_len=40)
    _, ct = s["model_t"].prefill(s["params_t"], _t(toks[:, :-1]), max_len=40)
    done = np.array([False, True, False])
    bj = jspec.spec_block_step(s["model_j"], s["params_j"], s["state"].dvi_params,
                               jnp.asarray(toks[:, -1]), cj, done=jnp.asarray(done))
    bt = tspec.spec_block_step(s["model_t"], s["params_t"], s["dvi_t"], _t(toks[:, -1]), ct,
                               done=_t(done))
    for key in ("d_blk", "commit_vec", "accept", "m", "pending"):
        np.testing.assert_array_equal(getattr(bt, key).numpy(), np.asarray(getattr(bj, key)),
                                      err_msg=key)
    _close(bj.hL_blk, bt.hL_blk)
    _close_cache(bj.cache, bt.cache)


def test_speculative_generate_matches_jax(pair):
    s = pair
    prompts = _prompts(s["cfg"], 3, 9, 4)
    live = np.array([True, False, True])
    r_j = jspec.speculative_generate(s["model_j"], s["params_j"], s["state"].dvi_params,
                                     jnp.asarray(prompts), 16, collect=True,
                                     live_mask=jnp.asarray(live))
    r_t = tspec.speculative_generate(s["model_t"], s["params_t"], s["dvi_t"], _t(prompts), 16,
                                     collect=True, live_mask=_t(live))
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    for b in range(3):
        n = min(int(r_t.lengths[b]), 9 + 16)
        np.testing.assert_array_equal(r_t.tokens[b, :n].numpy(), np.asarray(r_j.tokens[b, :n]))
    for name in ("blocks", "committed", "accepted_drafts", "drafted"):
        assert int(getattr(r_t, name)) == int(getattr(r_j, name)), name
    assert int(r_t.accepted_drafts) > 0
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 16)
    for b in (0, 2):
        n = int(r_ar.lengths[b])
        assert torch.equal(r_t.tokens[b, :n], r_ar.tokens[b, :n])


# the continuous engine: recurrentgemma on the contiguous layout, llama4
# paged (its rings per lane, its global layer in the pool)
ENGINE_KW = {
    "recurrentgemma-9b": dict(scheduler="continuous", num_slots=2, max_new=8, cache_len=40,
                              kv_pages=0, sync_every=2),
    "llama4-scout-17b-a16e": dict(scheduler="continuous", num_slots=2, max_new=8,
                                  cache_len=40, kv_pages=24, kv_page_size=4, sync_every=2),
}
REQS = [(5, 8), (14, 6), (9, 8), (7, 4), (12, 8)]


def _requests(cfg):
    rng = np.random.default_rng(21)
    return [(uid, rng.integers(2, cfg.vocab_size, n).astype(np.int32), mn)
            for uid, (n, mn) in enumerate(REQS)]


def _serve(eng, reqs, request_cls):
    for uid, p, mn in reqs:
        eng.submit_request(request_cls(uid, p, max_new=mn))
    outs = eng.run(max_steps=1000)
    assert len(outs) == len(reqs) and not eng.busy
    return {c.uid: c.gen_tokens.tolist() for c in outs}


def _port(s, **kw):
    return ServingEngine(s["model_t"], s["params_t"],
                         tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                         learn=False, **dict(ENGINE_KW[s["name"]], **kw))


def test_continuous_engine_matches_jax(pair):
    """Five requests through the port's and the JAX continuous engines:
    equal completions and counts; a paged engine's pool empty at the end."""
    s = pair
    reqs = _requests(s["cfg"])
    eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False,
                    **ENGINE_KW[s["name"]])
    eng_t = _port(s)
    assert eng_t.paged == (s["name"] != "recurrentgemma-9b")
    assert _serve(eng_t, reqs, Request) == _serve(eng_j, reqs, JRequest)
    for key in ("requests", "blocks", "committed", "accepted", "drafted", "dispatches"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.stats["accepted"] > 0 and eng_t.active_slots == 0
    if eng_t.paged:
        assert eng_t.kv_stats()["used_pages"] == 0
    with pytest.raises(ValueError, match="full-attention"):
        _port(s, kv_pages=24, kv_page_size=4, prefill_chunk=4, prefix_cache=True)


def test_chunked_prefill_equals_one_shot():
    """recurrentgemma-tiny on the contiguous engine with chunks of 5 (the
    RG-LRU states carried through ``rglru_step(take=)``, the ring written
    chunk by chunk): the one-shot engine's streams and the JAX chunked
    engine's, with equal chunk counters."""
    name = "recurrentgemma-9b"
    s = _make_pair(name)
    reqs = _requests(s["cfg"])
    one_shot = _serve(_port(s), reqs, Request)
    eng_t = _port(s, prefill_chunk=5)
    eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False,
                    **dict(ENGINE_KW[name], prefill_chunk=5))
    got_t, got_j = _serve(eng_t, reqs, Request), _serve(eng_j, reqs, JRequest)
    assert got_t == one_shot == got_j
    assert eng_t.stats["prefill_chunks"] > 0
    for key in ("prefill_chunks", "prefill_tokens", "max_tick_prefill_tokens", "blocks"):
        assert eng_t.stats[key] == eng_j.stats[key], key
