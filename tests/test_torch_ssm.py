"""The port's Mamba-2 path against the JAX package, mamba2-370m-tiny in float32:
the plain SSD scan against ``repro.models.ssm.ssd_chunked`` and the Pallas
``ssd_scan`` in interpret mode, ``conv1d_causal``, the full-sequence block
at a T that needs padding and at T < chunk, the step path's candidates
and their independence of the block length, prefill/step/commit with
per-lane accepts, chained speculative blocks
against the port's own ``ar_generate``, ``speculative_generate`` at depth
2, SSM lane surgery, and the sync and continuous (contiguous) engines'
completions against the JAX engine's.

Inputs are made with numpy from a seed and handed to both sides.  Scan and
layer outputs are held to atol 1e-4 (``tests/test_kernels.py::
test_ssd_scan``'s tolerance; the port's y is float32 like ssd_chunked's),
model hiddens and caches to rtol 1e-5 / atol 2e-5 (``tests/test_torch_model.py``),
tokens and counts to equality.  The deep block's ``out_proj`` is scaled
down (x0.1) so the drafter agrees with the verifier often enough that
accepted prefixes, bonus tokens and rejections all occur."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread keeps the test workers, which share
# the cores, from oversubscribing them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import online  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

NAME = "mamba2-370m"
SCAN_ATOL = 1e-4
RTOL, ATOL = 1e-5, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _scan_inputs(seed, B, T, H, hd, ds):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((B, T, H, hd)).astype(f32),
            (rng.standard_normal((B, T, 1, ds)) * 0.5).astype(f32),
            (rng.standard_normal((B, T, 1, ds)) * 0.5).astype(f32),
            np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(f32),
            (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32))


@pytest.fixture(scope="module")
def pair():
    cfg_j = tiny_cfg(NAME)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    segs = {}
    for seg in jtfm.model_segments(cfg_j):
        sp = dict(params_j["segments"][seg.name])
        for key in ("ln1", "norm_w"):             # random norm gains: (1 + w) is exercised
            sp[key] = jnp.asarray(rng.standard_normal(sp[key].shape).astype(np.float32) * 0.1)
        if seg.start >= cfg_j.dvi.split_layer:
            sp["out_proj"] = sp["out_proj"] * 0.1
        segs[seg.name] = sp
    params_j = dict(params_j, segments=segs)
    state = online.init_trainer(model_j, jax.random.PRNGKey(3))
    state.dvi_params = dict(state.dvi_params, B=jax.random.normal(
        jax.random.PRNGKey(11), state.dvi_params["B"].shape) * 0.01)
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, state.dvi_params), "cpu")
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, state=state,
                cfg_t=cfg_t, model_t=model_t, params_t=params_t, dvi_t=dvi_t)


# ---------------------------------------------------------------------------
# the scan's plain version, the conv, the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Q", [16, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_ssd_scan_matches_ssd_chunked(Q, with_h0):
    B, T, H, hd, ds = 2, 64, 4, 16, 32
    xh, Bc, Cc, dt, A = _scan_inputs(Q + with_h0, B, T, H, hd, ds)
    h0 = (np.random.default_rng(7).standard_normal((B, H, hd, ds)).astype(np.float32)
          if with_h0 else None)
    y_j, h_j = jssm.ssd_chunked(*map(jnp.asarray, (xh, Bc, Cc, dt, A)), Q,
                                h0=None if h0 is None else jnp.asarray(h0))
    y_t, h_t = ref.ssd_scan(*map(_t, (xh, Bc, Cc, dt, A)), Q,
                            h0=None if h0 is None else _t(h0))
    assert y_t.dtype == h_t.dtype == torch.float32
    _close(y_j, y_t, rtol=0, atol=SCAN_ATOL)
    _close(h_j, h_t, rtol=0, atol=SCAN_ATOL)


def test_plain_ssd_scan_matches_pallas_interpret():
    B, T, H, hd, ds, Q = 1, 32, 2, 8, 16, 16
    xh, Bc, Cc, dt, A = _scan_inputs(5, B, T, H, hd, ds)
    y_j, h_j = pallas_ssd_scan(*map(jnp.asarray, (xh, Bc, Cc, dt, A)), chunk=Q,
                               interpret=True)
    y_t, h_t = ref.ssd_scan(*map(_t, (xh, Bc, Cc, dt, A)), Q)
    _close(np.asarray(y_j, np.float32), y_t, rtol=0, atol=SCAN_ATOL)
    _close(h_j, h_t, rtol=0, atol=SCAN_ATOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 7])
def test_conv1d_causal(with_state, T):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    y_j, s_j = jlayers.conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    y_t, s_t = tlayers.conv1d_causal(_t(x), _t(w), None if st is None else _t(st))
    _close(y_j, y_t)
    _close(s_j, s_t, rtol=0, atol=0)


def _layer(params, i=0, name="s0"):
    return {k: v[i] for k, v in params["segments"][name].items()}


@pytest.mark.parametrize("T", [45, 20])
def test_ssm_forward_full(pair, T):
    """T = 45 pads to two chunks of 32 (dt = 0 rows); T = 20 is one chunk of 20."""
    s = pair
    x = np.random.default_rng(T).standard_normal((2, T, s["cfg_t"].d_model)).astype(np.float32)
    out_j, con_j = jssm.ssm_forward_full(_layer(s["params_j"]), jnp.asarray(x),
                                         s["cfg_j"].ssm, s["cfg_j"].norm_eps)
    out_t, con_t = tssm.ssm_forward_full(_layer(s["params_t"]), _t(x), s["cfg_t"].ssm,
                                         s["cfg_t"].norm_eps)
    _close(out_j, out_t, rtol=0, atol=SCAN_ATOL)
    _close(con_j["conv"], con_t["conv"])
    _close(con_j["state"], con_t["state"], rtol=0, atol=SCAN_ATOL)


def test_ssm_step_candidates(pair):
    """Five tokens from a nonzero conv window and state: the output and the
    window and state after each token; the cache itself is untouched."""
    s = pair
    cfg = s["cfg_t"]
    d_in, H, conv_dim, _ = tssm.ssm_dims(cfg.d_model, cfg.ssm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.ssm.d_conv - 1, conv_dim)).astype(np.float32)
    state = rng.standard_normal((2, H, cfg.ssm.head_dim, cfg.ssm.d_state)).astype(np.float32)
    out_j, cand_j = jssm.ssm_step(_layer(s["params_j"]), jnp.asarray(x),
                                  {"conv": jnp.asarray(conv), "state": jnp.asarray(state)},
                                  s["cfg_j"].ssm, s["cfg_j"].norm_eps)
    cache_t = {"conv": _t(conv), "state": _t(state)}
    out_t, cand_t = tssm.ssm_step(_layer(s["params_t"]), _t(x), cache_t, cfg.ssm, cfg.norm_eps)
    _close(out_j, out_t)
    assert tuple(cand_t["conv"].shape) == (2, 5, cfg.ssm.d_conv - 1, conv_dim)
    assert tuple(cand_t["state"].shape) == (2, 5, H, cfg.ssm.head_dim, cfg.ssm.d_state)
    _close(cand_j["conv"], cand_t["conv"])
    _close(cand_j["state"], cand_t["state"])
    np.testing.assert_array_equal(cache_t["state"].numpy(), state)


def test_ssm_step_is_token_by_token(pair):
    """A block of five tokens gives bit for bit what five chained one-token
    steps give: a token's arithmetic does not depend on the block length."""
    s = pair
    cfg = s["cfg_t"]
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32))
    cache = tssm.init_ssm_cache(1, 2, cfg.d_model, cfg.ssm, torch.float32, "cpu")
    cache = {k: v[0] + 0.1 for k, v in cache.items()}
    p = _layer(s["params_t"])
    out, cand = tssm.ssm_step(p, x, cache, cfg.ssm, cfg.norm_eps)
    c = cache
    for t in range(5):
        o, cd = tssm.ssm_step(p, x[:, t:t + 1].contiguous(), c, cfg.ssm, cfg.norm_eps)
        assert torch.equal(o[:, 0], out[:, t])
        for key in ("conv", "state"):
            assert torch.equal(cd[key][:, 0], cand[key][:, t])
        c = {key: cd[key][:, 0] for key in cd}


def _cache_close(cj, ct):
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name, seg in ct["segs"].items():
        assert set(seg) == {"conv", "state"}
        for key, leaf in seg.items():
            _close(cj["segs"][name][key], leaf)


def test_prefill_step_commit(pair):
    """Prefill, a verify-sized step over the whole stack, then commit with
    per-lane accepts 0, 2 and 5: lane 0 keeps its state, the others take
    their candidate at accept-1."""
    s = pair
    toks = np.random.default_rng(9).integers(2, s["cfg_t"].vocab_size, (3, 11)).astype(np.int32)
    h_j, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=32)
    h_t, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=32)
    _close(h_j, h_t)
    _cache_close(cj, ct)
    x = np.random.default_rng(10).standard_normal((3, 5, s["cfg_t"].d_model)).astype(np.float32)
    hj, cj, cands_j, _ = s["model_j"].step(s["params_j"], jnp.asarray(x), cj)
    ht, ct, cands_t = s["model_t"].step(s["params_t"], _t(x), ct)
    _close(hj, ht)
    assert set(cands_t) == set(cands_j) == {seg.name for seg in tfm.model_segments(s["cfg_t"])}
    before = {n: c["state"][:, 0].clone() for n, c in ct["segs"].items()}
    acc = np.array([0, 2, 5], np.int32)
    cj = s["model_j"].commit(cj, cands_j, jnp.asarray(acc))
    ct = s["model_t"].commit(ct, cands_t, _t(acc))
    _cache_close(cj, ct)
    for name, c in ct["segs"].items():
        assert torch.equal(c["state"][:, 0], before[name])
        assert torch.equal(c["state"][:, 2], cands_t[name]["state"][:, 2, 4])


def test_chained_block_steps_lossless(pair):
    """tests/test_serve_step.py::test_chained_block_steps_lossless on the
    port: eight chained blocks commit the greedy AR continuation."""
    s = pair
    B, Tp = 2, 8
    prompts = np.random.default_rng(1).integers(2, s["cfg_t"].vocab_size, (B, Tp)).astype(np.int32)
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 20)
    _, cache = s["model_t"].prefill(s["params_t"], _t(prompts[:, :-1]), max_len=64)
    pending = _t(prompts[:, -1])
    emitted = [[] for _ in range(B)]
    accepted = 0
    for _ in range(8):
        blk = tspec.spec_block_step(s["model_t"], s["params_t"], s["dvi_t"], pending, cache)
        pending, cache = blk.pending, blk.cache
        accepted += int(blk.m.sum())
        for b in range(B):
            emitted[b].extend(blk.commit_vec[b, :int(blk.accept[b])].tolist())
    assert accepted > 0
    for b in range(B):
        want = r_ar.tokens[b, Tp:int(r_ar.lengths[b])].tolist()
        n = min(len(want), len(emitted[b]))
        assert n > 0 and emitted[b][:n] == want[:n], b


def test_speculative_generate_depth_2_matches_jax(pair):
    s = pair
    prompts = np.random.default_rng(4).integers(2, s["cfg_t"].vocab_size, (3, 9)).astype(np.int32)
    live = np.array([True, False, True])
    r_j = jspec.speculative_generate(s["model_j"], s["params_j"], s["state"].dvi_params,
                                     jnp.asarray(prompts), 16, k_spec=2, collect=True,
                                     live_mask=jnp.asarray(live))
    r_t = tspec.speculative_generate(s["model_t"], s["params_t"], s["dvi_t"], _t(prompts), 16,
                                     k_spec=2, collect=True, live_mask=_t(live))
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    for b in range(3):
        n = min(int(r_t.lengths[b]), 9 + 16)
        np.testing.assert_array_equal(r_t.tokens[b, :n].numpy(), np.asarray(r_j.tokens[b, :n]))
    for name in ("blocks", "committed", "accepted_drafts", "drafted"):
        assert int(getattr(r_t, name)) == int(getattr(r_j, name)), name
    assert int(r_t.accepted_drafts) > 0
    assert int(r_t.buffer["count"]) == int(r_j.buffer["count"]) > 0


def test_insert_and_reset_slot(pair):
    """A B = 1 prefill spliced into lane 1 of a live 3-lane cache, then lane
    1 reset: the lane's conv window and state follow the reference, and the
    other lanes are untouched bit for bit."""
    s = pair
    rng = np.random.default_rng(12)
    toks = rng.integers(2, s["cfg_t"].vocab_size, (3, 6)).astype(np.int32)
    one = rng.integers(2, s["cfg_t"].vocab_size, (1, 9)).astype(np.int32)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=32)
    _, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=32)
    _, sj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(one), max_len=32)
    _, st = s["model_t"].prefill(s["params_t"], _t(one), max_len=32)
    others = {n: {k: v[:, [0, 2]].clone() for k, v in c.items()} for n, c in ct["segs"].items()}
    cj = jtfm.insert_slot(s["cfg_j"], cj, sj, jnp.int32(1))
    ct = tfm.insert_slot(s["cfg_t"], ct, st, 1)
    _cache_close(cj, ct)
    assert int(ct["lengths"][1]) == 9
    for name, c in ct["segs"].items():
        for key, leaf in c.items():
            assert torch.equal(leaf[:, 1], st["segs"][name][key][:, 0])
    cj = jtfm.reset_slot(s["cfg_j"], cj, jnp.int32(1))
    ct = tfm.reset_slot(s["cfg_t"], ct, 1)
    _cache_close(cj, ct)
    for name, c in ct["segs"].items():
        for key, leaf in c.items():
            assert not bool(leaf[:, 1].any())
            assert torch.equal(leaf[:, [0, 2]], others[name][key])


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

ENGINE_CELLS = {
    "sync": dict(scheduler="sync", batch_size=2, max_new=8, buckets=(8, 16)),
    "continuous": dict(scheduler="continuous", num_slots=2, max_new=8, cache_len=40,
                       kv_pages=0, sync_every=2),
}


@pytest.mark.parametrize("cell", list(ENGINE_CELLS))
def test_engine_matches_jax(pair, cell):
    """Five requests (prompts of 5-14 tokens across both sync buckets,
    budgets 4-8) through both engines: equal completions and counts.  The
    sync path left-pads to the bucket, the continuous path prefills each
    prompt at its exact length and splices it into a lane."""
    s = pair
    kw = ENGINE_CELLS[cell]
    rng = np.random.default_rng(21)
    reqs = [(uid, rng.integers(2, s["cfg_t"].vocab_size, n).astype(np.int32), mn)
            for uid, (n, mn) in enumerate([(5, 8), (14, 6), (9, 8), (7, 4), (12, 8)])]
    eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False, **kw)
    eng_t = ServingEngine(s["model_t"], s["params_t"],
                          tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                          learn=False, **kw)
    for uid, p, mn in reqs:
        eng_j.submit_request(JRequest(uid, p, max_new=mn))
        eng_t.submit_request(Request(uid, p, max_new=mn))
    outs_j = {c.uid: c.gen_tokens.tolist() for c in eng_j.run(max_steps=1000)}
    outs_t = {c.uid: c.gen_tokens.tolist() for c in eng_t.run(max_steps=1000)}
    assert outs_t == outs_j and len(outs_t) == len(reqs)
    for key in ("requests", "blocks", "committed", "accepted", "drafted"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.stats["accepted"] > 0 and not eng_t.busy
