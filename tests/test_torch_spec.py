"""The port's greedy speculative decoding against repro.core.spec, and its
losslessness against its own ar_generate, for vicuna-7b-tiny and
qwen3-0.6b-tiny in float32.  Tokens, block statistics and replay-buffer
tuples must be equal; hiddens within rtol 1e-5 / atol 2e-5.

The deep layers' residual branches are scaled down (x0.1) so the drafter
agrees with the verifier often enough that accepted prefixes, bonus tokens
and rejections all occur; the LoRA B is perturbed as in tests/test_spec.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import buffer as jbuffer  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import buffer as tbuffer  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

NAMES = ["vicuna-7b", "qwen3-0.6b"]
RTOL, ATOL = 1e-5, 2e-5
B, TP, NEW = 3, 8, 20
LIVE = np.array([True, True, False])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=NAMES)
def setup(request):
    name = request.param
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = dict(params_j["segments"])
    for s in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        segs[s.name] = dict(segs[s.name], wo=segs[s.name]["wo"] * 0.1,
                            wo_ff=segs[s.name]["wo_ff"] * 0.1)
    params_j = dict(params_j, segments=segs)
    dvi_j = jlora.init_draft_params(jax.random.PRNGKey(5), cfg_j)
    dvi_j = dict(dvi_j, B=jax.random.normal(jax.random.PRNGKey(11), dvi_j["B"].shape) * 0.01)
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, dvi_j), "cpu")
    prompts = np.random.default_rng(0).integers(2, cfg_t.vocab_size, size=(B, TP)).astype(np.int32)
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, dvi_j=dvi_j,
                cfg_t=cfg_t, model_t=model_t, params_t=params_t, dvi_t=dvi_t, prompts=prompts)


@pytest.fixture(scope="module")
def generated(setup):
    s = setup
    r_j = jspec.speculative_generate(s["model_j"], s["params_j"], s["dvi_j"],
                                     jnp.asarray(s["prompts"]), NEW, collect=True,
                                     live_mask=jnp.asarray(LIVE))
    r_t = tspec.speculative_generate(s["model_t"], s["params_t"], s["dvi_t"],
                                     _t(s["prompts"]), NEW, collect=True, live_mask=_t(LIVE))
    return r_j, r_t


def _close(j, t):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _streams_equal(tok_a, len_a, tok_b, len_b, cap):
    for b in range(tok_a.shape[0]):
        n = min(int(len_a[b]), int(len_b[b]), cap)
        np.testing.assert_array_equal(np.asarray(tok_a[b, :n]), np.asarray(tok_b[b, :n]),
                                      err_msg=f"lane {b}")


def _buffers_equal(buf_j, buf_t):
    for name in ("ptr", "count", "gen"):
        assert int(buf_j[name]) == int(buf_t[name]), name
    n = int(buf_t["count"])
    for name in ("action", "reward", "pos", "prev", "age"):
        np.testing.assert_array_equal(buf_t[name].numpy(), np.asarray(buf_j[name]), err_msg=name)
    for name in ("h_k", "h_L"):
        _close(buf_j[name][:n], buf_t[name][:n])
        np.testing.assert_array_equal(buf_t[name][n:].numpy(), np.asarray(buf_j[name][n:]))


def test_block_steps_match_jax(setup):
    """Two chained blocks (the second starts from the first's rolled-back
    cache), one lane masked done: tokens equal, hiddens and caches close."""
    s = setup
    K = s["cfg_t"].dvi.k_spec
    cap = TP + NEW + K + 2 + 128
    _, cache_j, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(s["prompts"][:, :-1]),
                                         max_len=cap)
    _, cache_t = s["model_t"].prefill(s["params_t"], _t(s["prompts"][:, :-1]), max_len=cap)
    pend_j, pend_t = jnp.asarray(s["prompts"][:, -1]), _t(s["prompts"][:, -1])
    done = np.array([False, True, False])
    for _ in range(2):
        bj = jspec.spec_block_step(s["model_j"], s["params_j"], s["dvi_j"], pend_j, cache_j,
                                   done=jnp.asarray(done))
        bt = tspec.spec_block_step(s["model_t"], s["params_t"], s["dvi_t"], pend_t, cache_t,
                                   done=_t(done))
        for name in ("pending", "commit_vec", "accept", "m", "d_blk"):
            np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                          np.asarray(getattr(bj, name)), err_msg=name)
        _close(bj.hk_blk, bt.hk_blk)
        _close(bj.hL_blk, bt.hL_blk)
        np.testing.assert_array_equal(bt.cache["lengths"].numpy(),
                                      np.asarray(bj.cache["lengths"]))
        for name, seg in bt.cache["segs"].items():
            _close(bj.cache["segs"][name]["k"], seg["k"])
            _close(bj.cache["segs"][name]["v"], seg["v"])
        assert int(bt.accept[1]) == 0
        pend_j, cache_j, pend_t, cache_t = bj.pending, bj.cache, bt.pending, bt.cache


def test_speculative_generate_streams_and_stats(setup, generated):
    r_j, r_t = generated
    _streams_equal(r_j.tokens, r_j.lengths, r_t.tokens, r_t.lengths, TP + NEW)
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    for name in ("blocks", "committed", "accepted_drafts", "drafted"):
        assert int(getattr(r_t, name)) == int(getattr(r_j, name)), name
    assert int(r_t.accepted_drafts) > 0 and int(r_t.blocks) > 0
    assert int(r_t.lengths[2]) == TP                  # the masked lane generated nothing
    assert r_t.steps >= int(r_t.blocks) // int(LIVE.sum())


def test_replay_buffer_tuples(generated):
    r_j, r_t = generated
    assert int(r_t.buffer["count"]) > 0
    _buffers_equal(r_j.buffer, r_t.buffer)


def test_ar_generate_matches_jax(setup):
    s = setup
    r_j = jspec.ar_generate(s["model_j"], s["params_j"], jnp.asarray(s["prompts"]), NEW)
    r_t = tspec.ar_generate(s["model_t"], s["params_t"], _t(s["prompts"]), NEW)
    _streams_equal(r_j.tokens, r_j.lengths, r_t.tokens, r_t.lengths, TP + NEW)
    assert int(r_t.committed) == int(r_j.committed) == int(r_t.blocks)
    assert r_t.buffer is None


@pytest.mark.parametrize("k_spec", [None, 1, 3])
def test_port_speculative_equals_port_ar(setup, k_spec):
    """Greedy losslessness inside the port, with a perturbed drafter."""
    s = setup
    dvi = dict(s["dvi_t"], B=s["dvi_t"]["B"] + 0.05 * torch.from_numpy(
        np.random.default_rng(k_spec or 0).standard_normal(tuple(s["dvi_t"]["B"].shape))
        .astype(np.float32)))
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(s["prompts"]), NEW)
    r_sd = tspec.speculative_generate(s["model_t"], s["params_t"], dvi, _t(s["prompts"]),
                                      NEW, k_spec=k_spec, collect=True)
    _streams_equal(r_ar.tokens, r_ar.lengths, r_sd.tokens, r_sd.lengths, TP + NEW)
    assert int(r_sd.committed) == int(r_sd.accepted_drafts) + int(r_sd.blocks)


def test_serve_step_wraps_block_step(setup):
    s = setup
    _, cache = s["model_t"].prefill(s["params_t"], _t(s["prompts"][:, :-1]), max_len=64)
    pend = _t(s["prompts"][:, -1])
    start = cache["lengths"].clone()
    p1, cv1, acc1, c1 = tspec.serve_step(s["model_t"], s["params_t"], s["dvi_t"], pend, cache)
    blk = tspec.spec_block_step(s["model_t"], s["params_t"], s["dvi_t"], pend,
                                dict(cache, lengths=start))
    assert torch.equal(p1, blk.pending) and torch.equal(cv1, blk.commit_vec)
    assert torch.equal(acc1, blk.accept) and torch.equal(c1["lengths"], start + acc1)


def test_sampling_and_ragged_depth_are_later_slices(setup):
    s = setup
    with pytest.raises(NotImplementedError):
        tspec.speculative_generate(s["model_t"], s["params_t"], s["dvi_t"], _t(s["prompts"]),
                                   4, temperature=0.7)
    _, cache = s["model_t"].prefill(s["params_t"], _t(s["prompts"][:, :-1]), max_len=64)
    with pytest.raises(NotImplementedError):
        tspec.spec_block_step(s["model_t"], s["params_t"], s["dvi_t"], _t(s["prompts"][:, -1]),
                              cache, k_lane=torch.ones(B, dtype=torch.int32))


@pytest.mark.parametrize("ptr,slots", [(0, 64), (50, 64), (5, 16)])
def test_add_block_ring_matches_jax(ptr, slots):
    """The masked prefix-sum ring write against the reference's drop-mode
    scatter, including wrap-around at the end of the ring."""
    cfg = get_config("vicuna-7b", tiny=True)
    rng = np.random.default_rng(ptr + slots)
    N, d = 12, cfg.d_model
    rows = dict(h_k=rng.standard_normal((N, d)).astype(np.float32),
                h_L=rng.standard_normal((N, d)).astype(np.float32),
                action=rng.integers(0, 500, N).astype(np.int32),
                reward=(rng.random(N) < 0.5).astype(np.float32),
                pos=rng.integers(1, 5, N).astype(np.int32),
                prev=rng.integers(0, 500, N).astype(np.int32))
    valid = rng.random(N) < 0.6
    buf_j = dict(jbuffer.init_buffer(cfg, slots), ptr=jnp.int32(ptr), gen=jnp.int32(3))
    buf_t = dict(tbuffer.init_buffer(cfg, slots, device="cpu"), ptr=torch.tensor(ptr, dtype=torch.int32),
                 gen=torch.tensor(3, dtype=torch.int32))
    order = ("h_k", "h_L", "action", "reward", "pos", "prev")
    for _ in range(3):                               # three appends, ring wraps
        buf_j = jbuffer.add_block(buf_j, *(jnp.asarray(rows[k]) for k in order),
                                  jnp.asarray(valid))
        buf_t = tbuffer.add_block(buf_t, *(_t(rows[k]) for k in order), _t(valid))
        for name in buf_t:
            np.testing.assert_array_equal(buf_t[name].numpy(), np.asarray(buf_j[name]),
                                          err_msg=name)
        valid = ~valid
