"""Sliding-window ring caches in the port against the JAX package, in
float32: ``spread_write`` with wrap, ``fill_cache_from_full`` with a prompt
longer than the ring, ``insert_slot``/``reset_slot`` on the (B, C) ``pos``
leaf (the lane on axis 0, emptied to -1), the ring form of
``decode_attention``'s plain version against the reference's masked
``attend``, and window-16 models (recurrentgemma-9b-tiny and
llama4-scout-17b-a16e-tiny cut to a window of 16, rings of 144 slots)
decoding 2.5 windows past a prompt that the decode carries past the ring:
``ar_generate``'s tokens equal JAX's, and ``speculative_generate`` equals
the port's own AR.

Hiddens, caches and attention outputs are held to rtol 1e-5 / atol 1e-4,
positions and tokens to equality: after a prefill of 150-200 tokens
(windowed attention over up to 200 keys and llama4's MoE FFN, in other
float32 orders of sums) the measured gap is 2.2e-5 on single elements of
hiddens up to 9 in magnitude and of K up to 3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
WINDOW = 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _windowed(name, cfg):
    if cfg.rglru is not None:
        return cfg.replace(rglru=cfg.rglru.__class__(**dict(
            cfg.rglru.__dict__, local_window=WINDOW)))
    return cfg.replace(sliding_window=WINDOW)


@pytest.fixture(scope="module", params=["recurrentgemma-9b", "llama4-scout-17b-a16e"])
def pair(request):
    name = request.param
    cfg_j = _windowed(name, tiny_cfg(name))
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = _windowed(name, get_config(name, tiny=True).replace(dtype="float32"))
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, cfg_t=cfg_t,
                model_t=model_t, params_t=params_t)


def _ring_segs(cfg):
    return [s.name for s in tfm.model_segments(cfg) if s.kind == "local"]


def _close_segs(cj, ct, names):
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name in names:
        for key, leaf in ct["segs"][name].items():
            if key == "pos":
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(cj["segs"][name][key]))
            else:
                _close(cj["segs"][name][key], leaf)


@pytest.mark.parametrize("lengths", [[0, 5], [140, 142], [300, 7]])
def test_spread_write_wraps(lengths):
    """A block of 5 into rings of 144 slots at lengths short of the ring,
    at its end (the block wraps to slot 0) and past it."""
    rng = np.random.default_rng(sum(lengths))
    cache = rng.standard_normal((2, 144, 2, 4)).astype(np.float32)
    blk = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    want = jtfm.spread_write(jnp.asarray(cache), jnp.asarray(blk), jnp.asarray(lens), wrap=True)
    got = _t(cache)
    tfm.spread_write(got, _t(blk), _t(lens), wrap=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T", [40, 200])
def test_fill_cache_from_full_past_the_ring(pair, T):
    """A prefill of T tokens: T = 200 exceeds the rings' 144 slots, so each
    keeps the last 144 positions p at slots p % 144 (the reference's
    ``T > Cap`` write); the rest of the cache matches too."""
    s = pair
    toks = np.random.default_rng(T).integers(2, s["cfg_t"].vocab_size, (2, T)).astype(np.int32)
    h_j, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=T + 16)
    h_t, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=T + 16)
    _close(h_j, h_t)
    rings = _ring_segs(s["cfg_t"])
    assert rings
    _close_segs(cj, ct, [n for n in ct["segs"] if "kp" not in ct["segs"][n]])
    for name in rings:
        pos = ct["segs"][name]["pos"]
        assert tuple(pos.shape) == (2, WINDOW + tfm.RING_SLACK)
        if T > pos.shape[1]:
            assert int(pos.min()) == T - pos.shape[1] and int(pos.max()) == T - 1
        else:
            assert int((pos >= 0).sum()) == 2 * T


def test_ring_step_matches(pair):
    """A verify-sized step past a prompt longer than the ring: hiddens,
    rings and positions match the reference's."""
    s = pair
    K = s["cfg_t"].dvi.k_spec
    toks = np.random.default_rng(3).integers(2, s["cfg_t"].vocab_size, (2, 150)).astype(np.int32)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=180)
    _, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=180)
    x = np.random.default_rng(4).standard_normal((2, K + 1, s["cfg_t"].d_model)) \
        .astype(np.float32)
    hj, cj, cands_j, _ = s["model_j"].step(s["params_j"], jnp.asarray(x), cj)
    ht, ct, cands_t = s["model_t"].step(s["params_t"], _t(x), ct)
    _close(hj, ht)
    _close_segs(cj, ct, _ring_segs(s["cfg_t"]))


def test_insert_and_reset_slot_on_pos(pair):
    """A B = 1 prefill spliced into lane 1 of a live 3-lane cache, then lane
    1 reset: the ring and its pos row follow the reference (pos is (B, C),
    reset to -1), the other lanes untouched bit for bit."""
    s = pair
    rng = np.random.default_rng(12)
    toks = rng.integers(2, s["cfg_t"].vocab_size, (3, 20)).astype(np.int32)
    one = rng.integers(2, s["cfg_t"].vocab_size, (1, 170)).astype(np.int32)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=200)
    _, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=200)
    _, sj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(one), max_len=200)
    _, st = s["model_t"].prefill(s["params_t"], _t(one), max_len=200)
    rings = _ring_segs(s["cfg_t"])
    others = {n: ct["segs"][n]["pos"][[0, 2]].clone() for n in rings}
    cj = jtfm.insert_slot(s["cfg_j"], cj, sj, jnp.int32(1))
    ct = tfm.insert_slot(s["cfg_t"], ct, st, 1)
    _close_segs(cj, ct, rings)
    for n in rings:
        assert torch.equal(ct["segs"][n]["pos"][1], st["segs"][n]["pos"][0])
    cj = jtfm.reset_slot(s["cfg_j"], cj, jnp.int32(1))
    ct = tfm.reset_slot(s["cfg_t"], ct, 1)
    _close_segs(cj, ct, rings)
    for n in rings:
        pos = ct["segs"][n]["pos"]
        assert bool((pos[1] == -1).all()) and torch.equal(pos[[0, 2]], others[n])
        assert not bool(ct["segs"][n]["k"][:, 1].any())


@pytest.mark.parametrize("Tq", [1, 5])
def test_plain_ring_attention_matches_reference_attend(Tq):
    """The plain ring form against the reference's step mask (pos >= 0,
    pos <= qpos, pos > qpos - W) through ``repro.models.layers.attend``,
    on lanes short of the ring, wrapped, and with stale writes past the
    length; the ops wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(Tq)
    B, C, H, KV, hd, W = 3, 24, 4, 2, 8, 16
    q = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    lens = np.array([7, 40, 25], np.int32)               # post-write lengths
    pos = np.full((B, C), -1, np.int32)
    for b, n in enumerate(lens):
        p = np.arange(max(0, n + 2 - C), n + 2)           # 2 stale writes past n
        pos[b, p % C] = p
    qpos = lens[:, None] - Tq + np.arange(Tq)[None, :]
    mask = ((pos[:, None, :] <= qpos[:, :, None]) & (pos[:, None, :] >= 0)
            & (pos[:, None, :] > qpos[:, :, None] - W))
    want = jlayers.attend(*map(jnp.asarray, (q, k, v, mask)))
    q_in = q[:, 0] if Tq == 1 else q
    got = ref.decode_attention(_t(q_in), _t(k), _t(v), _t(lens), pos=_t(pos), window=W)
    _close(np.asarray(want)[:, 0] if Tq == 1 else want, got)
    via_ops = ops.decode_attention(_t(q_in), _t(k), _t(v), _t(lens), pos=_t(pos), window=W)
    assert torch.equal(via_ops, got)


def test_window_model_decodes_past_the_ring(pair):
    """Prompts of 110 tokens decoded 40 more (2.5 windows; positions reach
    150, past the rings' 144 slots): greedy AR equals JAX's token for token,
    and speculative decoding equals the port's own AR."""
    s = pair
    prompts = np.random.default_rng(5).integers(2, s["cfg_t"].vocab_size, (2, 110)) \
        .astype(np.int32)
    # no EOS: every lane decodes its whole budget
    r_j = jspec.ar_generate(s["model_j"], s["params_j"], jnp.asarray(prompts), 40, eos_id=-1)
    r_t = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 40, eos_id=-1)
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    for b in range(2):
        n = int(r_t.lengths[b])
        assert n == 150
        np.testing.assert_array_equal(r_t.tokens[b, :n].numpy(), np.asarray(r_j.tokens[b, :n]))
    dvi = tlora.init_draft_params(torch.Generator().manual_seed(0), s["cfg_t"])
    r_sd = tspec.speculative_generate(s["model_t"], s["params_t"], dvi, _t(prompts), 40,
                                      eos_id=-1)
    assert torch.equal(r_sd.lengths, r_t.lengths)
    for b in range(2):
        n = int(r_t.lengths[b])
        assert torch.equal(r_sd.tokens[b, :n], r_t.tokens[b, :n])
