"""Whisper's encoder-decoder on the port against the JAX package, in float32
(whisper-large-v3-tiny: 2 encoder and 2 decoder layers of 4 heads of 64,
24 stub frames; the norm gains perturbed, the deep layer's output
projections scaled down x0.1 so drafts are accepted often; weights handed
over through the bridge, frame embeddings drawn with numpy).

``encode``; the prefill's hidden states, logits and cache with its cross
K/V; ``embed_block``'s sinusoidal rows at each lane's position (clamped at
the table's last row); a draft feed and a verify block, whose cross-
attention goes through ``decode_attention``'s non-causal form; chained
speculative blocks lossless against the port's ``ar_generate`` and equal
to the reference's stream; ``GenerateRunner`` (graphs off) equal to
``speculative_generate``; ``dense_train_losses`` and ``lm_loss`` with their
``aux_inputs`` and gradients; ``online_loop`` with ``aux_inputs_fn``.

Hiddens, logits and K/V within rtol 1e-5 / atol 2e-5, tokens exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.training.pretrain import lm_loss as jlm_loss  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import buffer as tbuffer  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import MAX_POSITIONS, build_model  # noqa: E402
from repro_torch.training.pretrain import loss_and_grads  # noqa: E402

NAME = "whisper-large-v3"
RTOL, ATOL = 1e-5, 2e-5
NORMS = ("ln1", "ln2", "ln_x", "final_norm")
OUT_PROJ = ("wo", "wo_ff", "wo_x")
B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _prep(tree, rng, deep: bool):
    """Norm gains perturbed; with `deep`, output projections scaled x0.1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _prep(v, rng, deep and k != "encoder")
        elif k in NORMS:
            out[k] = jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        else:
            out[k] = v * 0.1 if deep and k in OUT_PROJ else v
    return out


def _frames(cfg, n=B, seed=7):
    e = cfg.encoder
    return np.random.default_rng(seed).standard_normal(
        (n, e.num_frames, e.d_model or cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def s():
    cfg_j = tiny_cfg(NAME)
    model_j = jax_build_model(cfg_j)
    rng = np.random.default_rng(1)
    params_j = model_j.init(jax.random.PRNGKey(0))
    k = cfg_j.dvi.split_layer
    params_j = dict(params_j, segments={
        name: _prep(seg, rng, deep=name != "s0") for name, seg in params_j["segments"].items()})
    params_j = _prep(params_j, rng, deep=False)
    assert k == 1 and set(params_j["segments"]) == {"s0", "s1"}
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    drng = np.random.default_rng(2)
    dvi_np = {"A": np.zeros((cfg_t.d_model, cfg_t.dvi.lora_rank), np.float32),
              "B": (drng.standard_normal((cfg_t.dvi.lora_rank, cfg_t.vocab_size)) * 0.05
                    ).astype(np.float32)}
    frames = _frames(cfg_t)
    return dict(cfg=cfg_t, model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_t, dvi_np=dvi_np, frames=frames,
                aux_j={"frame_embeds": jnp.asarray(frames)},
                aux_t={"frame_embeds": _t(frames)})


def test_config_model_and_cache_layout(s):
    cfg, model = s["cfg"], s["model_t"]
    assert cfg.encoder.num_frames == 24 and cfg.arch_type == "audio"
    assert all(seg.cross for seg in tfm.model_segments(cfg))
    p = model.init(torch.Generator().manual_seed(0))
    assert set(p["encoder"]) == {"in_proj", "final_norm", "segments"}
    assert {"ln_x", "wq_x", "wk_x", "wv_x", "wo_x"} <= set(p["segments"]["s0"])
    assert not {"ln_x", "wq_x"} & set(p["encoder"]["segments"]["s0"])
    cache = model.init_cache(3, 40)
    F, H, hd = cfg.encoder.num_frames, cfg.num_heads, cfg.resolved_head_dim
    assert tuple(cache["segs"]["s1"]["xk"].shape) == (1, 3, F, H, hd)
    assert cache["xlen"].tolist() == [F] * 3 and cache["xlen"].dtype == torch.int32
    full = get_config(NAME)
    assert 1.5e9 < full.param_count() < 1.6e9
    with pytest.raises(NotImplementedError, match="cross-attention"):
        model.init_paged_cache(2, 8, 16, 4)


def test_encode_matches(s):
    enc_j = s["model_j"].encode(s["params_j"], s["aux_j"])
    enc_t = s["model_t"].encode(s["params_t"], s["aux_t"])
    assert tuple(enc_t.shape) == (B, s["cfg"].encoder.num_frames, s["cfg"].d_model)
    _close(enc_j, enc_t)


def _prefill(s, T=7, C=40, seed=3):
    toks = np.random.default_rng(seed).integers(2, s["cfg"].vocab_size,
                                                size=(B, T)).astype(np.int32)
    h_j, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), s["aux_j"], max_len=C)
    h_t, ct = s["model_t"].prefill(s["params_t"], _t(toks), s["aux_t"], max_len=C)
    return toks, h_j, cj, h_t, ct


def _close_cache(cj, ct):
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name, seg in ct["segs"].items():
        assert set(seg) == set(cj["segs"][name]) - {"pos"}, name
        for key, leaf in seg.items():
            _close(cj["segs"][name][key], leaf)


def test_prefill_hidden_logits_and_cross_cache(s):
    _, h_j, cj, h_t, ct = _prefill(s)
    _close(h_j, h_t)
    _close(s["model_j"].logits(s["params_j"], h_j), s["model_t"].logits(s["params_t"], h_t))
    _close_cache(cj, ct)
    assert float(ct["segs"]["s0"]["xk"].abs().sum()) > 0


@pytest.mark.parametrize("offset", [0, 5, 40])
def test_embed_block_positions(s, offset):
    """Each lane embeds at its own length, as the reference's table row.
    (The float32 angle p * f carries p's rounding, so the two packages'
    1-ulp differences in f show above the tolerance past a few hundred
    positions: ulp(300) = 3e-5.)"""
    toks = np.array([[3, 9], [11, 4]], np.int32)
    lens = np.array([offset, offset + 2], np.int32)
    _close(s["model_j"].embed_block(s["params_j"], jnp.asarray(toks), jnp.asarray(lens)),
           s["model_t"].embed_block(s["params_t"], _t(toks), _t(lens)))
    with pytest.raises(ValueError, match="lengths"):
        s["model_t"].embed_block(s["params_t"], _t(toks))


def test_embed_block_clamps_at_the_tables_last_row(s):
    """Positions past the reference's 2^16-row table take its last row."""
    toks = np.array([[3, 9], [11, 4]], np.int32)
    emb = s["params_t"]["embed"][_t(toks).long()]
    d = s["cfg"].d_model
    for lens, rows in (([MAX_POSITIONS - 2, 70000],
                        [[MAX_POSITIONS - 2, MAX_POSITIONS - 1], [MAX_POSITIONS - 1] * 2]),
                       ([MAX_POSITIONS + 5, 2 ** 20], [[MAX_POSITIONS - 1] * 2] * 2)):
        got = s["model_t"].embed_block(s["params_t"], _t(toks), _t(np.array(lens, np.int32)))
        want = tlayers.sinusoidal_positions(MAX_POSITIONS, d)[_t(rows).long()]
        assert torch.equal(got, emb + want)


def test_draft_step_and_verify_step(s):
    cfg = s["cfg"]
    k, L, K = cfg.dvi.split_layer, cfg.num_layers, cfg.dvi.k_spec
    toks, _, cj, _, ct = _prefill(s)
    pend = toks[:, -1:]
    hj, cj, _, _ = s["model_j"].step(
        s["params_j"], s["model_j"].embed_block(s["params_j"], jnp.asarray(pend), cj["lengths"]),
        cj, 0, k)
    ht, ct, _ = s["model_t"].step(
        s["params_t"], s["model_t"].embed_block(s["params_t"], _t(pend), ct["lengths"]), ct, 0, k)
    _close(hj, ht)
    x = np.random.default_rng(4).standard_normal((B, K + 1, cfg.d_model)).astype(np.float32)
    hj, cj, _, _ = s["model_j"].step(s["params_j"], jnp.asarray(x), cj, k, L)
    ht, ct, _ = s["model_t"].step(s["params_t"], _t(x), ct, k, L)
    _close(hj, ht)
    _close(s["model_j"].logits(s["params_j"], hj), s["model_t"].logits(s["params_t"], ht))
    _close_cache(cj, ct)


def _prompts(s, Tp=9, seed=5):
    return np.random.default_rng(seed).integers(2, s["cfg"].vocab_size,
                                                size=(B, Tp)).astype(np.int32)


def test_speculative_generate_lossless_and_matches_reference(s):
    prompts = _prompts(s)
    dvi_t = {k: _t(v) for k, v in s["dvi_np"].items()}
    r_t = tspec.speculative_generate(s["model_t"], s["params_t"], dvi_t, _t(prompts), 16,
                                     aux_inputs=s["aux_t"], eos_id=-1)
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 16,
                             aux_inputs=s["aux_t"], eos_id=-1)
    r_j = jspec.speculative_generate(s["model_j"], s["params_j"],
                                     {k: jnp.asarray(v) for k, v in s["dvi_np"].items()},
                                     jnp.asarray(prompts), 16, aux_inputs=s["aux_j"], eos_id=-1)
    n = prompts.shape[1] + 16
    assert min(r_t.lengths.tolist()) >= n
    np.testing.assert_array_equal(r_t.tokens[:, :n].numpy(), r_ar.tokens[:, :n].numpy())
    np.testing.assert_array_equal(r_t.tokens.numpy(), np.asarray(r_j.tokens))
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    assert int(r_t.accepted_drafts) == int(r_j.accepted_drafts) > 0
    assert r_t.steps < 16


def test_generate_runner_matches_speculative_generate(s):
    cfg = s["cfg"]
    dvi_t = {k: _t(v) for k, v in s["dvi_np"].items()}
    buf, fbuf = (tbuffer.init_buffer(cfg, device="cpu") for _ in range(2))
    runner = graphs.GenerateRunner(s["model_t"], s["params_t"], dvi_t, buf, max_new=8,
                                   graphs=True)
    for seed in (5, 6):
        prompts = _t(_prompts(s, seed=seed))
        aux = {"frame_embeds": _t(_frames(cfg, seed=seed + 10))}
        res = runner.generate(prompts, torch.ones(B, dtype=torch.bool), aux)
        ref = tspec.speculative_generate(s["model_t"], s["params_t"], dvi_t, prompts, 8,
                                         collect=True, buf=fbuf, aux_inputs=aux)
        assert torch.equal(res.tokens, ref.tokens) and torch.equal(res.lengths, ref.lengths)
        assert int(res.committed) == int(ref.committed) and res.steps == ref.steps
        fbuf = ref.buffer
    assert int(buf["count"]) == int(fbuf["count"]) > 0


def test_dense_train_losses_and_lm_loss(s):
    toks = np.random.default_rng(8).integers(2, s["cfg"].vocab_size,
                                             size=(B, 10)).astype(np.int32)

    def jloss(dp):
        return jlosses.dense_train_losses(s["model_j"], s["params_j"], dp, jnp.asarray(toks),
                                          350, jnp.float32(0.2), "full", s["aux_j"])
    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in s["dvi_np"].items()})
    dvi_t = {k: torch.tensor(v, requires_grad=True) for k, v in s["dvi_np"].items()}
    lt, mt = tlosses.dense_train_losses(s["model_t"], s["params_t"], dvi_t, _t(toks), 350,
                                        torch.tensor(0.2), "full", s["aux_t"])
    lt.backward()
    _close(lj, lt, atol=1e-5)
    _close(mj["acc_rate"], mt["acc_rate"])
    for k in ("A", "B"):
        _close(gj[k], dvi_t[k].grad, atol=1e-5)
    # the backbone's LM loss and its gradient, the encoder's leaves included
    pj = {k: v for k, v in s["params_j"].items()}
    (llj, _), glj = jax.value_and_grad(
        lambda p: jlm_loss(s["model_j"], p, jnp.asarray(toks), s["aux_j"]),
        has_aux=True)(pj)
    llt, _, glt = loss_and_grads(s["model_t"], s["params_t"], _t(toks),
                                        aux_inputs=s["aux_t"])
    _close(llj, llt)
    for key in ("encoder/in_proj", "encoder/segments/s0/wq", "segments/s1/wk_x", "embed"):
        node = glj
        for part in key.split("/"):
            node = node[part]
        _close(node, glt[key], atol=1e-5)
        assert float(glt[key].abs().sum()) > 0, key


def test_online_loop_takes_aux_inputs_fn(s):
    cfg = s["cfg"]
    frames = _t(_frames(cfg, seed=12))
    seen = []

    def aux_fn(prompts):
        seen.append(tuple(prompts.shape))
        return {"frame_embeds": frames}
    state = tonline.init_trainer(s["model_t"], dvi_params={k: _t(v)
                                                           for k, v in s["dvi_np"].items()})
    batches = [_prompts(s, seed=13), _prompts(s, seed=14)]
    state, hist = tonline.online_loop(s["model_t"], s["params_t"], batches, state, max_new=6,
                                      aux_inputs_fn=aux_fn)
    assert seen == [(B, 9)] * 2 and len(hist["loss"]) == 2
    assert all(np.isfinite(hist["loss"])) and int(state.buf["count"]) > 0
