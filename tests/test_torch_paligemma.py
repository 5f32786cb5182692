"""PaliGemma's patch prefix on the port against the JAX package, in float32
(paligemma-3b-tiny: 2 layers, MQA of 4 heads over one kv head of 64, GeGLU,
16 stub patches of 96; the norm gains perturbed, the deep layer's output
projections scaled down x0.1 so drafts are accepted often; weights handed
over through the bridge, patch embeddings drawn with numpy).

``embed`` (the scaled tokens behind the projected, unscaled patches); the
prefill's hidden states and logits under the bidirectional prefix mask,
and its cache, whose lengths count the patches; a draft feed and a verify
block at RoPE positions past the patches; chained speculative blocks
lossless against the port's ``ar_generate`` and equal to the reference's
stream; ``GenerateRunner`` (graphs off) equal to ``speculative_generate``;
``dense_train_losses`` and ``lm_loss`` (the patch positions dropped) with
gradients, and one ``pretrain`` step through ``aux_inputs_fn``; and 160 patches,
where the reference's default cache capacity leaves out the patches and
its prefill overflows, while the port's default holds them and its
stream equals the reference's at an explicit ``cache_len``.

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
from repro_torch.configs import VisionStubConfig, get_config  # noqa: E402
from repro_torch.core import buffer as tbuffer  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.pretrain import loss_and_grads, pretrain  # noqa: E402

NAME = "paligemma-3b"
RTOL, ATOL = 1e-5, 2e-5
NORMS = ("ln1", "ln2", "final_norm")
OUT_PROJ = ("wo", "wo_ff")
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
            out[k] = _prep(v, rng, deep)
        elif k in NORMS:
            out[k] = jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        else:
            out[k] = v * 0.1 if deep and k in OUT_PROJ else v
    return out


def _setup(cfg_j, cfg_t):
    model_j = jax_build_model(cfg_j)
    rng = np.random.default_rng(1)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = {name: _prep(seg, rng, deep=name != "s0") for name, seg in params_j["segments"].items()}
    params_j = dict(params_j, segments=segs, final_norm=jnp.asarray(
        rng.standard_normal(params_j["final_norm"].shape).astype(np.float32) * 0.1))
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return model_j, params_j, model_t, params_t


def _patches(cfg, n=B, seed=7):
    v = cfg.vision
    return np.random.default_rng(seed).standard_normal(
        (n, v.num_patches, v.d_embed)).astype(np.float32)


def _aux(patches):
    return {"patch_embeds": jnp.asarray(patches)}, {"patch_embeds": _t(patches)}


@pytest.fixture(scope="module")
def s():
    cfg_j = tiny_cfg(NAME)
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32")
    model_j, params_j, model_t, params_t = _setup(cfg_j, cfg_t)
    assert cfg_t.dvi.split_layer == 1 and set(params_j["segments"]) == {"s0", "s1"}
    drng = np.random.default_rng(2)
    dvi_np = {"A": np.zeros((cfg_t.d_model, cfg_t.dvi.lora_rank), np.float32),
              "B": (drng.standard_normal((cfg_t.dvi.lora_rank, cfg_t.vocab_size)) * 0.05
                    ).astype(np.float32)}
    aux_j, aux_t = _aux(_patches(cfg_t))
    return dict(cfg=cfg_t, model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_t, dvi_np=dvi_np, aux_j=aux_j, aux_t=aux_t)


def test_config_and_embed(s):
    cfg, model = s["cfg"], s["model_t"]
    P = cfg.vision.num_patches
    assert model.prefix_len() == P == 16 and cfg.arch_type == "vlm"
    assert not any(seg.cross for seg in tfm.model_segments(cfg))
    assert tuple(s["params_t"]["vision_proj"].shape) == (cfg.vision.d_embed, cfg.d_model)
    full = get_config(NAME)
    assert 2.4e9 < full.param_count() < 2.6e9
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (B, 5)).astype(np.int32)
    x_j = s["model_j"].embed(s["params_j"], jnp.asarray(toks), s["aux_j"])
    x_t = model.embed(s["params_t"], _t(toks), s["aux_t"])
    assert tuple(x_t.shape) == (B, P + 5, cfg.d_model)
    _close(x_j, x_t)
    # the block embedding has no prefix and is scaled as the prompt's tokens
    _close(s["model_j"].embed_block(s["params_j"], jnp.asarray(toks)),
           model.embed_block(s["params_t"], _t(toks), torch.zeros(B, dtype=torch.int32)))


def _prefill(s, T=7, C=48, seed=3):
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


def test_prefill_under_the_prefix_mask(s):
    P = s["cfg"].vision.num_patches
    toks, h_j, cj, h_t, ct = _prefill(s)
    _close(h_j, h_t)
    _close(s["model_j"].logits(s["params_j"], h_j), s["model_t"].logits(s["params_t"], h_t))
    _close_cache(cj, ct)
    assert ct["lengths"].tolist() == [P + toks.shape[1]] * B
    # the patches see each other: without the prefix mask the first patch's
    # hidden state would be its own alone
    h_causal, _ = s["model_t"].hidden(s["params_t"],
                                      s["model_t"].embed(s["params_t"], _t(toks), s["aux_t"]))
    assert float((h_causal[:, 0] - h_t[:, 0]).abs().max()) > 1e-3


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


def _prompts(cfg, Tp=9, seed=5):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, size=(B, Tp)).astype(np.int32)


def test_speculative_generate_lossless_and_matches_reference(s):
    prompts = _prompts(s["cfg"])
    dvi_t = {k: _t(v) for k, v in s["dvi_np"].items()}
    r_t = tspec.speculative_generate(s["model_t"], s["params_t"], dvi_t, _t(prompts), 16,
                                     aux_inputs=s["aux_t"], eos_id=-1)
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 16,
                             aux_inputs=s["aux_t"], eos_id=-1)
    r_j = jspec.speculative_generate(s["model_j"], s["params_j"],
                                     {k: jnp.asarray(v) for k, v in s["dvi_np"].items()},
                                     jnp.asarray(prompts), 16, aux_inputs=s["aux_j"], eos_id=-1)
    n = prompts.shape[1] + 16
    assert min(r_t.lengths.tolist()) >= n and r_t.tokens.shape[1] == n + 4 + 2
    np.testing.assert_array_equal(r_t.tokens[:, :n].numpy(), r_ar.tokens[:, :n].numpy())
    np.testing.assert_array_equal(r_t.tokens.numpy(), np.asarray(r_j.tokens))
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    assert int(r_t.accepted_drafts) == int(r_j.accepted_drafts) > 0


def test_generate_runner_matches_speculative_generate(s):
    cfg = s["cfg"]
    dvi_t = {k: _t(v) for k, v in s["dvi_np"].items()}
    buf, fbuf = (tbuffer.init_buffer(cfg, device="cpu") for _ in range(2))
    runner = graphs.GenerateRunner(s["model_t"], s["params_t"], dvi_t, buf, max_new=8,
                                   graphs=True)
    for seed in (5, 6):
        prompts = _t(_prompts(cfg, seed=seed))
        aux = _aux(_patches(cfg, seed=seed + 10))[1]
        res = runner.generate(prompts, torch.ones(B, dtype=torch.bool), aux)
        ref = tspec.speculative_generate(s["model_t"], s["params_t"], dvi_t, prompts, 8,
                                         collect=True, buf=fbuf, aux_inputs=aux)
        assert torch.equal(res.tokens, ref.tokens) and torch.equal(res.lengths, ref.lengths)
        assert int(res.committed) == int(ref.committed) and res.steps == ref.steps
        fbuf = ref.buffer
    st, _ = runner.prepare(B, 9)
    assert st["cache"]["segs"]["s0"]["k"].shape[2] == 9 + 8 + 4 + 2 + 128 + 16
    assert int(buf["count"]) == int(fbuf["count"]) > 0


def test_train_losses_with_aux_inputs(s):
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
    # lm_loss drops the P patch positions: its value and gradient (atol 1e-5
    # x the reference leaf's largest entry), vision_proj's included
    (lj_, _), gj_ = jax.value_and_grad(
        lambda p: jlm_loss(s["model_j"], p, jnp.asarray(toks), s["aux_j"]), has_aux=True)(
        s["params_j"])
    lt_, _, gt_ = loss_and_grads(s["model_t"], s["params_t"], _t(toks), aux_inputs=s["aux_t"])
    _close(lj_, lt_)
    for key in ("vision_proj", "embed", "segments/s1/wq"):
        want = gj_
        for part in key.split("/"):
            want = want[part]
        _close(want, gt_[key], atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    # pretrain's aux_inputs_fn: one step moves vision_proj
    pt = _clone(s["params_t"])
    seen = []

    def aux_fn(tokens):
        seen.append(tuple(tokens.shape))
        return s["aux_t"]
    pt, losses = pretrain(s["model_t"], pt, [toks], lr=1e-3, aux_inputs_fn=aux_fn)
    assert seen == [(B, 10)] and np.isfinite(losses).all()
    _close(lj_, torch.tensor(losses[0]))
    assert not torch.equal(pt["vision_proj"], s["params_t"]["vision_proj"])


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def test_patches_past_the_default_capacity():
    """160 patches: the reference sizes its default cache from the tokens
    alone (Tp + max_new + K + 2 + 128 = 149 slots for 167 prefill
    positions) and its prefill raises; the port's default adds the
    patches.  At an explicit ``cache_len`` both give one stream."""
    vis = VisionStubConfig(num_patches=160, d_embed=96)
    cfg_j = tiny_cfg(NAME).replace(vision=vis)
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32", vision=vis)
    model_j, params_j, model_t, params_t = _setup(cfg_j, cfg_t)
    prompts = _prompts(cfg_t, Tp=8, seed=9)
    aux_j, aux_t = _aux(_patches(cfg_t, seed=11))
    dvi_np = {"A": np.zeros((cfg_t.d_model, cfg_t.dvi.lora_rank), np.float32),
              "B": np.zeros((cfg_t.dvi.lora_rank, cfg_t.vocab_size), np.float32)}
    dvi_j = {k: jnp.asarray(v) for k, v in dvi_np.items()}
    dvi_t = {k: _t(v) for k, v in dvi_np.items()}
    with pytest.raises(Exception):
        jspec.speculative_generate(model_j, params_j, dvi_j, jnp.asarray(prompts), 8,
                                   aux_inputs=aux_j)
    r_t = tspec.speculative_generate(model_t, params_t, dvi_t, _t(prompts), 8, aux_inputs=aux_t)
    cap = 160 + 8 + 8 + 4 + 2 + tfm.RING_SLACK
    r_j = jspec.speculative_generate(model_j, params_j, dvi_j, jnp.asarray(prompts), 8,
                                     cache_len=cap, aux_inputs=aux_j)
    r_tc = tspec.speculative_generate(model_t, params_t, dvi_t, _t(prompts), 8, cache_len=cap,
                                      aux_inputs=aux_t)
    for r in (r_t, r_tc):
        np.testing.assert_array_equal(r.tokens.numpy(), np.asarray(r_j.tokens))
        np.testing.assert_array_equal(r.lengths.numpy(), np.asarray(r_j.lengths))
