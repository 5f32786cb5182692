"""The int8 KV cache (``cfg.kv_quant``) in the port against the JAX package,
in float32: the quantiser, the int8 plain attention forms (contiguous,
ring, paged) against the reference's dequantise-then-``attend``, qwen3-0.6b
tiny (the reference test's config) through prefill, one block and greedy
generation, a window-16 recurrentgemma past its ring, whisper (int8
self-attention, cross K/V in the model dtype) and deepseek (latents never
quantised), and the cache surgery that carries the scales.

int8 values are compared for equality and scales to float32 rounding:
``kv_quantize`` divides in float32 and rounds half to even on both sides.
Hidden states and attention outputs are held to rtol 1e-5 / atol 2e-5, as
the float32 parity tests are; tokens to equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import kv_pool as jkv_pool  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import kv_dequantize, kv_quantize  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _pair(name, seed=0, **replace):
    """The reference and the port on the same float32 tiny config with
    ``kv_quant`` and the same weights."""
    cfg_j = tiny_cfg(name).replace(kv_quant=True, **replace)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(seed))
    cfg_t = get_config(name, tiny=True).replace(dtype="float32", kv_quant=True, **replace)
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, cfg_t=cfg_t,
                model_t=model_t, params_t=params_t)


def _close_quant_cache(cj, ct):
    """Every leaf the port keeps: int8 values equal, scales and float leaves
    within float32 tolerance, positions and lengths equal."""
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name, seg in ct["segs"].items():
        for key, leaf in seg.items():
            want = np.asarray(cj["segs"][name][key])
            if leaf.dtype in (torch.int8, torch.int32):
                np.testing.assert_array_equal(leaf.numpy(), want, err_msg=f"{name}/{key}")
            else:
                _close(want, leaf)


# ---------------------------------------------------------------------------
# the quantiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_quantize_matches_reference(scale):
    """int8 values bit-equal and scales equal to the reference's, with an
    all-zero row (scale at the 1e-6 floor) and rows whose quotients land on
    .5 exactly (127 * 0.5 / 127 and its odd multiples: round half to even);
    dequantised in float32 and bfloat16 equal too."""
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.standard_normal((3, 7, 4, 32)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = np.linspace(-127, 127, 32).astype(np.float32) * scale
    x[1, 2, 1, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                              np.float32) * scale
    x[1, 2, 1, 8] = 127 * scale
    qj, sj = jtfm.kv_quantize(jnp.asarray(x))
    qt, st = kv_quantize(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0, 0, 0]) == np.float32(np.float32(1e-6) / np.float32(127.0))
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jtfm.kv_dequantize(qj, sj, dt_j).astype(jnp.float32))
        np.testing.assert_array_equal(kv_dequantize(qt, st, dt_t).float().numpy(), want)


# ---------------------------------------------------------------------------
# the int8 plain attention forms
# ---------------------------------------------------------------------------

def _int8(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1, *shape[-2:])[0] = 0.0                   # an all-zero slot
    q, s = jtfm.kv_quantize(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _deq(q, s):
    return jtfm.kv_dequantize(jnp.asarray(q), jnp.asarray(s), jnp.float32)


@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("form", ["contiguous", "ring", "paged"])
def test_int8_plain_attention_matches_reference(Tq, form):
    """The plain versions of the three int8 forms (which ``ops`` runs for CPU
    tensors) against the reference's dequantise-then-``attend`` with its
    step mask: a contiguous cache (a lane past capacity), a ring with
    wrapped lanes and stale writes, and pooled pages with a -1 entry."""
    rng = np.random.default_rng(Tq + len(form))
    B, H, KV, hd = 3, 4, 2, 16
    q = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    q_in = q[:, 0] if Tq == 1 else q
    if form == "paged":
        P, ps, mps = 14, 4, 4
        (k, ks), (v, vs) = _int8(rng, (P, ps, KV, hd)), _int8(rng, (P, ps, KV, hd))
        tbl = rng.permutation(np.arange(1, P))[:B * mps].reshape(B, mps).astype(np.int32)
        tbl[1, 1] = -1
        lens = np.array([mps * ps, 11, 6], np.int32)
        L = mps * ps
        _, phys = jkv_pool.logical_to_physical(jnp.asarray(tbl), jnp.broadcast_to(
            jnp.arange(L)[None], (B, L)), ps)
        flat = lambda a: jnp.asarray(a).reshape((P * ps,) + a.shape[2:])[phys]  # noqa: E731
        kd, vd = _deq(np.asarray(flat(k)), np.asarray(flat(ks))), _deq(
            np.asarray(flat(v)), np.asarray(flat(vs)))
        j = np.arange(L)
        mapped = np.asarray(tbl)[:, j // ps] >= 0
        qend = lens[:, None] - Tq + 1 + np.arange(Tq)[None, :]
        mask = mapped[:, None, :] & (j[None, None, :] < qend[:, :, None])
        got = ops.paged_decode_attention(_t(q_in), _t(k), _t(v), _t(lens), _t(tbl),
                                         k_scale=_t(ks), v_scale=_t(vs))
    else:
        C, W = 12, 8
        (k, ks), (v, vs) = _int8(rng, (B, C, KV, hd)), _int8(rng, (B, C, KV, hd))
        kd, vd = _deq(k, ks), _deq(v, vs)
        if form == "ring":
            lens = np.array([7, 20, 30], np.int32)
            pos = np.full((B, C), -1, np.int32)
            for b, n in enumerate(lens):
                p = np.arange(max(0, n + 2 - C), n + 2)      # 2 stale writes past n
                pos[b, p % C] = p
            qpos = lens[:, None] - Tq + np.arange(Tq)[None, :]
            mask = ((pos[:, None, :] <= qpos[:, :, None]) & (pos[:, None, :] >= 0)
                    & (pos[:, None, :] > qpos[:, :, None] - W))
            kw = dict(pos=_t(pos), window=W)
        else:
            lens = np.array([Tq, 9, C + 3], np.int32)
            qend = lens[:, None] - Tq + 1 + np.arange(Tq)[None, :]
            mask = np.arange(C)[None, None, :] < qend[:, :, None]
            kw = {}
        got = ops.decode_attention(_t(q_in), _t(k), _t(v), _t(lens), k_scale=_t(ks),
                                   v_scale=_t(vs), **kw)
    want = np.asarray(jlayers.attend(jnp.asarray(q), kd, vd, jnp.asarray(mask)))
    _close(want[:, 0] if Tq == 1 else want, got)


def test_int8_wrappers_check_their_inputs():
    """int8 K/V need both scales in float32 at (B, S, KV); scales go with
    int8 only; the non-causal form takes no int8 (cross K/V stay in the
    model dtype)."""
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((2, 3, 4, 16)).astype(np.float32))
    k, ks = map(_t, _int8(rng, (2, 8, 2, 16)))
    lens = _t(np.array([3, 8], np.int32))
    with pytest.raises(ValueError, match="scales"):
        ops.decode_attention(q, k, k, lens)
    with pytest.raises(ValueError, match="float32"):
        ops.decode_attention(q, k, k, lens, k_scale=ks.double(), v_scale=ks)
    with pytest.raises(ValueError, match=r"\(2, 8, 2\)"):
        ops.decode_attention(q, k, k, lens, k_scale=ks[:, :4], v_scale=ks)
    with pytest.raises(ValueError, match="int8 K/V only"):
        ops.decode_attention(q, k.float(), k.float(), lens, k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="non-causal"):
        ops.decode_attention(q, k, k, lens, causal=False, k_scale=ks, v_scale=ks)


# ---------------------------------------------------------------------------
# every config builds; the caches' layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL_ARCHS)
def test_every_config_builds_with_int8_caches(name):
    """``kv_quant`` builds on every registered config: contiguous, ring and
    paged attention K/V int8 with float32 scales beside them (one a slot
    and kv head); cross K/V, MLA latents and SSM / RG-LRU states keep their
    dtypes."""
    cfg = get_config(name, tiny=True).replace(dtype="float32", kv_quant=True)
    model = build_model(cfg, device="cpu")
    layouts = [model.init_cache(2, 24)]
    if cfg.mla is None and cfg.encoder is None:
        layouts.append(model.init_paged_cache(2, 6, 4, 6))
    for cache in layouts:
        for seg in tfm.model_segments(cfg):
            c = cache["segs"][seg.name]
            for vals, scales in (("k", "ks"), ("v", "vs"), ("kp", "ksp"), ("vp", "vsp")):
                if vals in c:
                    assert c[vals].dtype == torch.int8 and c[scales].dtype == torch.float32
                    assert c[scales].shape == c[vals].shape[:-1]
            assert not ({"ks", "vs", "ksp", "vsp"} & set(c)) or seg.kind in ("attn", "local")
            for key in ("xk", "xv", "ckv", "krope", "conv"):
                if key in c:
                    assert c[key].dtype != torch.int8, key
            if "ckv" in c:
                assert not {"ks", "vs"} & set(c)


# ---------------------------------------------------------------------------
# qwen3-0.6b tiny: the reference test's config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen3-0.6b")


def test_prefill_and_step_match_reference(qwen):
    """Prefill 8 tokens and one 4-token block: hidden states within float32
    tolerance, the int8 caches equal to the reference's and the scales
    within float32 rounding; against the full-precision model the block's
    hidden state stays within 5 % (the reference test's bound)."""
    s = qwen
    toks = np.random.default_rng(1).integers(0, s["cfg_t"].vocab_size, (2, 12)).astype(np.int32)
    h_j, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks[:, :8]), max_len=32)
    h_t, ct = s["model_t"].prefill(s["params_t"], _t(toks[:, :8]), max_len=32)
    _close(h_j, h_t)
    _close_quant_cache(cj, ct)
    xj = s["model_j"].embed_block(s["params_j"], jnp.asarray(toks[:, 8:]), cj["lengths"])
    xt = s["model_t"].embed_block(s["params_t"], _t(toks[:, 8:]), ct["lengths"])
    hj, cj, _, _ = s["model_j"].step(s["params_j"], xj, cj)
    ht, ct, _ = s["model_t"].step(s["params_t"], xt, ct)
    _close(hj, ht)
    _close_quant_cache(cj, ct)
    fp = build_model(s["cfg_t"].replace(kv_quant=False), device="cpu")
    _, cf = fp.prefill(s["params_t"], _t(toks[:, :8]), max_len=32)
    hf = fp.step(s["params_t"], fp.embed_block(s["params_t"], _t(toks[:, 8:]), cf["lengths"]),
                 cf)[0]
    rel = float((ht - hf).abs().max() / (hf.abs().max() + 1e-9))
    assert 0 < rel < 0.05


def test_dvi_lossless_and_streams_match_reference(qwen):
    """Greedy DVI under the int8 cache commits exactly the port's own int8
    AR stream (drafter and verifier read one cache), and both streams equal
    the reference's."""
    s = qwen
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 8), 2,
                                            s["cfg_t"].vocab_size), np.int32)
    dvi_j = jax.tree.map(np.asarray, jlora.init_draft_params(jax.random.PRNGKey(5), s["cfg_j"]))
    dvi_t = weights.draft_params_from_numpy(dvi_j, "cpu")
    r_arj = jspec.ar_generate(s["model_j"], s["params_j"], jnp.asarray(prompts), 20)
    r_sdj = jspec.speculative_generate(s["model_j"], s["params_j"],
                                       jax.tree.map(jnp.asarray, dvi_j), jnp.asarray(prompts), 20)
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 20)
    r_sd = tspec.speculative_generate(s["model_t"], s["params_t"], dvi_t, _t(prompts), 20)
    for b in range(2):
        n = int(r_ar.lengths[b])
        assert int(r_sd.lengths[b]) >= min(n, 28) and n == int(r_arj.lengths[b])
        assert torch.equal(r_sd.tokens[b, :n], r_ar.tokens[b, :n])
        np.testing.assert_array_equal(r_ar.tokens[b, :n].numpy(), np.asarray(r_arj.tokens[b, :n]))
        m = int(r_sdj.lengths[b])
        assert int(r_sd.lengths[b]) == m
        np.testing.assert_array_equal(r_sd.tokens[b, :m].numpy(), np.asarray(r_sdj.tokens[b, :m]))


# ---------------------------------------------------------------------------
# a ring past its window, whisper, deepseek
# ---------------------------------------------------------------------------

def test_ring_past_the_window_matches_reference():
    """recurrentgemma-9b tiny at a window of 16 (rings of 144 int8 slots),
    prompts of 150 tokens (the prefill's wrapped write) decoded 20 more:
    the ring caches after the prefill equal the reference's, AR's tokens
    equal the reference's and greedy DVI equals the port's own AR."""
    name = "recurrentgemma-9b"
    rg = tiny_cfg(name).rglru
    s = _pair(name, rglru=rg.__class__(**dict(rg.__dict__, local_window=16)))
    prompts = np.random.default_rng(5).integers(2, s["cfg_t"].vocab_size, (2, 150)) \
        .astype(np.int32)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(prompts), max_len=180)
    _, ct = s["model_t"].prefill(s["params_t"], _t(prompts), max_len=180)
    rings = [seg.name for seg in tfm.model_segments(s["cfg_t"]) if seg.kind == "local"]
    assert rings
    for nm in rings:
        c = ct["segs"][nm]
        assert c["k"].dtype == torch.int8 and int(c["pos"].min()) == 150 - 144
        np.testing.assert_array_equal(c["k"].numpy(), np.asarray(cj["segs"][nm]["k"]))
        _close(cj["segs"][nm]["vs"], c["vs"])
    r_j = jspec.ar_generate(s["model_j"], s["params_j"], jnp.asarray(prompts), 20, eos_id=-1)
    r_t = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 20, eos_id=-1)
    np.testing.assert_array_equal(r_t.tokens.numpy()[:, :170], np.asarray(r_j.tokens)[:, :170])
    dvi = tlora.init_draft_params(torch.Generator().manual_seed(0), s["cfg_t"])
    r_sd = tspec.speculative_generate(s["model_t"], s["params_t"], dvi, _t(prompts), 20,
                                      eos_id=-1)
    assert torch.equal(r_sd.tokens[:, :170], r_t.tokens[:, :170])


def test_whisper_quantises_self_attention_only():
    """whisper tiny with ``kv_quant``: self-attention K/V int8 with scales,
    cross K/V in the model dtype equal to the reference's; AR's tokens equal
    the reference's and greedy DVI equals the port's own AR."""
    s = _pair("whisper-large-v3")
    cfg = s["cfg_t"]
    e = cfg.encoder
    frames = np.random.default_rng(7).standard_normal(
        (2, e.num_frames, e.d_model or cfg.d_model)).astype(np.float32)
    prompts = np.random.default_rng(8).integers(2, cfg.vocab_size, (2, 7)).astype(np.int32)
    aux_j, aux_t = {"frame_embeds": jnp.asarray(frames)}, {"frame_embeds": _t(frames)}
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(prompts), aux_j, max_len=40)
    _, ct = s["model_t"].prefill(s["params_t"], _t(prompts), aux_t, max_len=40)
    for name, c in ct["segs"].items():
        assert c["k"].dtype == torch.int8 and c["xk"].dtype == torch.float32
        np.testing.assert_array_equal(c["k"].numpy(), np.asarray(cj["segs"][name]["k"]))
        _close(cj["segs"][name]["xk"], c["xk"])
    r_j = jspec.ar_generate(s["model_j"], s["params_j"], jnp.asarray(prompts), 12,
                            aux_inputs=aux_j)
    r_t = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 12, aux_inputs=aux_t)
    dvi = tlora.init_draft_params(torch.Generator().manual_seed(1), cfg)
    r_sd = tspec.speculative_generate(s["model_t"], s["params_t"], dvi, _t(prompts), 12,
                                      aux_inputs=aux_t)
    for b in range(2):
        n = int(r_t.lengths[b])
        assert n == int(r_j.lengths[b])
        np.testing.assert_array_equal(r_t.tokens[b, :n].numpy(), np.asarray(r_j.tokens[b, :n]))
        assert torch.equal(r_sd.tokens[b, :n], r_t.tokens[b, :n])


def test_deepseek_latents_are_never_quantised():
    """deepseek-v3 tiny with ``kv_quant`` runs exactly as without it: the
    same latent caches and the same AR tokens, equal to the reference's."""
    s = _pair("deepseek-v3-671b")
    prompts = np.random.default_rng(9).integers(2, s["cfg_t"].vocab_size, (2, 9)) \
        .astype(np.int32)
    plain = build_model(s["cfg_t"].replace(kv_quant=False), device="cpu")
    _, cq = s["model_t"].prefill(s["params_t"], _t(prompts), max_len=32)
    _, cp = plain.prefill(s["params_t"], _t(prompts), max_len=32)
    for name, c in cq["segs"].items():
        assert set(c) == {"ckv", "krope", "pos"}
        for key, leaf in c.items():
            assert torch.equal(leaf, cp["segs"][name][key])
    r_j = jspec.ar_generate(s["model_j"], s["params_j"], jnp.asarray(prompts), 10)
    r_q = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 10)
    r_p = tspec.ar_generate(plain, s["params_t"], _t(prompts), 10)
    assert torch.equal(r_q.tokens, r_p.tokens) and torch.equal(r_q.lengths, r_p.lengths)
    for b in range(2):
        n = int(r_q.lengths[b])
        np.testing.assert_array_equal(r_q.tokens[b, :n].numpy(), np.asarray(r_j.tokens[b, :n]))


# ---------------------------------------------------------------------------
# the cache surgery carries the scales
# ---------------------------------------------------------------------------

def test_insert_slot_from_a_prompt_sized_scratch(qwen):
    """A B = 1 prefill into a scratch sized to its prompt, spliced into lane
    1 of a live 3-lane contiguous cache, then the lane reset: values and
    scales follow the reference (the scratch's ks / vs land in the lane's
    prefix), the other lanes untouched."""
    s = qwen
    rng = np.random.default_rng(12)
    toks = rng.integers(2, s["cfg_t"].vocab_size, (3, 10)).astype(np.int32)
    one = rng.integers(2, s["cfg_t"].vocab_size, (1, 13)).astype(np.int32)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=32)
    _, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=32)
    _, sj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(one), max_len=13)
    _, st = s["model_t"].prefill(s["params_t"], _t(one), max_len=13)
    others = {n: {k: v[:, [0, 2]].clone() for k, v in c.items()} for n, c in ct["segs"].items()}
    cj = jtfm.insert_slot(s["cfg_j"], cj, sj, jnp.int32(1))
    ct = tfm.insert_slot(s["cfg_t"], ct, st, 1)
    _close_quant_cache(cj, ct)
    for name, c in ct["segs"].items():
        assert torch.equal(c["ks"][:, 1, :13], st["segs"][name]["ks"][:, 0])
        assert not bool(c["ks"][:, 1, 13:].any())
    cj = jtfm.reset_slot(s["cfg_j"], cj, jnp.int32(1))
    ct = tfm.reset_slot(s["cfg_t"], ct, 1)
    _close_quant_cache(cj, ct)
    for name, c in ct["segs"].items():
        assert not bool(c["ks"][:, 1].any()) and not bool(c["k"][:, 1].any())
        for key, leaf in others[name].items():
            assert torch.equal(c[key][:, [0, 2]], leaf), key


def test_paged_splice_and_copy_on_write(qwen):
    """``_insert_paged_seg`` (through ``insert_slot``) scatters a prefilled
    lane's values and scales through its block-table row, and ``copy_page``
    copies a page's values and scales, as the reference does."""
    s = qwen
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    one = np.random.default_rng(13).integers(2, cfg_t.vocab_size, (1, 11)).astype(np.int32)
    _, sj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(one), max_len=11)
    _, st = s["model_t"].prefill(s["params_t"], _t(one), max_len=11)
    pj = s["model_j"].init_paged_cache(2, 8, 4, 4)
    pt = s["model_t"].init_paged_cache(2, 8, 4, 4)
    row = np.array([5, 2, 7, -1], np.int32)
    pj = jtfm.map_slot_pages(pj, jnp.int32(1), jnp.asarray(row))
    pt = tfm.map_slot_pages(pt, 1, _t(row))
    pj = jtfm.insert_slot(cfg_j, pj, sj, jnp.int32(1))
    pt = tfm.insert_slot(cfg_t, pt, st, 1)
    _close_quant_cache(pj, pt)
    pj = jtfm.copy_page(pj, jnp.int32(7), jnp.int32(3))
    pt = tfm.copy_page(pt, 7, 3)
    _close_quant_cache(pj, pt)
    for c in pt["segs"].values():
        assert bool(c["ksp"][:, 3, :3].all()) and torch.equal(c["ksp"][:, 3], c["ksp"][:, 7])
        assert torch.equal(c["kp"][:, 3], c["kp"][:, 7])
