"""DeepSeek-V3's multi-head latent attention and its MTP head on the port
against the JAX package, in float32 (deepseek-v3-671b-tiny: a dense layer,
then two MoE layers of 4 experts, top 2, and a shared one; the norm gains
perturbed, the deep blocks' output projections scaled down x0.1 so drafts
are accepted often; weights handed over through the bridge).

``mla_full`` (also past ``attend_full``'s blockwise threshold) and
``mla_step`` (writes past the capacity dropped) against the reference's,
the absorbed step against the decompressed full pass, ``mtp_logits`` and
the ``mtp`` subtree through ``params_from_numpy`` and ``load_npz``, chained
speculative blocks lossless against the port's ``ar_generate`` and equal
to the JAX package's, the sync and contiguous continuous engines against
the JAX engines, chunked prefill equal to one-shot (TINY's
``capacity_factor`` 8 drops no token), lane surgery on the latent cache,
the paged layout refused, and ``expert_ranks`` at 256 experts.

Hiddens, latents and logits within rtol 1e-5 / atol 2e-5 (the absorbed
step against the full pass: atol 2e-4, the reference's own bound), ``pos``
and tokens exactly."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.checkpoint.ckpt import save_checkpoint  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import online  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

NAME = "deepseek-v3-671b"
RTOL, ATOL = 1e-5, 2e-5
NORMS = ("ln1", "ln2", "final_norm", "q_ln", "kv_ln", "norm")
OUT_PROJ = ("w_o", "wo_ff", "we_down", "ws_down")


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


@functools.lru_cache(maxsize=None)
def _pair(mtp_depth: int = 0):
    cfg_j = tiny_cfg(NAME).replace(mtp_depth=mtp_depth)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    k, L = cfg_j.dvi.split_layer, cfg_j.num_layers
    deep = {s.name for s in jtfm.segments_in_range(cfg_j, k, L)}
    params_j = {key: ({n: _prep(sp, rng, n in deep) for n, sp in v.items()}
                      if key == "segments" else
                      _prep(v, rng, False) if isinstance(v, dict) else
                      (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                       if key in NORMS else v))
                for key, v in params_j.items()}
    state = online.init_trainer(model_j, jax.random.PRNGKey(3))
    state.dvi_params = dict(state.dvi_params, B=jax.random.normal(
        jax.random.PRNGKey(11), state.dvi_params["B"].shape) * 0.01)
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32", mtp_depth=mtp_depth)
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, state.dvi_params), "cpu")
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, state=state, cfg_t=cfg_t,
                model_t=model_t, params_t=params_t, dvi_t=dvi_t)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (B, T)).astype(np.int32)


def _close_cache(cj, ct):
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name, seg in ct["segs"].items():
        assert set(seg) == set(cj["segs"][name]) == {"ckv", "krope", "pos"}, name
        np.testing.assert_array_equal(seg["pos"].numpy(), np.asarray(cj["segs"][name]["pos"]))
        for key in ("ckv", "krope"):
            _close(cj["segs"][name][key], seg[key])


def _layer0(s):
    """Layer 0's parameters in both packages."""
    pj = jax.tree.map(lambda w: w[0], s["params_j"]["segments"]["s0"])
    return pj, tfm._layer(s["params_t"]["segments"]["s0"], 0)


# ---------------------------------------------------------------------------
# the attention module
# ---------------------------------------------------------------------------

def test_config_builds_with_mla_and_refuses_the_rest():
    cfg = get_config(NAME, tiny=True).replace(dtype="float32")
    assert cfg.mla is not None and cfg.mla.kv_lora_rank == 32
    assert build_model(cfg, device="cpu").cfg.mla == cfg.mla
    params = build_model(cfg.replace(mtp_depth=1), device="cpu").init(torch.Generator())
    assert set(params["mtp"]) == {"proj", "norm", "layer"}
    assert set(params["mtp"]["layer"]) >= {"w_dq", "q_ln", "w_uq", "w_dkv", "kv_ln", "w_kr",
                                           "w_uk", "w_uv", "w_o", "wi", "wg", "wo_ff"}
    quant = build_model(cfg.replace(kv_quant=True), device="cpu")   # latents stay unquantised
    assert set(quant.init_cache(2, 8)["segs"]["s0"]) == {"ckv", "krope", "pos"}


@pytest.mark.parametrize("B,T", [(2, 9), (1, 1030)])
def test_mla_full_matches(pair, B, T):
    """The decompressed form, also past attend_full's blockwise threshold
    (T^2 > 2^20): output and the cache contributions."""
    s = pair
    cfg = s["cfg_t"]
    pj, pt = _layer0(s)
    x = np.random.default_rng(T).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    out_j, lat_j = jmla.mla_full(pj, jnp.asarray(x), cfg.num_heads, s["cfg_j"].mla,
                                 jnp.asarray(pos), jlayers.MaskSpec(), cfg.rope_theta)
    out_t, lat_t = tmla.mla_full(pt, _t(x), cfg.num_heads, cfg.mla, _t(pos),
                                 tlayers.MaskSpec(), cfg.rope_theta)
    _close(out_j, out_t)
    for key in ("ckv", "krope"):
        _close(lat_j[key], lat_t[key])


def test_mla_step_matches(pair):
    """The absorbed form on a K+1 block against latent caches of 24 slots,
    one lane's writes past the capacity dropped: the output and the caches
    written in place."""
    s = pair
    cfg, m = s["cfg_t"], s["cfg_t"].mla
    pj, pt = _layer0(s)
    rng = np.random.default_rng(7)
    B, T, S = 3, cfg.dvi.k_spec + 1, 24
    lengths = np.array([5, 11, 22], np.int32)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    qpos = lengths[:, None] + np.arange(T)[None]
    out_j, ckv_j, krope_j = jmla.mla_step(pj, jnp.asarray(x), jnp.asarray(ckv),
                                          jnp.asarray(krope), jnp.asarray(lengths),
                                          cfg.num_heads, s["cfg_j"].mla, jnp.asarray(qpos),
                                          cfg.rope_theta)
    ckv_t, krope_t = _t(ckv), _t(krope)
    out_t = tmla.mla_step(pt, _t(x), ckv_t, krope_t, _t(lengths), cfg.num_heads, m,
                          _t(qpos), cfg.rope_theta)
    _close(out_j, out_t)
    _close(ckv_j, ckv_t)
    _close(krope_j, krope_t)
    assert torch.equal(ckv_t[2, :22], _t(ckv[2, :22]))          # a full lane's prefix kept


def test_absorbed_step_equals_decompressed_full_pass(pair):
    """A block decoded against the prefilled latent cache gives the hidden
    states of the full pass over the whole sequence (the reference's
    tests/test_mixers.py::test_mla_step_matches_full)."""
    s = pair
    model, params = s["model_t"], s["params_t"]
    toks = _t(_prompts(s["cfg_t"], 2, 12, 1))
    h_full, _ = model.hidden(params, model.embed(params, toks))
    _, cache = model.prefill(params, toks[:, :8], max_len=32)
    h_blk, _, _ = model.step(params, model.embed_block(params, toks[:, 8:]), cache)
    np.testing.assert_allclose(h_blk.numpy(), h_full[:, 8:].numpy(), atol=2e-4)


def test_prefill_and_block_match(pair):
    """Prefill (logits, the latent cache and its pos) and one speculative
    block from it, lane 1 done, against the JAX package."""
    s = pair
    toks = _prompts(s["cfg_t"], 3, 12, 2)
    h_j, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks[:, :-1]), max_len=40)
    h_t, ct = s["model_t"].prefill(s["params_t"], _t(toks[:, :-1]), max_len=40)
    _close(s["model_j"].logits(s["params_j"], h_j), s["model_t"].logits(s["params_t"], h_t))
    _close_cache(cj, ct)
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


# ---------------------------------------------------------------------------
# the MTP head
# ---------------------------------------------------------------------------

def test_mtp_logits_match():
    s = _pair(1)
    toks = _prompts(s["cfg_t"], 2, 10, 3)
    h_j, _, _ = s["model_j"].hidden(s["params_j"], s["model_j"].embed(s["params_j"],
                                                                       jnp.asarray(toks)))
    h_t, _ = s["model_t"].hidden(s["params_t"], s["model_t"].embed(s["params_t"], _t(toks)))
    _close(h_j, h_t)
    lj = s["model_j"].mtp_logits(s["params_j"], h_j[:, :-1], jnp.asarray(toks[:, 1:]))
    lt = s["model_t"].mtp_logits(s["params_t"], h_t[:, :-1], _t(toks[:, 1:]))
    assert tuple(lt.shape) == (2, 9, s["cfg_t"].vocab_size)
    _close(lj, lt)


def test_mtp_subtree_through_the_bridge_and_npz(tmp_path):
    """The mtp subtree leaf for leaf through params_from_numpy and load_npz,
    the norm gain float32; the port's own init draws the same tree."""
    s = _pair(1)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(s["params_j"]["mtp"])[0]}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, s["params_j"])
    loaded = weights.load_npz(s["cfg_t"], path, "cpu")
    drawn = s["model_t"].init(torch.Generator().manual_seed(0))
    for key, arr in flat_j.items():
        parts = key.strip("[]'").split("']['")
        for tree in (s["params_t"]["mtp"], loaded["mtp"], drawn["mtp"]):
            node = tree
            for part in parts:
                node = node[part]
            assert tuple(node.shape) == arr.shape and node.dtype == torch.float32, key
            if tree is not drawn["mtp"]:
                np.testing.assert_array_equal(node.numpy(), arr)
    assert len(flat_j) == 2 + 2 + 9 + 3         # proj, norm; ln1, ln2, MLA, FFN


def test_mtp_bf16_leaves_bit_exact(tmp_path):
    cfg_j = jax_build_model(tiny_cfg(NAME).replace(mtp_depth=1, dtype="bfloat16"))
    params_j = cfg_j.init(jax.random.PRNGKey(0))
    path = str(tmp_path / "bf16.npz")
    save_checkpoint(path, params_j)
    loaded = weights.load_npz(get_config(NAME, tiny=True).replace(mtp_depth=1), path, "cpu")
    assert loaded["mtp"]["proj"].dtype == torch.bfloat16
    assert loaded["mtp"]["norm"].dtype == torch.float32
    for name in ("w_uk", "q_ln", "wo_ff"):
        arr = np.asarray(params_j["mtp"]["layer"][name])
        got = loaded["mtp"]["layer"][name]
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(), arr.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), arr)


# ---------------------------------------------------------------------------
# speculative decoding and the engines
# ---------------------------------------------------------------------------

def test_chained_block_steps_lossless(pair):
    """Eight chained blocks from a prefill (the reference's
    tests/test_serve_step.py::test_chained_block_steps_lossless): the
    committed tokens equal the port's ar_generate and the JAX package's
    chained blocks."""
    s = pair
    dvi_j = jlora.init_draft_params(jax.random.PRNGKey(5), s["cfg_j"])
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, dvi_j), "cpu")
    B, Tp = 2, 8
    prompts = _prompts(s["cfg_t"], B, Tp, 4)
    r_ar = tspec.ar_generate(s["model_t"], s["params_t"], _t(prompts), 20)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(prompts[:, :-1]), max_len=64)
    _, ct = s["model_t"].prefill(s["params_t"], _t(prompts[:, :-1]), max_len=64)
    pj, pt = jnp.asarray(prompts[:, -1]), _t(prompts[:, -1])
    got_j, got_t = [[] for _ in range(B)], [[] for _ in range(B)]
    for _ in range(8):
        bj = jspec.spec_block_step(s["model_j"], s["params_j"], dvi_j, pj, cj)
        bt = tspec.spec_block_step(s["model_t"], s["params_t"], dvi_t, pt, ct)
        pj, cj, pt, ct = bj.pending, bj.cache, bt.pending, bt.cache
        for b in range(B):
            got_j[b].extend(np.asarray(bj.commit_vec[b, :int(bj.accept[b])]).tolist())
            got_t[b].extend(bt.commit_vec[b, :int(bt.accept[b])].tolist())
    assert got_t == got_j
    for b in range(B):
        ref = r_ar.tokens[b, Tp:int(r_ar.lengths[b])].tolist()
        n = min(len(ref), len(got_t[b]))
        assert n > 8 and got_t[b][:n] == ref[:n], f"lane {b} diverged"


REQS = [(5, 8), (14, 6), (9, 8), (7, 4), (12, 8)]
CONT = dict(scheduler="continuous", num_slots=2, max_new=8, cache_len=40, kv_pages=0,
            sync_every=2)
SYNC = dict(scheduler="sync", batch_size=2, max_new=8, buckets=(8, 16))


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
                         learn=False, **kw)


@pytest.mark.parametrize("kw", [SYNC, CONT], ids=["sync", "continuous"])
def test_engine_matches_jax(pair, kw):
    """Five requests through the port's and the JAX engine (sync: two
    buckets, padded batches; continuous: the contiguous latent cache, two
    lanes): equal completions and counts, lanes empty at the end."""
    s = pair
    reqs = _requests(s["cfg_t"])
    eng_t = _port(s, **kw)
    eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False, **kw)
    assert _serve(eng_t, reqs, Request) == _serve(eng_j, reqs, JRequest)
    for key in ("requests", "blocks", "committed", "accepted", "drafted"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.stats["accepted"] > 0 and eng_t.active_slots == 0


def test_chunked_prefill_equals_one_shot(pair):
    """The contiguous engine with chunks of 5 (the chunk step writes the
    latents in place; its MoE path is dropless, and TINY's capacity factor
    8 drops nothing in one-shot prefill either): the one-shot engine's
    streams and the JAX chunked engine's, with equal chunk counters."""
    s = pair
    reqs = _requests(s["cfg_t"])
    one_shot = _serve(_port(s, **CONT), reqs, Request)
    eng_t = _port(s, **CONT, prefill_chunk=5)
    eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False, **CONT,
                    prefill_chunk=5)
    assert _serve(eng_t, reqs, Request) == one_shot == _serve(eng_j, reqs, JRequest)
    assert eng_t.stats["prefill_chunks"] > 0
    for key in ("prefill_chunks", "prefill_tokens", "max_tick_prefill_tokens", "blocks"):
        assert eng_t.stats[key] == eng_j.stats[key], key


@pytest.mark.parametrize("scratch", [6, 40], ids=["chunk_scratch", "full"])
def test_insert_and_reset_slot_match(pair, scratch):
    """A B = 1 prefill (into a chunk-sized scratch, or one of the live
    cache's capacity) spliced into lane 1 of a live 3-lane latent cache,
    then lane 1 reset: latents and pos follow the reference's (pos is no
    ring: the source's row lands in the lane's prefix, the rest stays -1),
    the other lanes untouched bit for bit."""
    s = pair
    toks = _prompts(s["cfg_t"], 3, 9, 12)
    one = _prompts(s["cfg_t"], 1, 6, 13)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(toks), max_len=40)
    _, ct = s["model_t"].prefill(s["params_t"], _t(toks), max_len=40)
    cj = jtfm.reset_slot(s["cfg_j"], cj, jnp.int32(1))
    ct = tfm.reset_slot(s["cfg_t"], ct, 1)
    _close_cache(cj, ct)
    others = {n: {k: v.clone() for k, v in seg.items()} for n, seg in ct["segs"].items()}
    _, sj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(one), max_len=scratch)
    _, st = s["model_t"].prefill(s["params_t"], _t(one), max_len=scratch)
    cj = jtfm.insert_slot(s["cfg_j"], cj, sj, jnp.int32(1))
    ct = tfm.insert_slot(s["cfg_t"], ct, st, 1)
    _close_cache(cj, ct)
    for n, seg in ct["segs"].items():
        assert seg["pos"][1].tolist() == list(range(6)) + [-1] * 34
        assert torch.equal(seg["ckv"][:, [0, 2]], others[n]["ckv"][:, [0, 2]])
        assert torch.equal(seg["pos"][[0, 2]], others[n]["pos"][[0, 2]])
    cj = jtfm.reset_slot(s["cfg_j"], cj, jnp.int32(1))
    ct = tfm.reset_slot(s["cfg_t"], ct, 1)
    _close_cache(cj, ct)
    for seg in ct["segs"].values():
        assert bool((seg["pos"][1] == -1).all()) and not bool(seg["ckv"][:, 1].any())


def test_paged_layout_refused(pair):
    """The reference has no paged MLA cache: the port's init_paged_cache
    raises as the reference's does, and a paged engine (with or without
    the prefix cache) fails at construction."""
    s = pair
    with pytest.raises(NotImplementedError, match="MLA"):
        jtfm.init_paged_cache(s["cfg_j"], 2, 8, 4, 4)
    with pytest.raises(NotImplementedError, match="MLA"):
        tfm.init_paged_cache(s["cfg_t"], 2, 8, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        _port(s, **dict(CONT, kv_pages=24, kv_page_size=4))
    with pytest.raises(NotImplementedError, match="MLA"):
        _port(s, **dict(CONT, kv_pages=24, kv_page_size=4, prefill_chunk=4,
                        prefix_cache=True))


# the routing at deepseek-v3's 256 experts, top 8: a verify block of 8
# lanes (8 x 5 tokens), a chunk step (8 x 32) and sync prefills (8 x 127;
# 16 x 128 past the one-hot threshold, the sort branch)
@pytest.mark.parametrize("tokens", [40, 256, 8 * 127, 16 * 128])
def test_expert_ranks_at_256_experts(tokens):
    E, k = 256, 8
    flat_e = np.random.default_rng(tokens).integers(0, E, tokens * k).astype(np.int32)
    one_hot = tmoe.expert_ranks(_t(flat_e), E, one_hot_limit=1 << 30)
    by_sort = tmoe.expert_ranks(_t(flat_e), E, one_hot_limit=0)
    assert torch.equal(one_hot.long(), by_sort.long())
    np.testing.assert_array_equal(tmoe.expert_ranks(_t(flat_e), E).numpy(),
                                  np.asarray(jmoe._expert_ranks(jnp.asarray(flat_e), E)))
