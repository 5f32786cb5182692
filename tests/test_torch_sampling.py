"""Speculative sampling in the port (temperature > 0): ``rejection_commit``
and the sampled ``spec_block_step`` against repro.core.spec, fed the very
noise JAX draws, and the port's own statistical checks.

* ``rejection_commit`` on random p, q and drafts, with JAX's uniforms and
  Gumbel noise: m and the correction equal, with and without ``k_lane``
  (lanes at depth 0 included).
* The reference's two unit tests on the port with a seeded generator: the
  emitted token's total variation from p below 0.02 over 30 000 draws, and
  the all-accept bonus.
* Two and three consecutive sampled blocks at T 0.7 on vicuna-7b-tiny
  (contiguous and paged) and mamba2-370m-tiny, each driven by the
  reference's key schedule: m, the committed tokens, the pending tokens and
  the cache's lengths equal.  A token may differ only at a near-tie the
  test shows (the accept test: |u - p/q| <= 1e-5 p/q; a Gumbel-max draw:
  the top-2 gap of logits + g <= 1e-5 |top-1|); then the case stops there.
* The reference's sampled-generation and temperature-0 tests on the port,
  and one generator seed giving the same streams bit for bit.
* Losslessness of a whole block: one prompt on many lanes at T 0.5; the
  first committed token against softmax(target logits / T) by a
  chi-square test at p > 1e-3.

Float32 tiny configs; the deep residual outputs are scaled down (x0.1) and
the draft head's B perturbed, so drafts are accepted and rejected often.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.core.losses import verifier_logits  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

T = 0.7
TIE = 1e-5
RTOL, ATOL = 1e-5, 2e-5
B, TP, PS, MPS = 3, 8, 4, 12
RESIDUAL_OUT = ("wo", "wo_ff", "out_proj")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# rejection_commit alone
# ---------------------------------------------------------------------------

def _probs(rng, shape, conc):
    x = rng.gamma(conc, size=shape).astype(np.float32)
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _gap_tie(v: np.ndarray) -> bool:
    top = np.sort(v)[-2:]
    return top[1] - top[0] <= TIE * abs(top[1])


@pytest.mark.parametrize("ragged", [False, True])
def test_rejection_commit_matches_jax(ragged):
    rng = np.random.default_rng(3 + ragged)
    Bn, K, V = 64, 4, 40
    p = _probs(rng, (Bn, K + 1, V), 0.5)
    # q near p on some lanes (accepts), far on others (rejects, residuals)
    q = np.where(rng.random((Bn, 1, 1)) < 0.5, 0.8 * p + 0.2 * _probs(rng, p.shape, 0.5),
                 _probs(rng, p.shape, 0.5)).astype(np.float32)
    d = np.stack([[rng.choice(V, p=q[b, j] / q[b, j].sum()) for j in range(K + 1)]
                  for b in range(Bn)]).astype(np.int32)
    p[:4] = q[:4]                                    # all-accept lanes: the bonus from p
    k_lane = rng.integers(0, K + 1, Bn).astype(np.int32) if ragged else None
    if ragged:
        k_lane[:3] = 0
    key = jax.random.PRNGKey(17)
    m_j, c_j = jspec.rejection_commit(key, jnp.asarray(d), jnp.asarray(q), jnp.asarray(p),
                                      k_lane=None if k_lane is None else jnp.asarray(k_lane))
    ku, kr = jax.random.split(key)
    u = np.asarray(jax.random.uniform(ku, (Bn, K)))
    g = np.asarray(jax.random.gumbel(kr, (Bn, V), jnp.float32))
    m_t, c_t = tspec.rejection_commit(_t(d), _t(q), _t(p),
                                      None if k_lane is None else _t(k_lane), u=_t(u), g=_t(g))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    if ragged:
        assert (m_t.numpy() <= k_lane).all() and (m_t.numpy()[:3] == 0).all()
    assert len(set(m_t.tolist())) >= 3              # rejects, partial and full accepts
    for b in np.nonzero(c_t.numpy() != np.asarray(c_j))[0]:
        mb, kb = int(m_t[b]), K if k_lane is None else int(k_lane[b])
        pm, qm = p[b, mb], q[b, mb]
        res = np.maximum(pm - qm, 0)
        dist = pm if mb == kb or res.sum() <= 1e-20 else res / res.sum()
        assert _gap_tie(np.log(np.maximum(dist, 1e-30)) + g[b]), f"lane {b}: correction"


def test_rejection_commit_matches_target_distribution():
    """One drafted position (K = 1) drawn from q: the emitted first token
    (the accepted draft or the correction) is distributed as p."""
    V, N = 8, 30_000
    p = torch.tensor([0.30, 0.22, 0.15, 0.12, 0.09, 0.06, 0.04, 0.02])
    q = torch.tensor([0.05, 0.05, 0.30, 0.20, 0.10, 0.10, 0.10, 0.10])
    gen = torch.Generator().manual_seed(0)
    d = torch.argmax(torch.log(q)[None] + tspec.gumbel((N, V), gen, "cpu"), dim=-1)
    d_blk = torch.stack([d, d], dim=1).to(torch.int32)
    m, corr = tspec.rejection_commit(d_blk, q.expand(N, 2, V), p.expand(N, 2, V),
                                     generator=gen)
    emitted = torch.where(m >= 1, d_blk[:, 0], corr)
    freq = torch.bincount(emitted, minlength=V).double() / N
    tv = 0.5 * float((freq - p.double()).abs().sum())
    assert tv < 0.02, f"total variation {tv:.4f} vs target"


def test_rejection_commit_all_accept_bonus():
    """q == p: every draft accepted (ratio 1), the bonus drawn from p."""
    V = 4
    p = torch.tensor([0.4, 0.3, 0.2, 0.1])
    m, corr = tspec.rejection_commit(torch.tensor([[0, 1, 2]], dtype=torch.int32),
                                     p.expand(1, 3, V), p.expand(1, 3, V),
                                     generator=torch.Generator().manual_seed(1))
    assert int(m[0]) == 2 and 0 <= int(corr[0]) < V


def test_categorical_is_gumbel_max():
    """The reference's categorical is argmax(logits + gumbel(key)), the
    draw the port makes."""
    logits = jax.random.normal(jax.random.PRNGKey(2), (5, 300))
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.categorical(key, logits))
    got = np.argmax(np.asarray(logits) + np.asarray(jax.random.gumbel(key, (5, 300))), -1)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# sampled blocks against the reference
# ---------------------------------------------------------------------------

def _pair(name):
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = dict(params_j["segments"])
    for s in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        segs[s.name] = {key: w * 0.1 if key in RESIDUAL_OUT else w
                        for key, w in segs[s.name].items()}
    params_j = dict(params_j, segments=segs)
    dvi_j = jlora.init_draft_params(jax.random.PRNGKey(5), cfg_j)
    dvi_j = dict(dvi_j, B=jax.random.normal(jax.random.PRNGKey(11), dvi_j["B"].shape) * 0.05)
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, dvi_j), "cpu")
    # the reference's sampled block, compiled once for all of a model's cases
    block_j = jax.jit(lambda params, dvi, pend, cache, done, key: jspec.spec_block_step(
        model_j, params, dvi, pend, cache, done=done, temperature=T, key=key))
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, dvi_j=dvi_j, cfg_t=cfg_t,
                model_t=model_t, params_t=params_t, dvi_t=dvi_t, block_j=block_j)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in ("vicuna-7b", "mamba2-370m")}


def _caches(s, prompts, paged):
    cfg_j, model_j, params_j = s["cfg_j"], s["model_j"], s["params_j"]
    cfg_t, model_t, params_t = s["cfg_t"], s["model_t"], s["params_t"]
    if not paged:
        _, cj, _ = model_j.prefill(params_j, jnp.asarray(prompts[:, :-1]), max_len=48)
        _, ct = model_t.prefill(params_t, _t(prompts[:, :-1]), max_len=48)
        return cj, ct
    perm = np.random.default_rng(1).permutation(np.arange(1, B * MPS + 1))
    cj = model_j.init_paged_cache(B, B * MPS, PS, MPS)
    ct = model_t.init_paged_cache(B, B * MPS, PS, MPS)
    for b in range(B):
        row = perm[b * MPS:(b + 1) * MPS].astype(np.int32)
        cj = jtfm.map_slot_pages(cj, jnp.int32(b), jnp.asarray(row))
        ct = tfm.map_slot_pages(ct, b, _t(row))
        _, pj, _ = model_j.prefill(params_j, jnp.asarray(prompts[b:b + 1, :-1]), max_len=TP - 1)
        _, pt = model_t.prefill(params_t, _t(prompts[b:b + 1, :-1]), max_len=TP - 1)
        cj = jtfm.insert_slot(cfg_j, cj, pj, jnp.int32(b))
        ct = tfm.insert_slot(cfg_t, ct, pt, b)
    return cj, ct


def jax_draws(key, Bn, V, K):
    """The noise the reference's sampled block draws from `key`, in its key
    order, and the key it hands the next block."""
    k_, feeds = key, []
    for _ in range(K + 1):
        k_, sub = jax.random.split(k_)
        feeds.append(np.asarray(jax.random.gumbel(sub, (Bn, V), jnp.float32)))
    key_next, sub = jax.random.split(k_)
    ku, kr = jax.random.split(sub)
    return key_next, tspec.Draws(_t(np.stack(feeds)), _t(jax.random.uniform(ku, (Bn, K))),
                                 _t(jax.random.gumbel(kr, (Bn, V), jnp.float32)))


def _recorder(monkeypatch):
    """Record the port's draft logits of each feed and rejection_commit's
    inputs, to show a near-tie where a token differs."""
    rec = {"dlog": [], "commit": None}
    draft, commit = tspec.draft_logits, tspec.rejection_commit

    def draft_rec(*a, **kw):
        out = draft(*a, **kw)
        rec["dlog"].append(out.detach().clone())
        return out

    def commit_rec(d_blk, dprobs, vprobs, k_lane=None, **kw):
        rec["commit"] = (dprobs, vprobs)
        return commit(d_blk, dprobs, vprobs, k_lane, **kw)

    monkeypatch.setattr(tspec, "draft_logits", draft_rec)
    monkeypatch.setattr(tspec, "rejection_commit", commit_rec)
    return rec


def _near_tie(bj, bt, rec, draws, K) -> list:
    """Lanes where the blocks differ, each shown to differ at a near-tie:
    the first differing draft feed's Gumbel-max draw, else the first
    differing accept test, else the correction's draw.  Fails otherwise."""
    lanes = []
    dprobs, vprobs = (x.numpy() for x in rec["commit"])
    for b in range(B):
        same = (np.array_equal(np.asarray(bj.commit_vec[b]), bt.commit_vec[b].numpy())
                and int(bj.m[b]) == int(bt.m[b])
                and np.array_equal(np.asarray(bj.d_blk[b]), bt.d_blk[b].numpy()))
        if same:
            continue
        lanes.append(b)
        dj, dt = np.asarray(bj.d_blk[b]), bt.d_blk[b].numpy()
        if not np.array_equal(dj, dt):
            j = int(np.nonzero(dj != dt)[0][0])
            z = rec["dlog"][j][b].numpy() / T + draws.feeds[j][b].numpy()
            assert _gap_tie(z), f"lane {b}: draft feed {j} differs outside a near-tie"
            continue
        i = min(int(bj.m[b]), int(bt.m[b]))
        if int(bj.m[b]) != int(bt.m[b]):
            ratio = vprobs[b, i, dt[i]] / max(dprobs[b, i, dt[i]], 1e-20)
            assert abs(float(draws.u[b, i]) - ratio) <= TIE * ratio, \
                f"lane {b}: accept test {i} differs outside a near-tie"
            continue
        res = np.maximum(vprobs[b, i] - dprobs[b, i], 0)
        dist = vprobs[b, i] if i == K or res.sum() <= 1e-20 else res / res.sum()
        assert _gap_tie(np.log(np.maximum(dist, 1e-30)) + draws.corr[b].numpy()), \
            f"lane {b}: correction differs outside a near-tie"
    return lanes


SAMPLED_CELLS = [("vicuna-7b", False, 2), ("vicuna-7b", True, 3), ("mamba2-370m", False, 3)]


@pytest.mark.parametrize("name,paged,blocks", SAMPLED_CELLS)
def test_sampled_blocks_match_jax(pairs, monkeypatch, name, paged, blocks):
    s = pairs[name]
    cfg = s["cfg_t"]
    K, V = cfg.dvi.k_spec, cfg.vocab_size
    prompts = np.random.default_rng(4).integers(2, V, size=(B, TP)).astype(np.int32)
    cj, ct = _caches(s, prompts, paged)
    pend_j, pend_t = jnp.asarray(prompts[:, -1]), _t(prompts[:, -1])
    done = np.array([False, False, True]) if name == "mamba2-370m" else np.zeros(B, bool)
    key = jax.random.PRNGKey(21)
    rec = _recorder(monkeypatch)
    ms = []
    for n in range(blocks):
        bj = s["block_j"](s["params_j"], s["dvi_j"], pend_j, cj, jnp.asarray(done), key)
        key_next, draws = jax_draws(key, B, V, K)
        assert np.array_equal(np.asarray(bj.key), np.asarray(key_next))
        rec["dlog"].clear()
        bt = tspec.spec_block_step(s["model_t"], s["params_t"], s["dvi_t"], pend_t, ct,
                                   done=_t(done), temperature=T, draws=draws)
        tied = _near_tie(bj, bt, rec, draws, K)
        if tied:                          # the streams part here: stop the case
            print(f"{name} block {n}: lanes {tied} differ at a near-tie")
            return
        for field in ("pending", "commit_vec", "accept", "m", "d_blk"):
            np.testing.assert_array_equal(getattr(bt, field).numpy(),
                                          np.asarray(getattr(bj, field)), err_msg=field)
        np.testing.assert_array_equal(bt.cache["lengths"].numpy(),
                                      np.asarray(bj.cache["lengths"]))
        np.testing.assert_allclose(bt.hL_blk.numpy(), np.asarray(bj.hL_blk), rtol=RTOL,
                                   atol=ATOL)
        ms.append(bt.m.numpy().copy())
        pend_j, cj, key = bj.pending, bj.cache, bj.key
        pend_t, ct = bt.pending, bt.cache
    ms = np.concatenate(ms)
    live = np.tile(~done, blocks)
    assert ms[live].max() >= 1 and ms[live].min() < K     # accepts and rejects occurred


# ---------------------------------------------------------------------------
# sampled generation on the port
# ---------------------------------------------------------------------------

def test_sampled_generation_runs(pairs):
    s = pairs["vicuna-7b"]
    cfg, model, params, dvi = s["cfg_t"], s["model_t"], s["params_t"], s["dvi_t"]
    prompts = _t(np.random.default_rng(1).integers(2, cfg.vocab_size, (3, 8)).astype(np.int32))

    def run(seed, collect=False):
        return tspec.speculative_generate(model, params, dvi, prompts, 24, temperature=0.8,
                                          collect=collect,
                                          generator=torch.Generator().manual_seed(seed))

    res = run(3, collect=True)
    lens = res.lengths.numpy()
    assert (lens > 8).all()
    for b in range(3):
        toks = res.tokens[b, :lens[b]]
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert int(res.buffer["count"]) > 0
    again = run(3)
    assert torch.equal(again.tokens, res.tokens) and torch.equal(again.lengths, res.lengths)
    other = run(99)
    assert not torch.equal(other.tokens, res.tokens)


def test_temperature_zero_unchanged(pairs):
    """temperature 0 stays the paper's greedy path: lossless against AR."""
    s = pairs["vicuna-7b"]
    cfg, model, params, dvi = s["cfg_t"], s["model_t"], s["params_t"], s["dvi_t"]
    prompts = _t(np.random.default_rng(2).integers(2, cfg.vocab_size, (2, 8)).astype(np.int32))
    r1 = tspec.speculative_generate(model, params, dvi, prompts, 16, temperature=0.0)
    r2 = tspec.ar_generate(model, params, prompts, 16)
    for b in range(2):
        n = min(int(r1.lengths[b]), int(r2.lengths[b]))
        assert torch.equal(r1.tokens[b, :n], r2.tokens[b, :n])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def test_block_is_lossless_chi_square(pairs):
    """One prompt on many lanes at T 0.5: the first committed token of a
    sampled block (the accepted draft, or the correction) is distributed as
    softmax(target logits / T)."""
    s = pairs["vicuna-7b"]
    cfg, model, params, dvi = s["cfg_t"], s["model_t"], s["params_t"], s["dvi_t"]
    temp, lanes, reps = 0.5, 500, 8
    prompt = np.random.default_rng(5).integers(2, cfg.vocab_size, TP).astype(np.int32)
    prompts = _t(np.tile(prompt, (lanes, 1)))
    _, cache = model.prefill(params, prompts[:, :-1], max_len=TP + cfg.dvi.k_spec + 2)
    gen = torch.Generator().manual_seed(7)
    first, m_all = [], []
    for _ in range(reps):
        blk = tspec.spec_block_step(model, params, dvi, prompts[:, -1], _clone(cache),
                                    temperature=temp, generator=gen)
        first.append(blk.commit_vec[:, 0])
        m_all.append(blk.m)
    first, m_all = torch.cat(first).numpy(), torch.cat(m_all).numpy()
    assert (m_all >= 1).any() and (m_all == 0).any()   # both branches emit the first token
    h, _ = model.prefill(params, _t(prompt[None]))
    logits = verifier_logits(model, params, h[:, -1])[0].double() / temp
    p = torch.softmax(logits, dim=-1).numpy()
    n = len(first)
    expected = n * p
    obs = np.bincount(first, minlength=cfg.vocab_size).astype(np.float64)
    big = expected >= 5
    assert big.sum() >= 5
    f_obs = np.append(obs[big], obs[~big].sum())
    f_exp = np.append(expected[big], expected[~big].sum())
    if f_exp[-1] < 5:                      # too little mass left to pool on its own
        f_obs, f_exp = f_obs[:-1], f_exp[:-1]
        f_exp = f_exp * f_obs.sum() / f_exp.sum()
    pval = stats.chisquare(f_obs, f_exp).pvalue
    assert pval > 1e-3, f"chi-square p = {pval:.2e} over {len(f_obs)} bins"


def test_sampling_never_draws_from_the_global_generator():
    """Without a generator (or ready-made noise) sampling refuses to draw,
    and a seeded generator leaves torch's global one untouched."""
    p = torch.tensor([[[0.5, 0.5], [0.5, 0.5]]])
    d = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="Generator"):
        tspec.rejection_commit(d, p, p)
    state = torch.get_rng_state()
    tspec.rejection_commit(d, p, p, generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), state)
