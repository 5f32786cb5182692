"""The port's fused superstep (``spec_superstep``, greedy, fixed depth)
against repro.core.spec.spec_superstep: from the same pending tokens, cache,
done mask and budgets, with an EOS that fires mid-superstep and lanes that
finish before the last block, the token buffer, counts, done mask, per-lane
counters, histograms and replay buffer are equal (hiddens rtol 1e-5 / atol
2e-5), on a contiguous and on a paged cache.  vicuna-7b-tiny in float32, deep
residuals scaled down (x0.1) so drafts are accepted often."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread keeps the test workers, which share
# the cores, from oversubscribing them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5
B, TP, PS, MPS = 3, 8, 4, 12


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    cfg_j = tiny_cfg("vicuna-7b")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = dict(params_j["segments"])
    for s in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        segs[s.name] = dict(segs[s.name], wo=segs[s.name]["wo"] * 0.1,
                            wo_ff=segs[s.name]["wo_ff"] * 0.1)
    params_j = dict(params_j, segments=segs)
    dvi_j = jlora.init_draft_params(jax.random.PRNGKey(5), cfg_j)
    dvi_j = dict(dvi_j, B=jax.random.normal(jax.random.PRNGKey(11), dvi_j["B"].shape) * 0.01)
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, dvi_j), "cpu")
    prompts = np.random.default_rng(0).integers(2, cfg_t.vocab_size, size=(B, TP)).astype(np.int32)
    return cfg_j, model_j, params_j, dvi_j, cfg_t, model_t, params_t, dvi_t, prompts


def _caches(s, paged):
    """The prompts' prefill (all but the last token) as a contiguous cache,
    or spliced lane by lane into a paged cache over shuffled pages."""
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t, _, prompts = s
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


def _run_both(s, paged, steps, done, budget, eos_id):
    cfg_j, model_j, params_j, dvi_j, cfg_t, model_t, params_t, dvi_t, prompts = s
    cj, ct = _caches(s, paged)
    rj = jspec.spec_superstep(model_j, params_j, dvi_j, jnp.asarray(prompts[:, -1]), cj,
                              steps=steps, done=jnp.asarray(done), budget=jnp.asarray(budget),
                              eos_id=eos_id, collect=True)
    rt = tspec.spec_superstep(model_t, params_t, dvi_t, _t(prompts[:, -1]), ct, steps=steps,
                              done=_t(done), budget=_t(budget), eos_id=eos_id, collect=True)
    return rj, rt


def _eos_mid_superstep(s):
    """A token lane 0 commits third in an EOS-free run, and not before."""
    _, rt = _run_both(s, False, 4, np.zeros(B, bool), np.full(B, 40, np.int32), -1)
    gen = rt.gen_buf[0, :int(rt.gen_count[0])].tolist()
    assert len(gen) >= 4
    return gen[2] if gen[2] not in gen[:2] else gen[3]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("case", ["eos", "early"])
def test_superstep_matches_jax(setup, paged, case):
    if case == "eos":              # EOS mid-superstep, a budget cap, a done lane
        steps, done, budget = 4, np.array([False, False, True]), np.array([40, 3, 40], np.int32)
        eos = _eos_mid_superstep(setup)
    else:                          # every lane done before the last block
        steps, done, budget = 5, np.zeros(B, bool), np.array([2, 3, 1], np.int32)
        eos = -1
    rj, rt = _run_both(setup, paged, steps, done, budget, eos)
    for name in ("pending", "done", "gen_buf", "gen_count", "lane_blocks", "lane_committed",
                 "lane_accepted", "lane_drafted", "accept_hist", "depth_hist"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(rt.cache["lengths"].numpy(), np.asarray(rj.cache["lengths"]))
    assert rt.iters == steps
    if case == "eos":
        assert int(rt.lane_blocks[2]) == 0 and int(rt.gen_count[1]) == 3
        assert int(rt.gen_buf[0, int(rt.gen_count[0]) - 1]) == eos
        assert int(rt.lane_blocks[0]) < steps and bool(rt.done[0])
    else:
        assert bool(rt.done.all()) and int(rt.lane_blocks.max()) < steps
    assert int(rt.lane_accepted.sum()) > 0
    bj, bt = rj.buffer, rt.buffer
    for name in ("ptr", "count", "gen"):
        assert int(bt[name]) == int(bj[name]), name
    for name in ("action", "reward", "pos", "prev", "age"):
        np.testing.assert_array_equal(bt[name].numpy(), np.asarray(bj[name]), err_msg=name)
    n = int(bt["count"])
    for name in ("h_k", "h_L"):
        np.testing.assert_allclose(bt[name][:n].numpy(), np.asarray(bj[name][:n]),
                                   rtol=RTOL, atol=ATOL)


def test_superstep_later_slices_raise(setup):
    """Sampling and per-lane depth are ported: what still raises is a
    sampled superstep without a generator and a superstep of no blocks; a
    ragged ``k_lane`` with the depth controller runs and moves the depths
    within their ceilings."""
    from repro_torch.core.schedule import DepthConfig
    _, _, _, _, cfg_t, model_t, params_t, dvi_t, prompts = setup
    _, ct = _caches(setup, False)
    for kw, exc in ((dict(temperature=0.5), ValueError), (dict(steps=0), ValueError)):
        with pytest.raises(exc):
            tspec.spec_superstep(model_t, params_t, dvi_t, _t(prompts[:, -1]), ct,
                                 **dict(dict(steps=2), **kw))
    dc = DepthConfig(k_min=1, k_max=cfg_t.dvi.k_spec, k_init=2, cooldown=1)
    k_cap = torch.tensor([1, 2, 4], dtype=torch.int32)
    res = tspec.spec_superstep(model_t, params_t, dvi_t, _t(prompts[:, -1]), ct, steps=3,
                               k_lane=torch.tensor([1, 2, 4], dtype=torch.int32),
                               depth_cfg=dc, accept_ema=torch.full((B,), 0.5),
                               k_cool=torch.zeros(B, dtype=torch.int32), k_cap=k_cap)
    assert (res.k_lane >= 1).all() and (res.k_lane <= k_cap).all()
    assert int(res.depth_hist.sum()) == int(res.lane_blocks.sum())
    assert int((res.depth_hist * torch.arange(res.depth_hist.numel())).sum()) == int(
        res.lane_drafted.sum())
