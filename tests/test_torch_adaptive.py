"""Per-lane adaptive speculation depth in the port: the depth controller
(``repro_torch.core.schedule``), ``k_lane`` through ``spec_superstep`` and the
continuous ``ServingEngine(adaptive_k=True)``, against repro.core.schedule /
repro.core.spec and against the port's own fixed-depth path.

* ``DepthConfig``'s validation; ``depth_update`` against the reference on
  random (m, live, k_hi) sequences (k and cool exact, the EMA within 1e-6,
  as XLA may contract to FMA); ``max_depth_rises`` equal to the reference
  and never beaten by the controller.
* Pinned depth (k_lane all K) is the fixed-depth superstep bit for bit:
  steps 1 and 8, T 0 and 0.7, contiguous and paged.
* A ragged ``k_lane`` with the controller in ``spec_superstep``, against
  the reference: the same tokens and the same (k, ema, cool) after every
  superstep.
* The engine: the controller pinned at K equals fixed K (contiguous and
  paged, sync_every 1 and 8, ``drafted`` and ``blocks`` included); a
  recycled lane resets its depth; the adversarial swing on a tight pool is
  lossless and drains the pool; the default controller equals the JAX
  engine's; through the fake CUDA of tests/test_torch_graphs.py, one
  capture per draft width seen and graphed equal to eager bit for bit.

vicuna-7b-tiny in float32, deep residuals scaled down (x0.1) so drafts are
accepted often.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import online  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.core.schedule import (DepthConfig, depth_update, init_depth_state,  # noqa: E402
                                       max_depth_rises)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_graphs import FakeCuda  # noqa: E402

EOS = 1
B, TP, PS, MPS = 3, 8, 4, 24


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(k_min=0, k_init=1), dict(k_min=3, k_init=2),
                                dict(k_init=5, k_max=4), dict(cooldown=0),
                                dict(lo=0.7, hi=0.7), dict(hi=1.2), dict(lo=-0.1)])
def test_depth_config_validation(kw):
    with pytest.raises(ValueError):
        DepthConfig(**kw)


def test_depth_config_accepts_the_reference_defaults():
    assert DepthConfig() == DepthConfig(1, 4, 4, 0.25, 0.70, 0.35, 4, 0.5)
    k, ema, cool = init_depth_state(DepthConfig(k_init=2, ema_init=0.3), 5)
    assert k.tolist() == [2] * 5 and cool.tolist() == [0] * 5 and ema.dtype == torch.float32
    assert torch.allclose(ema, torch.full((5,), 0.3))


@pytest.mark.parametrize("seed", range(3))
def test_depth_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 16
    kw = dict(k_min=1, k_max=6, k_init=int(rng.integers(1, 7)), cooldown=int(rng.integers(1, 4)),
              ema_alpha=float(rng.uniform(0.1, 0.9)), hi=0.6, lo=0.3,
              ema_init=float(rng.uniform(0, 1)))
    dc_j, dc_t = jschedule.DepthConfig(**kw), DepthConfig(**kw)
    kj, ej, cj = jschedule.init_depth_state(dc_j, n)
    kt, et, ct = init_depth_state(dc_t, n)
    k_hi = rng.integers(1, 7, n).astype(np.int32) if seed else None
    moved = 0
    for _ in range(60):
        m = rng.integers(0, 7, n).astype(np.int32)
        m = np.minimum(m, np.asarray(kj))                  # at most the depth it ran at
        live = rng.random(n) < 0.8
        kj, ej, cj = jschedule.depth_update(dc_j, kj, ej, cj, jnp.asarray(m), jnp.asarray(live),
                                            k_hi=None if k_hi is None else jnp.asarray(k_hi))
        k_prev = kt.clone()
        kt, et, ct = depth_update(dc_t, kt, et, ct, _t(m), _t(live),
                                  k_hi=None if k_hi is None else _t(k_hi))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-6)
        assert kt.dtype == ct.dtype == torch.int32 and et.dtype == torch.float32
        moved += int((kt != k_prev).sum())
    assert moved > 0


@pytest.mark.parametrize("cooldown", [1, 2, 4])
def test_max_depth_rises_matches_jax_and_bounds_the_controller(cooldown):
    dc_j = jschedule.DepthConfig(k_min=1, k_max=64, k_init=1, cooldown=cooldown, hi=0.1,
                                 lo=0.05, ema_init=1.0)
    dc = DepthConfig(k_min=1, k_max=64, k_init=1, cooldown=cooldown, hi=0.1, lo=0.05,
                     ema_init=1.0)
    for cool0 in (0, 1, 3, 7):
        for steps in (1, 2, 3, 4, 8, 16):
            bound = max_depth_rises(dc, steps, cool0)
            assert bound == jschedule.max_depth_rises(dc_j, steps, cool0)
            k, ema, cool = (torch.tensor([1], dtype=torch.int32), torch.tensor([1.0]),
                            torch.tensor([cool0], dtype=torch.int32))
            for _ in range(steps):                     # full acceptance every block
                k, ema, cool = depth_update(dc, k, ema, cool, k, torch.tensor([True]))
            assert int(k[0]) - 1 <= bound, (cool0, steps)


# ---------------------------------------------------------------------------
# k_lane through the superstep
# ---------------------------------------------------------------------------

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
    return dict(cfg_j=cfg_j, model_j=model_j, params_j=params_j, dvi_j=dvi_j, cfg_t=cfg_t,
                model_t=model_t, params_t=params_t, dvi_t=dvi_t)


def _prompts(cfg, seed=7):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (B, TP)).astype(np.int32)


def _cache_t(s, prompts, paged):
    model, params, cfg = s["model_t"], s["params_t"], s["cfg_t"]
    if not paged:
        _, cache = model.prefill(params, _t(prompts[:, :-1]), max_len=96)
        return cache
    perm = np.random.default_rng(1).permutation(np.arange(1, B * MPS + 1))
    cache = model.init_paged_cache(B, B * MPS + 1, PS, MPS)
    for b in range(B):
        tfm.map_slot_pages(cache, b, _t(perm[b * MPS:(b + 1) * MPS].astype(np.int32)))
        _, pc = model.prefill(params, _t(prompts[b:b + 1, :-1]), max_len=TP - 1)
        tfm.insert_slot(cfg, cache, pc, b)
    return cache


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_pinned_k_lane_bit_identical(setup, steps, temperature, layout):
    s = setup
    K = s["cfg_t"].dvi.k_spec
    prompts = _prompts(s["cfg_t"])
    budget = _t(np.array([4, 9, 30], np.int32))
    out = []
    for k_lane in (None, torch.full((B,), K, dtype=torch.int32)):
        gen = torch.Generator().manual_seed(99) if temperature else None
        out.append(tspec.spec_superstep(
            s["model_t"], s["params_t"], s["dvi_t"], _t(prompts[:, -1]),
            _cache_t(s, prompts, layout == "paged"), steps=steps, budget=budget, eos_id=EOS,
            temperature=temperature, generator=gen, k_lane=k_lane, collect=True))
    ref, pin = out
    for name in ("gen_buf", "gen_count", "done", "pending", "lane_blocks", "lane_committed",
                 "lane_accepted", "lane_drafted", "k_lane", "accept_hist", "depth_hist"):
        assert torch.equal(getattr(ref, name), getattr(pin, name)), name
    assert torch.equal(ref.cache["lengths"], pin.cache["lengths"])
    for name in ("ptr", "count", "action", "reward", "h_k"):
        assert torch.equal(ref.buffer[name], pin.buffer[name]), name


def test_ragged_superstep_with_controller_matches_jax(setup):
    """Three supersteps of 3 blocks, lanes starting at depths 1, 2 and 4
    under ceilings 2, 4 and 4, a rise-prone controller (cooldown 1): the
    tokens, counters, histograms and the controller's state after each
    superstep equal the reference's."""
    s = setup
    kw = dict(k_min=1, k_max=4, k_init=2, cooldown=1, hi=0.3, lo=0.1, ema_alpha=0.5)
    dc_j, dc_t = jschedule.DepthConfig(**kw), DepthConfig(**kw)
    prompts = _prompts(s["cfg_t"], seed=3)
    _, cj, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(prompts[:, :-1]), max_len=96)
    ct = _cache_t(s, prompts, False)
    pend_j, pend_t = jnp.asarray(prompts[:, -1]), _t(prompts[:, -1])
    k = np.array([1, 2, 4], np.int32)
    ema = np.array([0.5, 0.2, 0.9], np.float32)
    cool = np.zeros(B, np.int32)
    k_cap = np.array([2, 4, 4], np.int32)
    budget = np.array([40, 40, 7], np.int32)
    sup_j = jax.jit(lambda pend, cache, budget, k, ema, cool: jspec.spec_superstep(
        s["model_j"], s["params_j"], s["dvi_j"], pend, cache, steps=3, budget=budget,
        eos_id=-1, k_lane=k, depth_cfg=dc_j, accept_ema=ema, k_cool=cool,
        k_cap=jnp.asarray(k_cap)))
    seen = set()
    for _ in range(3):
        rj = sup_j(pend_j, cj, jnp.asarray(budget), jnp.asarray(k), jnp.asarray(ema),
                   jnp.asarray(cool))
        rt = tspec.spec_superstep(s["model_t"], s["params_t"], s["dvi_t"], pend_t, ct, steps=3,
                                  budget=_t(budget), eos_id=-1, k_lane=_t(k), depth_cfg=dc_t,
                                  accept_ema=_t(ema), k_cool=_t(cool), k_cap=_t(k_cap))
        for name in ("gen_count", "done", "pending", "lane_blocks", "lane_committed",
                     "lane_accepted", "lane_drafted", "k_lane", "k_cool", "accept_hist",
                     "depth_hist"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name)), err_msg=name)
        np.testing.assert_allclose(rt.accept_ema.numpy(), np.asarray(rj.accept_ema), rtol=0,
                                   atol=1e-6)
        for b in range(B):
            n = int(rt.gen_count[b])
            np.testing.assert_array_equal(rt.gen_buf[b, :n].numpy(), np.asarray(rj.gen_buf[b, :n]))
        seen |= set(rt.k_lane.tolist())
        k, ema, cool = rt.k_lane.numpy(), rt.accept_ema.numpy(), rt.k_cool.numpy()
        budget = np.maximum(budget - rt.gen_count.numpy(), 1).astype(np.int32)
        pend_j, cj, pend_t, ct = rj.pending, rj.cache, rt.pending, rt.cache
        assert (k <= k_cap).all() and (k >= 1).all()
    assert len(seen) >= 2                         # the controller moved the depths


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tp, mn = int(rng.choice([6, 9, 12])), int(rng.choice([6, 10, 16]))
        reqs.append((i, rng.integers(2, cfg.vocab_size, tp).astype(np.int32), mn))
    return reqs


def _serve(s, reqs, **kw):
    eng = ServingEngine(s["model_t"], s["params_t"],
                        tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                        scheduler="continuous", max_new=16, learn=False, **kw)
    for uid, p, mn in reqs:
        eng.submit_request(Request(uid, p, max_new=mn))
    outs = eng.run(max_steps=2000)
    assert len(outs) == len(reqs)
    return eng, {o.uid: o.gen_tokens.tolist() for o in outs}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("sync_every", [1, 8])
def test_engine_pinned_adaptive_matches_fixed(setup, layout, sync_every):
    K = setup["cfg_t"].dvi.k_spec
    reqs = _requests(setup["cfg_t"], 5)
    kw = dict(num_slots=2, sync_every=sync_every)
    if layout == "paged":
        kw.update(cache_len=40, kv_pages=40, kv_page_size=4)
    ref_eng, ref = _serve(setup, reqs, **kw)
    pin_eng, pin = _serve(setup, reqs, adaptive_k=True,
                          depth_cfg=DepthConfig(k_min=K, k_max=K, k_init=K), **kw)
    assert pin == ref
    for key in ("drafted", "blocks", "committed", "accepted", "dispatches", "host_syncs"):
        assert pin_eng.stats[key] == ref_eng.stats[key], key
    assert pin_eng.adaptive_stats()["mean_depth"] == K


def test_slot_reuse_resets_depth_state(setup):
    K = setup["cfg_t"].dvi.k_spec
    dc = DepthConfig(k_min=1, k_max=K, k_init=K, cooldown=1, ema_alpha=0.9, hi=0.95, lo=0.80,
                     ema_init=0.9)
    eng = ServingEngine(setup["model_t"], setup["params_t"],
                        tonline.init_trainer(setup["model_t"], dvi_params=setup["dvi_t"]),
                        scheduler="continuous", num_slots=1, max_new=16, sync_every=1,
                        learn=False, adaptive_k=True, depth_cfg=dc)
    reqs = _requests(setup["cfg_t"], 2, seed=11)
    eng.submit_request(Request(*reqs[0][:2], max_new=reqs[0][2]))
    eng.run(max_steps=500)
    assert int(eng._k_host[0]) < K, "the first request should have throttled"
    assert float(eng._ema_host[0]) != pytest.approx(dc.ema_init)
    eng.submit_request(Request(*reqs[1][:2], max_new=reqs[1][2]))
    eng._admit_waiting()
    assert int(eng._k_host[0]) == dc.k_init and int(eng._cool_host[0]) == 0
    assert float(eng._ema_host[0]) == pytest.approx(dc.ema_init)
    assert len(eng.run(max_steps=500)) == 1
    st = eng.adaptive_stats()
    assert st["adaptive"] and 1 <= st["mean_depth"] <= K and st["draft_efficiency"] > 0


def test_paged_adaptive_swings_tight_pool(setup):
    """Lanes admitted at the floor climb to the ceiling inside a superstep
    (cooldown 1, a rise-always band) over an ample pool, a tight one and
    one that preempts: streams equal the contiguous fixed-K run of the same
    lanes and supersteps, and the pool drains."""
    K = setup["cfg_t"].dvi.k_spec
    dc = DepthConfig(k_min=1, k_max=K, k_init=1, cooldown=1, hi=0.1, lo=0.05, ema_init=0.9)
    preempted = 0
    for slots, sync_every, n, pages in ((2, 8, 5, 40), (2, 8, 5, 16), (3, 2, 7, 12)):
        reqs = _requests(setup["cfg_t"], n, seed=2)
        _, ref = _serve(setup, reqs, num_slots=slots, sync_every=sync_every)
        eng, got = _serve(setup, reqs, num_slots=slots, sync_every=sync_every, cache_len=40,
                          kv_pages=pages, kv_page_size=4, adaptive_k=True, depth_cfg=dc)
        assert got == ref, f"paged adaptive (pages={pages}) diverged"
        assert eng.kv_stats()["used_pages"] == 0, "the pool must drain"
        assert int(np.max(eng._k_host)) > 1               # the swing happened
        preempted = eng.stats["preemptions"]
    assert preempted > 0


def test_engine_adaptive_matches_jax(setup):
    """The default controller (k_min 1, k_max K) on a paged pool with
    sync_every 4, against the JAX engine: streams, counters and each lane's
    controller state at the end."""
    s = setup
    reqs = _requests(s["cfg_t"], 5, seed=4)
    kw = dict(scheduler="continuous", num_slots=2, max_new=16, sync_every=4, cache_len=40,
              kv_pages=24, kv_page_size=4, adaptive_k=True)
    state = online.init_trainer(s["model_j"], jax.random.PRNGKey(3))
    state.dvi_params = dict(s["dvi_j"])
    eng_j = JEngine(s["model_j"], s["params_j"], state, learn=False, **kw)
    eng_t = ServingEngine(s["model_t"], s["params_t"],
                          tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                          learn=False, **kw)
    for uid, p, mn in reqs:
        eng_j.submit_request(JRequest(uid, p, max_new=mn))
        eng_t.submit_request(Request(uid, p, max_new=mn))
    outs_j, outs_t = eng_j.run(max_steps=2000), eng_t.run(max_steps=2000)
    assert ({c.uid: c.gen_tokens.tolist() for c in outs_t}
            == {c.uid: c.gen_tokens.tolist() for c in outs_j})
    for key in ("requests", "blocks", "steps", "committed", "accepted", "drafted",
                "preemptions", "dispatches", "host_syncs"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    np.testing.assert_array_equal(eng_t._k_host, eng_j._k_host)
    np.testing.assert_array_equal(eng_t._cool_host, eng_j._cool_host)
    np.testing.assert_allclose(eng_t._ema_host, eng_j._ema_host, rtol=0, atol=1e-6)
    assert list(eng_t.stats["k_mean"]) == list(eng_j.stats["k_mean"])
    assert eng_t.stats["drafted"] < 4 * eng_t.stats["blocks"]      # the depth fell


def test_one_capture_per_draft_width(setup, monkeypatch):
    """Through the capture path (a fake graph whose replay re-runs the
    captured body): one capture per draft width the dispatches asked for,
    every one of them replayed, streams and counts equal to eager."""
    K = setup["cfg_t"].dvi.k_spec
    reqs = _requests(setup["cfg_t"], 5, seed=2)
    dc = DepthConfig(k_min=1, k_max=K, k_init=1, cooldown=1, hi=0.1, lo=0.05, ema_init=0.9)
    kw = dict(num_slots=2, sync_every=2, cache_len=40, kv_pages=40, kv_page_size=4,
              adaptive_k=True, depth_cfg=dc)
    eng_e, outs_e = _serve(setup, reqs, graphs=False, **kw)
    widths = []
    inner = graphs.SuperstepRunner.dispatch

    def dispatch(self, *a, **k):
        widths.append(k.get("k_blk"))
        return inner(self, *a, **k)

    monkeypatch.setattr(graphs.SuperstepRunner, "dispatch", dispatch)
    fake = FakeCuda()
    monkeypatch.setattr(graphs, "_cuda", fake)
    eng_g, outs_g = _serve(setup, reqs, graphs=True, **kw)
    assert outs_g == outs_e
    for key in ("blocks", "committed", "accepted", "drafted", "dispatches", "host_syncs"):
        assert eng_g.stats[key] == eng_e.stats[key], key
    st = eng_g.graph_stats()
    assert len(set(widths)) >= 2
    assert st["captures"] == len(fake.graphs) == len(set(widths)) <= K
    assert sorted(eng_g._runner.steps) == sorted(set(widths))
    assert all(step.replays > 0 for step in eng_g._runner.steps.values())
    eng_g.warmup()                                 # the rest of [k_min, k_max]
    assert sorted(eng_g._runner.steps) == list(range(1, K + 1))
