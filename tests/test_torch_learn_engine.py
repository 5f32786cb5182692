"""The port's ServingEngine with ``learn=True`` against the JAX
ServingEngine with ``learn=True`` (vicuna-7b-tiny, float32, CPU), both
samplers pinned to the same indices (``test_torch_online.pin_samplers``):
on the sync path, the continuous path over the contiguous layout, and over
a paged pool.  Equal completions and update counts (the reference's
cadence), every update's loss, KL and batch acceptance within rtol 1e-4,
the same dvi_train_* history, and the final A and B: 99.9 % of their
entries within 2e-6 and all within 1e-4.  The drafter's updates compound:
the replay buffer's hidden states already differ in float32 rounding
between the frameworks, and Adam's normalisation m / sqrt(v) passes a
relative error of a gradient entry on to the step unscaled, so an entry
whose gradient sums nearly cancelling per-tuple terms carries the residue.
Measured on the sync cell (6 updates, lr 1e-3): 2 of B's 4096 entries
differ by 2.6e-5 and 5.5e-5, where the first moment m differs by 0.1-0.3 %;
the 99.9th percentile is 1.3e-6.

Also: the engine's capture path (a stand-in for the CUDA calls whose replay
re-runs the captured body) with learning on, equal to the eager engine bit
for bit and refusing a rebound A; warm-up leaves the replay buffer's count,
ptr and gen alone; and a port of
tests/test_telemetry.py::test_train_telemetry_and_prometheus_exposure."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import online as jonline  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.telemetry import parse_prometheus_text  # noqa: E402
from test_torch_graphs import FakeCuda  # noqa: E402
from test_torch_online import pin_samplers  # noqa: E402

AB_ATOL, AB_BULK_ATOL = 1e-4, 2e-6
CELLS = {
    "sync": dict(scheduler="sync", batch_size=3, max_new=10, buckets=(8, 16),
                 updates_per_batch=2),
    "contiguous": dict(scheduler="continuous", num_slots=3, max_new=16, cache_len=40,
                       sync_every=2, update_every=2),
    "paged": dict(scheduler="continuous", num_slots=3, max_new=16, cache_len=40,
                  kv_pages=40, kv_page_size=4, sync_every=2),
}
COUNTS = ("requests", "blocks", "committed", "accepted", "drafted", "updates")
# counted by the continuous scheduler only (the reference's sync path keeps
# them at 0)
CONTINUOUS_COUNTS = ("steps", "dispatches", "host_syncs")


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
    dvi_np = jax.tree.map(np.asarray, jonline.init_trainer(model_j, jax.random.PRNGKey(3))
                          .dvi_params)
    dvi_np["B"] = np.asarray(jax.random.normal(jax.random.PRNGKey(11), dvi_np["B"].shape)
                             * 0.01, np.float32)
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(2, cfg_t.vocab_size, size=int(rng.choice([6, 9, 12])))
             .astype(np.int32), int(rng.choice([6, 10, 16]))) for i in range(7)]
    return dict(model_j=model_j, params_j=params_j, model_t=model_t, params_t=params_t,
                dvi_np=dvi_np, reqs=reqs)


def jax_state(s):
    state = jonline.init_trainer(s["model_j"], jax.random.PRNGKey(3))
    state.dvi_params = {k: jax.numpy.asarray(v) for k, v in s["dvi_np"].items()}
    return state


def port_state(s):
    state = tonline.init_trainer(s["model_t"], torch.Generator().manual_seed(3))
    for k, v in s["dvi_np"].items():
        state.dvi_params[k].copy_(torch.tensor(v))
    return state


def record_updates(eng, jax_side: bool) -> list:
    """Wrap the engine's update function to keep each update's metrics."""
    seen, inner = [], eng._update_fn

    def update(*a, **kw):
        out = inner(*a, **kw)
        seen.append(out[3] if jax_side else out)
        return out

    eng._update_fn = update
    return seen


def serve(eng, reqs, request_cls):
    for uid, p, mn in reqs:
        eng.submit_request(request_cls(uid, p, max_new=mn))
    return {c.uid: c.gen_tokens.tolist() for c in eng.run(max_steps=1000)}


@pytest.fixture(scope="module")
def runs(setup):
    """Every cell served by both engines with learning on, samplers pinned."""
    mp = pytest.MonkeyPatch()
    pin_samplers(mp)
    out = {}
    try:
        for cell, kw in CELLS.items():
            eng_j = JEngine(setup["model_j"], setup["params_j"], jax_state(setup), **kw)
            eng_t = ServingEngine(setup["model_t"], setup["params_t"], port_state(setup), **kw)
            assert eng_j.learn and eng_t.learn
            rec_j, rec_t = record_updates(eng_j, True), record_updates(eng_t, False)
            out[cell] = dict(eng_j=eng_j, eng_t=eng_t,
                             outs_j=serve(eng_j, setup["reqs"], JRequest),
                             outs_t=serve(eng_t, setup["reqs"], Request),
                             rec_j=rec_j, rec_t=rec_t)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_learning_engine_matches_jax(runs, cell):
    r = runs[cell]
    eng_j, eng_t = r["eng_j"], r["eng_t"]
    assert r["outs_t"] == r["outs_j"] and len(r["outs_t"]) == 7 and not eng_t.busy
    for key in COUNTS + (CONTINUOUS_COUNTS if eng_t.scheduler == "continuous" else ()):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.stats["updates"] == len(r["rec_t"]) == len(r["rec_j"]) >= 3
    for mt, mj in zip(r["rec_t"], r["rec_j"]):
        for key in ("loss", "kl", "acc_rate", "gnorm", "baseline_after"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
        assert float(mt["buffer_count"]) == float(mj["buffer_count"])
    if eng_t.scheduler == "continuous":
        assert eng_t.stats["host_syncs"] == eng_t.stats["dispatches"]
    tt, tj = eng_t.train_telemetry(), eng_j.train_telemetry()
    assert tt["step"] == tj["step"] == int(eng_t.state.step) == eng_t.stats["updates"]
    assert len(tt["history"]) == len(tj["history"]) >= 1
    for ht, hj in zip(tt["history"], tj["history"]):
        assert ht["step"] == hj["step"] and ht["phase"] == hj["phase"]
        for key in ("loss", "loss_kl", "loss_ce", "acceptance_batch", "ema_after"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-4, atol=1e-6, err_msg=key)
    for k in ("A", "B"):
        diff = np.abs(eng_t.state.dvi_params[k].numpy() - np.asarray(eng_j.state.dvi_params[k]))
        assert diff.max() <= AB_ATOL and np.quantile(diff, 0.999) <= AB_BULK_ATOL, k
    np.testing.assert_allclose(float(eng_t.state.baseline), float(eng_j.state.baseline),
                               rtol=1e-5)
    for name in ("ptr", "count", "gen", "action", "reward", "pos", "prev", "age"):
        np.testing.assert_array_equal(eng_t.buf[name].numpy(), np.asarray(eng_j.state.buf[name]),
                                      err_msg=name)


def test_learning_moves_the_drafter_in_place(setup, runs):
    """A and B are the state's tensors from construction, changed in place;
    the first update on each path ran in the warmup phase of the schedule."""
    for cell, r in runs.items():
        eng = r["eng_t"]
        assert eng._runner.drafter == graphs.drafter_ptrs(eng.state.dvi_params), cell
        assert not np.allclose(eng.state.dvi_params["B"].numpy(), setup["dvi_np"]["B"]), cell
        assert float(r["rec_t"][0]["lam_pg"]) == 0.0


def _graphed(setup, kw, monkeypatch, fake):
    monkeypatch.setattr(graphs, "_cuda", fake)
    return ServingEngine(setup["model_t"], setup["params_t"], port_state(setup), graphs=True,
                         **kw)


@pytest.mark.parametrize("cell", ["sync", "paged"])
def test_capture_path_replays_in_place_updates(setup, monkeypatch, cell):
    """Graphs on through the stand-in capture path, learning on: streams,
    every drafter and optimizer tensor, the baseline and the step equal the
    eager engine's bit for bit; A and B keep their addresses; warm-up leaves
    the replay buffer's count, ptr and gen as they were."""
    kw = CELLS[cell]
    eng_e = ServingEngine(setup["model_t"], setup["params_t"], port_state(setup),
                          graphs=False, **kw)
    outs_e = serve(eng_e, setup["reqs"], Request)
    eng_g = _graphed(setup, kw, monkeypatch, FakeCuda())
    ptrs = graphs.drafter_ptrs(eng_g.state.dvi_params)
    ring = {k: eng_g.buf[k].clone() for k in ("count", "ptr", "gen")}
    eng_g.warmup()
    for k, v in ring.items():
        assert torch.equal(eng_g.buf[k], v), k
    outs_g = serve(eng_g, setup["reqs"], Request)
    assert outs_g == outs_e and eng_g.graph_stats()["replays"] > 0
    assert eng_g.stats["updates"] == eng_e.stats["updates"] > 0
    se, sg = eng_e.state, eng_g.state
    for k in ("A", "B"):
        assert torch.equal(sg.dvi_params[k], se.dvi_params[k]), k
        assert torch.equal(sg.opt_state["m"][k], se.opt_state["m"][k]), k
        assert torch.equal(sg.opt_state["v"][k], se.opt_state["v"][k]), k
    assert torch.equal(sg.baseline, se.baseline) and torch.equal(sg.step, se.step)
    assert graphs.drafter_ptrs(sg.dvi_params) == ptrs


@pytest.mark.parametrize("cell", ["sync", "paged"])
def test_rebound_drafter_is_refused(setup, monkeypatch, cell):
    eng = _graphed(setup, CELLS[cell], monkeypatch, FakeCuda())
    eng.warmup()
    eng.state.dvi_params["A"] = eng.state.dvi_params["A"].clone()
    for uid, p, mn in setup["reqs"][:2]:
        eng.submit_request(Request(uid, p, max_new=mn))
    with pytest.raises(RuntimeError, match="rebound"):
        eng.run(max_steps=10)


def test_train_telemetry_and_prometheus_exposure(setup):
    """A learning run surfaces all three DVI loss components and the
    acceptance EMA around updates: in train_telemetry(), in the bounded
    history, and in the Prometheus rendering; reset clears them."""
    eng = ServingEngine(setup["model_t"], setup["params_t"], port_state(setup),
                        scheduler="continuous", buckets=(16,), num_slots=3, max_new=12,
                        sync_every=2, learn=True, update_every=2, telemetry=True)
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(2, 512, size=int(rng.choice([6, 9, 12]))).astype(np.int32), 12)
            for i in range(6)]
    assert len(serve(eng, reqs, Request)) == len(reqs)
    tt = eng.train_telemetry()
    assert tt["updates"] > 0
    assert tt["step"] == tt["updates"]
    assert tt["phase_name"] in ("warmup", "ramp", "rl")
    for k in ("loss", "loss_kl", "loss_ce", "loss_pg", "lambda_pg",
              "lambda_kl", "beta", "acceptance_batch",
              "acceptance_ema_before", "acceptance_ema_after"):
        assert np.isfinite(tt[k]), k
    assert tt["history"], "per-update history must accumulate"
    rec = tt["history"][-1]
    assert rec["step"] >= 1 and rec["span_s"] >= 0.0
    assert {"loss", "loss_kl", "loss_ce", "loss_pg", "ema_before",
            "ema_after", "phase"} <= set(rec)

    prom = eng.render_prometheus()
    for name in ("dvi_train_loss_kl", "dvi_train_loss_ce",
                 "dvi_train_loss_pg", "dvi_train_acceptance_ema_after",
                 "dvi_serving_block_accepted_drafts_bucket",
                 "dvi_serving_block_depth_bucket"):
        assert name in prom, name
    back = parse_prometheus_text(prom)
    assert back["dvi_train_updates_total"]["value"] == tt["updates"]
    assert back["dvi_train_loss_kl"]["value"] == pytest.approx(tt["loss_kl"], rel=1e-6)

    eng.reset_stats()
    assert eng.stats["requests"] == 0
    assert eng.metrics_snapshot()["dvi_serving_blocks_total"]["value"] == 0
    assert eng.train_telemetry()["history"] == []


# learning together with adaptive depth (the reference's drift arm), plain
# and with chunked prefill, over a paged pool
ADAPTIVE_KW = dict(scheduler="continuous", num_slots=3, max_new=16, cache_len=40, kv_pages=40,
                   kv_page_size=4, sync_every=2, update_every=2, adaptive_k=True)


@pytest.mark.parametrize("chunk", [0, 5])
def test_learning_adaptive_engine_matches_jax(setup, monkeypatch, chunk):
    """``learn=True`` with ``adaptive_k=True`` (k_min 1, k_max K), samplers
    pinned, against the JAX engine: equal completions, counters (the chunk
    counters with ``prefill_chunk`` 5), update count and every update's
    metrics, the drafter's A and B, and each lane's depth, acceptance EMA
    and cooldown at the end."""
    pin_samplers(monkeypatch)
    kw = dict(ADAPTIVE_KW, prefill_chunk=chunk)
    eng_j = JEngine(setup["model_j"], setup["params_j"], jax_state(setup), **kw)
    eng_t = ServingEngine(setup["model_t"], setup["params_t"], port_state(setup), **kw)
    assert eng_t.learn and eng_t.adaptive_k
    rec_j, rec_t = record_updates(eng_j, True), record_updates(eng_t, False)
    outs_t = serve(eng_t, setup["reqs"], Request)
    assert outs_t == serve(eng_j, setup["reqs"], JRequest) and len(outs_t) == 7
    for key in COUNTS + CONTINUOUS_COUNTS + ("preemptions", "prefill_chunks", "prefill_tokens",
                                             "max_tick_prefill_tokens"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert (eng_t.stats["prefill_chunks"] > 0) == (chunk > 0)
    assert eng_t.stats["updates"] == len(rec_t) == len(rec_j) >= 3
    for mt, mj in zip(rec_t, rec_j):
        for key in ("loss", "kl", "acc_rate", "gnorm", "baseline_after"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
        assert float(mt["buffer_count"]) == float(mj["buffer_count"])
    for k in ("A", "B"):
        diff = np.abs(eng_t.state.dvi_params[k].numpy() - np.asarray(eng_j.state.dvi_params[k]))
        assert diff.max() <= AB_ATOL and np.quantile(diff, 0.999) <= AB_BULK_ATOL, k
    np.testing.assert_array_equal(eng_t._k_host, eng_j._k_host)
    np.testing.assert_array_equal(eng_t._cool_host, eng_j._cool_host)
    np.testing.assert_allclose(eng_t._ema_host, eng_j._ema_host, rtol=0, atol=1e-6)
    assert list(eng_t.stats["k_mean"]) == list(eng_j.stats["k_mean"])
    assert eng_t.stats["drafted"] < 4 * eng_t.stats["blocks"]      # the depth moved
    assert eng_t.kv_stats()["used_pages"] == 0 and eng_t.stats["host_syncs"] == eng_t.stats[
        "dispatches"]
