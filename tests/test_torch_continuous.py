"""The port's continuous-batching engine against
repro.serving.engine.ServingEngine(scheduler="continuous", learn=False) on
the requests of tests/test_paged_kv.py (num_slots 3, max_new 16, cache_len 40,
page size 4): over an ample pool (40 pages), a tight one that preempts (14
pages), the contiguous layout, and sync_every 3.  Per request the generated
tokens are equal, and equal to that request's own ar_generate stream; the
block, commit, accept, draft, preemption, dispatch and host-sync counts are
equal; every page is free at the end.  vicuna-7b-tiny in float32, deep
residuals scaled down (x0.1) so drafts are accepted often."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread keeps the test workers, which share
# the cores, from oversubscribing them
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import online  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

KW = dict(scheduler="continuous", num_slots=3, max_new=16, cache_len=40, kv_page_size=4)
CELLS = {"paged40": dict(kv_pages=40), "paged14": dict(kv_pages=14),
         "contiguous": dict(kv_pages=0), "paged40_s3": dict(kv_pages=40, sync_every=3)}
COUNTS = ("requests", "blocks", "steps", "committed", "accepted", "drafted", "preemptions",
          "dispatches", "host_syncs", "submitted")


def _requests(cfg, n, seed=0):
    """tests/test_paged_kv.py::_requests: prompts of 6, 9 or 12 tokens,
    budgets of 6, 10 or 16."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        Tp = int(rng.choice([6, 9, 12]))
        mn = int(rng.choice([6, 10, 16]))
        p = np.asarray(jax.random.randint(jax.random.PRNGKey(100 + i), (Tp,), 2,
                                          cfg.vocab_size), np.int32)
        reqs.append((i, p, mn))
    return reqs


def _state(model, dvi):
    """A trainer state around the drafter `dvi` (an empty replay buffer)."""
    return tonline.init_trainer(model, dvi_params=dvi)


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
    state = online.init_trainer(model_j, jax.random.PRNGKey(3))
    state.dvi_params = dict(state.dvi_params, B=jax.random.normal(
        jax.random.PRNGKey(11), state.dvi_params["B"].shape) * 0.01)
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, state.dvi_params), "cpu")
    return cfg_j, model_j, params_j, state, cfg_t, model_t, params_t, dvi_t, _requests(cfg_t, 7)


@pytest.fixture(scope="module")
def runs(setup):
    """Every cell served by both engines: {cell: (jax engine, jax outs,
    port engine, port outs)}."""
    cfg_j, model_j, params_j, state, cfg_t, model_t, params_t, dvi_t, reqs = setup
    out = {}
    for cell, kw in CELLS.items():
        eng_j = JEngine(model_j, params_j, state, learn=False, **KW, **kw)
        eng_t = ServingEngine(model_t, params_t, _state(model_t, dvi_t), learn=False, **KW, **kw)
        for uid, p, mn in reqs:
            eng_j.submit_request(JRequest(uid, p, max_new=mn))
            eng_t.submit_request(Request(uid, p, max_new=mn))
        out[cell] = (eng_j, eng_j.run(max_steps=1000), eng_t, eng_t.run(max_steps=1000))
    return out


def _streams(outs):
    return {c.uid: c.gen_tokens.tolist() for c in outs}


@pytest.mark.parametrize("cell", list(CELLS))
def test_engine_matches_jax(runs, cell):
    eng_j, outs_j, eng_t, outs_t = runs[cell]
    assert len(outs_t) == len(outs_j) == 7 and not eng_t.busy
    assert _streams(outs_t) == _streams(outs_j)
    for c in outs_t:
        assert c.tokens.tolist()[-len(c.gen_tokens):] == c.gen_tokens.tolist()
    for key in COUNTS:
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.stats["host_syncs"] == eng_t.stats["dispatches"]
    assert eng_t.acceptance == eng_j.acceptance and eng_t.stats["accepted"] > 0
    snap_t, snap_j = eng_t.metrics_snapshot(), eng_j.metrics_snapshot()
    for name in ("dvi_serving_block_accepted_drafts", "dvi_serving_block_depth"):
        assert snap_t[name] == snap_j[name], name
    if eng_t.paged:
        kv_t, kv_j = eng_t.kv_stats(), eng_j.kv_stats()
        assert kv_t["used_pages"] == 0 and kv_t["peak_used_pages"] == kv_j["peak_used_pages"]
        assert kv_t["preemptions"] == kv_j["preemptions"]
        if cell == "paged14":
            assert kv_t["preemptions"] > 0, "the tight pool must preempt"


def test_streams_equal_across_sync_every_and_ar(setup, runs):
    """sync_every 1 and 3 commit the same streams, and each request's stream
    is its own greedy ar_generate stream (capped at max_new, EOS = 1)."""
    _, _, _, _, _, model_t, params_t, _, reqs = setup
    got = _streams(runs["paged40"][3])
    assert _streams(runs["paged40_s3"][3]) == got
    assert runs["paged40_s3"][2].stats["dispatches"] < runs["paged40"][2].stats["dispatches"]
    for uid, p, mn in reqs:
        r = tspec.ar_generate(model_t, params_t, torch.from_numpy(p.copy())[None], mn)
        ar = r.tokens[0, len(p):int(r.lengths[0])].tolist()[:mn]
        if 1 in ar:
            ar = ar[:ar.index(1) + 1]
        assert got[uid] == ar, uid


def test_cancel_leaves_other_lanes_unchanged(setup, runs):
    """Cancelling one request mid-decode (and one still queued) retires them
    at a superstep boundary; every other request's stream is the one of the
    run without cancels, and the pool ends empty."""
    _, _, _, _, _, model_t, params_t, dvi_t, reqs = setup
    eng = ServingEngine(model_t, params_t, _state(model_t, dvi_t), learn=False, **KW,
                        kv_pages=40)
    handles = {uid: eng.submit_request(Request(uid, p, max_new=mn)) for uid, p, mn in reqs}
    outs = eng.step() + eng.step()             # uid 1 is live, uid 6 queued
    assert handles[1].cancel() and handles[6].cancel()
    outs += eng.run(max_steps=1000)
    want = _streams(runs["paged40"][3])
    got = _streams(outs)
    assert set(got) == set(want) - {1, 6}
    assert all(got[u] == want[u] for u in got)
    assert handles[1].outcome == handles[6].outcome == "cancelled"
    assert handles[1].result().gen_tokens.tolist() == want[1][:len(handles[1].tokens())]
    assert handles[0].outcome == "completed" and handles[0].tokens() == want[0]
    assert eng.stats["cancelled"] == 2 and eng.kv_stats()["used_pages"] == 0
    assert eng.stats["host_syncs"] == eng.stats["dispatches"]


def test_tracer_changes_nothing(setup, runs):
    """With the lifecycle tracer on (telemetry=True), the tight pool commits
    the same streams with the same host syncs, and the trace is valid."""
    from repro_torch.serving.telemetry import validate_trace
    _, _, _, _, _, model_t, params_t, dvi_t, reqs = setup
    eng = ServingEngine(model_t, params_t, _state(model_t, dvi_t), learn=False, **KW,
                        **CELLS["paged14"], telemetry=True)
    for uid, p, mn in reqs:
        eng.submit_request(Request(uid, p, max_new=mn))
    outs = eng.run(max_steps=1000)
    ref = runs["paged14"][2]
    assert _streams(outs) == _streams(runs["paged14"][3])
    for key in ("host_syncs", "dispatches", "preemptions", "blocks"):
        assert eng.stats[key] == ref.stats[key], key
    trace = eng.trace_dict()
    validate_trace(trace)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"superstep", "preempt", "tick", "sync_wait"} <= names


def test_engine_rejects_bad_config(setup):
    _, _, _, _, _, model_t, params_t, dvi_t, _ = setup
    with pytest.raises(ValueError):          # the sync scheduler has no pool
        ServingEngine(model_t, params_t, _state(model_t, dvi_t), scheduler="sync", kv_pages=8)
    with pytest.raises(ValueError):          # one request must fit the pool
        ServingEngine(model_t, params_t, _state(model_t, dvi_t), scheduler="continuous",
                      cache_len=40, kv_pages=2, kv_page_size=4)
