"""Chunked prefill on the port, held against the JAX package (the checks of
tests/test_chunked_prefill.py): a cache built by ``prefill`` of the first
chunk and ``prefill_chunk`` of the rest decodes the streams of one-shot
``prefill`` (chunks of 1, 7 and 24; vicuna-7b contiguous and paged,
mamba2-370m contiguous) and, at the ragged chunk of 7, equals JAX's built
the same way; the continuous engine with ``prefill_chunk`` commits the
port's one-shot streams and the JAX chunked engine's, with equal chunk
counters, over a tight paged pool that preempts lanes mid-prefill and on
mamba2's and vicuna's contiguous layouts (and the one-shot streams over
vicuna's contiguous layout at chunks of 7 and an ample paged pool at
chunks of 1, 5 and 64); a
tick's prefill
work stays within ``num_slots * prefill_chunk`` tokens; done-masked lanes
keep their SSM state, length and pending through a superstep; the chunk
step runs through the capture path (``graphs._cuda`` stood in); the sync
scheduler refuses ``prefill_chunk``.

Tiny configs in float32 on the CPU, weights made once and handed to both
packages; caches are held to rtol 1e-5 / atol 2e-5 (``tests/
test_torch_model.py``), tokens and counts to equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread keeps the test workers, which share
# the cores, from oversubscribing them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import online  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.kv_pool import pages_for  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_graphs import FakeCuda  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5
PS = 4                                   # page size of the paged cases
CHUNK_COUNTS = ("prefill_chunks", "prefill_tokens", "max_tick_prefill_tokens", "preemptions")


def _pair(name):
    """JAX and port models with the same weights: the deep blocks' output
    projections scaled down (x0.1) so drafts are accepted often, and the
    drafter's B drawn small."""
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = dict(params_j["segments"])
    for s in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        keys = ("out_proj",) if s.kind == "ssm" else ("wo", "wo_ff")
        segs[s.name] = dict(segs[s.name], **{k: segs[s.name][k] * 0.1 for k in keys})
    params_j = dict(params_j, segments=segs)
    state = online.init_trainer(model_j, jax.random.PRNGKey(3))
    state.dvi_params = dict(state.dvi_params, B=jax.random.normal(
        jax.random.PRNGKey(11), state.dvi_params["B"].shape) * 0.01)
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, state.dvi_params), "cpu")
    return dict(cfg=cfg_t, model_j=model_j, params_j=params_j, state=state, model_t=model_t,
                params_t=params_t, dvi_t=dvi_t)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in ("vicuna-7b", "mamba2-370m")}


# ---------------------------------------------------------------------------
# 1) the model: a chunk-built cache == JAX's, and decodes one-shot's streams
# ---------------------------------------------------------------------------

def _scaffold(model, cap, paged, jax_side):
    """A B = 1 cache of capacity `cap`; paged: lane 0 mapped over pages
    1..MPS (page 0 is the null page)."""
    if not paged:
        return model.init_cache(1, cap)
    mps = pages_for(cap, PS)
    row = np.arange(1, mps + 1, dtype=np.int32)
    if jax_side:
        return jtfm.map_slot_pages(model.init_paged_cache(1, mps, PS, mps), jnp.int32(0),
                                   jnp.asarray(row))
    return tfm.map_slot_pages(model.init_paged_cache(1, mps, PS, mps), 0, torch.from_numpy(row))


def _build_chunked(s, prompt, chunk, paged, cap, jax_side):
    """The engine's recipe: ``prefill`` of the first chunk into a
    chunk-sized scratch spliced into the lane, then ``prefill_chunk`` of
    the rest, the last chunk ragged (padded, committed through `take`).
    The JAX side's functions are jitted, as its engine jits them."""
    n = prompt.shape[1] - 1
    c1 = min(chunk, n)
    if jax_side:
        model, params, arr = s["model_j"], s["params_j"], jnp.asarray
        prefill = jax.jit(model.prefill, static_argnames="max_len")
        insert = jax.jit(lambda live, src: jtfm.insert_slot(model.cfg, live, src, jnp.int32(0)))
        step = jax.jit(model.prefill_chunk)
    else:
        model, params, arr = s["model_t"], s["params_t"], torch.from_numpy
        prefill, step = model.prefill, model.prefill_chunk

        def insert(live, src):
            return tfm.insert_slot(model.cfg, live, src, 0)
    cache = insert(_scaffold(model, cap, paged, jax_side),
                   prefill(params, arr(prompt[:, :c1].copy()), max_len=c1)[1])
    pos = c1
    while pos < n:
        take = min(chunk, n - pos)
        blk = np.zeros((1, chunk), np.int32)
        blk[0, :take] = prompt[0, pos:pos + take]
        _, cache = step(params, arr(blk), cache, arr(np.array([take], np.int32)))
        pos += take
    return cache


def _decode(s, cache, prompt, max_new):
    res = tspec.spec_superstep(s["model_t"], s["params_t"], s["dvi_t"],
                               torch.from_numpy(prompt[:, -1].copy()), cache, steps=max_new,
                               budget=torch.tensor([max_new], dtype=torch.int32))
    return res.gen_buf[0, :int(res.gen_count[0])].tolist()


def _lane_view(seg_c, n):
    """A B = 1 cache segment's committed contents: the first n K/V rows
    (paged: through pages 1.. of lane 0) or the SSM window and state."""
    if "conv" in seg_c:
        return {k: np.asarray(seg_c[k]) for k in ("conv", "state")}
    if "kp" in seg_c:
        return {k: np.asarray(seg_c[k]).reshape(seg_c[k].shape[0], -1,
                                                *seg_c[k].shape[3:])[:, PS:PS + n]
                for k in ("kp", "vp")}
    return {k: np.asarray(seg_c[k])[:, 0, :n] for k in ("k", "v")}


CHUNK_CASES = [("vicuna-7b", False), ("vicuna-7b", True), ("mamba2-370m", False)]


@pytest.mark.parametrize("name,paged", CHUNK_CASES)
@pytest.mark.parametrize("chunk", [1, 7, 24])        # one token / ragged / one chunk
def test_chunked_cache_decodes_like_one_shot(pairs, name, paged, chunk):
    """The chunk-built cache decodes one-shot's greedy streams bit for bit;
    at the ragged chunk of 7 (two chunk steps, the last padded) it also
    equals the JAX package's chunk-built cache."""
    s = pairs[name]
    cfg = s["cfg"]
    Tp, max_new = 17, 12
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, Tp), 2, cfg.vocab_size),
                        np.int32)
    cap = Tp + max_new + cfg.dvi.k_spec + 2 + tfm.RING_SLACK
    got_t = _build_chunked(s, prompt, chunk, paged, cap, jax_side=False)
    assert int(got_t["lengths"][0]) == Tp - 1
    if chunk == 7:
        got_j = _build_chunked(s, prompt, chunk, paged, cap, jax_side=True)
        assert int(got_j["lengths"][0]) == Tp - 1
        for seg_name, seg_c in got_t["segs"].items():
            view_t = _lane_view({k: v.numpy() for k, v in seg_c.items()}, Tp - 1)
            view_j = _lane_view(got_j["segs"][seg_name], Tp - 1)
            for key, v in view_t.items():
                np.testing.assert_allclose(v, view_j[key], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{seg_name}.{key}")
    # the one-shot cache: prefilled whole into the lane
    one = _scaffold(s["model_t"], cap, paged, jax_side=False)
    _, pc = s["model_t"].prefill(s["params_t"], torch.from_numpy(prompt[:, :-1].copy()),
                                 max_len=Tp - 1)
    one = tfm.insert_slot(cfg, one, pc, 0)
    want = _decode(s, one, prompt, max_new)
    assert len(want) > 0 and _decode(s, got_t, prompt, max_new) == want


# ---------------------------------------------------------------------------
# 2) the engine: chunked == one-shot == the JAX chunked engine
# ---------------------------------------------------------------------------

def _requests(cfg, n, seed=0, long_lens=(20, 33)):
    """tests/test_chunked_prefill.py::_requests: prompts of 6 tokens or
    long ones, budgets of 6, 10 or 16."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        Tp = int(rng.choice([6] + list(long_lens)))
        mn = int(rng.choice([6, 10, 16]))
        p = np.asarray(jax.random.randint(jax.random.PRNGKey(100 + i), (Tp,), 2,
                                          cfg.vocab_size), np.int32)
        reqs.append((i, p, mn))
    return reqs


KW = dict(scheduler="continuous", num_slots=3, max_new=16)
PAGED = dict(kv_pages=40, kv_page_size=PS, cache_len=64)
ENGINE_CELLS = {
    # (arch, requests (n, seed, long prompts), engine keywords)
    # tests/test_chunked_prefill.py's tight pool: lanes preempted mid-prefill
    "tight": ("vicuna-7b", (7, 1, (24, 33)), dict(PAGED, kv_pages=16, prefill_chunk=5,
                                                  sync_every=2)),
    "mamba2": ("mamba2-370m", (6, 0, (20, 33)), dict(prefill_chunk=5, sync_every=2)),
    # vicuna's contiguous layout: admit_chunk into a chunk-sized scratch
    "contiguous": ("vicuna-7b", (7, 1, (24, 33)), dict(prefill_chunk=5, sync_every=2)),
}


def _serve(eng, reqs, request_cls, max_steps=4000):
    for uid, p, mn in reqs:
        eng.submit_request(request_cls(uid, p, max_new=mn))
    outs = eng.run(max_steps=max_steps)
    assert len(outs) == len(reqs) and not eng.busy
    return {o.uid: o.gen_tokens.tolist() for o in outs}


def _port(s, **kw):
    return ServingEngine(s["model_t"], s["params_t"],
                         tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                         learn=False, **dict(KW, **kw))


def _mid_prefill_preemptions(eng) -> list:
    """Record, per preemption, whether the victim was mid-prefill."""
    seen, inner = [], eng._preempt

    def preempt(slot):
        seen.append(eng._slots[slot].pf_pos is not None)
        inner(slot)

    eng._preempt = preempt
    return seen


@pytest.fixture(scope="module")
def engines(pairs):
    """Every cell through the port's chunked engine, the port's one-shot
    engine (contiguous; served once for cells of one model and requests)
    and the JAX chunked engine: {cell: dict}."""
    out, one_shot = {}, {}
    for cell, (name, req_args, kw) in ENGINE_CELLS.items():
        s = pairs[name]
        reqs = _requests(s["cfg"], *req_args)
        if (name, req_args) not in one_shot:
            one_shot[name, req_args] = _serve(_port(s, sync_every=2), reqs, Request)
        eng_t = _port(s, **kw)
        mid = _mid_prefill_preemptions(eng_t)
        eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False, **KW, **kw)
        out[cell] = dict(reqs=reqs, eng_t=eng_t, eng_j=eng_j, mid=mid,
                         got_t=_serve(eng_t, reqs, Request),
                         got_j=_serve(eng_j, reqs, JRequest),
                         one_shot=one_shot[name, req_args])
    return out


@pytest.mark.parametrize("cell", list(ENGINE_CELLS))
def test_chunked_engine_matches_one_shot_and_jax(engines, cell):
    r = engines[cell]
    eng_t, eng_j = r["eng_t"], r["eng_j"]
    assert r["got_t"] == r["one_shot"] == r["got_j"]
    for key in CHUNK_COUNTS + ("requests", "blocks", "committed", "accepted", "drafted",
                               "dispatches", "host_syncs"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    assert eng_t.stats["prefill_chunks"] > 0
    assert eng_t.stats["host_syncs"] == eng_t.stats["dispatches"]
    ds = eng_t.dispatch_stats()
    assert ds["prefill_chunk"] == 5 and ds["prefill_tokens"] == eng_t.stats["prefill_tokens"]
    assert eng_t.active_slots == 0
    if eng_t.paged:
        assert eng_t.kv_stats()["used_pages"] == 0


def test_mid_prefill_preemption_is_lossless(engines):
    """The tight pool preempts, lanes mid-prefill among the victims, and
    every stream is still the one-shot engine's (checked above, with the
    JAX engine's preemption count)."""
    r = engines["tight"]
    assert r["eng_t"].stats["preemptions"] == len(r["mid"]) > 0
    assert any(r["mid"]), "no lane was preempted mid-prefill"


@pytest.mark.parametrize("paged,chunk", [(False, 7), (True, 1), (True, 5), (True, 64)])
def test_chunk_sizes_keep_the_streams(pairs, engines, paged, chunk):
    """vicuna's contiguous layout at a second ragged chunk (``ENGINE_CELLS``
    holds it at 5), and an ample paged pool at one token a chunk, a ragged
    chunk and a chunk longer than every prompt (no chunk step at all): the
    one-shot streams, and the pool empty at the end."""
    s, r = pairs["vicuna-7b"], engines["tight"]
    eng = _port(s, **dict(PAGED if paged else {}, prefill_chunk=chunk, sync_every=2))
    assert _serve(eng, r["reqs"], Request) == r["one_shot"]
    assert (eng.stats["prefill_chunks"] > 0) == (chunk < 64)
    assert 0 < eng.stats["max_tick_prefill_tokens"] <= 3 * chunk or chunk == 64
    assert eng.stats["preemptions"] == 0 and eng.active_slots == 0
    if paged:
        assert eng.kv_stats()["used_pages"] == 0


def test_per_tick_prefill_work_is_bounded(pairs):
    """The chunk-budget contract: one chunk step a tick, each prefilling
    lane advancing at most `chunk` tokens, so no tick prefills more than
    num_slots * chunk tokens; decode keeps interleaving; the one-shot engine
    does no chunk work."""
    s = pairs["vicuna-7b"]
    chunk, slots = 4, 3
    reqs = _requests(s["cfg"], 6, seed=2, long_lens=(33,))
    eng = _port(s, prefill_chunk=chunk, sync_every=2, telemetry=True)
    got = _serve(eng, reqs, Request)
    assert eng.stats["prefill_chunks"] > 0
    assert 0 < eng.stats["max_tick_prefill_tokens"] <= slots * chunk
    assert eng.stats["prefill_chunks"] <= len(eng.stats["tick_s"])
    assert eng.stats["dispatches"] > 0
    tp = eng.tick_percentiles()
    assert tp["count"] == len(eng.stats["tick_s"]) and 0 <= tp["p50_s"] <= tp["max_s"]
    names = {e.get("name") for e in eng.trace_dict()["traceEvents"]}
    assert {"prefill_chunk", "prefill", "decode"} <= names
    eng0 = _port(s, sync_every=2)
    assert _serve(eng0, reqs, Request) == got
    assert eng0.stats["max_tick_prefill_tokens"] == eng0.stats["prefill_chunks"] == 0
    assert eng0.tick_percentiles()["count"] > 0


# ---------------------------------------------------------------------------
# 3) done-masked lanes are frozen through a superstep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vicuna-7b", "mamba2-370m"])
def test_done_lane_frozen_through_superstep(pairs, name):
    """A done-masked lane's length, pending token and SSM conv window and
    state come out of a superstep bit for bit: a mid-prefill lane rides
    along masked and resumes from them."""
    s = pairs[name]
    cfg = s["cfg"]
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 9), 2, cfg.vocab_size),
                         np.int32)
    _, cache = s["model_t"].prefill(s["params_t"], torch.from_numpy(prompts[:, :-1].copy()),
                                    max_len=48)
    before = {name: {k: v[:, 0].clone() for k, v in seg_c.items()}
              for name, seg_c in cache["segs"].items()}
    pending = torch.from_numpy(prompts[:, -1].copy())
    len0 = int(cache["lengths"][0])
    res = tspec.spec_superstep(s["model_t"], s["params_t"], s["dvi_t"], pending.clone(), cache,
                               steps=3, done=torch.tensor([True, False]),
                               budget=torch.tensor([8, 8], dtype=torch.int32))
    assert int(res.gen_count[0]) == 0 and int(res.gen_count[1]) > 0
    assert int(res.pending[0]) == int(pending[0])
    assert int(res.cache["lengths"][0]) == len0
    for seg_name, seg_c in res.cache["segs"].items():
        for key in ("conv", "state"):
            if key in seg_c:
                assert torch.equal(seg_c[key][:, 0], before[seg_name][key]), (seg_name, key)


# ---------------------------------------------------------------------------
# 4) the chunk step through the capture path; refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["tight", "mamba2"])
def test_chunk_step_capture_path_matches_eager(pairs, engines, monkeypatch, cell):
    """Graphs on through the stand-in capture path (a fake graph whose
    replay re-runs the captured body): the chunk step is captured once,
    ahead of traffic, with the superstep, replayed once a chunk step, and
    the streams and counts equal the eager engine's; its static buffers
    never move."""
    name, (n, seed, long_lens), kw = ENGINE_CELLS[cell]
    s, r = pairs[name], engines[cell]
    fake = FakeCuda()
    monkeypatch.setattr(graphs, "_cuda", fake)
    eng = _port(s, graphs=True, **kw)
    eng.warmup()
    runner = eng._runner
    assert len(fake.graphs) == 2 and runner.chunk_step.graph is not None
    ptrs = {k: t.data_ptr() for k, t in runner.chunk_state.items()}
    assert _serve(eng, r["reqs"], Request) == r["got_t"]
    for key in CHUNK_COUNTS + ("blocks", "dispatches", "host_syncs"):
        assert eng.stats[key] == r["eng_t"].stats[key], key
    assert runner.chunk_step.replays == eng.stats["prefill_chunks"] > 0
    st = eng.graph_stats()
    assert st["captures"] == 2 and st["replays"] > runner.chunk_step.replays
    assert {k: t.data_ptr() for k, t in runner.chunk_state.items()} == ptrs


def test_chunked_prefill_refusals(pairs):
    s = pairs["vicuna-7b"]
    state = tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"])
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(s["model_t"], s["params_t"], state, scheduler="sync", prefill_chunk=4)
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        ServingEngine(s["model_t"], s["params_t"], state, scheduler="continuous",
                      kv_pages=40, kv_page_size=PS, cache_len=64, prefill_chunk=4,
                      prefix_cache=True)
    eng = ServingEngine(s["model_t"], s["params_t"], state, scheduler="continuous",
                        prefill_chunk=1000)
    assert eng._chunk == tfm.RING_SLACK
