"""The block-step runners of ``repro_torch.core.graphs`` on the CPU, where
their body runs eagerly over the static buffers (tiny float32 configs).

* Parity: ``SuperstepRunner.dispatch`` against ``spec.spec_superstep`` and
  ``GenerateRunner.generate`` against ``spec.speculative_generate``, bit for
  bit (streams, counters, histograms, caches, replay-buffer contents), on
  vicuna-7b-tiny contiguous and paged and mamba2-370m-tiny, steps 1 to
  sync_every, two dispatches in a row.
* The engine's capture path, with a stand-in for the CUDA calls whose replay
  re-runs the captured body: streams, counts and replay buffer equal to
  ``graphs=False`` through admissions, a preemption and a cancel, and equal
  to the JAX engine on the same cancels.
* Static buffers stay put: the engine's pending tokens, cache and replay
  buffer are the runner's tensors, at the same addresses, all run long.
* Launch accounting: with ``ops._device`` / ``_stream`` / ``_launch``
  stubbed and a fake graph, the launches recorded at capture are added once
  a replay, capturing counts nothing, and a failed capture or replay raises.
"""
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
from repro_torch.core import buffer as buffer_mod  # noqa: E402
from repro_torch.core import graphs, spec  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

B, TP, PS, MPS, SYNC = 3, 8, 4, 12, 3
NAMES = ("vicuna-7b", "mamba2-370m")


def _model(name):
    """The tiny config in float32 with random weights, its deep residual
    outputs scaled down (x0.1) and a small draft head, so that drafts are
    accepted often."""
    cfg = get_config(name, tiny=True).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    for seg in tfm.segments_in_range(cfg, cfg.dvi.split_layer, cfg.num_layers):
        sp = params["segments"][seg.name]
        for key in ("wo", "wo_ff", "out_proj"):
            if key in sp:
                sp[key] = sp[key] * 0.1
    dvi = {"A": torch.randn((cfg.d_model, cfg.dvi.lora_rank), generator=gen) * 0.02,
           "B": torch.randn((cfg.dvi.lora_rank, cfg.vocab_size), generator=gen) * 0.01}
    return model, params, dvi


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in NAMES}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _assert_tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}/{k}")
    else:
        assert torch.equal(a, b), where


def _lanes_cache(model, params, paged):
    """B lanes prefilled with prompts of TP - 1 tokens (the pending token
    apart), as a contiguous cache or spliced into a paged one over shuffled
    pages; and the pending tokens."""
    cfg = model.cfg
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(B, TP)).astype(np.int32))
    if not paged:
        _, cache = model.prefill(params, prompts[:, :-1], max_len=48)
        return cache, prompts[:, -1].clone()
    perm = np.random.default_rng(1).permutation(np.arange(1, B * MPS + 1))
    cache = model.init_paged_cache(B, B * MPS, PS, MPS)
    for b in range(B):
        tfm.map_slot_pages(cache, b, torch.from_numpy(perm[b * MPS:(b + 1) * MPS].astype(np.int32)))
        _, pc = model.prefill(params, prompts[b:b + 1, :-1], max_len=TP - 1)
        tfm.insert_slot(cfg, cache, pc, b)
    return cache, prompts[:, -1].clone()


SUPERSTEP_CELLS = [("vicuna-7b", False), ("vicuna-7b", True), ("mamba2-370m", False)]


@pytest.mark.parametrize("steps", range(1, SYNC + 1))
@pytest.mark.parametrize("name,paged", SUPERSTEP_CELLS)
def test_superstep_runner_matches_spec_superstep(models, name, paged, steps):
    """Two dispatches in a row (a done lane, a budget cap, lanes finishing
    inside the superstep): each equals ``spec_superstep`` on the same state,
    and the runner's buffers end equal to the functional path's."""
    model, params, dvi = models[name]
    cache, pending = _lanes_cache(model, params, paged)
    fcache, fpending = _clone(cache), pending.clone()
    buf, fbuf = (buffer_mod.init_buffer(model.cfg, device="cpu") for _ in range(2))
    runner = graphs.SuperstepRunner(model, params, dvi, pending, cache, buf, sync_every=SYNC,
                                    eos_id=-1, graphs=True)
    done = np.array([False, False, True])
    budget = np.array([40, 3, 40], np.int32)
    for _ in range(2):
        res = runner.dispatch(done, budget, steps)
        ref = spec.spec_superstep(model, params, dvi, fpending, fcache, steps=steps,
                                  done=torch.from_numpy(done), budget=torch.from_numpy(budget),
                                  eos_id=-1, buf=fbuf, collect=True)
        for field in ("pending", "done", "gen_count", "lane_blocks", "lane_committed",
                      "lane_accepted", "lane_drafted", "accept_hist", "depth_hist"):
            assert torch.equal(getattr(res, field), getattr(ref, field)), field
        for b in range(B):
            n = int(ref.gen_count[b])
            assert torch.equal(res.gen_buf[b, :n], ref.gen_buf[b, :n])
        assert res.iters == ref.iters == steps and res.gen_buf.shape[1] == SYNC * 5
        _assert_tree_equal(res.cache, ref.cache, "cache")
        _assert_tree_equal(res.buffer, ref.buffer, "buf")
        assert res.pending is pending and res.cache is cache and res.buffer is buf
        fpending, fcache, fbuf = ref.pending, ref.cache, ref.buffer
        done = ref.done.numpy()
        budget = np.maximum(budget - ref.gen_count.numpy(), 1).astype(np.int32)
    assert int(runner.state["lane_accepted"].sum()) + int(fbuf["count"]) > 0


@pytest.mark.parametrize("name", NAMES)
def test_generate_runner_matches_speculative_generate(models, name):
    """Three batches, two of one shape (the second reuses its static cache
    and graph) and one of another, one with a padding lane: each equals
    ``speculative_generate`` bit for bit, and so does the shared buffer."""
    model, params, dvi = models[name]
    cfg = model.cfg
    buf, fbuf = (buffer_mod.init_buffer(cfg, device="cpu") for _ in range(2))
    runner = graphs.GenerateRunner(model, params, dvi, buf, max_new=8, graphs=True)
    rng = np.random.default_rng(2)
    for Tp, live in ((8, [True, True, True]), (12, [True, True, False]),
                     (8, [True, False, True])):
        prompts = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, Tp)).astype(np.int32))
        live_mask = torch.tensor(live)
        res = runner.generate(prompts, live_mask)
        ref = spec.speculative_generate(model, params, dvi, prompts, 8, collect=True, buf=fbuf,
                                        live_mask=live_mask)
        assert torch.equal(res.tokens, ref.tokens) and torch.equal(res.lengths, ref.lengths)
        for field in ("blocks", "committed", "accepted_drafts", "drafted"):
            assert int(getattr(res, field)) == int(getattr(ref, field)), field
        assert res.steps == ref.steps and res.buffer is buf
        _assert_tree_equal(buf, ref.buffer, "buf")
        fbuf = ref.buffer
    assert sorted(runner._shapes) == [(B, 8), (B, 12)] and int(buf["count"]) > 0


# ---------------------------------------------------------------------------
# the engine's capture path, with a stand-in for the CUDA calls
# ---------------------------------------------------------------------------

class FakeGraph:
    """A captured graph stand-in: capturing records the body without running
    it; a replay runs it, over the same static buffers."""

    def __init__(self):
        self.fn = None
        self.instantiated = False

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        self.fn()


class FakeCuda:
    def __init__(self, fail_capture=False):
        self.fail_capture = fail_capture
        self.graphs = []

    def captures(self, device):
        return True

    def new_pool(self):
        return object()

    def new_graph(self):
        self.graphs.append(FakeGraph())
        return self.graphs[-1]

    def warm(self, fn):
        fn()

    def capture(self, graph, pool, fn):
        if self.fail_capture:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph.fn = fn

    def reserved(self):
        return 0

    def nodes(self, graph):
        return 1, {"_Z9lora_mainv": 3}


# (prompt length, budget) of the engine tests' requests: the three lanes
# admitted first have budgets of 16, more than one superstep can commit
SPECS = [(6, 16), (9, 16), (12, 16), (9, 6), (12, 10), (6, 16), (9, 10)]


def _requests(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, vocab, size=tp).astype(np.int32), mn)
            for i, (tp, mn) in enumerate(SPECS[:n])]


ENGINE_CELLS = {
    # a pool tight enough to preempt, and a cancel
    "vicuna_paged14": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                         cache_len=40, kv_pages=14, kv_page_size=4,
                                         sync_every=SYNC)),
    "vicuna_contiguous": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                            cache_len=40, sync_every=2)),
    "mamba2_continuous": ("mamba2-370m", dict(scheduler="continuous", num_slots=2, max_new=10,
                                              cache_len=40, sync_every=2)),
    "vicuna_sync": ("vicuna-7b", dict(scheduler="sync", batch_size=2, max_new=10,
                                      buckets=(8, 16))),
    "mamba2_sync": ("mamba2-370m", dict(scheduler="sync", batch_size=2, max_new=8,
                                        buckets=(8, 16))),
}


def _serve(model, params, dvi, kw, reqs, graphs_on, cancel=()):
    """Serve `reqs`; after the first tick cancel the requests in `cancel`.
    Returns (engine, {uid: generated tokens}, handles)."""
    eng = ServingEngine(model, params, tonline.init_trainer(model, dvi_params=dvi),
                        graphs=graphs_on, learn=False, **kw)
    eng.warmup()
    handles = {uid: eng.submit_request(Request(uid, p, max_new=mn)) for uid, p, mn in reqs}
    outs = eng.step()
    for uid in cancel:
        assert handles[uid].cancel()
    outs += eng.run(max_steps=1000)
    return eng, {c.uid: c.gen_tokens.tolist() for c in outs}, handles


def _static_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_static_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tree, tree.data_ptr())}


@pytest.mark.parametrize("cell", list(ENGINE_CELLS))
def test_engine_capture_path_matches_eager(models, monkeypatch, cell):
    """The engine with graphs on, through the capture path (a fake graph
    whose replay re-runs the captured body), against ``graphs=False``:
    equal streams, counts and replay buffer; one replay a block run; the
    engine's state tensors are the runner's and never move."""
    name, kw = ENGINE_CELLS[cell]
    model, params, dvi = models[name]
    reqs = _requests(model.cfg.vocab_size, 7 if name == "vicuna-7b" else 4)
    cancel = (2,) if cell == "vicuna_paged14" else ()
    eng_e, outs_e, _ = _serve(model, params, dvi, kw, reqs, False, cancel)
    fake = FakeCuda()
    monkeypatch.setattr(graphs, "_cuda", fake)
    eng_g, outs_g, handles = _serve(model, params, dvi, kw, reqs, True, cancel)
    assert outs_g == outs_e and len(outs_g) == len(reqs) - len(cancel)
    for key in ("requests", "blocks", "steps", "committed", "accepted", "drafted",
                "preemptions", "dispatches", "host_syncs", "cancelled"):
        assert eng_g.stats[key] == eng_e.stats[key], key
    _assert_tree_equal(eng_g.buf, eng_e.buf, "buf")
    st = eng_g.graph_stats()
    assert st["replays"] > 0 and st["captures"] == len(fake.graphs)
    if kw["scheduler"] == "continuous":
        assert st["captures"] == 1 and st["replays"] >= eng_g.stats["steps"]
        assert eng_g._pending is eng_g._runner.state["pending"]
        assert eng_g._cache is eng_g._runner.state["cache"]
        assert eng_g.buf is eng_g._runner.state["buf"]
    else:
        assert st["replays"] == eng_g.stats["steps"]
        assert st["captures"] == len(kw["buckets"])      # warmup(): every bucket
    if cell == "vicuna_paged14":
        assert eng_g.stats["preemptions"] > 0 and eng_g.stats["cancelled"] == 1
        assert handles[2].outcome == "cancelled" and eng_g.kv_stats()["used_pages"] == 0


def test_static_buffers_stay_put(models, monkeypatch):
    """Every static buffer of a continuous runner keeps its identity and
    address over a run with admissions, a preemption and a cancel; the
    engine's pending tokens, cache leaves and buffer leaves are those
    tensors.  A sync runner's buffers stay put across batches of a shape."""
    monkeypatch.setattr(graphs, "_cuda", FakeCuda())
    model, params, dvi = models["vicuna-7b"]
    kw = ENGINE_CELLS["vicuna_paged14"][1]
    eng = ServingEngine(model, params, tonline.init_trainer(model, dvi_params=dvi),
                        learn=False, **kw)
    eng.warmup()
    runner = eng._runner
    before = _static_leaves(runner.state)
    before["acc"] = (runner.acc, runner.acc.data_ptr())
    handles = {uid: eng.submit_request(Request(uid, p, max_new=mn))
               for uid, p, mn in _requests(model.cfg.vocab_size, 7)}
    eng.step()
    assert handles[2].cancel()
    for _ in range(1000):
        if not eng.busy:
            break
        eng.step()
        assert eng._runner is runner
        assert eng._pending is runner.state["pending"] and eng._cache is runner.state["cache"]
        assert eng.buf is runner.state["buf"]
        now = _static_leaves(runner.state)
        now["acc"] = (runner.acc, runner.acc.data_ptr())
        assert now.keys() == before.keys()
        for key, (t, ptr) in now.items():
            assert t is before[key][0] and ptr == before[key][1], key
    assert eng.stats["preemptions"] > 0 and eng.stats["cancelled"] == 1 and not eng.busy
    eng = ServingEngine(model, params, tonline.init_trainer(model, dvi_params=dvi),
                        learn=False, **ENGINE_CELLS["vicuna_sync"][1])
    for uid, p, mn in _requests(model.cfg.vocab_size, 5):
        eng.submit_request(Request(uid, p, max_new=mn))
    eng.step()
    shapes = {key: _static_leaves(st) for key, (st, _) in eng._runner._shapes.items()}
    eng.run()
    for key, leaves in shapes.items():
        st, _ = eng._runner._shapes[key]
        for path, (t, ptr) in _static_leaves(st).items():
            assert t is leaves[path][0] and ptr == leaves[path][1], (key, path)
        assert st["buf"] is eng.buf


def test_engine_with_graphs_matches_jax_on_cancels():
    """The engine at its defaults (graphs on; on the CPU the body runs
    eagerly) against the JAX engine over the tight pool, with a request
    cancelled mid-decode and one while queued: equal streams, counts and
    outcomes."""
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
    kw = ENGINE_CELLS["vicuna_paged14"][1]
    eng_j = JEngine(model_j, params_j, state, learn=False, **kw)
    eng_t = ServingEngine(model_t, params_t, tonline.init_trainer(model_t, dvi_params=dvi_t),
                          learn=False, **kw)
    assert eng_t.graphs
    reqs = _requests(cfg_t.vocab_size, 7)
    hj = {uid: eng_j.submit_request(JRequest(uid, p, max_new=mn)) for uid, p, mn in reqs}
    ht = {uid: eng_t.submit_request(Request(uid, p, max_new=mn)) for uid, p, mn in reqs}
    outs_j, outs_t = eng_j.step(), eng_t.step()
    for h in (hj, ht):
        assert h[1].cancel() and h[6].cancel()    # uid 1 live, uid 6 queued
    outs_j += eng_j.run(max_steps=1000)
    outs_t += eng_t.run(max_steps=1000)
    assert ({c.uid: c.gen_tokens.tolist() for c in outs_t}
            == {c.uid: c.gen_tokens.tolist() for c in outs_j})
    for key in ("requests", "blocks", "steps", "committed", "accepted", "drafted",
                "preemptions", "dispatches", "host_syncs", "cancelled"):
        assert eng_t.stats[key] == eng_j.stats[key], key
    for uid in (1, 6):
        assert ht[uid].outcome == hj[uid].outcome == "cancelled"
        assert ht[uid].tokens() == list(hj[uid].tokens())
    assert eng_t.stats["preemptions"] > 0 and eng_t.kv_stats()["used_pages"] == 0


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------

@pytest.fixture
def launched(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: each launch counts as the
    real one does, and runs nothing."""
    def launch(name, *args):
        ops.launches[name] += 1

    monkeypatch.setattr(ops, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(ops, "_stream", lambda dev: None)
    monkeypatch.setattr(ops, "_launch", launch)
    ops.reset_launches()
    yield
    ops.reset_launches()


class RecordingCuda(FakeCuda):
    """Capturing runs the body once, as a capture calls every wrapper (and
    so counts its launches) without running a kernel; a replay runs
    nothing."""

    def __init__(self, fail_replay=False, **kw):
        super().__init__(**kw)
        self.fail_replay = fail_replay

    def capture(self, graph, pool, fn):
        fn()
        if self.fail_capture:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph.fn = self._replay

    def _replay(self):
        if self.fail_replay:
            raise RuntimeError("cudaGraphLaunch failed")


def _vocab_body():
    """A body of one verify_argmax and two lora_logits calls on aligned
    operands (the fast loader) and one lora_logits call on an unaligned h
    (the element loader)."""
    h = torch.zeros(4, 64)
    w = torch.zeros(64, 256)
    a, b = torch.zeros(64, 8), torch.zeros(8, 256)
    h_odd = torch.zeros(4 * 64 + 1)[1:].view(4, 64)

    def body():
        ops.verify_argmax(h, w)
        ops.lora_logits(h, w, a, b, 1.0)
        ops.lora_logits(h, w, a, b, 1.0)
        ops.lora_logits(h_odd, w, a, b, 1.0)
    return body


def test_replays_add_the_captured_launches(launched, monkeypatch):
    monkeypatch.setattr(graphs, "_cuda", RecordingCuda())
    warmups = []
    body = _vocab_body()
    step = graphs.StepGraph(body, capture=True, pool=None,
                            warmup=lambda: (warmups.append(1), body()))
    per_call = {"verify_argmax": 1, "lora_logits": 3, "decode_attention": 0,
                "paged_decode_attention": 0, "ssd_scan": 0}
    # the warm-up ran once; the capture counted nothing
    assert warmups == [1] and ops.launches == per_call
    assert step.counts["launches"] == per_call
    assert step.counts["vocab_paths"] == {"verify_argmax": {"fast": 1, "element": 0},
                                          "lora_logits": {"fast": 2, "element": 1}}
    for n in range(1, 4):
        step()
        assert ops.launches == {k: v * (n + 1) for k, v in per_call.items()}
        assert ops.vocab_paths["lora_logits"] == {"fast": 2 * (n + 1), "element": n + 1}
    assert step.replays == 3 and step.nodes == 1 and step.graph.instantiated
    eager = graphs.StepGraph(body, capture=False)
    eager()
    assert ops.launches["lora_logits"] == 3 * 5 and eager.graph is None
    stats = graphs.graph_stats([step, eager])
    assert stats["captures"] == 1 and stats["replays"] == 3
    assert stats["per_graph"] == [(per_call, {"_Z9lora_mainv": 3})]


def test_failed_capture_or_replay_raises(launched, monkeypatch):
    """A capture that raises propagates and leaves the counts as they were;
    a replay that raises propagates and counts nothing; nothing runs the
    body eagerly instead."""
    calls = []
    body = _vocab_body()

    def counted():
        calls.append(1)
        body()

    monkeypatch.setattr(graphs, "_cuda", RecordingCuda(fail_capture=True))
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.StepGraph(counted, capture=True, warmup=body)
    # the warm-up ran the body; the capture's launches were taken back out
    assert ops.launches["lora_logits"] == 3 and calls == [1]
    monkeypatch.setattr(graphs, "_cuda", RecordingCuda(fail_replay=True))
    step = graphs.StepGraph(counted, capture=True, warmup=body)
    calls.clear()
    with pytest.raises(RuntimeError, match="cudaGraphLaunch"):
        step()
    assert ops.launches["lora_logits"] == 6 and calls == [] and step.replays == 0


def test_failed_capture_raises_through_the_engine(models, monkeypatch):
    model, params, dvi = models["vicuna-7b"]
    monkeypatch.setattr(graphs, "_cuda", FakeCuda(fail_capture=True))
    for _, kw in (ENGINE_CELLS["vicuna_paged14"], ENGINE_CELLS["vicuna_sync"]):
        eng = ServingEngine(model, params, tonline.init_trainer(model, dvi_params=dvi),
                            learn=False, **kw)
        with pytest.raises(RuntimeError, match="capturing"):
            eng.warmup()
