"""``prime`` of the block-step runners (``repro_torch.core.graphs``) on the
CPU, through the capture path of ``tests/test_torch_graphs.py``'s stand-in
``graphs._cuda`` (a replay re-runs the captured body).

A primed replay runs each captured graph once inside its warm-up's frame,
between two waves of requests: it replays every graph once, adds each
capture's launches to ``ops.launches`` (none on the CPU) and nothing to the
replay statistics, leaves the replay buffer as it was, and the second
wave's streams and counters equal those of an engine that was not primed,
bit for bit, on the continuous engine (paged with preemption, chunked
prefill, adaptive depth, mamba2) and the sync engine.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_graphs import (FakeCuda, _assert_tree_equal, _clone,  # noqa: E402
                               _model, _requests)

from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

SYNC = 3
CELLS = {
    "vicuna_paged14": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                         cache_len=40, kv_pages=14, kv_page_size=4,
                                         sync_every=SYNC)),
    "vicuna_chunked": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                         cache_len=40, kv_pages=20, kv_page_size=4,
                                         sync_every=SYNC, prefill_chunk=4)),
    "vicuna_adaptive": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                          cache_len=40, sync_every=2, adaptive_k=True,
                                          k_min=1, k_max=4)),
    "mamba2_continuous": ("mamba2-370m", dict(scheduler="continuous", num_slots=2, max_new=10,
                                              cache_len=40, sync_every=2)),
    "vicuna_sync": ("vicuna-7b", dict(scheduler="sync", batch_size=2, max_new=10,
                                      buckets=(8, 16))),
}
STATS = ("requests", "blocks", "steps", "committed", "accepted", "drafted", "preemptions",
         "dispatches")


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in ("vicuna-7b", "mamba2-370m")}


class CountingCuda(FakeCuda):
    """The stand-in, counting every graph's replays."""

    def new_graph(self):
        graph = super().new_graph()
        graph.calls, replay = 0, graph.replay

        def counted():
            graph.calls += 1
            replay()
        graph.replay = counted
        return graph


def _wave(eng, reqs, base):
    for uid, p, mn in reqs:
        eng.submit_request(Request(base + uid, p, max_new=mn))
    outs = eng.run(max_steps=1000)
    return {c.uid - base: c.gen_tokens.tolist() for c in outs}


@pytest.mark.parametrize("cell", list(CELLS))
def test_prime_changes_nothing_a_later_wave_reads(models, monkeypatch, cell):
    name, kw = CELLS[cell]
    model, params, dvi = models[name]
    reqs = _requests(model.cfg.vocab_size, 7 if name == "vicuna-7b" else 4)
    waves = {}
    for prime in (False, True):
        fake = CountingCuda()
        monkeypatch.setattr(graphs, "_cuda", fake)
        eng = ServingEngine(model, params, tonline.init_trainer(model, dvi_params=dvi),
                            graphs=True, learn=False, **kw)
        eng.warmup()
        first = _wave(eng, reqs, 0)
        if prime:
            launches, replays = dict(ops.launches), eng.graph_stats()["replays"]
            calls = [g.calls for g in fake.graphs]
            buf = _clone(eng.buf)
            assert eng._runner.prime() == len(fake.graphs)
            assert [g.calls for g in fake.graphs] == [c + 1 for c in calls]
            assert ops.launches == launches and eng.graph_stats()["replays"] == replays
            _assert_tree_equal(eng.buf, buf, "buf")
        second = _wave(eng, reqs, 100)
        waves[prime] = first, second, {key: eng.stats[key] for key in STATS}
    assert waves[True] == waves[False]
    assert len(waves[True][1]) == len(reqs)
