"""The serving engine on the int8 KV cache (``cfg.kv_quant``) against the
JAX package's engine: the continuous engine over a paged pool tight enough
to preempt, over the contiguous layout, with chunked prefill, and with the
prefix cache (shared system prompts, a page copied on write, a wholly
cached prompt), each with ``learn=False`` on both sides.  Per request the
generated tokens are equal and the counts are equal; the one-shot streams
equal the port's own int8 AR, and the prefix cache's equal the same
chunked engine run cold.

Chunked prefill attends its chunk through the step path (dequantised K/V),
one-shot prefill in full precision, in the reference as here, so chunked
streams are held to the reference's chunked engine, not to one-shot ones.

vicuna-7b tiny in float32 with the weights of ``test_torch_chunked._pair``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_chunked import _pair  # noqa: E402
from test_torch_prefix_cache import PREFIX_STATS, _serve, _waves  # noqa: E402

KW = dict(scheduler="continuous", num_slots=3, max_new=16, cache_len=40, kv_page_size=4)
CELLS = {"paged14": dict(kv_pages=14), "contiguous": dict(kv_pages=0),
         "chunked": dict(kv_pages=20, prefill_chunk=4)}
COUNTS = ("requests", "blocks", "committed", "accepted", "drafted", "preemptions",
          "dispatches", "host_syncs", "prefill_chunks")


@pytest.fixture(scope="module")
def s():
    """The chunked tests' vicuna pair, both sides rebuilt with kv_quant (the
    flag changes no parameter)."""
    p = _pair("vicuna-7b")
    cfg_t = p["cfg"].replace(kv_quant=True)
    cfg_j = dataclasses.replace(p["model_j"].cfg, kv_quant=True)
    p.update(cfg=cfg_t, model_t=build_model(cfg_t, device="cpu"),
             model_j=jax_build_model(cfg_j))
    rng = np.random.default_rng(0)
    p["reqs"] = [(i, rng.integers(2, cfg_t.vocab_size, int(rng.choice([6, 9, 13])))
                  .astype(np.int32), int(rng.choice([10, 16]))) for i in range(6)]
    return p


def _port(s, **kw):
    return ServingEngine(s["model_t"], s["params_t"],
                         tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                         learn=False, **dict(KW, **kw))


def _streams(outs):
    return {c.uid: c.gen_tokens.tolist() for c in outs}


@pytest.fixture(scope="module")
def runs(s):
    out = {}
    for cell, kw in CELLS.items():
        eng_j = JEngine(s["model_j"], s["params_j"], s["state"], learn=False, **KW, **kw)
        eng_t = _port(s, **kw)
        for uid, p, mn in s["reqs"]:
            eng_j.submit_request(JRequest(uid, p, max_new=mn))
            eng_t.submit_request(Request(uid, p, max_new=mn))
        out[cell] = (eng_j, _streams(eng_j.run(max_steps=2000)), eng_t,
                     _streams(eng_t.run(max_steps=2000)))
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_engine_matches_jax(runs, cell):
    eng_j, got_j, eng_t, got_t = runs[cell]
    assert len(got_t) == 6 and got_t == got_j
    for key in COUNTS:
        assert eng_t.stats.get(key, 0) == eng_j.stats.get(key, 0), key
    assert eng_t.stats["host_syncs"] == eng_t.stats["dispatches"]
    if eng_t.paged:
        assert eng_t.kv_stats()["used_pages"] == 0
    if cell == "paged14":
        assert eng_t.kv_stats()["preemptions"] > 0, "the tight pool must preempt"
    if cell == "chunked":
        assert eng_t.stats["prefill_chunks"] > 0


def test_one_shot_streams_equal_int8_ar(s, runs):
    """The one-shot engines commit each request's own int8 AR stream."""
    got = runs["paged14"][3]
    assert runs["contiguous"][3] == got
    for uid, p, mn in s["reqs"]:
        r = tspec.ar_generate(s["model_t"], s["params_t"], torch.from_numpy(p.copy())[None], mn)
        ar = r.tokens[0, len(p):int(r.lengths[0])].tolist()[:mn]
        if 1 in ar:
            ar = ar[:ar.index(1) + 1]
        assert got[uid] == ar, uid


def test_prefix_cache_matches_jax_and_the_cold_engine(s):
    """The prefix cache's waves (14 pages of 4, chunks of 4) through the
    port with and without the cache and through the JAX engine with it: the
    port's warm streams equal the JAX engine's and the port's cold ones, the
    six prefix stats equal the JAX engine's after each wave, and a page was
    copied on write with its scales."""
    kw = dict(kv_pages=14, prefill_chunk=4, max_new=8)
    waves = _waves(s["cfg"])
    ref = JEngine(s["model_j"], s["params_j"], s["state"], learn=False, prefix_cache=True,
                  **dict(KW, **kw))
    got_j, after_j = _serve(ref, waves, JRequest)
    got_w, after_w = _serve(_port(s, prefix_cache=True, **kw), waves, Request)
    got_c, _ = _serve(_port(s, **kw), waves, Request)
    assert got_w == got_j == got_c
    assert after_w == after_j
    assert after_w[-1]["prefix_hits"] > 0 and after_w[-1]["prefix_cow_copies"] > 0
