"""The paper's baselines in the port (``repro_torch.core.baselines``) against
``repro.core.baselines``, in float32 at tiny sizes.

* Two-model SpS on three pairs: vicuna-7b-tiny with a 2-layer drafter, the
  qwen3-0.6b-tiny -> qwen3-1.7b-tiny pair and qwen3-0.6b-tiny drafting for
  itself.  Tokens, lengths and the four counters equal the reference's; the
  port's stream equals the port's own ``ar_generate`` bit for bit.  Block by
  block (the reference's ``while_loop`` run as a Python loop that records
  each carry), the streams and both caches' lengths equal the reference's:
  on the self-pair every draft of the first block is accepted, and the
  drafter's length then lags the target's by one (the d_K clamp).
* Medusa-lite: ``medusa_head_logits`` within rtol 1e-5; ``medusa_generate``
  tokens and counters equal, MAT >= 1.9; ``train_medusa_heads`` for 3 steps
  on the same batches, each step's loss within rtol 1e-4, the heads within
  rtol 1e-4 and atol 1e-4 (a tenth of the learning rate).
* The runners (``graphs.TwoModelRunner``, ``graphs.MedusaRunner``): eager and
  through the capture path of ``tests/test_torch_graphs.py``'s stand-in
  ``graphs._cuda`` (a replay re-runs the captured body) equal to the
  functional loops, twice on one shape; a rebound parameter raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs.base import DVIConfig as JDVIConfig  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import DVIConfig  # noqa: E402
from repro_torch.core import baselines, graphs, spec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

B, TP, NEW, K = 3, 8, 20, 4
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


class _Lax:
    """``jax.lax`` with ``while_loop`` run as a Python loop that records
    every carry after a body."""

    def __init__(self, rec):
        self.rec = rec

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def while_loop(self, cond, body, carry):
        while bool(cond(carry)):
            carry = body(carry)
            self.rec["carries"].append(carry)
        return carry


class _Jax:
    """The reference module's ``jax``, recording: its ``while_loop``'s
    carries, and the outputs of each call of a function it jits."""

    def __init__(self):
        self.rec = {"carries": [], "outs": []}
        self.lax = _Lax(self.rec)

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def call(*args):
            out = jitted(*args)
            self.rec["outs"].append(out)
            return out
        return call


@pytest.fixture()
def recorder(monkeypatch):
    shim = _Jax()
    monkeypatch.setattr(jbase, "jax", shim)
    return shim.rec


def _port_model(arch, params_j, **over):
    cfg_t = get_config(arch, tiny=True).replace(dtype="float32", **over)
    model = build_model(cfg_t, device="cpu")
    return model, weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")


def _pair(kind):
    """(target_j, t_params_j, draft_j, d_params_j, target_t, t_params_t,
    draft_t, d_params_t) for one of the three pairs."""
    if kind == "vicuna":
        t_name = d_name = "vicuna-7b"
        over = dict(name="drafter", num_layers=2)
        d_over_j = dict(over, dvi=JDVIConfig(split_layer=1))
        d_over_t = dict(over, dvi=DVIConfig(split_layer=1))
    else:
        t_name = "qwen3-0.6b" if kind == "self" else "qwen3-1.7b"
        d_name = "qwen3-0.6b"
        d_over_j = d_over_t = {}
    cfg_t = tiny_cfg(t_name)
    target_j = jax_build_model(cfg_t)
    tp_j = target_j.init(jax.random.PRNGKey(0))
    draft_j = jax_build_model(tiny_cfg(d_name).replace(**d_over_j))
    dp_j = tp_j if kind == "self" else draft_j.init(jax.random.PRNGKey(1))
    target_t, tp_t = _port_model(t_name, tp_j)
    draft_t, dp_t = ((target_t, tp_t) if kind == "self"
                     else _port_model(d_name, dp_j, **d_over_t))
    return target_j, tp_j, draft_j, dp_j, target_t, tp_t, draft_t, dp_t


def _prompts(vocab, seed=2):
    return np.random.default_rng(seed).integers(2, vocab, size=(B, TP)).astype(np.int32)


def _equal_result(r_j, r_t):
    np.testing.assert_array_equal(r_t.tokens.numpy(), np.asarray(r_j.tokens))
    np.testing.assert_array_equal(r_t.lengths.numpy(), np.asarray(r_j.lengths))
    for name in spec.GEN_COUNTERS:
        assert int(getattr(r_t, name)) == int(getattr(r_j, name)), name


def _equal_ar(model, params, prompts, r):
    r_ar = spec.ar_generate(model, params, _t(prompts), NEW)
    for b in range(B):
        n = min(int(r_ar.lengths[b]), int(r.lengths[b]), TP + NEW)
        assert torch.equal(r.tokens[b, :n], r_ar.tokens[b, :n]), b


@pytest.mark.parametrize("kind", ["vicuna", "qwen"])
def test_two_model_generate_matches_reference(kind):
    tj, tpj, dj, dpj, tt, tpt, dt, dpt = _pair(kind)
    prompts = _prompts(tt.cfg.vocab_size)
    r_j = jbase.two_model_generate(tj, tpj, dj, dpj, jnp.asarray(prompts), NEW, k_spec=K)
    r_t = baselines.two_model_generate(tt, tpt, dt, dpt, _t(prompts), NEW, k_spec=K)
    _equal_result(r_j, r_t)
    _equal_ar(tt, tpt, prompts, r_t)


def test_two_model_self_pair_clamps_d_k(recorder):
    """qwen3-0.6b-tiny drafting for itself: block by block, the stream and
    both caches' lengths equal the reference's; after a fully accepted
    block the drafter's length has grown by K, the target's by K + 1."""
    tj, tpj, dj, dpj, tt, tpt, dt, dpt = _pair("self")
    prompts = _prompts(tt.cfg.vocab_size)
    r_j = jbase.two_model_generate(tj, tpj, dj, dpj, jnp.asarray(prompts), NEW, k_spec=K)
    r_t = baselines.two_model_generate(tt, tpt, dt, dpt, _t(prompts), NEW, k_spec=K)
    _equal_result(r_j, r_t)
    _equal_ar(tt, tpt, prompts, r_t)
    carries = recorder["carries"]
    assert r_t.steps == len(carries)
    cap = TP + NEW + K + 2 + 128
    _, t_cache = tt.prefill(tpt, _t(prompts)[:, :TP - 1], max_len=cap)
    _, d_cache = dt.prefill(dpt, _t(prompts)[:, :TP - 1], max_len=cap)
    st = baselines.init_state(_t(prompts), K, NEW, dict(t_cache=t_cache, d_cache=d_cache))
    full = 0
    for out, out_len, pending, done, t_c, d_c, stats in carries:
        t0t, t0d = st["t_cache"]["lengths"].clone(), st["d_cache"]["lengths"].clone()
        live = ~st["done"]
        st = baselines.two_model_block(tt, tpt, dt, dpt, st, k_spec=K, limit=TP + NEW,
                                       eos_id=1)
        np.testing.assert_array_equal(st["out"].numpy(), np.asarray(out))
        np.testing.assert_array_equal(st["pending"].numpy(), np.asarray(pending))
        np.testing.assert_array_equal(st["t_cache"]["lengths"].numpy(),
                                      np.asarray(t_c["lengths"]))
        np.testing.assert_array_equal(st["d_cache"]["lengths"].numpy(),
                                      np.asarray(d_c["lengths"]))
        all_in = live & (st["t_cache"]["lengths"] - t0t == K + 1)
        assert torch.equal((st["d_cache"]["lengths"] - t0d)[all_in],
                           torch.full((int(all_in.sum()),), K, dtype=torch.int32))
        full += int(all_in.sum())
    assert full > 0              # the d_K clamp acted


@pytest.fixture(scope="module")
def medusa():
    cfg_j = tiny_cfg("vicuna-7b")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    heads_j = jbase.init_medusa_heads(jax.random.PRNGKey(9), model_j, 3)
    model_t, params_t = _port_model("vicuna-7b", params_j)
    heads_t = weights.medusa_heads_from_numpy(jax.tree.map(np.asarray, heads_j), "cpu")
    return model_j, params_j, heads_j, model_t, params_t, heads_t


def test_medusa_head_logits_match(medusa):
    model_j, params_j, heads_j, model_t, params_t, heads_t = medusa
    h = np.random.default_rng(3).standard_normal((2, 5, model_t.cfg.d_model)).astype(np.float32)
    lj = jbase.medusa_head_logits(model_j, params_j, heads_j, jnp.asarray(h))
    lt = baselines.medusa_head_logits(model_t, params_t, heads_t, _t(h))
    assert lt.shape == (3, 2, 5, model_t.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=2e-5)


def test_medusa_generate_matches_reference(medusa):
    model_j, params_j, heads_j, model_t, params_t, heads_t = medusa
    prompts = _prompts(model_t.cfg.vocab_size)
    r_j = jbase.medusa_generate(model_j, params_j, heads_j, jnp.asarray(prompts), NEW)
    r_t = baselines.medusa_generate(model_t, params_t, heads_t, _t(prompts), NEW)
    _equal_result(r_j, r_t)
    _equal_ar(model_t, params_t, prompts, r_t)
    assert float(r_t.committed) / float(r_t.blocks) >= 1.9


def test_train_medusa_heads_matches_reference(medusa, recorder):
    model_j, params_j, heads_j, model_t, params_t, heads_t = medusa
    batches = [np.random.default_rng(10 + i).integers(2, model_t.cfg.vocab_size, size=(2, 24))
               .astype(np.int32) for i in range(3)]
    out_j = jbase.train_medusa_heads(model_j, params_j, heads_j,
                                     [jnp.asarray(b) for b in batches])
    heads = {"w1": heads_t["w1"].clone()}
    losses = []
    out_t = baselines.train_medusa_heads(model_t, params_t, heads, batches,
                                         on_step=lambda i, loss: losses.append(float(loss)))
    assert out_t is heads
    want = [float(o[2]) for o in recorder["outs"]]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    # atol a tenth of the learning rate: where an element's gradient lies at
    # float32 noise, Adam's normalised step m / sqrt(v) may take any value up to lr
    np.testing.assert_allclose(out_t["w1"].numpy(), np.asarray(out_j["w1"]), rtol=1e-4,
                               atol=1e-4)
    assert not torch.equal(out_t["w1"], heads_t["w1"])


def _fake_cuda():
    from test_torch_graphs import FakeCuda
    return FakeCuda()


def _same(a, b):
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    assert all(int(getattr(a, n)) == int(getattr(b, n)) for n in spec.GEN_COUNTERS)
    assert a.steps == b.steps


@pytest.mark.parametrize("captured", [False, True])
def test_runners_match_functional_loops(captured, medusa, monkeypatch):
    if captured:
        monkeypatch.setattr(graphs, "_cuda", _fake_cuda())
    *_, tt, tpt, dt, dpt = _pair("qwen")
    prompts = _t(_prompts(tt.cfg.vocab_size))
    runner = graphs.TwoModelRunner(tt, tpt, dt, dpt, max_new=NEW, graphs=True, k_spec=K)
    want = baselines.two_model_generate(tt, tpt, dt, dpt, prompts, NEW, k_spec=K)
    for _ in range(2):
        _same(runner.generate(prompts), want)
    stats = runner.graph_stats()
    assert stats["captures"] == int(captured)
    assert stats["replays"] == (2 * want.steps if captured else 0)
    *_, model_t, params_t, heads_t = medusa
    m_runner = graphs.MedusaRunner(model_t, params_t, heads_t, max_new=NEW, graphs=True)
    want = baselines.medusa_generate(model_t, params_t, heads_t, prompts, NEW)
    for _ in range(2):
        _same(m_runner.generate(prompts), want)
    short = prompts[:2, 1:]
    _same(m_runner.generate(short), baselines.medusa_generate(model_t, params_t, heads_t,
                                                               short, NEW))
    assert m_runner.graph_stats()["captures"] == (2 if captured else 0)
    w1 = heads_t["w1"]
    heads_t["w1"] = w1.clone()
    try:
        with pytest.raises(RuntimeError, match="rebound"):
            m_runner.generate(prompts)
    finally:
        heads_t["w1"] = w1
