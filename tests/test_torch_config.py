"""The port's serving front end against the reference's: ``EngineConfig``
(fields and defaults equal the reference's field by field, every field an
engine parameter, flags round trip), ``ModelSpec`` and
``build_model_bundle``; the rest of the engine API (``submit`` warns and
streams what ``submit_request`` streams; ``abort_pending``,
``write_trace`` and ``slot_acceptance`` as the JAX engine's on the same
weights; the ``profile_dir`` window); the load generator's workload and
report against ``benchmarks/load_gen.py`` on the same seeds; and
``launch.serve.main`` on the CPU."""
import argparse
import dataclasses
import importlib.util
import inspect
import json
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.serving import config as ref_config  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.launch import load_gen, serve  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.config import (EngineConfig, ModelSpec,  # noqa: E402
                                        build_engine, build_model_bundle,
                                        format_tenant_weights, parse_tenant_weights)
from test_torch_chunked import _pair  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_load_gen():
    spec = importlib.util.spec_from_file_location("ref_load_gen",
                                                  ROOT / "benchmarks" / "load_gen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse(cls, argv, defaults=None):
    ap = argparse.ArgumentParser()
    cls.add_args(ap, defaults)
    return cls.from_args(ap.parse_args(argv))


# ---------------------------------------------------------------------------
# 1) EngineConfig and ModelSpec
# ---------------------------------------------------------------------------

def test_engine_config_fields_equal_the_reference():
    port = [(f.name, f.default, f.type) for f in dataclasses.fields(EngineConfig)]
    ref = [(f.name, f.default, f.type) for f in dataclasses.fields(ref_config.EngineConfig)]
    assert port == ref
    assert dataclasses.asdict(EngineConfig()) == dataclasses.asdict(ref_config.EngineConfig())
    # the defaults serve contiguous and learning, as the reference's do
    assert EngineConfig().learn and EngineConfig().kv_pages == 0


@pytest.mark.parametrize("argv", [[], ["--scheduler", "sync", "--batch", "5", "--no-learn"],
                                  ["--kv-pages", "48", "--prefix-cache", "--prefill-chunk", "8",
                                   "--adaptive-k", "--k-max", "3", "--tenant-weights",
                                   "gold:3,free:1", "--profile-dir", "p", "--telemetry"]])
def test_engine_config_flags_equal_the_reference(argv):
    port, ref = _parse(EngineConfig, argv), _parse(ref_config.EngineConfig, argv)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.to_argv() == ref.to_argv()
    assert port.engine_kwargs() == ref.engine_kwargs()


def test_engine_config_round_trips():
    for c in (EngineConfig(), EngineConfig(
            scheduler="sync", num_slots=3, batch_size=4, max_new=7, bucket=32, sync_every=2,
            learn=False, kv_pages=48, kv_page_size=8, prefix_cache=True, prefill_chunk=8,
            adaptive_k=True, k_min=2, k_max=5, max_queue=9,
            tenant_weights={"gold": 3.0, "free": 1.0}, telemetry=True, profile_dir="prof")):
        assert _parse(EngineConfig, c.to_argv()) == c
    assert _parse(EngineConfig, []) == EngineConfig()
    assert _parse(EngineConfig, ["--batch", "5"]).batch_size == 5
    w = {"gold": 2.5, "free": 1.0}
    assert parse_tenant_weights(format_tenant_weights(w)) == w
    assert parse_tenant_weights("") is None


def test_engine_kwargs_match_the_port_engine():
    kw = EngineConfig().engine_kwargs()
    params = inspect.signature(ServingEngine.__init__).parameters
    assert set(kw) <= set(params), set(kw) - set(params)
    assert kw["buckets"] == (EngineConfig().bucket,)
    # what the engine takes beyond the config: its model, weights, trainer
    # state, injected clock, the depth controller's full override (as in the
    # reference) and the port's own `graphs`
    assert set(params) - set(kw) == {"self", "model", "params", "state", "clock", "depth_cfg",
                                     "graphs"}


def test_model_spec_and_bundle():
    ref = [(f.name, f.default) for f in dataclasses.fields(ref_config.ModelSpec)]
    port = [(f.name, f.default) for f in dataclasses.fields(ModelSpec)]
    assert port == ref + [("device", None)]
    argv = ["--arch", "qwen3-0.6b", "--seed", "3", "--pretrain-steps", "5", "--full-size"]
    got = _parse(ModelSpec, argv + ["--device", "cpu"])
    want = _parse(ref_config.ModelSpec, argv)
    assert dataclasses.asdict(got) == dict(dataclasses.asdict(want), device="cpu")
    assert _parse(ModelSpec, []).device is None           # the card by default
    spec = ModelSpec(pretrain_steps=2, device="cpu")
    cfg, model, params, tasks, state = build_model_bundle(spec)
    _, _, params2, _, state2 = build_model_bundle(spec)
    assert cfg.dtype == "float32" and model.device.type == "cpu"
    assert int(state.step) == 0 and int(state.buf["count"]) == 0
    for name, seg in params["segments"].items():
        for key, leaf in seg.items():
            assert torch.equal(leaf, params2["segments"][name][key]), (name, key)
    assert torch.equal(state.dvi_params["A"], state2.dvi_params["A"])
    eng = build_engine(EngineConfig(num_slots=2, kv_pages=64, prefill_chunk=4,
                                    prefix_cache=True), model, params, state, graphs=False)
    assert eng.prefix_cache and eng.num_slots == 2 and not eng.graphs


# ---------------------------------------------------------------------------
# 2) the rest of the engine API, against the JAX engine on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return _pair("vicuna-7b")


def _reqs(cfg, n=5):
    rng = np.random.default_rng(4)
    return [(i, rng.integers(2, cfg.vocab_size, 6 + 3 * i).astype(np.int32), 6)
            for i in range(n)]


def test_engine_api_matches_jax(pair, tmp_path):
    s = pair
    kw = dict(scheduler="continuous", num_slots=3, max_new=6, sync_every=2, learn=False,
              telemetry=True)
    port = ServingEngine(s["model_t"], s["params_t"],
                         tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]), **kw)
    ref = JEngine(s["model_j"], s["params_j"], s["state"], **kw)
    reqs = _reqs(s["cfg"])
    with pytest.warns(DeprecationWarning):
        hp = {uid: port.submit(Request(uid=uid, prompt=p, max_new=m)) for uid, p, m in reqs}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hr = {uid: ref.submit(JRequest(uid=uid, prompt=p, max_new=m)) for uid, p, m in reqs}
    port.run()
    ref.run()
    assert {u: h.tokens() for u, h in hp.items()} == {u: h.tokens() for u, h in hr.items()}
    np.testing.assert_array_equal(port.slot_acceptance, ref.slot_acceptance)
    assert port.slot_acceptance.shape == (3,) and port.slot_acceptance.max() > 0
    # write_trace: a Chrome trace with the reference's event names
    port.write_trace(str(tmp_path / "port.json"))
    ref.write_trace(str(tmp_path / "ref.json"))
    names = [{e["name"] for e in json.loads((tmp_path / f).read_text())["traceEvents"]}
             for f in ("port.json", "ref.json")]
    assert names[0] == names[1] and "superstep" in names[0]
    # submit streams what submit_request streams
    again = ServingEngine(s["model_t"], s["params_t"],
                          tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]), **kw)
    h2 = {uid: again.submit_request(Request(uid=uid, prompt=p, max_new=m))
          for uid, p, m in reqs}
    again.run()
    assert {u: h.tokens() for u, h in h2.items()} == {u: h.tokens() for u, h in hp.items()}
    # abort_pending: every unfinished handle fails with outcome "error"
    outcomes = []
    for eng, req_cls in ((port, Request), (ref, JRequest)):
        hs = [eng.submit_request(req_cls(uid=100 + uid, prompt=p, max_new=m))
              for uid, p, m in reqs[:2]]
        eng.abort_pending("stopped")
        outcomes.append([(h.finished, h.outcome) for h in hs] + [len(eng._handles)])
        with pytest.raises(RuntimeError):
            hs[0].result(timeout=1.0)
    assert outcomes[0] == outcomes[1] == [(True, "error"), (True, "error"), 0]
    # without the tracer, both refuse to write a trace
    for cls, model, params, state in ((ServingEngine, s["model_t"], s["params_t"],
                                       tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"])),
                                      (JEngine, s["model_j"], s["params_j"], s["state"])):
        with pytest.raises(ValueError, match="telemetry=True"):
            cls(model, params, state, scheduler="continuous").write_trace(str(tmp_path / "x"))


def test_profile_window_writes_a_trace(pair, tmp_path):
    """``profile_dir``: a torch.profiler window over the first
    ``profile_steps`` dispatches, one "superstep" range each, written as a
    Chrome trace; spent once."""
    s = pair
    eng = ServingEngine(s["model_t"], s["params_t"],
                        tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                        scheduler="continuous", num_slots=3, max_new=6, learn=False,
                        profile_dir=str(tmp_path / "prof"), profile_steps=2)
    for uid, p, m in _reqs(s["cfg"]):
        eng.submit_request(Request(uid=uid, prompt=p, max_new=m))
    eng.run()
    assert eng.stats["dispatches"] > 2 and eng.profile_dir is None and eng._profile is None
    trace = json.loads((tmp_path / "prof" / "superstep_trace.json").read_text())
    ranges = [e for e in trace["traceEvents"] if e.get("name") == "superstep"]
    assert len(ranges) == 2


# ---------------------------------------------------------------------------
# 3) the load generator and the serve launcher
# ---------------------------------------------------------------------------

def test_load_gen_matches_the_reference():
    ref = _ref_load_gen()
    for seed, pattern in ((0, "poisson"), (3, "bursty")):
        a = load_gen.arrival_times(20, 8.0, pattern, np.random.default_rng(seed))
        b = ref.arrival_times(20, 8.0, pattern, np.random.default_rng(seed))
        assert a == b
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [load_gen.draw_len(ra, 24.0, 0.5, 4, 64) for _ in range(30)] == \
            [ref.draw_len(rb, 24.0, 0.5, 4, 64) for _ in range(30)]
    for mix in ("default:1", "gold:3,free:1", "solo"):
        assert load_gen.parse_mix(mix) == ref.parse_mix(mix)
    rng = np.random.default_rng(5)
    recs = []
    for i in range(12):
        outcome = ["completed", "cancelled", "rejected", "error"][i % 4]
        done = outcome == "completed"
        recs.append({"tenant": ["a", "b"][i % 2], "outcome": outcome,
                     "tokens": list(range(i % 5)),
                     "ttft_s": float(rng.random()) if done else None,
                     "tpot_s": float(rng.random()) / 10 if done else None,
                     "e2e_s": float(rng.random()) * 40 if done else None})
    args = argparse.Namespace(requests=12, rate=8.0, arrivals="poisson", tenants="a:1,b:1",
                              cancel_fraction=0.2, slo_ttft=0.5, slo_e2e=30.0,
                              workload_seed=0, smoke=False)
    assert load_gen.build_report(args, recs, 3.5) == ref.build_report(args, recs, 3.5)
    assert load_gen.SCHEMA_VERSION == ref.SCHEMA_VERSION


def test_serve_main_on_the_cpu(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    serve.main(["--pretrain-steps", "2", "--device", "cpu", "--requests", "6",
                "--num-slots", "3", "--batch-size", "3", "--max-new", "6", "--kv-pages", "48",
                "--prefill-chunk", "8", "--prefix-cache", "--adaptive-k", "--trace-out",
                str(trace), "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    for head in ("[serve]    3 reqs", "[serve] 6 completions", "[serve] request phases",
                 "[serve] dispatch:", "[serve] chunked prefill:", "[serve] paged KV:",
                 "[serve] prefix cache:", "[serve] adaptive K in [1,", "[serve] DVI train:",
                 "[serve] trace written", "[serve] metrics written"):
        assert head in out, head
    assert json.loads(trace.read_text())["traceEvents"]
    assert "dvi_serving_prefix_lookups_total" in json.loads(metrics.read_text())
