"""The telemetry contract's gate on the port: drained continuous runs of
the port's engine (paged and learning; paged, adaptive and chunked;
contiguous, learning, adaptive and chunked) write their metrics as a JSON
snapshot and as Prometheus text (``write_metrics``), and both checkers
pass them, the reference's ``scripts/check_metrics_schema.py`` and the
port's ``scripts/torch_check_metrics_schema.py``: every required metric at
its type, the per-block histograms reconciled exactly with the counters
they shadow, the lifecycle counters with the completions.  The checkers
are not vacuous: a counter moved off its histogram fails both.
vicuna-7b-tiny in float32 on the CPU."""
import copy
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lora  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = {
    "paged_learning": dict(kv_pages=40, kv_page_size=4, cache_len=40, learn=True),
    "paged_adaptive_chunked": dict(kv_pages=40, kv_page_size=4, cache_len=40, learn=False,
                                   adaptive_k=True, prefill_chunk=4),
    "learning_adaptive_chunked": dict(learn=True, adaptive_k=True, prefill_chunk=4),
}


def _checker(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def checkers():
    return [_checker("check_metrics_schema"), _checker("torch_check_metrics_schema")]


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(2, cfg.vocab_size, size=int(rng.choice([6, 11, 17])))
                    .astype(np.int32), max_new=int(rng.choice([6, 10])))
            for i in range(6)]
    return model, params, dvi, reqs


@pytest.mark.parametrize("cell", list(CELLS))
def test_both_checkers_pass_a_drained_run(setup, checkers, tmp_path, monkeypatch, cell):
    model, params, dvi, reqs = setup
    state = (tonline.init_trainer(model, torch.Generator().manual_seed(3))
             if CELLS[cell]["learn"] else tonline.init_trainer(model, dvi_params=dvi))
    eng = ServingEngine(model, params, state, scheduler="continuous", num_slots=3, max_new=10,
                        sync_every=2, update_every=2, **CELLS[cell])
    for r in reqs:
        eng.submit_request(r)
    assert len(eng.run(max_steps=2000)) == len(reqs) and not eng.busy
    assert eng.stats["dispatches"] > 0
    assert (eng.stats["updates"] > 0) == CELLS[cell]["learn"]
    assert (eng.stats["prefill_chunks"] > 0) == ("prefill_chunk" in CELLS[cell])
    eng.train_telemetry()                        # fold a staged update's metrics
    paths = [str(tmp_path / "metrics.json"), str(tmp_path / "metrics.prom")]
    for path in paths:
        eng.write_metrics(path)
    for chk in checkers:
        for path in paths:
            snaps = chk.extract_snapshots(path)
            assert len(snaps) == 1
            for label, snap in snaps.items():
                assert chk.check_snapshot(snap, label) == [], (chk.__name__, path)
            monkeypatch.setattr(sys, "argv", [chk.__name__, path])
            chk.main()                           # raises SystemExit on a failure
        # the reconciliation is checked, not skipped: a drafted count off its
        # histogram's sum fails
        bad = copy.deepcopy(eng.metrics_snapshot())
        bad["dvi_serving_drafted_tokens_total"]["value"] += 1
        errs = chk.check_snapshot(bad, "bad")
        assert len(errs) == 1 and "dvi_serving_block_depth" in errs[0], chk.__name__
