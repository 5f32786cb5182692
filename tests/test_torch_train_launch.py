"""The port's training launcher, checkpoints and quickstart on the CPU:
each launcher mode through ``main([..., "--device", "cpu"])`` at a few
steps on the tiny configs; the pretrain mode's losses against the
reference's ``pretrain`` on the stream its launcher builds, from the same
weights; ``.npz`` checkpoints and LoRA checkpoints written by one package
and read by the other (float32, exact), and a bfloat16 round trip within
the port (bit for bit, as 2-byte void on disk); ``examples/torch_quickstart.py``
at a shrunken size (lossless against AR).

Losses: rtol 1e-5 / atol 1e-6 (float32, the two frameworks sum in
different orders); checkpoints are exact."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data import SyntheticTasks as JTasks  # noqa: E402
from repro.data import TASK_CATEGORIES  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.training import pretrain as jax_pretrain  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, load_lora, save_checkpoint, save_lora  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import build_model, trained_tree  # noqa: E402
from repro_torch.tree import flatten, unflatten  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("arch", ["vicuna-7b", "qwen3-0.6b", "mamba2-370m"])
def test_pretrain_mode_writes_a_checkpoint(arch, tmp_path):
    path = str(tmp_path / "backbone.npz")
    out = train.main(["--arch", arch, "--tiny", "--mode", "pretrain", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt", path])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    model, params = out["model"], out["params"]
    with np.load(path) as data:
        assert set(data.files) == set(flatten(trained_tree(model.cfg, params)))
    loaded = weights.load_npz(model.cfg, path, "cpu")
    for k, v in flatten(params).items():
        assert torch.equal(flatten(loaded)[k], v), k


def test_pretrain_mode_matches_the_reference_launcher():
    """The launcher's pretrain mode (lr 2e-3, the stream at seed + 1) from
    the reference's weights gives the reference's losses on the same
    stream."""
    cfg_j = tiny_cfg("vicuna-7b")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params_j)   # the reference's step donates them
    tasks = JTasks(cfg_j.vocab_size, seed=0)
    _, losses_j = jax_pretrain(model_j, params_j,
                               tasks.stream(TASK_CATEGORIES, 3, 2, 16, seed=1), lr=2e-3)
    args = train.parse_args(["--arch", "vicuna-7b", "--tiny", "--mode", "pretrain",
                             "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu"])
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, np_params, "cpu")
    out = train.run(args, model_t, params_t)
    np.testing.assert_allclose(out["losses"], losses_j, rtol=RTOL, atol=ATOL)


def test_dvi_batch_mode(tmp_path):
    path = str(tmp_path / "lora.npz")
    seen = []
    out = train.run(train.parse_args(
        ["--arch", "vicuna-7b", "--tiny", "--mode", "dvi-batch", "--steps", "3",
         "--pretrain-steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt", path]), on_step=lambda i, m: seen.append((i, float(m["loss"]))))
    assert [i for i, _ in seen] == [0, 1, 2] and np.isfinite([x for _, x in seen]).all()
    assert np.isfinite([float(v) for v in out["metrics"].values()]).all()
    state = out["state"]
    dvi, step, baseline = load_lora(path, state.dvi_params)
    assert (step, baseline) == (0, 0.0)            # as the reference's launcher writes it
    for k in ("A", "B"):
        assert torch.equal(dvi[k], state.dvi_params[k])
    assert float(state.dvi_params["B"].abs().max()) > 0.0


def test_dvi_online_mode(tmp_path):
    path = str(tmp_path / "lora.npz")
    out = train.main(["--arch", "qwen3-0.6b", "--tiny", "--mode", "dvi-online", "--prompts",
                      "8", "--batch", "4", "--pretrain-steps", "2", "--max-new", "8",
                      "--device", "cpu", "--ckpt", path])
    hist, state = out["history"], out["state"]
    assert len(hist["mat"]) == 2 and all(m >= 1.0 for m in hist["mat"])
    dvi, step, _ = load_lora(path, state.dvi_params)
    assert step == int(state.step) == 2 and torch.equal(dvi["B"], state.dvi_params["B"])


def test_launcher_defaults_match_the_reference():
    args = train.parse_args([])
    assert (args.arch, args.mode, args.steps, args.prompts, args.batch, args.seq,
            args.max_new, args.lr, args.loss_mode, args.pretrain_steps, args.seed, args.ckpt,
            args.dtype, args.device) == ("vicuna-7b", "dvi-online", 200, 200, 8, 32, 24,
                                         1e-3, "full", 200, 0, "", "float32", None)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["vicuna-7b", "mamba2-370m"])
def pair(request):
    cfg_j = tiny_cfg(request.param)
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    cfg_t = get_config(request.param, tiny=True).replace(dtype="float32")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_t, params_j, params_t


def test_port_checkpoint_read_by_the_reference(pair, tmp_path):
    cfg_t, params_j, params_t = pair
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, trained_tree(cfg_t, params_t))
    like = jax.tree.map(jnp.zeros_like, params_j)
    got = jckpt.load_checkpoint(path, like)
    for path_j, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "/".join(str(p.key) for p in path_j)
        np.testing.assert_array_equal(np.asarray(leaf), flatten(params_t)[key].numpy())


def test_reference_checkpoint_read_by_the_port(pair, tmp_path):
    cfg_t, params_j, params_t = pair
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, params_j)
    like = {k: torch.zeros_like(v) for k, v in flatten(trained_tree(cfg_t, params_t)).items()}
    got = load_checkpoint(path, unflatten(like))
    for k, v in flatten(got).items():
        assert v.dtype == torch.float32 and torch.equal(v, flatten(params_t)[k]), k


def test_lora_checkpoints_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    dvi_np = {"A": rng.standard_normal((16, 4)).astype(np.float32),
              "B": rng.standard_normal((4, 32)).astype(np.float32)}
    dvi_t = {k: torch.tensor(v) for k, v in dvi_np.items()}
    save_lora(str(tmp_path / "port.npz"), dvi_t, 17, 0.25)
    got, step, baseline = jckpt.load_lora(str(tmp_path / "port.npz"),
                                          {k: jnp.zeros_like(v) for k, v in dvi_np.items()})
    assert (step, baseline) == (17, 0.25)
    for k in dvi_np:
        np.testing.assert_array_equal(np.asarray(got[k]), dvi_np[k])
    jckpt.save_lora(str(tmp_path / "ref.npz"), {k: jnp.asarray(v) for k, v in dvi_np.items()},
                    9, 0.5)
    got, step, baseline = load_lora(str(tmp_path / "ref.npz"),
                                    {k: torch.zeros_like(v) for k, v in dvi_t.items()})
    assert (step, baseline) == (9, 0.5)
    for k in dvi_np:
        assert torch.equal(got[k], dvi_t[k])


def test_bf16_round_trip_within_the_port(tmp_path):
    cfg = get_config("vicuna-7b", tiny=True)
    assert cfg.dtype == "bfloat16"
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    path = str(tmp_path / "bf16.npz")
    save_checkpoint(path, trained_tree(cfg, params))
    with np.load(path) as data:
        assert data["segments/s0/wq"].dtype.str == "|V2"
        assert data["final_norm"].dtype == np.float32
    like = {k: torch.empty_like(v) for k, v in flatten(trained_tree(cfg, params)).items()}
    got = flatten(load_checkpoint(path, unflatten(like)))
    for k, v in flatten(trained_tree(cfg, params)).items():
        assert got[k].dtype == v.dtype, k
        bits = (lambda t: t.view(torch.int16)) if v.dtype == torch.bfloat16 else (lambda t: t)
        assert torch.equal(bits(got[k]), bits(v)), k
    loaded = weights.load_npz(cfg, path, "cpu")
    assert torch.equal(loaded["lm_head"], params["lm_head"])


def test_quickstart_small_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--pretrain-steps", "20", "--batches", "4"])
    assert out["lossless"] is True
    assert len(out["losses"]) == 20 and np.isfinite(out["losses"]).all()
    assert out["mat_trained"] >= 1.0 and out["ar_s"] > 0 and out["dvi_s"] > 0
