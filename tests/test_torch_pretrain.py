"""The port's training path against the JAX package, on vicuna-7b-tiny,
qwen3-0.6b-tiny (tied head) and mamba2-370m-tiny (tied head, the SSD scan
through ``ops.SsdScan``), in float32 on the CPU, from the same weights:
``forward_train``'s logits; ``lm_loss`` and its gradient in every trained
leaf against ``jax.grad`` (a tied model's head gradient on ``embed``, no
``lm_head`` in the tree); three ``make_pretrain_step`` steps (parameters,
moments, step, loss, gnorm); ``pretrain`` over a stream (the loss list);
two ``make_dvi_train_step`` steps (A, B, moments, baseline, metrics);
``remat=True`` gradients equal to ``remat=False``; the tied ``lm_head``
refreshed in place after a step.

Tolerances: logits rtol 1e-5 / atol 2e-5 (as tests/test_torch_model.py);
losses and metrics rtol 1e-5 / atol 1e-6; gradients and Adam's first moments
rtol 1e-5 with atol 1e-5 x the largest entry of the reference's leaf (the
two frameworks sum in different orders; the largest difference seen is
1-3e-6 of it), both doubled for the second moments (v is g^2).  Parameters after AdamW steps: rtol 1e-5 / atol 1e-6 on every entry
whose root-mean-square gradient (sqrt of the reference's v) is at least 1e-2
of its leaf's largest; Adam's step is the gradient's direction at size lr
however small the gradient, so on the entries below that the float32 noise
of g moves the step, and only the bound |difference| <= 2 lr x steps holds.

The reference's gradient through Mamba-2 is NaN at these weights: its
``ssd_chunked`` computes ``where(tri, exp(seg), 0)``, exp(seg) overflows
above the diagonal and the select's gradient multiplies 0 by inf (ROADMAP
§3).  ``test_reference_scan_gradient_is_nan`` shows it; the parity tests
hold the port against the reference with that one line as the port writes
it, ``exp(where(tri, seg, -inf))``, which gives the same values."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model, trained_tree  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

# the modules (each package's training/__init__ exports a function of the
# same name, `pretrain`)
jtrain = importlib.import_module("repro.training.pretrain")
ttrain = importlib.import_module("repro_torch.training.pretrain")

NAMES = ["vicuna-7b", "qwen3-0.6b", "mamba2-370m"]
RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5          # x the largest entry of the leaf
ADAM_FLOOR = 1e-2         # RMS gradient, x the leaf's largest, of a tight entry
NORMS = ("ln1", "ln2", "final_norm", "qn", "kn", "norm_w")
B, T = 2, 40              # mamba2-tiny: chunk 32, so T is padded to 64


def _perturb_norms(tree, rng):
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                    if k in NORMS else _perturb_norms(v, rng)) for k, v in tree.items()}
    return tree


def ssd_chunked_finite_grad(xh, Bc, Cc, dt, A, chunk: int, h0=None):
    """``repro.models.ssm.ssd_chunked`` line for line, its decay masked
    inside the exp (the same values, a finite gradient)."""
    B_, T, H, hd = xh.shape
    G, ds = Bc.shape[2], Bc.shape[3]
    nc = T // chunk
    rep = H // G
    f32 = jnp.float32
    xc = jnp.moveaxis(xh.reshape(B_, nc, chunk, H, hd), 1, 0).astype(f32)
    Bcc = jnp.moveaxis(jnp.repeat(Bc.reshape(B_, nc, chunk, G, ds), rep, axis=3), 1,
                       0).astype(f32)
    Ccc = jnp.moveaxis(jnp.repeat(Cc.reshape(B_, nc, chunk, G, ds), rep, axis=3), 1,
                       0).astype(f32)
    dtc = jnp.moveaxis(dt.reshape(B_, nc, chunk, H), 1, 0).astype(f32)
    tri = jnp.tril(jnp.ones((chunk, chunk), bool))

    def chunk_fn(h, inp):
        x_, B__, C__, dt_ = inp
        dA = dt_ * A[None, None, :]
        cum = jnp.cumsum(dA, axis=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        decay = jnp.exp(jnp.where(tri[None, :, :, None], seg, -jnp.inf))
        cb = jnp.einsum("bihs,bjhs->bijh", C__, B__)
        att = cb * decay * dt_[:, None, :, :]
        y = jnp.einsum("bijh,bjhd->bihd", att, x_)
        y = y + jnp.einsum("bihs,bhds,bih->bihd", C__, h, jnp.exp(cum))
        dec_out = jnp.exp(cum[:, -1:, :] - cum) * dt_
        chunk_state = jnp.einsum("bjh,bjhs,bjhd->bhds", dec_out, B__, x_)
        h = h * jnp.exp(cum[:, -1])[:, :, None, None] + chunk_state
        return h, y

    h_init = jnp.zeros((B_, H, hd, ds), f32) if h0 is None else h0.astype(f32)
    h_final, ys = jax.lax.scan(chunk_fn, h_init, (xc, Bcc, Ccc, dtc))
    return jnp.moveaxis(ys, 0, 1).reshape(B_, T, H, hd), h_final


@pytest.fixture
def finite_scan(monkeypatch):
    monkeypatch.setattr(jssm, "ssd_chunked", ssd_chunked_finite_grad)


def jflat(tree) -> dict:
    """The reference's tree flattened to "/"-joined paths."""
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().numpy() if torch.is_tensor(t) else t, np.float64)


def close(t, j, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def close_grad(t, j, what="", squared=False):
    """Gradients and first moments: rtol 1e-5, atol 1e-5 x the reference
    leaf's largest entry; both doubled for second moments (`squared`: v is
    g^2, so its relative error is twice g's)."""
    want = np.asarray(j, np.float64)
    k = 2 if squared else 1
    close(t, want, what, rtol=k * RTOL, atol=k * GRAD_ATOL * float(np.abs(want).max()))


def close_adam(t, j, v_j, lr: float, steps: int, what=""):
    """Parameters after `steps` AdamW steps of `lr`: tight where the RMS
    gradient sqrt(v) is at least ADAM_FLOOR of the leaf's largest, within
    2 lr x steps elsewhere."""
    got, want, rms = _np(t), np.asarray(j, np.float64), np.sqrt(np.asarray(v_j, np.float64))
    sure = rms >= ADAM_FLOOR * rms.max()
    np.testing.assert_allclose(got[sure], want[sure], rtol=RTOL, atol=ATOL, err_msg=what)
    assert np.all(np.abs(got - want) <= 2 * lr * steps), what


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    cfg_j = tiny_cfg(name)
    model_j = jax_build_model(cfg_j)
    params_j = _perturb_norms(model_j.init(jax.random.PRNGKey(0)), np.random.default_rng(1))
    cfg_t = get_config(name, tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    tokens = np.random.default_rng(2).integers(2, cfg_t.vocab_size, size=(B, T)).astype(np.int32)
    return dict(model_j=model_j, params_j=params_j, model_t=model_t, tokens=tokens,
                np_params=jax.tree.map(np.asarray, params_j))


def _params_t(pair):
    """A fresh copy of the reference's weights in the port (steps write in
    place)."""
    return weights.params_from_numpy(pair["model_t"].cfg, pair["np_params"], "cpu")


def test_forward_train_matches(pair):
    logits_j, aux_j = pair["model_j"].forward_train(pair["params_j"],
                                                    jnp.asarray(pair["tokens"]))
    logits_t, aux_t = pair["model_t"].forward_train(_params_t(pair),
                                                    torch.from_numpy(pair["tokens"]))
    assert logits_t.shape == logits_j.shape and aux_t.dtype == torch.float32
    close(logits_t, logits_j, "logits", atol=2e-5)
    assert float(aux_t) == float(aux_j) == 0.0


def test_lm_loss_and_gradients_match(pair, finite_scan):
    tokens = pair["tokens"]
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jtrain.lm_loss(pair["model_j"], p, jnp.asarray(tokens)),
        has_aux=True)(pair["params_j"])
    params_t = _params_t(pair)
    lt, mt, gt = ttrain.loss_and_grads(pair["model_t"], params_t, torch.from_numpy(tokens))
    close(lt, lj, "loss")
    close(mt["nll"], mj["nll"], "nll")
    gj = jflat(gj)
    assert set(gt) == set(gj) == set(flatten(trained_tree(pair["model_t"].cfg, params_t)))
    if pair["model_t"].cfg.tie_embeddings:
        assert "lm_head" not in gt and "lm_head" in params_t
    for k, g in gt.items():
        close_grad(g, gj[k], f"d{k}")
    assert float(gt["embed"].abs().max()) > 0.0


def test_pretrain_steps_match(pair, finite_scan):
    """Three steps, each from the reference's state: after a step is
    compared, the reference's parameters and moments are copied into the
    port's tensors (in place), so a difference Adam amplified in one step
    does not feed the next one's gradient."""
    tokens = [np.random.default_rng(10 + i).integers(2, pair["model_t"].cfg.vocab_size,
                                                     size=(B, T)).astype(np.int32)
              for i in range(3)]
    step_j = jtrain.make_pretrain_step(pair["model_j"], 1e-3, donate=False)
    pj, sj = pair["params_j"], jadamw.adamw_init(pair["params_j"])
    step_t = ttrain.make_pretrain_step(pair["model_t"], 1e-3)
    pt = _params_t(pair)
    st = ttrain.init_pretrain_state(pair["model_t"], pt)
    ptrs = {k: v.data_ptr() for k, v in flatten(pt).items()}
    for i, tok in enumerate(tokens):
        pj, sj, mj = step_j(pj, sj, jnp.asarray(tok))
        pt2, st2, mt = step_t(pt, st, torch.from_numpy(tok))
        assert pt2 is pt and st2 is st
        close(mt["loss"], mj["loss"], f"loss {i}")
        close(mt["gnorm"], mj["gnorm"], f"gnorm {i}")
        flat_j, m_j, v_j = jflat(pj), jflat(sj["m"]), jflat(sj["v"])
        flat_t = flatten(trained_tree(pair["model_t"].cfg, pt))
        assert set(flat_t) == set(flat_j) == set(st["m"]) == set(m_j)
        for k in flat_t:
            close_adam(flat_t[k], flat_j[k], v_j[k], 1e-3, 1, f"{k} {i}")
            close_grad(st["m"][k], m_j[k], f"m/{k} {i}")
            close_grad(st["v"][k], v_j[k], f"v/{k} {i}", squared=True)
            flat_t[k].copy_(torch.from_numpy(flat_j[k]))
            st["m"][k].copy_(torch.from_numpy(m_j[k]))
            st["v"][k].copy_(torch.from_numpy(v_j[k]))
        assert int(st["step"]) == int(sj["step"]) == i + 1
    assert {k: v.data_ptr() for k, v in flatten(pt).items()} == ptrs


def test_tied_head_refreshed_in_place(pair):
    cfg = pair["model_t"].cfg
    pt = _params_t(pair)
    head = pt["lm_head"]
    ptr = head.data_ptr()
    step = ttrain.make_pretrain_step(pair["model_t"], 1e-2)
    step(pt, ttrain.init_pretrain_state(pair["model_t"], pt), torch.from_numpy(pair["tokens"]))
    assert pt["lm_head"] is head and head.data_ptr() == ptr and head.is_contiguous()
    if cfg.tie_embeddings:
        assert torch.equal(head, pt["embed"].T)
        assert not torch.equal(head, torch.tensor(pair["np_params"]["embed"]).T)
    else:
        assert not torch.equal(head, torch.tensor(pair["np_params"]["lm_head"]))


def test_pretrain_loss_list_matches(pair, finite_scan):
    V = pair["model_t"].cfg.vocab_size
    batches = [np.random.default_rng(20 + i).integers(2, V, size=(B, T)).astype(np.int32)
               for i in range(3)]
    # a copy: the reference's step donates its parameters
    _, losses_j = jtrain.pretrain(pair["model_j"], jax.tree.map(jnp.array, pair["params_j"]),
                                  [jnp.asarray(b) for b in batches], lr=2e-3)
    pt = _params_t(pair)
    pt2, losses_t = ttrain.pretrain(pair["model_t"], pt, batches, lr=2e-3)
    assert pt2 is pt and len(losses_t) == len(losses_j) == 3
    assert all(isinstance(x, float) for x in losses_t)
    close(losses_t, losses_j, "losses")


def test_remat_gradients_equal(pair):
    pt = _params_t(pair)
    tok = torch.from_numpy(pair["tokens"])
    l0, _, g0 = ttrain.loss_and_grads(pair["model_t"], pt, tok, remat=False)
    l1, _, g1 = ttrain.loss_and_grads(pair["model_t"], pt, tok, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


DVI_KEYS = ("loss", "kl", "l_pg", "l_ce", "entropy", "acc_rate", "lam_pg", "lam_kl", "gnorm")


def test_dvi_train_steps_match(pair, finite_scan):
    cfg = pair["model_t"].cfg
    rng = np.random.default_rng(7)
    dvi_np = {"A": (rng.standard_normal((cfg.d_model, cfg.dvi.lora_rank))
                    / np.sqrt(cfg.d_model)).astype(np.float32),
              "B": (rng.standard_normal((cfg.dvi.lora_rank, cfg.vocab_size)) * 0.05
                    ).astype(np.float32)}
    tokens = [rng.integers(2, cfg.vocab_size, size=(B, 12)).astype(np.int32) for _ in range(2)]
    step_j = jtrain.make_dvi_train_step(pair["model_j"], lr=1e-3, mode="full")
    dj = {k: jnp.asarray(v) for k, v in dvi_np.items()}
    oj, bj = jadamw.adamw_init(dj), jnp.float32(0.1)
    step_t = ttrain.make_dvi_train_step(pair["model_t"], lr=1e-3, mode="full")
    pt = _params_t(pair)
    before = {k: v.clone() for k, v in flatten(pt).items()}
    dt = {k: torch.tensor(v) for k, v in dvi_np.items()}
    ot, bt = adamw_init(dt), torch.tensor(0.1)
    for i, tok in enumerate(tokens):
        t = 350 + i                                  # inside the KL->RL ramp
        dj, oj, bj, mj = step_j(pair["params_j"], dj, oj, jnp.asarray(tok), jnp.int32(t), bj)
        dt, ot, bt, mt = step_t(pt, dt, ot, torch.from_numpy(tok), t, bt)
        for k in DVI_KEYS:
            close(mt[k], mj[k], f"{k} {i}", atol=1e-5)
        close(bt, bj, f"baseline {i}")
    for k in ("A", "B"):
        close(dt[k], dj[k], k, atol=1e-5)
        close_grad(ot["m"][k], oj["m"][k], f"m/{k}")
        close_grad(ot["v"][k], oj["v"][k], f"v/{k}", squared=True)
    assert int(ot["step"]) == int(oj["step"]) == 2
    assert all(torch.equal(v, before[k]) for k, v in flatten(pt).items())


def test_reference_scan_gradient_is_nan():
    """The reference's own gradient through mamba2-370m-tiny at the parity
    tests' weights and tokens is NaN (its masked exp), where the port's is
    finite; the repaired copy agrees with the reference's values."""
    cfg_j = tiny_cfg("mamba2-370m")
    model_j = jax_build_model(cfg_j)
    params_j = _perturb_norms(model_j.init(jax.random.PRNGKey(0)), np.random.default_rng(1))
    tokens = jnp.asarray(np.random.default_rng(2).integers(2, cfg_j.vocab_size, size=(B, T)),
                         jnp.int32)
    grads = jax.grad(lambda p: jtrain.lm_loss(model_j, p, tokens)[0])(params_j)
    assert np.isnan(np.asarray(grads["segments"]["s0"]["A_log"])).any()
    rng = np.random.default_rng(3)
    xh = jnp.asarray(rng.standard_normal((1, 64, 4, 8)), jnp.float32)
    bc = jnp.asarray(rng.standard_normal((1, 64, 1, 8)), jnp.float32)
    dt = jnp.full((1, 64, 4), 2.0)
    A = -jnp.linspace(1.0, 16.0, 4)
    for a, b in zip(jssm.ssd_chunked(xh, bc, bc, dt, A, 64),
                    ssd_chunked_finite_grad(xh, bc, bc, dt, A, 64)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    params_t = weights.params_from_numpy(
        get_config("mamba2-370m", tiny=True).replace(dtype="float32"),
        jax.tree.map(np.asarray, params_j), "cpu")
    model_t = build_model(get_config("mamba2-370m", tiny=True).replace(dtype="float32"),
                          device="cpu")
    _, _, gt = ttrain.loss_and_grads(model_t, params_t, torch.from_numpy(np.asarray(tokens)))
    assert all(bool(torch.isfinite(g).all()) for g in gt.values())
