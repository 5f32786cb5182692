"""The port's Improve loop against the JAX package, piece by piece, on the
same numpy-seeded inputs (vicuna-7b-tiny in float32, CPU): the replay
buffer's ``sample`` (indices pinned) and ``fresh_batch`` (exact), the KL->RL
schedules, AdamW and the learning-rate schedules, the gradient of the
differentiable ``lora_logits`` against ``jax.grad`` of the reference's
``draft_logits``, every ``loss_terms`` / ``composite_loss`` output and its
gradient in all four modes at a warmup, a ramp and an rl step, one
``make_update_fn`` step with both samplers pinned to the same indices,
``dense_train_losses``, and three batches of ``online_loop``.

Float32 tolerance on losses and gradients: rtol 1e-5, atol 1e-6 (the two
frameworks sum in different orders); where a gradient's entries reach far
above 1, atol is taken against its largest entry (1e-6 x max |g|), since an
entry near 0 is then a difference of large float32 terms."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import buffer as jbuffer  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import online as jonline  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import buffer as tbuffer  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
STEPS = (0, 199, 200, 400, 599, 600, 5000)
# a warmup, a ramp and an rl step of the tiny config's schedule (200 + 400)
PHASE_STEPS = {"warmup": 3, "ramp": 350, "rl": 900}
MODES = ("kl", "pg", "ce", "full")
N_BUF, COUNT, PTR, GEN = 512, 300, 300, 5


def close(t, j, what="", rtol=RTOL, atol=ATOL, scaled=False):
    """`t` (port) against `j` (reference); with `scaled`, atol x max(1, max |j|)."""
    want = np.asarray(j, np.float64)
    if scaled:
        atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(t.detach().numpy() if torch.is_tensor(t) else t,
                                          np.float64), want, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def setup():
    """The tiny model on both sides with the same weights (deep residuals
    x0.1, so drafts are accepted), a LoRA head with B != 0, and a replay
    buffer of COUNT tuples of random numpy data, as dicts on each side."""
    cfg_j = tiny_cfg("vicuna-7b")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    segs = dict(params_j["segments"])
    for s in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        segs[s.name] = dict(segs[s.name], wo=segs[s.name]["wo"] * 0.1,
                            wo_ff=segs[s.name]["wo_ff"] * 0.1)
    params_j = dict(params_j, segments=segs)
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(0)
    d, V, r = cfg_t.d_model, cfg_t.vocab_size, cfg_t.dvi.lora_rank
    dvi_np = {"A": (rng.standard_normal((d, r)) / np.sqrt(d)).astype(np.float32),
              "B": (rng.standard_normal((r, V)) * 0.05).astype(np.float32)}
    buf_np = {
        "h_k": rng.standard_normal((N_BUF, d)).astype(np.float32),
        "h_L": rng.standard_normal((N_BUF, d)).astype(np.float32),
        "action": rng.integers(0, V, N_BUF).astype(np.int32),
        "reward": (rng.random(N_BUF) < 0.6).astype(np.float32),
        "pos": rng.integers(1, 5, N_BUF).astype(np.int32),
        "prev": rng.integers(0, V, N_BUF).astype(np.int32),
        "age": np.where(rng.random(N_BUF) < 0.3, GEN - 1,
                        rng.integers(0, GEN - 1, N_BUF)).astype(np.int32),
        "ptr": np.int32(PTR), "count": np.int32(COUNT), "gen": np.int32(GEN)}
    return dict(cfg=cfg_t, model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_t, dvi_np=dvi_np, buf_np=buf_np)


def jbuf(buf_np):
    return {k: jnp.asarray(v) for k, v in buf_np.items()}


def tbuf(buf_np):
    return {k: torch.tensor(np.asarray(v)) for k, v in buf_np.items()}


def pinned_idx(count, n, xp):
    """The indices both pinned samplers draw: a fixed spread over [0, count)."""
    return (xp.arange(n) * 37 + 11) % xp.maximum(count, 1)


def pin_samplers(monkeypatch):
    """Pin ``repro.core.buffer.sample``'s draw and replace the port's
    ``sample`` by ``rows_at`` at the same indices."""
    real = jbuffer.sample

    def j_sample(buf, key, n):
        randint = jax.random.randint
        jax.random.randint = lambda key, shape, lo, hi: pinned_idx(hi, n, jnp)
        try:
            return real(buf, key, n)
        finally:
            jax.random.randint = randint

    def t_sample(buf, gen, n):
        cnt = torch.clamp(buf["count"].long(), min=1)
        return tbuffer.rows_at(buf, (torch.arange(n) * 37 + 11) % cnt)

    monkeypatch.setattr(jbuffer, "sample", j_sample)
    monkeypatch.setattr(tbuffer, "sample", t_sample)


def assert_batch_equal(bt, bj):
    assert bt.keys() == bj.keys()
    for k in bj:
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the replay buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 7, COUNT, N_BUF])
def test_sample_rows_match_reference_at_pinned_indices(setup, monkeypatch, count):
    buf_np = dict(setup["buf_np"], count=np.int32(count))
    pin_samplers(monkeypatch)
    bj = jbuffer.sample(jbuf(buf_np), jax.random.PRNGKey(0), 64)
    bt = tbuffer.sample(tbuf(buf_np), torch.Generator(), 64)
    assert_batch_equal(bt, bj)
    assert float(bt["mask"].sum()) == (0 if count == 0 else 64)


def test_sample_draws_uniform_ranks(setup):
    """The port's own draw: ranks in [0, count) (all masked on an empty
    ring), reproducible from the generator, covering the ring."""
    buf = tbuf(setup["buf_np"])
    a = tbuffer.sample(buf, torch.Generator().manual_seed(3), 4096)
    b = tbuffer.sample(buf, torch.Generator().manual_seed(3), 4096)
    assert_batch_equal(a, b)
    # the slot of each sampled row, found by its (unique) first h_k entry
    first = {float(x): i for i, x in enumerate(setup["buf_np"]["h_k"][:, 0])}
    slots = np.array([first[float(x)] for x in a["h_k"][:, 0]])
    ranks = (PTR - 1 - slots) % N_BUF
    assert (ranks < COUNT).all() and bool((a["mask"] == 1).all())
    assert len(set(ranks.tolist())) > COUNT * 0.9     # 4096 draws reach nearly every rank
    empty = tbuffer.sample(dict(buf, count=torch.tensor(0, dtype=torch.int32)),
                           torch.Generator(), 8)
    assert float(empty["mask"].sum()) == 0.0


@pytest.mark.parametrize("n", [1, 64, 300, 512])
def test_fresh_batch_is_exact(setup, n):
    bj = jbuffer.fresh_batch(jbuf(setup["buf_np"]), n)
    bt = tbuffer.fresh_batch(tbuf(setup["buf_np"]), n)
    assert_batch_equal(bt, bj)
    assert 0 < float(bt["mask"].sum()) < n or n == 1


def test_buffer_reads_in_place(setup):
    """sample and fresh_batch leave every ring tensor as it was."""
    buf = tbuf(setup["buf_np"])
    before = {k: (v.data_ptr(), v.clone()) for k, v in buf.items()}
    tbuffer.sample(buf, torch.Generator(), 32)
    tbuffer.fresh_batch(buf, 32)
    for k, (ptr, val) in before.items():
        assert buf[k].data_ptr() == ptr and torch.equal(buf[k], val), k


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", STEPS)
def test_schedules_match(setup, t):
    dvi = setup["cfg"].dvi
    jdvi = setup["model_j"].cfg.dvi
    for got, want in zip(tsched.lambda_schedule(t, dvi), jsched.lambda_schedule(t, jdvi)):
        close(got, want, "lambda")
    close(tsched.beta_schedule(t, dvi), jsched.beta_schedule(t, jdvi), "beta")
    close(tsched.policy_gate(t, dvi), jsched.policy_gate(t, jdvi), "gate")
    tt = torch.tensor(t, dtype=torch.int32)           # a device step works alike
    close(tsched.beta_schedule(tt, dvi), jsched.beta_schedule(t, jdvi), "beta(tensor)")
    assert tsched.phase_info(t, dvi) == jsched.phase_info(t, jdvi)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3], ids=["clipping", "no-clipping"])
def test_adamw_three_steps_match(max_norm):
    rng = np.random.default_rng(1)
    params = {"A": rng.standard_normal((16, 4)).astype(np.float32),
              "B": rng.standard_normal((4, 32)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = jadamw.adamw_init(pj)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    ptrs = {k: v.data_ptr() for k, v in pt.items()}
    st = tadamw.adamw_init(pt)
    for g in grads:
        pj, sj, gn_j = jadamw.adamw_update(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj,
                                           1e-2, weight_decay=0.1, max_norm=max_norm)
        gn_t = tadamw.adamw_update(pt, {k: torch.tensor(v) for k, v in g.items()}, st, 1e-2,
                                   weight_decay=0.1, max_norm=max_norm)
        close(gn_t, gn_j, "gnorm")
    for k in params:
        close(pt[k], pj[k], k)
        close(st["m"][k], sj["m"][k], f"m/{k}")
        close(st["v"][k], sj["v"][k], f"v/{k}")
        assert pt[k].data_ptr() == ptrs[k]
    assert int(st["step"]) == int(sj["step"]) == 3


def test_adamw_writes_into_out():
    """With `out` the new values land there; the parameters stay as they
    were and the moments advance as without it."""
    p = {"A": torch.ones(3, 2)}
    g = {"A": torch.full((3, 2), 0.5)}
    out = {"A": torch.zeros(3, 2)}
    st, st2 = tadamw.adamw_init(p), tadamw.adamw_init(p)
    tadamw.adamw_update(p, g, st, 0.1, out=out)
    assert torch.equal(p["A"], torch.ones(3, 2))
    p2 = {"A": torch.ones(3, 2)}
    tadamw.adamw_update(p2, g, st2, 0.1)
    assert torch.equal(out["A"], p2["A"]) and torch.equal(st["m"]["A"], st2["m"]["A"])


@pytest.mark.parametrize("step", [0, 5, 10, 37, 100, 150])
def test_lr_schedules_match(step):
    close(tadamw.cosine_schedule(3e-4, 100)(step), jadamw.cosine_schedule(3e-4, 100)(step))
    close(tadamw.linear_warmup_cosine(3e-4, 10, 100)(step),
          jadamw.linear_warmup_cosine(3e-4, 10, 100)(step))


# ---------------------------------------------------------------------------
# the differentiable lora_logits and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 9, 64])
def test_lora_logits_gradient_matches_jax(setup, T):
    """d/dA, d/dB of sum(G * draft_logits) through the kernel's wrapper (on
    the CPU its plain version in the forward, the LoraLogits backward)
    against jax.grad of the reference's draft_logits."""
    rng = np.random.default_rng(T)
    cfg = setup["cfg"]
    h = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    G = rng.standard_normal((T, cfg.vocab_size)).astype(np.float32)

    def jloss(dp):
        return jnp.sum(jnp.asarray(G) * jlora.draft_logits(
            setup["model_j"], setup["params_j"], dp, jnp.asarray(h)))

    dvi_j = {k: jnp.asarray(v) for k, v in setup["dvi_np"].items()}
    val_j, gj = jax.value_and_grad(jloss)(dvi_j)
    dvi_t = {k: torch.tensor(v, requires_grad=True) for k, v in setup["dvi_np"].items()}
    val_t = (torch.tensor(G) * tlora.draft_logits(setup["model_t"], setup["params_t"], dvi_t,
                                                  torch.tensor(h))).sum()
    val_t.backward()
    close(val_t, val_j, "value", scaled=True)
    for k in ("A", "B"):
        close(dvi_t[k].grad, gj[k], k, scaled=True)


def test_lora_logits_backward_against_autograd_of_plain_version():
    """The LoraLogits backward against autograd through ref.lora_logits; h
    and w get no gradient; without a recorded gradient it is the plain
    forward."""
    g = torch.Generator().manual_seed(0)
    h, w = torch.randn(7, 32, generator=g), torch.randn(32, 50, generator=g)
    a = torch.randn(32, 3, generator=g, requires_grad=True)
    b = torch.randn(3, 50, generator=g, requires_grad=True)
    G = torch.randn(7, 50, generator=g)
    (ops.lora_logits(h, w, a, b, 2.0) * G).sum().backward()
    da, db = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    (ref.lora_logits(h, w, a, b, 2.0) * G).sum().backward()
    torch.testing.assert_close(da, a.grad, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(db, b.grad, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        out = ops.lora_logits(h, w, a, b, 2.0)
    assert not out.requires_grad and torch.equal(out, ref.lora_logits(h, w, a, b, 2.0))


def _batches(setup, n=48):
    """A buffer minibatch and a fresh batch as numpy dicts (masks with
    zeros, rewards with both values)."""
    out = []
    for seed in (1, 2):
        idx = np.random.default_rng(seed).choice(COUNT, n, replace=False)
        b = {k: setup["buf_np"][k][idx] for k in ("h_k", "h_L", "action", "reward")}
        b["mask"] = (np.random.default_rng(seed + 10).random(n) < 0.8).astype(np.float32)
        out.append(b)
    return out


TERM_KEYS = ("kl_tau", "kl_1", "l_pg", "l_ce", "entropy", "act_logp", "acc_rate")
METRIC_KEYS = ("loss", "kl", "l_pg", "l_ce", "entropy", "acc_rate", "lam_pg", "lam_kl",
               "pg_on", "beta", "gate")


def test_loss_terms_match(setup):
    batch, _ = _batches(setup)
    dvi_j = {k: jnp.asarray(v) for k, v in setup["dvi_np"].items()}
    dvi_t = {k: torch.tensor(v) for k, v in setup["dvi_np"].items()}
    tj = jlosses.loss_terms(setup["model_j"], setup["params_j"], dvi_j,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tt = tlosses.loss_terms(setup["model_t"], setup["params_t"], dvi_t,
                            {k: torch.tensor(v) for k, v in batch.items()})
    for k in TERM_KEYS:
        close(tt[k], tj[k], k)
    close(tlosses.verifier_logits(setup["model_t"], setup["params_t"],
                                  torch.tensor(batch["h_L"])),
          jlosses.verifier_logits(setup["model_j"], setup["params_j"],
                                  jnp.asarray(batch["h_L"])), "verifier_logits",
          atol=1e-5)


@pytest.mark.parametrize("phase", list(PHASE_STEPS))
@pytest.mark.parametrize("mode", MODES)
def test_composite_loss_and_gradient_match(setup, mode, phase):
    t = PHASE_STEPS[phase]
    batch, fresh = _batches(setup)
    baseline = 0.4

    def jloss(dp):
        return jlosses.composite_loss(
            dp, setup["model_j"], setup["params_j"],
            {k: jnp.asarray(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in fresh.items()}, t, jnp.float32(baseline), mode)

    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in setup["dvi_np"].items()})
    dvi_t = {k: torch.tensor(v, requires_grad=True) for k, v in setup["dvi_np"].items()}
    lt, mt = tlosses.composite_loss(
        dvi_t, setup["model_t"], setup["params_t"],
        {k: torch.tensor(v) for k, v in batch.items()},
        {k: torch.tensor(v) for k, v in fresh.items()},
        torch.tensor(t, dtype=torch.int32), torch.tensor(baseline), mode)
    lt.backward()
    close(lt, lj, "loss")
    for k in METRIC_KEYS:
        close(mt[k], mj[k], k)
    for k in ("A", "B"):
        close(dvi_t[k].grad, gj[k], f"d{k}")


def test_update_step_matches_with_pinned_samplers(setup, monkeypatch):
    """One make_update_fn step on each side from the same state, both
    samplers pinned to the same indices: metrics, new A and B, moments,
    baseline and step; every state tensor written in place."""
    pin_samplers(monkeypatch)
    cfg = setup["cfg"]
    upd_j = jonline.make_update_fn(setup["model_j"], "full", 1e-3)
    dvi_j = {k: jnp.asarray(v) for k, v in setup["dvi_np"].items()}
    t0 = PHASE_STEPS["ramp"]
    new_j, opt_j, base_j, mj = upd_j(setup["params_j"], dvi_j, jadamw.adamw_init(dvi_j),
                                     jbuf(setup["buf_np"]), jnp.float32(0.3), jnp.int32(t0),
                                     jax.random.PRNGKey(0))
    dvi_t = {k: torch.tensor(v) for k, v in setup["dvi_np"].items()}
    state = tonline.OnlineTrainerState(dvi_t, tadamw.adamw_init(dvi_t), tbuf(setup["buf_np"]),
                                       torch.tensor(0.3), torch.tensor(t0, dtype=torch.int32))
    tensors = [dvi_t["A"], dvi_t["B"], state.baseline, state.step, state.opt_state["step"],
               *state.opt_state["m"].values(), *state.opt_state["v"].values()]
    ptrs = [x.data_ptr() for x in tensors]
    mt = tonline.make_update_fn(setup["model_t"], "full", 1e-3)(
        setup["params_t"], state, torch.Generator())
    for k in METRIC_KEYS + ("gnorm", "baseline_before", "baseline_after", "buffer_count"):
        close(mt[k], mj[k], k)
    for k in ("A", "B"):
        close(state.dvi_params[k], new_j[k], k)
        close(state.opt_state["m"][k], opt_j["m"][k], f"m/{k}")
        close(state.opt_state["v"][k], opt_j["v"][k], f"v/{k}", atol=1e-9)
    close(state.baseline, base_j, "baseline")
    assert int(state.step) == t0 + 1 and int(state.opt_state["step"]) == 1
    assert [x.data_ptr() for x in tensors] == ptrs
    assert state.dvi_params["A"] is dvi_t["A"] and cfg.dvi.batch_size == 64


@pytest.mark.parametrize("mode", ["full", "kl"])
def test_dense_train_losses_match(setup, mode):
    tokens = np.random.default_rng(4).integers(2, setup["cfg"].vocab_size,
                                               size=(2, 12)).astype(np.int32)

    def jloss(dp):
        return jlosses.dense_train_losses(setup["model_j"], setup["params_j"], dp,
                                          jnp.asarray(tokens), 350, jnp.float32(0.2), mode)

    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in setup["dvi_np"].items()})
    dvi_t = {k: torch.tensor(v, requires_grad=True) for k, v in setup["dvi_np"].items()}
    lt, mt = tlosses.dense_train_losses(setup["model_t"], setup["params_t"], dvi_t,
                                        torch.tensor(tokens), 350, torch.tensor(0.2), mode)
    lt.backward()
    close(lt, lj, "loss", atol=1e-5)
    for k in METRIC_KEYS:
        close(mt[k], mj[k], k, atol=1e-5)
    for k in ("A", "B"):
        close(dvi_t[k].grad, gj[k], f"d{k}", atol=1e-5)
    with pytest.raises(NotImplementedError, match="item 15"):
        tlosses.dense_train_losses(setup["model_t"], setup["params_t"], dvi_t,
                                   torch.tensor(tokens), 0, 0.0, aux_inputs={})


def test_online_loop_three_batches_match(setup, monkeypatch):
    """Three batches of online_loop on each side from the same trainer
    state, samplers pinned: the same history, A and B, buffer and step."""
    pin_samplers(monkeypatch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, setup["cfg"].vocab_size, size=(3, 8)).astype(np.int32)
               for _ in range(3)]
    state_j = jonline.init_trainer(setup["model_j"], jax.random.PRNGKey(2))
    state_j.dvi_params = {k: jnp.asarray(v) for k, v in setup["dvi_np"].items()}
    state_j, hist_j = jonline.online_loop(setup["model_j"], setup["params_j"],
                                          [jnp.asarray(p) for p in prompts], state_j,
                                          max_new=8)
    state_t = tonline.init_trainer(setup["model_t"], torch.Generator())
    for k, v in setup["dvi_np"].items():
        state_t.dvi_params[k].copy_(torch.tensor(v))
    state_t, hist_t = tonline.online_loop(setup["model_t"], setup["params_t"], prompts,
                                          state_t, max_new=8)
    assert hist_t.keys() == hist_j.keys()
    assert hist_t["block_acc"] == hist_j["block_acc"] and hist_t["mat"] == hist_j["mat"]
    for k in ("acc_rate", "loss", "kl"):
        close(hist_t[k], hist_j[k], k)
    for k in ("A", "B"):
        close(state_t.dvi_params[k], state_j.dvi_params[k], k, atol=1e-5)
    for k in ("ptr", "count", "gen", "action", "reward", "pos", "prev", "age"):
        np.testing.assert_array_equal(state_t.buf[k].numpy(), np.asarray(state_j.buf[k]), k)
    assert int(state_t.step) == int(state_j.step) == 3
    assert tlora.num_trainable(state_t.dvi_params) == jlora.num_trainable(state_j.dvi_params)
