"""The port against the JAX package in bfloat16, on the CPU: vicuna-7b-tiny
in its own bf16 dtype, the same weights on both sides (carried by
``weights.params_from_numpy`` and ``draft_params_from_numpy``), one greedy
``spec_block_step`` from the same numpy-seeded prompts.

The port's verifier and drafter compare float32 logits (its kernels'
contract, as the Pallas kernels'), while the reference's model path takes
``jnp.argmax`` of logits rounded to bf16.  So a committed token may differ,
but only where the reference's bf16 top-2 logits there are a near-tie:
within tests/test_kernels.py's bf16 tolerance (rtol 2e-2, taken against
max(|top-1|, 1)).  Each lane is compared up to its first difference; past
it the two sides condition on different prefixes.

The online loss in bf16: the port rounds the normed float32 buffer rows to
bf16 before both heads (its kernel takes h and W in one dtype, and no
float32 copy of W is made), where the reference multiplies float32 rows by
the bf16 head.  ``test_online_loss_in_bf16_measures_the_hn_cast`` bounds
the logits' difference by that rounding and checks the loss terms."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import lora as jlora  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lora as tlora  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

BF16_RTOL = 2e-2                 # tests/test_kernels.py's bf16 logits tolerance
B, TP = 6, 12


@pytest.fixture(scope="module")
def block():
    cfg_j = jax_get_config("vicuna-7b", tiny=True)
    assert cfg_j.dtype == "bfloat16"
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    # the deep layers' residual branches scaled down, as in
    # tests/test_torch_spec.py, so drafts are accepted and a block commits
    # more than its bonus token
    segs = dict(params_j["segments"])
    for sg in jtfm.segments_in_range(cfg_j, cfg_j.dvi.split_layer, cfg_j.num_layers):
        segs[sg.name] = {key: w * 0.1 if key in ("wo", "wo_ff") else w
                         for key, w in segs[sg.name].items()}
    params_j = dict(params_j, segments=segs)
    dvi_j = jlora.init_draft_params(jax.random.PRNGKey(5), cfg_j)
    dvi_j = dict(dvi_j, B=jax.random.normal(jax.random.PRNGKey(11), dvi_j["B"].shape) * 0.01)
    cfg_t = get_config("vicuna-7b", tiny=True)
    assert cfg_t.torch_dtype == torch.bfloat16
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    dvi_t = weights.draft_params_from_numpy(jax.tree.map(np.asarray, dvi_j), "cpu")
    prompts = np.random.default_rng(3).integers(2, cfg_t.vocab_size,
                                                size=(B, TP)).astype(np.int32)
    cap = TP + cfg_t.dvi.k_spec + 2
    _, cache_j, _ = model_j.prefill(params_j, jnp.asarray(prompts[:, :-1]), max_len=cap)
    _, cache_t = model_t.prefill(params_t, torch.from_numpy(prompts[:, :-1]), max_len=cap)
    bj = jspec.spec_block_step(model_j, params_j, dvi_j, jnp.asarray(prompts[:, -1]), cache_j)
    bt = tspec.spec_block_step(model_t, params_t, dvi_t, torch.from_numpy(prompts[:, -1]),
                               cache_t)
    return dict(model_j=model_j, params_j=params_j, prompts=prompts, bj=bj, bt=bt,
                model_t=model_t, params_t=params_t, dvi_j=dvi_j, dvi_t=dvi_t)


def _ref_top2(s, prefix: np.ndarray) -> tuple:
    """The reference's bf16 top-2 logits for the token after `prefix`."""
    h, _, _ = s["model_j"].prefill(s["params_j"], jnp.asarray(prefix[None]))
    logits = s["model_j"].logits(s["params_j"], h[:, -1]).astype(jnp.float32)[0]
    top = jax.lax.top_k(logits, 2)[0]
    return float(top[0]), float(top[1])


def test_committed_tokens_differ_only_at_bf16_near_ties(block):
    s = block
    acc_j = np.asarray(s["bj"].accept)
    acc_t = s["bt"].accept.numpy()
    vec_j = np.asarray(s["bj"].commit_vec)
    vec_t = s["bt"].commit_vec.numpy()
    assert (acc_j >= 1).all() and (acc_t >= 1).all()
    for b in range(B):
        n = min(int(acc_j[b]), int(acc_t[b]))
        diff = np.nonzero(vec_j[b, :n] != vec_t[b, :n])[0]
        if len(diff) == 0:
            continue
        p = int(diff[0])
        t1, t2 = _ref_top2(s, np.concatenate([s["prompts"][b], vec_j[b, :p]]))
        assert t1 - t2 <= BF16_RTOL * max(abs(t1), 1.0), (
            f"lane {b}: token {p} differs ({vec_j[b, p]} vs {vec_t[b, p]}) outside a bf16 "
            f"near-tie: reference top-2 {t1} / {t2}")


def test_block_ran_in_bf16_on_both_sides(block):
    """The hiddens of the verify pass come out in bf16 on both sides, with
    the same shapes, so the test above compares bf16 paths."""
    bj, bt = block["bj"], block["bt"]
    assert bt.hL_blk.dtype == torch.bfloat16 and bj.hL_blk.dtype == jnp.bfloat16
    assert tuple(bt.hL_blk.shape) == bj.hL_blk.shape
    assert tuple(bt.commit_vec.shape) == bj.commit_vec.shape


def test_online_loss_in_bf16_measures_the_hn_cast(block):
    """The draft and verifier logits of the online loss on 64 float32
    buffer rows, port against reference in bf16.  Each logit differs by at
    most 2^-8 x sum_i |hn_i| |W_iv| (hn's bf16 rounding, 2^-9 relative, with
    room for the float32 sums): measured, the largest difference is 0.0075
    (draft) and 0.0071 (verifier), 0.16 % of the largest logit (4.65, 4.47).  The loss terms
    agree within the bf16 tolerance, the batch acceptance exactly."""
    s = block
    rng = np.random.default_rng(8)
    N, cfg = 64, s["model_t"].cfg
    batch = {"h_k": rng.standard_normal((N, cfg.d_model)).astype(np.float32),
             "h_L": rng.standard_normal((N, cfg.d_model)).astype(np.float32),
             "action": rng.integers(0, cfg.vocab_size, N).astype(np.int32),
             "reward": (rng.random(N) < 0.5).astype(np.float32),
             "mask": (rng.random(N) < 0.9).astype(np.float32)}
    tj = jlosses.loss_terms(s["model_j"], s["params_j"], s["dvi_j"],
                            {k: jnp.asarray(v) for k, v in batch.items()})
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    tt = tlosses.loss_terms(s["model_t"], s["params_t"], s["dvi_t"], bt)
    w = s["model_t"].head_matrix(s["params_t"]).float()
    for name, got, want, h in (
            ("draft", tlora.draft_logits(s["model_t"], s["params_t"], s["dvi_t"], bt["h_k"]),
             jlora.draft_logits(s["model_j"], s["params_j"], s["dvi_j"],
                                jnp.asarray(batch["h_k"])), bt["h_k"]),
            ("verifier", tlosses.verifier_logits(s["model_t"], s["params_t"], bt["h_L"]),
             jlosses.verifier_logits(s["model_j"], s["params_j"], jnp.asarray(batch["h_L"])),
             bt["h_L"])):
        want = torch.tensor(np.asarray(want, np.float32))
        hn = rms_norm(h, s["params_t"]["final_norm"], cfg.norm_eps)
        bound = 2.0 ** -8 * (hn.abs() @ w.abs())
        diff = (got.detach() - want).abs()
        assert bool((diff <= bound).all()), name
        assert float(diff.max()) <= 2e-3 * float(want.abs().max()), name
    for key in ("kl_tau", "kl_1", "l_pg", "l_ce", "entropy"):
        np.testing.assert_allclose(float(tt[key]), float(tj[key]), rtol=BF16_RTOL, err_msg=key)
    assert float(tt["acc_rate"]) == float(tj["acc_rate"])
