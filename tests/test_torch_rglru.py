"""The port's RG-LRU block (``repro_torch.models.rglru``) against
``repro.models.rglru``, on recurrentgemma-9b-tiny's first layer in float32:
the parallel scan against a sequential recurrence, the full-sequence block
(``associative_scan`` on the reference's side) at T below, at and across
the scan's chunk, its continuation from a carried conv window and state
(``conv_state``/``h0``) equal to one pass, the step path's per-token
candidates, their independence of the block length, and ``take``.

Inputs are made with numpy from a seed.  The scan computes exp(L_t - L_s)
from float32 cumulative sums where the reference multiplies the decays
pairwise, so the orders of the float32 sums differ: outputs and states are
held to rtol 1e-5 / atol 2e-5 (the measured gap is under 3e-6 at these
sizes); the step path runs the reference's own arithmetic per token and is
held to the same tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

NAME = "recurrentgemma-9b"
RTOL, ATOL = 1e-5, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def layer():
    """Layer 0 of the tiny config's first segment (an RG-LRU block) on both
    sides, its norm gain random so the (1 + w) convention is exercised."""
    cfg_j = tiny_cfg(NAME)
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    sp = dict(params_j["segments"]["s0"])
    sp["ln1"] = jnp.asarray(np.random.default_rng(1).standard_normal(sp["ln1"].shape)
                            .astype(np.float32) * 0.1)
    p_j = {k: v[0] for k, v in sp.items()}
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32")
    p_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, p_j), "cpu")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, p_j=p_j, p_t=p_t)


@pytest.mark.parametrize("T", [1, 16, 37, 300])
def test_linear_scan_matches_recurrence(T):
    """The chunked scan (recursing over chunks at T = 300) against the
    sequential recurrence in float64."""
    rng = np.random.default_rng(T)
    log_a = -np.abs(rng.standard_normal((2, T, 8))).astype(np.float32) * 3
    b = rng.standard_normal((2, T, 8)).astype(np.float32)
    h = np.zeros((2, 8))
    want = []
    for t in range(T):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + b[:, t]
        want.append(h)
    _close(np.stack(want, 1), trg.linear_scan(_t(log_a), _t(b)))


def test_gates_match(layer):
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 5, layer["cfg_t"].rglru.lru_width)).astype(np.float32)
    a_j, b_j = jrg._gates(layer["p_j"], jnp.asarray(u))
    log_a, b_t = trg._gates(layer["p_t"], _t(u))
    _close(a_j, torch.exp(log_a))
    _close(b_j, b_t)


@pytest.mark.parametrize("T", [7, 16, 45])
def test_forward_full_matches(layer, T):
    cfg = layer["cfg_t"]
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    out_j, con_j = jrg.rglru_forward_full(layer["p_j"], jnp.asarray(x), layer["cfg_j"].rglru,
                                          cfg.norm_eps)
    out_t, con_t = trg.rglru_forward_full(layer["p_t"], _t(x), cfg.rglru, cfg.norm_eps)
    _close(out_j, out_t)
    _close(con_j["conv"], con_t["conv"])
    _close(con_j["state"], con_t["state"])
    assert con_t["state"].dtype == torch.float32


def test_continuation_equals_one_pass(layer):
    """Two passes of 20 and 25 tokens, the second from the first's conv
    window and state, give one pass of 45 tokens; the reference's
    continuation gives the same."""
    cfg = layer["cfg_t"]
    x = np.random.default_rng(5).standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    out, con = trg.rglru_forward_full(layer["p_t"], _t(x), cfg.rglru, cfg.norm_eps)
    o1, c1 = trg.rglru_forward_full(layer["p_t"], _t(x[:, :20]), cfg.rglru, cfg.norm_eps)
    o2, c2 = trg.rglru_forward_full(layer["p_t"], _t(x[:, 20:]), cfg.rglru, cfg.norm_eps,
                                    conv_state=c1["conv"], h0=c1["state"])
    _close(out.numpy(), torch.cat([o1, o2], dim=1))
    _close(con["state"].numpy(), c2["state"])
    _close(con["conv"].numpy(), c2["conv"])
    j1, jc1 = jrg.rglru_forward_full(layer["p_j"], jnp.asarray(x[:, :20]), layer["cfg_j"].rglru,
                                     cfg.norm_eps)
    j2, jc2 = jrg.rglru_forward_full(layer["p_j"], jnp.asarray(x[:, 20:]), layer["cfg_j"].rglru,
                                     cfg.norm_eps, conv_state=jc1["conv"], h0=jc1["state"])
    _close(j2, o2)
    _close(jc2["state"], c2["state"])


def _cache(cfg, seed):
    rng = np.random.default_rng(seed)
    w = cfg.rglru.lru_width
    return (rng.standard_normal((2, cfg.rglru.d_conv - 1, w)).astype(np.float32),
            rng.standard_normal((2, w)).astype(np.float32))


def test_step_candidates_match(layer):
    """Five tokens from a nonzero conv window and state: the output and the
    window and state after each token; the cache itself is untouched."""
    cfg = layer["cfg_t"]
    conv, state = _cache(cfg, 3)
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    out_j, cand_j = jrg.rglru_step(layer["p_j"], jnp.asarray(x),
                                   {"conv": jnp.asarray(conv), "state": jnp.asarray(state)},
                                   layer["cfg_j"].rglru, cfg.norm_eps)
    cache_t = {"conv": _t(conv), "state": _t(state)}
    out_t, cand_t = trg.rglru_step(layer["p_t"], _t(x), cache_t, cfg.rglru, cfg.norm_eps)
    _close(out_j, out_t)
    assert tuple(cand_t["conv"].shape) == (2, 5, cfg.rglru.d_conv - 1, cfg.rglru.lru_width)
    assert tuple(cand_t["state"].shape) == (2, 5, cfg.rglru.lru_width)
    _close(cand_j["conv"], cand_t["conv"])
    _close(cand_j["state"], cand_t["state"])
    np.testing.assert_array_equal(cache_t["state"].numpy(), state)


def test_step_is_token_by_token_and_take(layer):
    """A block of five tokens gives bit for bit what five chained one-token
    steps give; with `take` it returns the candidate at take-1 (the cache's
    own where take is 0)."""
    cfg = layer["cfg_t"]
    conv, state = _cache(cfg, 6)
    x = _t(np.random.default_rng(7).standard_normal((2, 5, cfg.d_model)).astype(np.float32))
    cache = {"conv": _t(conv), "state": _t(state)}
    out, cand = trg.rglru_step(layer["p_t"], x, cache, cfg.rglru, cfg.norm_eps)
    c = cache
    for t in range(5):
        o, cd = trg.rglru_step(layer["p_t"], x[:, t:t + 1], c, cfg.rglru, cfg.norm_eps)
        assert torch.equal(o[:, 0], out[:, t])
        for key in ("conv", "state"):
            assert torch.equal(cd[key][:, 0], cand[key][:, t])
        c = {key: cd[key][:, 0] for key in cd}
    take = torch.tensor([3, 0], dtype=torch.int32)
    out2, sel = trg.rglru_step(layer["p_t"], x, cache, cfg.rglru, cfg.norm_eps, take=take)
    assert torch.equal(out2, out)
    assert torch.equal(sel["state"][0], cand["state"][0, 2])
    assert torch.equal(sel["conv"][0], cand["conv"][0, 2])
    assert torch.equal(sel["state"][1], cache["state"][1])
    assert torch.equal(sel["conv"][1], cache["conv"][1])
