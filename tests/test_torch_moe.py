"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe``, on llama4-scout-17b-a16e-tiny's experts in float32:
``moe_ffn`` with capacity drops (a capacity factor small enough that
experts overflow) and dropless (C = N, the block-decode path), top-1 and
top-2 routing, the auxiliary loss, and the ranks of both branches of
``expert_ranks`` (one-hot cumulative sum and stable sort) against each
other and the reference's.

Inputs are made with numpy from a seed; the router's logits are float32
on both sides, so the routing is equal and the outputs are held to rtol
1e-5 / atol 2e-5, the ranks to equality."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

NAME = "llama4-scout-17b-a16e"
RTOL, ATOL = 1e-5, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def experts():
    cfg_j = tiny_cfg(NAME)
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    p_j = jax.tree.map(lambda v: v[0], params_j["segments"]["s0"]["moe"])
    cfg_t = get_config(NAME, tiny=True).replace(dtype="float32")
    p_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, p_j), "cpu")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, p_j=p_j, p_t=p_t)


def _mo_pair(cfg_j, cfg_t, **kw):
    mj = dataclasses.replace(cfg_j.moe, **kw)
    mt = MoEConfig(**dataclasses.asdict(mj))
    return mj, mt


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dropless,capacity_factor", [(False, 0.5), (False, 8.0),
                                                      (True, 0.5)])
def test_moe_ffn_matches(experts, top_k, dropless, capacity_factor):
    """(B, T) = (3, 12): 36 tokens over 4 experts.  At capacity factor 0.5
    the full path keeps 8 (top-1, the reference's floor) or 9 (top-2) rows
    an expert, fewer than an even share, so tokens drop; dropless keeps
    every one."""
    e = experts
    mj, mt = _mo_pair(e["cfg_j"], e["cfg_t"], top_k=top_k, capacity_factor=capacity_factor)
    x = np.random.default_rng(top_k).standard_normal((3, 12, e["cfg_t"].d_model)) \
        .astype(np.float32)
    y_j, aux_j = jmoe.moe_ffn(e["p_j"], jnp.asarray(x), mj, e["cfg_j"].act, e["cfg_j"].glu,
                              dropless)
    y_t, aux_t = tmoe.moe_ffn(e["p_t"], _t(x), mt, e["cfg_t"].act, e["cfg_t"].glu, dropless)
    _close(y_j, y_t)
    _close(aux_j, aux_t)
    if not dropless and capacity_factor < 1:
        # tokens did drop: the dropless output differs
        y_all, _ = tmoe.moe_ffn(e["p_t"], _t(x), mt, e["cfg_t"].act, e["cfg_t"].glu, True)
        assert not torch.allclose(y_all, y_t)
        assert tmoe.capacity(36, mt, False) < 36 * top_k / mt.num_experts


@pytest.mark.parametrize("Nk,E", [(1, 4), (37, 4), (300, 16), (1000, 3)])
def test_expert_ranks_branches_agree(Nk, E):
    """The one-hot branch and the sort branch give the same ranks, and the
    reference's (its branch picked by its own threshold)."""
    flat_e = np.random.default_rng(Nk).integers(0, E, Nk).astype(np.int32)
    one_hot = tmoe.expert_ranks(_t(flat_e), E, one_hot_limit=1 << 30)
    by_sort = tmoe.expert_ranks(_t(flat_e), E, one_hot_limit=0)
    assert torch.equal(one_hot.long(), by_sort.long())
    want = np.asarray(jmoe._expert_ranks(jnp.asarray(flat_e), E))
    np.testing.assert_array_equal(one_hot.numpy(), want)
    # each row's rank counts the earlier rows of its expert
    for i in range(0, Nk, max(1, Nk // 7)):
        assert int(one_hot[i]) == int((flat_e[:i] == flat_e[i]).sum())


def test_reference_sort_branch_matches():
    """Past the reference's threshold (Nk * E > 2^22) both packages take
    the sort; the ranks agree."""
    Nk, E = 1 << 18, 32
    flat_e = np.random.default_rng(5).integers(0, E, Nk).astype(np.int32)
    got = tmoe.expert_ranks(_t(flat_e), E)
    want = np.asarray(jmoe._expert_ranks(jnp.asarray(flat_e), E))
    np.testing.assert_array_equal(got.numpy(), want)


def test_shapes_depend_on_token_count_alone(experts):
    """Every intermediate's shape follows from N: two inputs of one shape
    routed differently run the same shapes (a CUDA graph replays them)."""
    e = experts
    mt = e["cfg_t"].moe
    assert tmoe.capacity(40, mt, True) == 40
    assert tmoe.capacity(40, mt, False) == max(8, int(np.ceil(40 / mt.num_experts
                                                              * mt.capacity_factor)))
    x = torch.zeros((2, 5, e["cfg_t"].d_model))
    y, aux = tmoe.moe_ffn(e["p_t"], x, mt, e["cfg_t"].act, e["cfg_t"].glu, True)
    assert tuple(y.shape) == (2, 5, e["cfg_t"].d_model) and aux.ndim == 0
