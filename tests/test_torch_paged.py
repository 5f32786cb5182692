"""The port's paged KV layout against the JAX package, on the CPU in float32:
the addressing rule, the host-side page pool, the paged attention kernel's
plain version (against the jnp oracle, the interpret-mode Pallas kernel and
the reference model path's step mask), and the paged transformer step with
the lane surgery the continuous engine runs (insert, reset, table edits).
Tolerances as tests/test_kernels.py: attention atol 2e-5, hiddens rtol 1e-5 /
atol 2e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread keeps the test workers, which share
# the cores, from oversubscribing them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import kv_pool as jpool  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import kv_pool as tpool  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _pair(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _tables(rng, B, MPS, P, mapped):
    """Block tables over a shuffled (non-contiguous) page assignment: lane b
    maps its first mapped[b] logical pages to distinct physical pages >= 1;
    the rest stay -1."""
    perm = rng.permutation(np.arange(1, P))
    tbl = np.full((B, MPS), -1, np.int32)
    i = 0
    for b in range(B):
        tbl[b, :mapped[b]] = perm[i:i + mapped[b]]
        i += mapped[b]
    return tbl


# ---------------------------------------------------------------------------
# the addressing rule and the page pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [1, 4, 16])
def test_logical_to_physical_matches_jax(ps):
    rng = np.random.default_rng(ps)
    B, MPS = 4, 6
    tbl = _tables(rng, B, MPS, 40, [6, 3, 0, 5])
    tbl[0, 2] = -1                                   # unmapped mid-row
    pos = rng.integers(0, MPS * ps + 9, size=(B, 11))  # some past the table
    page_j, phys_j = jpool.logical_to_physical(jnp.asarray(tbl), jnp.asarray(pos), ps)
    page_t, phys_t = tpool.logical_to_physical(torch.from_numpy(tbl), torch.from_numpy(pos), ps)
    np.testing.assert_array_equal(page_t.numpy(), np.asarray(page_j))
    np.testing.assert_array_equal(phys_t.numpy(), np.asarray(phys_j))


def _pool_state(pool):
    return (list(pool._free), dict(pool._owned), dict(pool._ref), dict(pool._cached),
            dict(pool._index), pool.peak_used, pool.alloc_calls, pool.free_calls,
            pool.failed_allocs, pool.evictions, pool.prefix_hits, pool.prefix_misses)


def test_kv_pool_random_ops_match_jax():
    """A random sequence of alloc / ensure / free / prefix lookups and
    publishes leaves the port's KVPool and the reference's in one state."""
    rng = np.random.default_rng(0)
    pj, pt = jpool.KVPool(24, 4), tpool.KVPool(24, 4)
    live, uid = [], 0
    prompts = [rng.integers(2, 9, size=int(n)).tolist() for n in rng.integers(3, 14, size=6)]
    for _ in range(300):
        op = rng.integers(0, 5)
        if op == 0 or not live:
            n = int(rng.integers(0, 5))
            out = [p.alloc(n, owner=uid) for p in (pj, pt)]
            assert out[0] == out[1]
            if out[0] is not None:
                live.append(uid)
            uid += 1
        elif op == 1:
            o = live[int(rng.integers(len(live)))]
            n = int(rng.integers(0, 8))
            assert pj.ensure(o, n) == pt.ensure(o, n)
        elif op == 2:
            o = live.pop(int(rng.integers(len(live))))
            assert pj.free(o) == pt.free(o)
        elif op == 3:
            toks = prompts[int(rng.integers(len(prompts)))]
            hits = [p.acquire_prefix(uid, toks) for p in (pj, pt)]
            assert dataclasses.astuple(hits[0]) == dataclasses.astuple(hits[1])
            if hits[0].pages:
                live.append(uid)
            uid += 1
        else:
            o = live[int(rng.integers(len(live)))]
            toks = prompts[int(rng.integers(len(prompts)))]
            assert pj.publish_prefix(o, toks) == pt.publish_prefix(o, toks)
        assert _pool_state(pj) == _pool_state(pt)
        assert pj.utilization(7) == pt.utilization(7)


# ---------------------------------------------------------------------------
# the plain version of paged_decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ps", [4, 16])
def test_paged_attention_matches_jax_oracle(G, ps):
    rng = np.random.default_rng(G * ps)
    B, KV, hd, MPS, P = 3, 2, 16, 5, 20
    tbl = _tables(rng, B, MPS, P, [5, 4, 3])
    tbl[0, 1] = -1                                   # unmapped mid-row
    lens = np.array([5 * ps - 2, 3 * ps + 1, 2 * ps], np.int32)
    qj, qt = _pair(rng, B, KV * G, hd)
    kj, kt = _pair(rng, P, ps, KV, hd)
    vj, vt = _pair(rng, P, ps, KV, hd)
    out_j = jref.ref_paged_decode_attention(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl))
    out_t = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(tbl))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)


def test_paged_attention_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    B, KV, G, hd, ps, MPS, P = 2, 2, 2, 16, 4, 4, 12
    tbl = _tables(rng, B, MPS, P, [4, 3])
    tbl[1, 1] = -1
    lens = np.array([15, 10], np.int32)
    qj, qt = _pair(rng, B, KV * G, hd)
    kj, kt = _pair(rng, P, ps, KV, hd)
    vj, vt = _pair(rng, P, ps, KV, hd)
    out_p = jops.paged_decode_attention(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl))
    out_t = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(tbl))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_p), atol=ATOL)


def _step_state(rng, B, MPS, ps, T):
    """A paged cache as the model path leaves it mid-block: lengths before
    the block, shuffled tables with a -1 entry mid-row, one lane whose
    block writes past the table, and the reference's step mask over the
    gathered view (slot valid when mapped and j < lengths + T; pos <= qpos)."""
    P = B * MPS + 1
    tbl = _tables(rng, B, MPS, P, [MPS] * B)
    tbl[0, 1] = -1
    before = rng.integers(1, MPS * ps - T, size=B)
    before[-1] = MPS * ps - 2                        # writes run past the table
    L = MPS * ps
    j = np.arange(L)
    page = np.take_along_axis(tbl, j[None, :].repeat(B, 0) // ps, axis=1)
    slot_pos = np.where((page >= 0) & (j[None, :] < before[:, None] + T), j[None, :], -1)
    qpos = before[:, None] + np.arange(T)[None, :]
    ref_mask = (slot_pos[:, None, :] <= qpos[:, :, None]) & (slot_pos[:, None, :] >= 0)
    return P, tbl, before.astype(np.int32), ref_mask


@pytest.mark.parametrize("ps", [4, 16])
def test_block_limits_equal_reference_step_mask(ps):
    """The port's form (mapped, j < len_post - (Tq-1-t), j < MPS*ps) equals
    the reference's paged step mask, with stale speculative slots, a -1
    entry mid-row and a block that writes past the table."""
    rng = np.random.default_rng(ps)
    B, MPS, T = 16, 5, 5
    _, tbl, before, ref_mask = _step_state(rng, B, MPS, ps, T)
    L = MPS * ps
    j = np.arange(L)
    page = np.take_along_axis(tbl, j[None, :].repeat(B, 0) // ps, axis=1)
    lim = np.minimum((before + T)[:, None] - (T - 1 - np.arange(T))[None, :], L)
    port_mask = (page >= 0)[:, None, :] & (j[None, None, :] < lim[:, :, None])
    np.testing.assert_array_equal(port_mask, ref_mask)


@pytest.mark.parametrize("G,ps", [(1, 4), (4, 16), (2, 1)])
def test_paged_block_matches_attend_step_mask(G, ps):
    """The Tq = K+1 block form against the reference model path: layers.attend
    over the gathered logical view under the step mask; Tq = 1 is the last
    query of the block."""
    rng = np.random.default_rng(G + ps)
    B, KV, hd, T = 3, 2, 16, 5
    MPS = 4 if ps > 1 else 12
    P, tbl, before, ref_mask = _step_state(rng, B, MPS, ps, T)
    qj, qt = _pair(rng, B, T, KV * G, hd)
    kj, kt = _pair(rng, P, ps, KV, hd)
    vj, vt = _pair(rng, P, ps, KV, hd)
    L = MPS * ps
    _, phys = jpool.logical_to_physical(jnp.asarray(tbl),
                                        jnp.broadcast_to(jnp.arange(L)[None], (B, L)), ps)
    out_j = jl.attend(qj, kj.reshape(P * ps, KV, hd)[phys], vj.reshape(P * ps, KV, hd)[phys],
                      jnp.asarray(ref_mask))
    lens = torch.from_numpy(before + T)
    out_t = ops.paged_decode_attention(qt, kt, vt, lens, torch.from_numpy(tbl))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    one = ops.paged_decode_attention(qt[:, -1], kt, vt, lens, torch.from_numpy(tbl))
    np.testing.assert_allclose(one.numpy(), out_t[:, -1].numpy(), atol=ATOL)


def test_idle_lane_is_finite():
    """A lane of length 0 with an all -1 row (idle or preempted) reads only
    masked slots: finite, never NaN."""
    q = torch.randn(2, 1, 4, 8)
    kp = torch.randn(5, 4, 2, 8)
    tbl = torch.tensor([[1, 2], [-1, -1]], dtype=torch.int32)
    out = ops.paged_decode_attention(q, kp, kp, torch.tensor([6, 1], dtype=torch.int32), tbl)
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the paged transformer step and the lane surgery
# ---------------------------------------------------------------------------

PS, MPS, NPAGES, B = 4, 8, 30, 3
PROMPT_LENS = [9, 6, 0]                 # the last lane stays idle


@pytest.fixture(scope="module")
def pair():
    cfg_j = tiny_cfg("vicuna-7b")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = weights.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg_t.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    perm = rng.permutation(np.arange(1, NPAGES + 1))
    rows = np.full((B, MPS), -1, np.int32)
    rows[0, :5] = perm[:5]
    rows[1, :3] = perm[5:8]
    rows[1, 4] = perm[8]                 # mapped past an unmapped entry
    return cfg_j, model_j, params_j, cfg_t, model_t, params_t, prompts, rows


def _admit_both(pair):
    """Map rows, prefill each prompt into a prompt-sized scratch and splice
    it into the paged cache, on both sides."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t, prompts, rows = pair
    cj = model_j.init_paged_cache(B, NPAGES, PS, MPS)
    ct = model_t.init_paged_cache(B, NPAGES, PS, MPS)
    for b, p in enumerate(prompts):
        if not len(p):
            continue
        cj = jtfm.map_slot_pages(cj, jnp.int32(b), jnp.asarray(rows[b]))
        ct = tfm.map_slot_pages(ct, b, torch.from_numpy(rows[b]))
        _, pj, _ = model_j.prefill(params_j, jnp.asarray(p[None]), max_len=len(p))
        _, pt = model_t.prefill(params_t, torch.from_numpy(p[None]), max_len=len(p))
        cj = jtfm.insert_slot(cfg_j, cj, pj, jnp.int32(b))
        ct = tfm.insert_slot(cfg_t, ct, pt, b)
    return cj, ct


def _mapped_kv_equal(cj, ct, lanes=range(B)):
    """lengths and tables equal; K/V equal at every mapped slot below each
    lane's length."""
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    np.testing.assert_array_equal(ct["tbl"].numpy(), np.asarray(cj["tbl"]))
    tbl, lens = ct["tbl"].numpy(), ct["lengths"].numpy()
    for name, seg in ct["segs"].items():
        for key in ("kp", "vp"):
            got, want = seg[key].numpy(), np.asarray(cj["segs"][name][key])
            for b in lanes:
                for t in range(int(lens[b])):
                    page = tbl[b, t // PS]
                    if page >= 0:
                        np.testing.assert_allclose(got[:, page, t % PS], want[:, page, t % PS],
                                                   rtol=RTOL, atol=ATOL)


def test_insert_slot_and_tables_match_jax(pair):
    cj, ct = _admit_both(pair)
    _mapped_kv_equal(cj, ct)
    assert ct["lengths"].tolist() == [9, 6, 0]
    # the batched table push replaces every row at once
    rows = pair[-1].copy()
    rows[2, :2] = [NPAGES, NPAGES - 1]
    cj = jtfm.set_block_tables(cj, jnp.asarray(rows))
    ct = tfm.set_block_tables(ct, torch.from_numpy(rows))
    np.testing.assert_array_equal(ct["tbl"].numpy(), np.asarray(cj["tbl"]))


def test_paged_steps_match_jax(pair):
    """A draft feed (T = 1, layers [0, k)) then a verify block (T = K+1,
    layers [k, L)) over the paged cache: hiddens of the live lanes and the
    K/V at every mapped slot equal the reference; then commit and reset."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t, prompts, rows = pair
    k, L, K = cfg_t.dvi.split_layer, cfg_t.num_layers, cfg_t.dvi.k_spec
    cj, ct = _admit_both(pair)
    live = [0, 1]
    tok = np.array([[5], [7], [9]], np.int32)
    hj, cj, _, _ = model_j.step(params_j, model_j.embed_block(params_j, jnp.asarray(tok)), cj, 0, k)
    ht, ct, _ = model_t.step(params_t, model_t.embed_block(params_t, torch.from_numpy(tok)), ct, 0, k)
    np.testing.assert_allclose(ht.numpy()[live], np.asarray(hj)[live], rtol=RTOL, atol=ATOL)
    acc = np.array([1, 1, 0], np.int32)
    cj = model_j.commit(cj, {}, jnp.asarray(acc))
    ct = model_t.commit(ct, {}, torch.from_numpy(acc))
    x = np.random.default_rng(4).standard_normal((B, K + 1, cfg_t.d_model)).astype(np.float32)
    hj, cj, _, _ = model_j.step(params_j, jnp.asarray(x), cj, k, L)
    ht, ct, _ = model_t.step(params_t, torch.from_numpy(x), ct, k, L)
    np.testing.assert_allclose(ht.numpy()[live], np.asarray(hj)[live], rtol=RTOL, atol=ATOL)
    acc = np.array([3, 5, 0], np.int32)
    cj = model_j.commit(cj, {}, jnp.asarray(acc))
    ct = model_t.commit(ct, {}, torch.from_numpy(acc))
    assert "tbl" in ct
    _mapped_kv_equal(cj, ct, live)
    cj = jtfm.reset_slot(cfg_j, cj, jnp.int32(0))
    ct = tfm.reset_slot(cfg_t, ct, 0)
    _mapped_kv_equal(cj, ct, live)
    assert ct["lengths"][0] == 0 and bool((ct["tbl"][0] == -1).all())


def test_attn_layer_step_paged_matches_jax(pair):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t, prompts, rows = pair
    cj, ct = _admit_both(pair)
    seg_j = jtfm.model_segments(cfg_j)[0]
    pj = jax.tree.map(lambda a: a[0], params_j["segments"][seg_j.name])
    pt = {n: w[0] for n, w in params_t["segments"][seg_j.name].items()}
    x = np.random.default_rng(6).standard_normal((B, 3, cfg_t.d_model)).astype(np.float32)
    cjs, cts = cj["segs"][seg_j.name], ct["segs"][seg_j.name]
    xj, kj, vj, _, _, _ = jtfm.attn_layer_step_paged(
        pj, jnp.asarray(x), cjs["kp"][0], cjs["vp"][0], cj["tbl"], cj["lengths"], cfg_j,
        seg_j, jnp.float32(0.0))
    xt = tfm.attn_layer_step_paged(pt, torch.from_numpy(x), cts["kp"][0], cts["vp"][0],
                                   ct["tbl"], ct["lengths"], cfg_t)
    np.testing.assert_allclose(xt.numpy()[:2], np.asarray(xj)[:2], rtol=RTOL, atol=ATOL)
    written = np.unique(rows[:2][rows[:2] >= 0])
    np.testing.assert_allclose(cts["kp"][0].numpy()[written], np.asarray(kj)[written],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cts["vp"][0].numpy()[written], np.asarray(vj)[written],
                               rtol=RTOL, atol=ATOL)


def test_contiguous_insert_and_reset_match_jax(pair):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t, prompts, _ = pair
    C = 24
    cj = model_j.init_cache(B, C)
    ct = model_t.init_cache(B, C)
    p = prompts[0]
    _, pj, _ = model_j.prefill(params_j, jnp.asarray(p[None]), max_len=C)
    _, pt = model_t.prefill(params_t, torch.from_numpy(p[None]), max_len=C)
    cj = jtfm.insert_slot(cfg_j, cj, pj, jnp.int32(1))
    ct = tfm.insert_slot(cfg_t, ct, pt, 1)
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    for name, seg in ct["segs"].items():
        for key in ("k", "v"):
            np.testing.assert_allclose(seg[key].numpy(), np.asarray(cj["segs"][name][key]),
                                       rtol=RTOL, atol=ATOL)
    cj = jtfm.reset_slot(cfg_j, cj, jnp.int32(1))
    ct = tfm.reset_slot(cfg_t, ct, 1)
    for name, seg in ct["segs"].items():
        np.testing.assert_array_equal(seg["k"].numpy(), np.asarray(cj["segs"][name]["k"]))
    assert int(ct["lengths"][1]) == 0


def test_prefix_splice_is_a_later_slice(pair):
    cfg_t = pair[3]
    with pytest.raises(NotImplementedError):
        tfm.insert_slot(cfg_t, {}, None, 0)
