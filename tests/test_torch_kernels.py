"""The port's kernel functions on the CPU (their plain versions, which
``ops`` runs for CPU tensors) against the JAX package: its jnp oracles in
repro.kernels.ref, one interpret-mode Pallas case per kernel (as
tests/test_kernels.py runs them), and, for decode attention with Tq > 1,
``layers.attend`` under the model's step mask.  float32; tolerances as
tests/test_kernels.py (rtol 1e-5, attention atol 2e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.lora_logits import lora_logits as pallas_lora_logits  # noqa: E402
from repro.kernels.verify_argmax import verify_argmax as pallas_verify_argmax  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _pair(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# verify_argmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,d,V", [(5, 64, 500), (40, 128, 2048), (1, 32, 129)])
def test_verify_argmax_matches_jax_oracle(T, d, V):
    rng = np.random.default_rng(T + V)
    hj, ht = _pair(rng, T, d)
    wj, wt = _pair(rng, d, V)
    arg_j, mx_j = jref.ref_verify_argmax(hj, wj)
    arg_t, mx_t = ops.verify_argmax(ht, wt)
    assert arg_t.dtype == torch.int32 and mx_t.dtype == torch.float32
    np.testing.assert_array_equal(arg_t.numpy(), np.asarray(arg_j))
    np.testing.assert_allclose(mx_t.numpy(), np.asarray(mx_j), rtol=RTOL)


def test_verify_argmax_tie_goes_to_lowest_index():
    """Equal maxima resolve to the lowest index, as jnp.argmax and the Pallas
    kernel's strict '>' fold across vocab tiles do.  Each row's winning
    column is copied to a second position (below or above it, in another
    128-wide Pallas tile), so every row has an exact tie."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((6, 32)).astype(np.float32)
    w = rng.standard_normal((32, 300)).astype(np.float32)
    best = np.argmax(h @ w, axis=-1)
    for c in best:
        w[:, (c + 150) % 300] = w[:, c]
    arg_t, _ = ops.verify_argmax(torch.from_numpy(h), torch.from_numpy(w))
    arg_j, _ = jref.ref_verify_argmax(jnp.asarray(h), jnp.asarray(w))
    arg_p, _ = pallas_verify_argmax(jnp.asarray(h), jnp.asarray(w), block_t=8,
                                    block_v=128, interpret=True)
    np.testing.assert_array_equal(arg_t.numpy(), np.asarray(arg_j))
    np.testing.assert_array_equal(arg_t.numpy(), np.asarray(arg_p))
    assert all(int(a) == min(c, (c + 150) % 300) for a, c in zip(arg_t, best))
    # an exact tie built by repeating the whole vocab: the first copy wins
    arg4, _ = ops.verify_argmax(torch.from_numpy(h), torch.from_numpy(np.tile(w, (1, 4))))
    np.testing.assert_array_equal(arg4.numpy(), arg_t.numpy())


def test_verify_argmax_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    hj, ht = _pair(rng, 33, 64)
    wj, wt = _pair(rng, 64, 1000)
    arg_p, mx_p = pallas_verify_argmax(hj, wj, block_t=8, block_v=256, interpret=True)
    arg_t, mx_t = ops.verify_argmax(ht, wt)
    np.testing.assert_array_equal(arg_t.numpy(), np.asarray(arg_p))
    np.testing.assert_allclose(mx_t.numpy(), np.asarray(mx_p), rtol=RTOL)


# ---------------------------------------------------------------------------
# lora_logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,d,V,r", [(8, 64, 500, 8), (17, 128, 300, 4), (8, 64, 256, 1)])
def test_lora_logits_matches_jax_oracle(T, d, V, r):
    rng = np.random.default_rng(T * r)
    hj, ht = _pair(rng, T, d)
    wj, wt = _pair(rng, d, V)
    aj, at = _pair(rng, d, r)
    bj, bt = _pair(rng, r, V)
    out_t = ops.lora_logits(ht, wt, at, bt, 2.0)
    assert out_t.dtype == torch.float32 and out_t.shape == (T, V)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(jref.ref_lora_logits(hj, wj, aj, bj, 2.0)),
                               rtol=RTOL, atol=1e-4)


def test_lora_logits_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    hj, ht = _pair(rng, 5, 64)
    wj, wt = _pair(rng, 64, 500)
    aj, at = _pair(rng, 64, 8)
    bj, bt = _pair(rng, 8, 500)
    out_p = pallas_lora_logits(hj, wj, aj, bj, 2.0, block_t=16, block_v=256, interpret=True)
    np.testing.assert_allclose(ops.lora_logits(ht, wt, at, bt, 2.0).numpy(), np.asarray(out_p),
                               rtol=RTOL, atol=1e-4)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,hd,S", [(2, 8, 2, 32, 100), (3, 16, 16, 64, 64),
                                         (1, 4, 1, 128, 300)])
def test_decode_attention_matches_jax_oracle(B, H, KV, hd, S):
    rng = np.random.default_rng(B * H + S)
    qj, qt = _pair(rng, B, H, hd)
    kj, kt = _pair(rng, B, S, KV, hd)
    vj, vt = _pair(rng, B, S, KV, hd)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    out_t = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    np.testing.assert_allclose(out_t.numpy(),
                               np.asarray(jref.ref_decode_attention(qj, kj, vj, jnp.asarray(lens))),
                               atol=ATOL)


def test_decode_attention_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, 2, 8, 32)
    kj, kt = _pair(rng, 2, 100, 2, 32)
    vj, vt = _pair(rng, 2, 100, 2, 32)
    lens = np.array([37, 100], np.int32)
    out_p = decode_attention_pallas(qj, kj, vj, jnp.asarray(lens), block_s=32, interpret=True)
    np.testing.assert_allclose(ops.decode_attention(qt, kt, vt, torch.from_numpy(lens)).numpy(),
                               np.asarray(out_p), atol=ATOL)


def _step_state(rng, B, C, T, stale):
    """A contiguous full cache as the model path leaves it: lengths before
    the block, slots below lengths+T written (the block's own writes
    included), stale speculative writes up to `stale` slots further, and
    the reference's slot positions (pos = j where written, else -1).
    Writes past capacity C are dropped."""
    before = rng.integers(1, C, size=B)
    pos = np.full((B, C), -1, np.int64)
    for b in range(B):
        top = min(C, before[b] + T + stale[b])
        pos[b, :top] = np.arange(top)
    qpos = before[:, None] + np.arange(T)[None, :]
    return before.astype(np.int32), pos, qpos


@pytest.mark.parametrize("T,C", [(5, 40), (1, 40), (5, 7)])
def test_length_mask_equals_step_pos_mask(T, C):
    """Query t of a block attends slots j < lengths_after - (T-1-t), clipped
    to C — on a contiguous full cache exactly the reference's step mask
    (pos <= qpos) & (pos >= 0), stale speculative slots and clipped writes
    past capacity included."""
    rng = np.random.default_rng(T * C)
    B = 64
    before, pos, qpos = _step_state(rng, B, C, T, rng.integers(0, 6, size=B))
    pos_mask = (pos[:, None, :] <= qpos[:, :, None]) & (pos[:, None, :] >= 0)
    after = before + T
    lim = np.minimum(after[:, None] - (T - 1 - np.arange(T))[None, :], C)
    len_mask = np.arange(C)[None, None, :] < lim[:, :, None]
    np.testing.assert_array_equal(len_mask, pos_mask)


@pytest.mark.parametrize("B,Tq,H,KV,hd,C", [(3, 5, 8, 8, 32, 40), (2, 5, 8, 2, 16, 30),
                                            (2, 1, 4, 1, 32, 25)])
def test_decode_attention_block_matches_attend_step_mask(B, Tq, H, KV, hd, C):
    """decode_attention with Tq > 1 and post-write lengths against the
    reference model path: layers.attend under the step mask built from pos."""
    rng = np.random.default_rng(B * Tq * C)
    before, pos, qpos = _step_state(rng, B, C, Tq, rng.integers(0, 4, size=B))
    qj, qt = _pair(rng, B, Tq, H, hd)
    kj, kt = _pair(rng, B, C, KV, hd)
    vj, vt = _pair(rng, B, C, KV, hd)
    mask = (pos[:, None, :] <= qpos[:, :, None]) & (pos[:, None, :] >= 0)
    out_j = jl.attend(qj, kj, vj, jnp.asarray(mask))
    out_t = ops.decode_attention(qt, kt, vt, torch.from_numpy(before + Tq))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    # the single-query form is the Tq = 1 block
    one = ops.decode_attention(qt[:, -1], kt, vt, torch.from_numpy(before + Tq))
    np.testing.assert_allclose(one.numpy(), out_t[:, -1].numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# dispatch: plain path on the CPU, no fallback, no silent launches
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_path_and_count_no_launch():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32))
    a = torch.zeros(16, 2)
    b = torch.zeros(2, 40)
    q = torch.randn(2, 3, 4, 8)
    k = torch.randn(2, 10, 2, 8)
    ops.verify_argmax(h, w)
    ops.lora_logits(h, w, a, b, 2.0)
    ops.decode_attention(q, k, k, torch.tensor([5, 10], dtype=torch.int32))
    ops.paged_decode_attention(q, k.reshape(5, 4, 2, 8), k.reshape(5, 4, 2, 8),
                               torch.tensor([5, 7], dtype=torch.int32),
                               torch.tensor([[1, 2], [3, -1]], dtype=torch.int32))
    ops.ssd_scan(torch.randn(1, 4, 2, 8), torch.randn(1, 4, 1, 4), torch.randn(1, 4, 1, 4),
                 torch.rand(1, 4, 2), -torch.rand(2), 2)
    assert ops.launches == {"verify_argmax": 0, "lora_logits": 0, "decode_attention": 0,
                            "paged_decode_attention": 0, "ssd_scan": 0}
    assert set(ops.launches) == set(build.KERNELS)


def test_other_devices_raise():
    h = torch.empty(4, 16, device="meta")
    w = torch.empty(16, 40, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.verify_argmax(h, w)
    with pytest.raises(ValueError, match="different devices"):
        ops.verify_argmax(torch.zeros(4, 16), w)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


def test_build_targets_are_keyed_by_source_hash():
    names = {build._target(n).name for n in build.KERNELS}
    assert len(names) == len(build.KERNELS)
    for n in build.KERNELS:
        assert build._target(n) == build._target(n)
        assert build._target(n).name.startswith(n + "-")
        assert (build.CSRC / f"{n}.cu").exists()
