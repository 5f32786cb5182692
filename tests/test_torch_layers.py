"""Port layer functions against repro.models.layers on the same numpy inputs
(float32; tolerances as tests/test_kernels.py: rtol 1e-5, attention atol
2e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _np(x):
    return np.asarray(x)


def _pair(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), _np(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 8, 4, 16)])
def test_norms(shape):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, *shape, scale=3.0)
    wj, wt = _pair(rng, shape[-1], scale=0.1)
    _close(jl.rms_norm(xj, wj, 1e-5), tl.rms_norm(xt, wt, 1e-5), atol=1e-5)
    _close(jl.head_rms_norm(xj, wj, 1e-6), tl.head_rms_norm(xt, wt, 1e-6), atol=1e-5)
    # the gain is 1 + w: zero w is a plain RMS normalisation
    z = torch.zeros(shape[-1])
    out = tl.rms_norm(xt, z)
    np.testing.assert_allclose(out.pow(2).mean(-1).numpy(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, 2, 7, 3, 32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    _close(jl.rope_freqs(32, theta), tl.rope_freqs(32, theta), atol=0)
    _close(jl.apply_rope(xj, jnp.asarray(pos), theta),
           tl.apply_rope(xt, torch.from_numpy(pos), theta))


@pytest.mark.parametrize("H,KV,Tq,Tk", [(8, 8, 5, 9), (8, 2, 1, 17), (4, 1, 6, 6)])
def test_attend_gqa_masked(H, KV, Tq, Tk):
    rng = np.random.default_rng(H * 100 + KV)
    qj, qt = _pair(rng, 2, Tq, H, 16)
    kj, kt = _pair(rng, 2, Tk, KV, 16)
    vj, vt = _pair(rng, 2, Tk, KV, 16)
    mask = rng.random((2, Tq, Tk)) < 0.7
    mask[:, :, 0] = True
    _close(jl.attend(qj, kj, vj, jnp.asarray(mask)),
           tl.attend(qt, kt, vt, torch.from_numpy(mask)))
    # 2-D mask broadcasts over the batch
    m2 = np.array(jl.causal_mask(Tq, Tk, offset=Tk - Tq))
    _close(jl.attend(qj, kj, vj, jnp.asarray(m2)),
           tl.attend(qt, kt, vt, torch.from_numpy(m2)))


@pytest.mark.parametrize("kw", [dict(), dict(offset=3), dict(window=4),
                                dict(prefix_len=5), dict(offset=2, window=3, prefix_len=4)])
def test_causal_mask(kw):
    np.testing.assert_array_equal(tl.causal_mask(9, 12, **kw).numpy(),
                                  _np(jl.causal_mask(9, 12, **kw)))


@pytest.mark.parametrize("T,spec", [
    (48, dict()),                                   # materialised path
    (1100, dict()),                                 # blockwise path (> threshold)
    (1100, dict(window=300, prefix_len=50)),
    (64, dict(bidirectional=True)),
])
def test_attend_full(T, spec):
    rng = np.random.default_rng(T)
    qj, qt = _pair(rng, 1, T, 4, 8)
    kj, kt = _pair(rng, 1, T, 2, 8)
    vj, vt = _pair(rng, 1, T, 2, 8)
    if T * T > 1024 * 1024:
        assert T * T > tl._FLASH_THRESHOLD == jl._FLASH_THRESHOLD
    _close(jl.attend_full(qj, kj, vj, jl.MaskSpec(**spec)),
           tl.attend_full(qt, kt, vt, tl.MaskSpec(**spec)))


def test_attend_full_rectangular_bidirectional_blockwise(monkeypatch):
    """Tq != Tk (Whisper's cross-attention and its encoder prefill) through
    the blockwise path, key padding included: the unmasked attend, as the
    reference's tests/test_layers.py::test_flash_cross_attention_rect."""
    rng = np.random.default_rng(50)
    qj, qt = _pair(rng, 2, 50, 4, 16)
    kj, kt = _pair(rng, 2, 23, 4, 16)
    vj, vt = _pair(rng, 2, 23, 4, 16)
    naive = jl.attend(qj, kj, vj, jnp.ones((50, 23), bool))
    monkeypatch.setattr(tl, "_FLASH_THRESHOLD", 1)
    spec = tl.MaskSpec(bidirectional=True)
    _close(naive, tl.attend_full(qt, kt, vt, spec, q_chunk=16, k_chunk=16))
    _close(naive, tl.attend_full(qt, kt, vt, spec))


@pytest.mark.parametrize("num_pos,dim", [(24, 256), (64, 1280), (1, 8)])
def test_sinusoidal_positions(num_pos, dim):
    """Whisper's table, and its rows computed at given positions alone."""
    want = jl.sinusoidal_positions(num_pos, dim)
    got = tl.sinusoidal_positions(num_pos, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (num_pos, dim)
    _close(want, got)
    pos = torch.tensor([[num_pos - 1, 0], [num_pos // 2, num_pos - 1]])
    assert torch.equal(tl.sinusoidal_at(pos, dim), got[pos])


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True), ("gelu", False)])
def test_mlp(act, glu):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, 2, 3, 32)
    pj, pt = {}, {}
    for name, shape in (("wi", (32, 48)), ("wg", (32, 48)), ("wo_ff", (48, 32))):
        pj[name], pt[name] = _pair(rng, *shape, scale=0.2)
    _close(jl.mlp(pj, xj, act, glu), tl.mlp(pt, xt, act, glu), atol=1e-5)


def test_dense_init_scale_dtype_device():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(g, (3, 256, 512), torch.bfloat16)
    assert w.shape == (3, 256, 512) and w.dtype == torch.bfloat16 and w.device.type == "cpu"
    assert abs(float(w.float().std()) - 1 / 16) < 2e-3
    e = tl.dense_init(torch.Generator().manual_seed(0), (512, 256), torch.float32, scale=0.02)
    assert abs(float(e.std()) - 0.02) < 1e-3
    again = tl.dense_init(torch.Generator().manual_seed(0), (512, 256), torch.float32, scale=0.02)
    assert torch.equal(e, again)
