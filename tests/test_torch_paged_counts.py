"""``page_counts`` of the port's paged attention against the JAX package, on
the CPU in float32: per-lane page counts below, at and above
ceil(lengths / ps), 0 (clipped to 1) and past MPS (clipped to MPS), through
``ops.paged_decode_attention`` (its plain version on the CPU) against
``repro.kernels.ref.ref_paged_decode_attention`` and the Pallas kernel in
interpret mode; and in the port's block form (Tq > 1) the same page mask
for every query.  Tolerance as tests/test_kernels.py: attention atol 2e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL = 2e-5
B, KV, hd, MPS = 5, 2, 16, 6


def _case(G, ps, seed):
    """Shuffled, fully mapped tables with one -1 entry mid-row on lane 2;
    lengths and numpy-seeded q, pages, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    P = B * MPS + 3
    tbl = rng.permutation(np.arange(1, P))[:B * MPS].reshape(B, MPS).astype(np.int32)
    tbl[2, 1] = -1
    lens = np.array([4 * ps + 3, 3 * ps, 2 * ps + 1, 3 * ps + 2, MPS * ps], np.int32)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, KV * G, hd), (P, ps, KV, hd), (P, ps, KV, hd))]
    return tbl, lens, arrs


# counts per lane against ceil(len / ps) = 5, 3, 3, 4, 6: below, at, above,
# 0 (clipped to 1), past MPS (clipped to 6); and each kind on every lane
COUNTS = {
    "mixed": [2, 3, 4, 0, MPS + 5],
    "below": [1, 2, 2, 3, 5],
    "at": [5, 3, 3, 4, 6],
    "above": [6, 5, 4, 6, MPS],
    "zero": [0, 0, 0, 0, 0],
    "past MPS": [MPS + 1, MPS + 9, 100, MPS + 2, 2 ** 20],
}


@pytest.mark.parametrize("G,ps", [(1, 4), (4, 16)])
@pytest.mark.parametrize("kind", list(COUNTS))
def test_page_counts_match_jax_oracle(G, ps, kind):
    tbl, lens, (q, kp, vp) = _case(G, ps, G * ps)
    pc = np.array(COUNTS[kind], np.int32)
    want = jref.ref_paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                           jnp.asarray(lens), jnp.asarray(tbl),
                                           page_counts=jnp.asarray(pc))
    out = ops.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                     torch.from_numpy(vp), torch.from_numpy(lens),
                                     torch.from_numpy(tbl), page_counts=torch.from_numpy(pc))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


def test_page_counts_match_pallas_interpret():
    tbl, lens, (q, kp, vp) = _case(2, 4, 5)
    pc = np.array(COUNTS["mixed"], np.int32)
    want = jops.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.asarray(lens), jnp.asarray(tbl),
                                       page_counts=jnp.asarray(pc))
    out = ops.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                     torch.from_numpy(vp), torch.from_numpy(lens),
                                     torch.from_numpy(tbl), page_counts=torch.from_numpy(pc))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind", ["at", "above", "past MPS"])
def test_counts_covering_the_length_change_nothing(kind):
    """Counts at or above ceil(len / ps) leave the length mask in charge:
    the result equals the call without page_counts, and None is the call
    without the argument."""
    tbl, lens, (q, kp, vp) = _case(1, 4, 9)
    args = [torch.from_numpy(a) for a in (q, kp, vp, lens, tbl)]
    plain = ops.paged_decode_attention(*args)
    assert torch.equal(ops.paged_decode_attention(*args, page_counts=None), plain)
    out = ops.paged_decode_attention(*args, page_counts=torch.tensor(COUNTS[kind],
                                                                     dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL)


def test_zero_and_past_mps_are_clipped():
    tbl, lens, (q, kp, vp) = _case(4, 4, 3)
    args = [torch.from_numpy(a) for a in (q, kp, vp, lens, tbl)]

    def run(counts):
        return ops.paged_decode_attention(*args, page_counts=torch.tensor(counts,
                                                                          dtype=torch.int32))

    torch.testing.assert_close(run([0] * B), run([1] * B), rtol=0, atol=0)
    torch.testing.assert_close(run([MPS + 7] * B), run([MPS] * B), rtol=0, atol=0)


@pytest.mark.parametrize("Tq", [2, 5])
@pytest.mark.parametrize("kind", ["mixed", "below", "zero"])
def test_block_form_masks_every_query_alike(Tq, kind):
    """Query t of a block (lengths counting the block's own writes) equals a
    single-query call at length lengths - (Tq-1-t) with the same counts."""
    ps, G = 4, 2
    tbl, lens, (_, kp, vp) = _case(G, ps, 17 + Tq)
    qb = np.random.default_rng(Tq).standard_normal((B, Tq, KV * G, hd)).astype(np.float32)
    pc = torch.tensor(COUNTS[kind], dtype=torch.int32)
    kp_t, vp_t, tbl_t = torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(tbl)
    out = ops.paged_decode_attention(torch.from_numpy(qb), kp_t, vp_t, torch.from_numpy(lens),
                                     tbl_t, page_counts=pc)
    for t in range(Tq):
        lens_t = torch.from_numpy(lens - (Tq - 1 - t))
        one = ops.paged_decode_attention(torch.from_numpy(qb[:, t].copy()), kp_t, vp_t, lens_t,
                                         tbl_t, page_counts=pc)
        np.testing.assert_allclose(out[:, t].numpy(), one.numpy(), atol=ATOL)
