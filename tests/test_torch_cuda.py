"""The port's CUDA kernels against their plain versions on the card, over
shapes the main path does not use (ragged vocab and d, T > 48 rows, r = 1,
GQA groups, Tq > 1, lengths at and past the cache capacity, paged tables
with -1 entries, all -1 lanes, page sizes 16 and 4 and per-lane page counts,
the attention kernels' split of a lane over 1, 2, 4 and 8 CTAs at its edges),
in float32 and bfloat16, the ring form of ``decode_attention`` at the
hybrid and MoE decoders' local layers (hd 256 / G 16 and hd 128 / G 5,
wrapped and not), the non-causal form over Whisper's 1500 encoder frames at hd 64 and
paligemma's MQA at hd 256, the SSD scan at odd chunk lengths, with padded
rows, a carried h0, strided inputs and every slice width of its hd split,
plus the greedy sync path and the continuous paged
path on the card, mamba2-370m-tiny's greedy path in bfloat16, the
engines' block-step replayed from CUDA graphs against the eager block-step,
and the Improve loop on the card: the differentiable ``lora_logits``
against autograd through its plain version, one update step against the
same step on the CPU, the update without a host sync, and a graphed
learning engine against the eager one; the training path: ``ssd_scan``'s
gradient (``SsdScan``) against autograd through the plain version, and two
pretraining steps of a narrow mamba2 against the same steps on the CPU.

These tests need an NVIDIA GPU and skip without one.  The machine with the
card has no JAX, so run them there without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

# float32: the kernels and the plain versions differ only in summation order;
# bfloat16: the plain attention rounds its probabilities to bf16
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def ops():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ops
    return ops


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,V", [(1, 32, 129), (40, 4096, 32000), (50, 200, 1001),
                                   (97, 128, 64), (8, 256, 2)])
def test_verify_argmax(ops, dtype, T, d, V):
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(T * V)
    h = _randn(gen, T, d, dtype=dtype)
    w = _randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    arg, mx = ops.verify_argmax(h, w)
    arg_r, mx_r = ref.verify_argmax(h, w)
    torch.testing.assert_close(mx, mx_r, rtol=1e-5, atol=1e-4)
    top = (h.float() @ w.float()).topk(min(2, V), dim=-1).values
    near_tie = (top[:, 0] - top[:, -1]) <= 1e-4 if V > 1 else torch.zeros(T, dtype=torch.bool)
    assert bool(((arg == arg_r) | near_tie.cuda()).all())


def test_verify_argmax_exact_ties(ops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = _randn(gen, 12, 300, dtype=torch.bfloat16)
    w = _randn(gen, 300, 100, dtype=torch.bfloat16)
    arg1, mx1 = ops.verify_argmax(h, w)
    argn, mxn = ops.verify_argmax(h, w.repeat(1, 7).contiguous())
    assert torch.equal(arg1, argn) and torch.equal(mx1, mxn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,V,r", [(8, 4096, 32000, 64), (8, 4096, 32000, 1),
                                     (50, 200, 1001, 8), (1, 64, 65, 3)])
def test_lora_logits(ops, dtype, T, d, V, r):
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(T + r)
    h = _randn(gen, T, d, dtype=dtype)
    w = _randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    a = _randn(gen, d, r, scale=d ** -0.5)
    b = _randn(gen, r, V, scale=0.05)
    torch.testing.assert_close(ops.lora_logits(h, w, a, b, 2.0),
                               ref.lora_logits(h, w, a, b, 2.0), rtol=1e-5, atol=1e-4)


# vocab widths about a strip of 128 columns: one short of it, exactly it, one
# past it (the element loader in both dtypes) and 8 short and 8 past it (the
# 16-byte loader in both); rows in one, two and several passes
VOCAB_EDGE_V = (120, 127, 128, 129, 136)
VOCAB_EDGE_T = (1, 9, 41, 49, 67)


def _fast_expected(dtype, d, V):
    elt = 2 if dtype == torch.bfloat16 else 4
    return d * elt % 16 == 0 and V * elt % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", VOCAB_EDGE_T)
@pytest.mark.parametrize("V", VOCAB_EDGE_V)
def test_verify_argmax_vocab_edges(ops, dtype, T, V):
    from repro_torch.kernels import ref
    d = 320
    gen = torch.Generator(device="cuda").manual_seed(T * 1000 + V)
    h = _randn(gen, T, d, dtype=dtype)
    w = _randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    ops.reset_launches()
    arg, mx = ops.verify_argmax(h, w)
    fast = _fast_expected(dtype, d, V)
    assert ops.vocab_paths["verify_argmax"] == {"fast": int(fast), "element": int(not fast)}
    arg_r, mx_r = ref.verify_argmax(h, w)
    torch.testing.assert_close(mx, mx_r, rtol=1e-5, atol=1e-4)
    top = (h.float() @ w.float()).topk(2, dim=-1).values
    assert bool(((arg == arg_r) | ((top[:, 0] - top[:, 1]) <= 1e-4)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,n", [(1001, 8), (5, 200), (3, 43)])
def test_verify_argmax_exact_ties_at_every_offset(ops, dtype, L, n):
    """w's first L columns repeated n times: the copies sit at every offset
    inside a strip, a warp's 32 columns and an m16 fragment (1001 and 5
    are odd), so each row's maximum is tied n ways at different places; the
    kernel must give every copy bit-equal logits and pick the first one."""
    gen = torch.Generator(device="cuda").manual_seed(L * n)
    d = 256
    h = _randn(gen, 41, d, dtype=dtype)
    w = _randn(gen, d, L, dtype=dtype)
    arg1, mx1 = ops.verify_argmax(h, w)
    argn, mxn = ops.verify_argmax(h, w.repeat(1, n).contiguous())
    assert torch.equal(arg1, argn) and torch.equal(mx1, mxn)
    assert bool((argn < L).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", (1, 9, 41, 67))
@pytest.mark.parametrize("V", (127, 128, 136))
@pytest.mark.parametrize("r", (1, 512))
def test_lora_logits_vocab_edges(ops, dtype, T, V, r):
    from repro_torch.kernels import ref
    d = 320
    gen = torch.Generator(device="cuda").manual_seed(T * 1000 + V + r)
    h = _randn(gen, T, d, dtype=dtype)
    w = _randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    a = _randn(gen, d, r, scale=d ** -0.5)
    b = _randn(gen, r, V, scale=0.05)
    ops.reset_launches()
    out = ops.lora_logits(h, w, a, b, 2.0)
    fast = _fast_expected(dtype, d, V)
    assert ops.vocab_paths["lora_logits"] == {"fast": int(fast), "element": int(not fast)}
    torch.testing.assert_close(out, ref.lora_logits(h, w, a, b, 2.0), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_kernels_take_unaligned_operands(ops, dtype):
    """h starting one element past 16 bytes, and a d whose rows are not
    16-byte multiples, take the element loader and agree all the same."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = _randn(gen, 9 * 256 + 1, dtype=dtype)
    h = flat[1:].reshape(9, 256)
    w = _randn(gen, 256, 1024, dtype=dtype, scale=1 / 16)
    h_odd = _randn(gen, 9, 250, dtype=dtype)
    w_odd = _randn(gen, 250, 1024, dtype=dtype, scale=1 / 16)
    a, b = _randn(gen, 256, 4, scale=1 / 16), _randn(gen, 4, 1024, scale=0.05)
    ops.reset_launches()
    for hh, ww in ((h, w), (h_odd, w_odd)):
        arg, mx = ops.verify_argmax(hh, ww)
        torch.testing.assert_close(mx, ref.verify_argmax(hh, ww)[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ops.lora_logits(h, w, a, b, 0.5),
                               ref.lora_logits(h, w, a, b, 0.5), rtol=1e-5, atol=1e-4)
    assert ops.vocab_paths == {"verify_argmax": {"fast": 0, "element": 2},
                               "lora_logits": {"fast": 0, "element": 1}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,H,KV,hd,S", [(8, 5, 32, 32, 128, 294), (8, 1, 32, 32, 128, 294),
                                            (3, 1, 32, 8, 128, 300),
                                            (3, 5, 32, 8, 128, 300), (2, 3, 16, 2, 64, 40),
                                            (4, 2, 4, 1, 32, 33)])
def test_decode_attention(ops, dtype, B, Tq, H, KV, hd, S):
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(B * S + Tq)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    k = _randn(gen, B, S, KV, hd, dtype=dtype)
    v = _randn(gen, B, S, KV, hd, dtype=dtype)
    rng = np.random.default_rng(S)
    lens = rng.integers(Tq, S + 1, size=B)
    lens[0] = Tq                                   # the first query sees one slot
    lens[-1] = S + 3                               # writes clipped at capacity
    lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    torch.testing.assert_close(ops.decode_attention(q_in, k, v, lens),
                               ref.decode_attention(q_in, k, v, lens), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("B,H,KV,hd,S,causal", [(8, 20, 20, 64, 1500, False),
                                                (3, 8, 2, 64, 40, False),
                                                (8, 20, 20, 64, 200, True),
                                                (4, 8, 1, 256, 420, True)])
def test_decode_attention_cross_and_whisper_paligemma_widths(ops, dtype, Tq, B, H, KV, hd, S,
                                                             causal):
    """Whisper's widths (MHA of 20 heads of 64), the non-causal form over
    its 1500 encoder frames (every query sees j < lengths, one lane
    shorter), and paligemma's MQA (8 heads of 256 over one kv head)."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(B * S + Tq + hd)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    k = _randn(gen, B, S, KV, hd, dtype=dtype)
    v = _randn(gen, B, S, KV, hd, dtype=dtype)
    lens = np.full(B, S) if not causal else np.random.default_rng(S).integers(Tq, S + 1, size=B)
    lens[-1] = S // 3 + Tq
    lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    ops.reset_launches()
    got = ops.decode_attention(q_in, k, v, lens, causal=causal)
    torch.testing.assert_close(got, ref.decode_attention(q_in, k, v, lens, causal=causal),
                               **TOL[dtype])
    assert ops.attn_forms == {"causal": int(causal), "ring": 0, "cross": int(not causal)}


def _ring_pos(n: int, C: int, stale: int) -> np.ndarray:
    """Slot positions of a ring of C slots after positions 0..n-1 and
    `stale` rejected writes past them, position p at slot p % C."""
    pos = np.full(C, -1, np.int32)
    p = np.arange(max(0, n + stale - C), n + stale)
    pos[p % C] = p
    return pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("H,KV,hd,W", [(16, 1, 256, 2048), (40, 8, 128, 8192)])
@pytest.mark.parametrize("wrapped", [False, True])
def test_decode_attention_ring(ops, dtype, Tq, H, KV, hd, W, wrapped):
    """The ring form at recurrentgemma-9b's local layers (MQA, hd 256, G 16:
    a verify pass's 80 rows take two row tiles) and llama4-scout's (hd 128,
    G 5), rings of W + 128 slots, lanes short of the ring or wrapped past
    it, 3 stale writes a lane past its length."""
    from repro_torch.kernels import ref
    C = W + 128
    B = 3
    gen = torch.Generator(device="cuda").manual_seed(W + Tq + wrapped)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    k = _randn(gen, B, C, KV, hd, dtype=dtype)
    v = _randn(gen, B, C, KV, hd, dtype=dtype)
    lens = [C + 1, C + 300, 2 * C + 7] if wrapped else [Tq, 150, C - 3]
    pos = torch.as_tensor(np.stack([_ring_pos(n, C, 3) for n in lens]), device="cuda")
    lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    torch.testing.assert_close(ops.decode_attention(q_in, k, v, lens, pos=pos, window=W),
                               ref.decode_attention(q_in, k, v, lens, pos=pos, window=W),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("G,ps", [(1, 16), (4, 16), (8, 4), (1, 4)])
def test_paged_decode_attention(ops, dtype, Tq, G, ps):
    """Shuffled pages; lane 0 past the table (length > MPS*ps), lane 1 with
    a -1 entry mid-row, lane 2 at exactly MPS*ps, lane 3 all -1 with a
    length, lane 4 idle (length 0, all -1).  Lanes with a mapped slot match
    the plain version; lanes without one give 0."""
    from repro_torch.kernels import ref
    B, KV, hd, mps = 5, 4, 64, 6
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(G * ps + Tq)
    rng = np.random.default_rng(G * ps)
    P = B * mps + 3
    perm = rng.permutation(np.arange(1, P))
    tbl = perm[:B * mps].reshape(B, mps).astype(np.int32)
    tbl[1, 2] = -1
    tbl[3:] = -1
    lens = np.array([mps * ps + 3, 3 * ps + 2, mps * ps, 2 * ps, 0], np.int32)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    kp = _randn(gen, P, ps, KV, hd, dtype=dtype)
    vp = _randn(gen, P, ps, KV, hd, dtype=dtype)
    lens_t = torch.as_tensor(lens, device="cuda")
    tbl_t = torch.as_tensor(tbl, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t)
    want = ref.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t)
    torch.testing.assert_close(out[:3], want[:3], **TOL[dtype])
    assert bool((out[3:] == 0).all()) and bool(torch.isfinite(want).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("G,ps", [(1, 16), (4, 4)])
def test_paged_decode_attention_page_counts(ops, dtype, Tq, G, ps):
    """page_counts per lane: below ceil(len/ps), at it, above it (the length
    mask still holds), 0 (clipped to 1) and above MPS (clipped to MPS), each
    lane fully mapped; the kernel matches the plain version on every query,
    and page_counts=None is bit-identical to the call without it."""
    from repro_torch.kernels import ref
    B, KV, hd, mps = 5, 4, 64, 6
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(7 * G + ps + Tq)
    rng = np.random.default_rng(G * ps + 1)
    P = B * mps + 3
    tbl = rng.permutation(np.arange(1, P))[:B * mps].reshape(B, mps).astype(np.int32)
    lens = np.array([4 * ps + 3, 3 * ps, 2 * ps + 1, 3 * ps + 2, mps * ps], np.int32)
    counts = np.array([2, 3, 4, 0, mps + 5], np.int32)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    kp = _randn(gen, P, ps, KV, hd, dtype=dtype)
    vp = _randn(gen, P, ps, KV, hd, dtype=dtype)
    lens_t, tbl_t = torch.as_tensor(lens, device="cuda"), torch.as_tensor(tbl, device="cuda")
    pc_t = torch.as_tensor(counts, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    ops.reset_launches()
    out = ops.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t, page_counts=pc_t)
    assert ops.launches["paged_decode_attention"] == 1
    want = ref.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t, page_counts=pc_t)
    torch.testing.assert_close(out, want, **TOL[dtype])
    # the counts below ceil(len/ps) change the result
    full = ops.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t)
    assert not torch.equal(out[:1], full[:1]) and not torch.equal(out[3:4], full[3:4])
    assert torch.equal(ops.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t,
                                                  page_counts=None), full)


def _capacity(ops, splits, pairs):
    """A lane capacity at which the wrappers split each of `pairs` (lane, kv
    head) pairs over `splits` CTAs: the largest one that still picks it
    (twice the smallest for the last choice), so the shares are as long as
    that choice allows."""
    caps = [c for c in range(16, 4097, 16) if ops.attn_splits(c, pairs) == splits]
    return caps[-1] if splits < max(ops.ATTN_SPLITS) else 2 * caps[0]


def _close_visible(out, want, visible, dtype):
    """The kernel's rows that see a slot match the plain version; the others
    are exactly 0 (the plain version gives them a uniform average)."""
    B, Tq = visible.shape
    out4, want4 = out.reshape(B, Tq, *out.shape[-2:]), want.reshape(B, Tq, *out.shape[-2:])
    vis = torch.as_tensor(visible, device="cuda")
    torch.testing.assert_close(out4[vis], want4[vis], **TOL[dtype])
    assert bool((out4[~vis] == 0).all()) and bool(torch.isfinite(want4).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,G", [(1, 1), (5, 1), (5, 4)])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_decode_attention_split_edges(ops, dtype, Tq, G, splits):
    """Each lane split over `splits` CTAs: a lane of length 1 (at Tq = 5 its
    first queries see nothing), one shorter than a CTA's share (the other
    CTAs of its cluster empty), lanes at the capacity and past it, an idle
    lane (length 0) and a lane ending one slot past a share border."""
    from repro_torch.kernels import ref
    B, KV, hd = 8, 2, 64
    S = _capacity(ops, splits, B * KV)
    assert ops.attn_splits(S, B * KV) == splits
    gen = torch.Generator(device="cuda").manual_seed(S * Tq + G)
    q = _randn(gen, B, Tq, KV * G, hd, dtype=dtype)
    k = _randn(gen, B, S, KV, hd, dtype=dtype)
    v = _randn(gen, B, S, KV, hd, dtype=dtype)
    share = ops.attn_share(S, splits)
    lens = np.array([1, 10, S, S + 3, 0, min(share + 1, S), S // 2, S - 1], np.int32)
    lens_t = torch.as_tensor(lens, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    ops.reset_launches()
    out = ops.decode_attention(q_in, k, v, lens_t)
    assert ops.launches["decode_attention"] == 1
    visible = np.array([[min(int(n) - (Tq - 1 - t), S) > 0 for t in range(Tq)] for n in lens])
    _close_visible(out, ref.decode_attention(q_in, k, v, lens_t), visible, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,G", [(1, 1), (5, 1), (5, 4)])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_paged_decode_attention_split_edges(ops, dtype, Tq, G, splits):
    """Shuffled pages of 16 with each lane split over `splits` CTAs: lanes
    of length 1 and 10, at MPS * ps and past it, an idle lane (length 0, all
    -1), a lane with -1 entries on both sides of a share border, and lanes
    with a -1 entry on the first and on the last live page."""
    from repro_torch.kernels import ref
    ps, B, KV, hd = 16, 8, 2, 64
    mps = _capacity(ops, splits, B * KV) // ps
    cap = mps * ps
    assert ops.attn_splits(cap, B * KV) == splits
    rng = np.random.default_rng(cap * Tq + G)
    P = B * mps + 3
    tbl = rng.permutation(np.arange(1, P))[:B * mps].reshape(B, mps).astype(np.int32)
    n_border = cap - ps + 5
    share = ops.attn_share(n_border, splits)
    border = share // ps if share < n_border else 1
    lens = np.array([1, 10, cap, cap + 3, 0, n_border, 3 * ps + 1, cap - 1], np.int32)
    tbl[4] = -1
    tbl[5, border - 1] = tbl[5, border] = -1
    tbl[6, 0] = tbl[7, mps - 1] = -1
    gen = torch.Generator(device="cuda").manual_seed(cap * Tq + G)
    q = _randn(gen, B, Tq, KV * G, hd, dtype=dtype)
    kp = _randn(gen, P, ps, KV, hd, dtype=dtype)
    vp = _randn(gen, P, ps, KV, hd, dtype=dtype)
    lens_t, tbl_t = torch.as_tensor(lens, device="cuda"), torch.as_tensor(tbl, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    ops.reset_launches()
    out = ops.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t)
    assert ops.launches["paged_decode_attention"] == 1
    page = tbl[:, np.arange(cap) // ps]
    visible = np.array([[bool(((page[b] >= 0) & (np.arange(cap) < min(int(n) - (Tq - 1 - t),
                                                                          cap))).any())
                         for t in range(Tq)] for b, n in enumerate(lens)])
    _close_visible(out, ref.paged_decode_attention(q_in, kp, vp, lens_t, tbl_t), visible, dtype)


def test_attention_rejects_what_it_does_not_take(ops):
    """hd must be a whole number of 16-wide mma steps in bf16 and of 16-byte
    copies in float32; K/V must start on 16 bytes."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    lens = torch.tensor([3, 4], device="cuda", dtype=torch.int32)
    q = _randn(gen, 2, 4, 40, dtype=torch.bfloat16)
    kv = _randn(gen, 2, 10, 4, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd % 16"):
        ops.decode_attention(q, kv, kv, lens)
    ops.decode_attention(q.float(), kv.float(), kv.float(), lens)     # float32 takes hd 40
    kv = _randn(gen, 2 * 10 * 4 * 32 + 1, dtype=torch.bfloat16)[1:].reshape(2, 10, 4, 32)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.decode_attention(_randn(gen, 2, 4, 32, dtype=torch.bfloat16), kv, kv, lens)


def test_wrappers_check_inputs_and_count_launches(ops):
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = _randn(gen, 4, 64)
    w = _randn(gen, 64, 100)
    ops.reset_launches()
    ops.verify_argmax(h, w)
    ops.verify_argmax(h, w)
    assert ops.launches["verify_argmax"] == 2
    with pytest.raises(ValueError, match="contiguous"):
        ops.verify_argmax(h, w.t().contiguous().t())
    with pytest.raises(ValueError, match="dtype"):
        ops.verify_argmax(h, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        ops.lora_logits(h, w, torch.zeros(64, 2, device="cuda", dtype=torch.bfloat16),
                        torch.zeros(2, 100, device="cuda"), 1.0)
    q = _randn(gen, 2, 4, 32)
    kv = _randn(gen, 2, 10, 4, 32)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q, kv, kv, torch.tensor([3, 4], device="cuda"))
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, kv, kv, torch.tensor([3, 4], device="cuda",
                                                           dtype=torch.int32),
                                   torch.zeros(2, 3, device="cuda", dtype=torch.int64))
    assert ops.launches == {"verify_argmax": 2, "lora_logits": 0, "decode_attention": 0,
                            "paged_decode_attention": 0, "ssd_scan": 0}


def test_greedy_path_on_the_card(ops):
    """Tiny vicuna in float32 on the card: speculative == AR, every launch
    accounted for by the per-block formula."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.models.model import build_model
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    prompts = torch.randint(2, cfg.vocab_size, (3, 8), generator=gen, device="cuda",
                            dtype=torch.int32)
    r_ar = spec.ar_generate(model, params, prompts, 16)
    ops.reset_launches()
    r_sd = spec.speculative_generate(model, params, dvi, prompts, 16, collect=True)
    for b in range(3):
        n = min(int(r_ar.lengths[b]), int(r_sd.lengths[b]), 8 + 16)
        assert torch.equal(r_ar.tokens[b, :n], r_sd.tokens[b, :n])
    K, k, L, n = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers, r_sd.steps
    assert ops.launches == {"decode_attention": ((K + 1) * k + L - k) * n,
                            "lora_logits": (K + 1) * n, "verify_argmax": n,
                            "paged_decode_attention": 0, "ssd_scan": 0}


def test_continuous_paged_path_on_the_card(ops):
    """Tiny vicuna in float32 on the card through the continuous engine over
    a paged pool tight enough to preempt: every stream equals its own
    ar_generate stream, the pool ends empty, each dispatch runs without a
    synchronising operation, and every launch is accounted for by the
    per-block formula (no contiguous decode_attention)."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, online, spec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab_size, size=int(rng.choice([6, 9, 12])))
                    .astype(np.int32), max_new=int(rng.choice([6, 10, 16]))) for i in range(7)]
    eng = ServingEngine(model, params, online.init_trainer(model, dvi_params=dvi),
                        scheduler="continuous", num_slots=3, max_new=16, cache_len=40,
                        kv_pages=14, kv_page_size=4, sync_every=3, learn=False)
    eng.warmup()                   # the graph's capture and warm-up block, not counted
    inner, iters = eng._dispatch_superstep, []

    def dispatch():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        iters.append(eng._inflight[0].iters)

    eng._dispatch_superstep = dispatch
    for r in reqs:
        eng.submit_request(r)
    ops.reset_launches()
    outs = {c.uid: c.gen_tokens.tolist() for c in eng.run(max_steps=1000)}
    launches = dict(ops.launches)
    K, k, L, n = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers, sum(iters)
    assert launches == {"paged_decode_attention": ((K + 1) * k + L - k) * n,
                        "lora_logits": (K + 1) * n, "verify_argmax": n, "decode_attention": 0,
                        "ssd_scan": 0}
    kv = eng.kv_stats()
    assert kv["used_pages"] == 0 and kv["preemptions"] > 0
    assert eng.stats["host_syncs"] == eng.stats["dispatches"] == len(iters)
    for r in reqs:
        res = spec.ar_generate(model, params, torch.as_tensor(r.prompt, device="cuda")[None],
                               r.max_new)
        ar = res.tokens[0, len(r.prompt):int(res.lengths[0])].tolist()[:r.max_new]
        if 1 in ar:
            ar = ar[:ar.index(1) + 1]
        assert outs[r.uid] == ar, r.uid


def _ssd_inputs(gen, B, T, H, hd, ds, dtype, pad_rows=0):
    """The scan's inputs as the model gives them: xh, Bc and Cc strided views
    of one conv output (B, T, H*hd + 2*ds), dt after softplus with dt = 0 on
    the last `pad_rows` rows, A < 0."""
    xbc = _randn(gen, B, T, H * hd + 2 * ds, dtype=dtype)
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = (xbc[..., H * hd:H * hd + ds] * 0.5).to(dtype).reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
    dt = torch.nn.functional.softplus(_randn(gen, B, T, H))
    if pad_rows:
        dt[:, T - pad_rows:] = 0.0
    A = -torch.exp(_randn(gen, H, scale=0.3))
    return xh, Bc, Cc, dt, A


# both sides compute in float32: only the order of summation differs
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Q,H,hd,ds,pad,with_h0", [
    (8, 127, 127, 32, 64, 128, 0, False),      # the sync path's bucket-128 prefill
    (1, 95, 95, 32, 64, 128, 0, False),        # a continuous admission of 96 tokens
    (2, 256, 128, 32, 64, 128, 56, False),     # a padded long prompt, dt = 0 rows
    (2, 64, 32, 8, 64, 128, 0, True),          # a carried state
    (3, 40, 8, 8, 64, 32, 3, True),            # the tiny config's widths
    (1, 1, 1, 4, 16, 16, 0, True),             # one row
    (1, 63, 63, 32, 64, 128, 0, False),        # a continuous admission of 64 tokens
    (1, 127, 127, 32, 64, 128, 0, False),      # an admission of 128 tokens, P > 1
    (1, 1, 1, 32, 64, 128, 0, False),          # Q = 1 at P > 1
    (2, 190, 95, 32, 64, 128, 0, False),       # two chunks of 95, no h0
    (2, 190, 95, 32, 64, 128, 4, True),        # two chunks of 95 with h0, padded
    (1, 381, 127, 8, 64, 128, 0, True),        # three chunks of 127 with h0
    (1, 96, 32, 4, 64, 32, 0, False),          # ds 32, slices of 8 columns
    (2, 126, 63, 4, 64, 32, 5, True),          # ds 32 with h0
    (1, 40, 20, 4, 32, 8, 0, True)])           # ds 8: padded to a 16-column tile
def test_ssd_scan(ops, dtype, B, T, Q, H, hd, ds, pad, with_h0):
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(B * T + Q)
    xh, Bc, Cc, dt, A = _ssd_inputs(gen, B, T, H, hd, ds, dtype, pad)
    h0 = _randn(gen, B, H, hd, ds) if with_h0 else None
    ops.reset_launches()
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    assert ops.launches["ssd_scan"] == 1
    y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, y_r, **SSD_TOL)
    torch.testing.assert_close(h, h_r, **SSD_TOL)
    if pad:                                   # dt = 0 rows leave the state as it was
        _, h_np = ref.ssd_scan(xh[:, :T - pad], Bc[:, :T - pad], Cc[:, :T - pad],
                               dt[:, :T - pad], A, 1, h0=h0)
        torch.testing.assert_close(h, h_np, **SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("B,T,Q,with_h0", [(1, 95, 95, False), (2, 254, 127, True)])
def test_ssd_scan_every_slice_width(ops, monkeypatch, dtype, splits, B, T, Q, with_h0):
    """Every slice width the kernel takes at hd 64 (32, 16 and 8 columns a
    CTA), whatever ssd_plan would choose."""
    from repro_torch.kernels import ref
    monkeypatch.setattr(ops, "ssd_plan", lambda *a: splits)
    gen = torch.Generator(device="cuda").manual_seed(B * T + splits)
    xh, Bc, Cc, dt, A = _ssd_inputs(gen, B, T, 32, 64, 128, dtype)
    h0 = _randn(gen, B, 32, 64, 128) if with_h0 else None
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    torch.testing.assert_close(y, y_r, **SSD_TOL)
    torch.testing.assert_close(h, h_r, **SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_cols", [1, 3])
def test_ssd_scan_rows_off_16_bytes(ops, dtype, pad_cols):
    """A conv output whose rows are not a whole number of 16 bytes: the
    kernel copies element by element in place of its 16-byte copies."""
    from repro_torch.kernels import ref
    B, T, Q, H, hd, ds = 2, 126, 63, 8, 64, 32
    gen = torch.Generator(device="cuda").manual_seed(pad_cols)
    xbc = _randn(gen, B, T, H * hd + 2 * ds + pad_cols, dtype=dtype)
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:H * hd + 2 * ds].reshape(B, T, 1, ds)
    dt = torch.nn.functional.softplus(_randn(gen, B, T, H))
    A = -torch.exp(_randn(gen, H, scale=0.3))
    h0 = _randn(gen, B, H, hd, ds)
    assert xh.stride(1) * xh.element_size() % 16 != 0
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    torch.testing.assert_close(y, y_r, **SSD_TOL)
    torch.testing.assert_close(h, h_r, **SSD_TOL)


def test_ssd_scan_rejects_what_it_does_not_take(ops):
    gen = torch.Generator(device="cuda").manual_seed(2)
    xh, Bc, Cc, dt, A = _ssd_inputs(gen, 1, 130, 4, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(xh, Bc, Cc, dt, A, 130)        # a chunk above 128
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(xh, Bc, Cc, dt, A, 100)        # T % chunk != 0
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(xh, Bc, Cc, dt.to(torch.bfloat16), A, 10)


def test_mamba2_greedy_path_on_the_card(ops):
    """mamba2-370m-tiny in bfloat16 on the card: the speculative stream
    equals the AR stream bit for bit (the SSM block runs token by token, so
    the verify pass rounds as one-token AR steps do), and every launch is
    accounted for: 5 lora_logits and 1 verify_argmax per block, no
    attention, and one ssd_scan per SSM layer per prefill call."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.models.model import build_model
    cfg = get_config("mamba2-370m", tiny=True)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    prompts = torch.randint(2, cfg.vocab_size, (3, 40), generator=gen, device="cuda",
                            dtype=torch.int32)
    r_ar = spec.ar_generate(model, params, prompts, 16)
    ops.reset_launches()
    r_sd = spec.speculative_generate(model, params, dvi, prompts, 16, collect=True)
    K, L, n = cfg.dvi.k_spec, cfg.num_layers, r_sd.steps
    assert ops.launches == {"decode_attention": 0, "paged_decode_attention": 0,
                            "lora_logits": (K + 1) * n, "verify_argmax": n, "ssd_scan": L}
    for b in range(3):
        n_b = min(int(r_ar.lengths[b]), int(r_sd.lengths[b]), 40 + 16)
        assert torch.equal(r_ar.tokens[b, :n_b], r_sd.tokens[b, :n_b]), b


# ---------------------------------------------------------------------------
# the block-step replayed from CUDA graphs (core.graphs)
# ---------------------------------------------------------------------------

GRAPH_CELLS = {
    "vicuna_sync": ("vicuna-7b", dict(scheduler="sync", batch_size=3, max_new=16,
                                      buckets=(8, 16))),
    "vicuna_paged": ("vicuna-7b", dict(scheduler="continuous", num_slots=3, max_new=16,
                                       cache_len=40, kv_pages=14, kv_page_size=4,
                                       sync_every=3)),
    "mamba2_sync": ("mamba2-370m", dict(scheduler="sync", batch_size=3, max_new=16,
                                        buckets=(16,))),
    "mamba2_continuous": ("mamba2-370m", dict(scheduler="continuous", num_slots=3,
                                              max_new=16, cache_len=64, sync_every=3)),
}


def _graph_engine_run(name, kw, graphs_on, ops, around=None):
    """A tiny engine (vicuna in float32, mamba2 in its bfloat16) with graphs
    on or off, captured ahead, over seven requests (inside the context
    `around()` when given): (streams, stats, launches, engine)."""
    import contextlib
    from repro_torch.configs import get_config
    from repro_torch.core import lora, online
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(name, tiny=True)
    if name == "vicuna-7b":
        cfg = cfg.replace(dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab_size, size=int(rng.choice([6, 9, 12])))
                    .astype(np.int32), max_new=int(rng.choice([6, 10, 16]))) for i in range(7)]
    eng = ServingEngine(model, params, online.init_trainer(model, dvi_params=dvi),
                        graphs=graphs_on, learn=False, **kw)
    eng.warmup()
    for r in reqs:
        eng.submit_request(r)
    ops.reset_launches()
    with (around or contextlib.nullcontext)():
        outs = {c.uid: c.gen_tokens.tolist() for c in eng.run(max_steps=1000)}
        torch.cuda.synchronize()
    stats = {key: eng.stats[key] for key in ("requests", "blocks", "steps", "committed",
                                            "accepted", "drafted", "preemptions",
                                            "dispatches", "host_syncs")}
    return outs, stats, dict(ops.launches), eng


@pytest.mark.parametrize("cell", list(GRAPH_CELLS))
def test_graphed_paths_match_eager(ops, cell):
    """graphs=True and graphs=False on the card: bit-identical streams,
    equal counts, equal launch counts (under replay, the capture's counts
    once a replay), and the replay buffers equal; the graphed engine
    replayed its graphs and ran nothing eagerly."""
    name, kw = GRAPH_CELLS[cell]
    outs_e, stats_e, launches_e, eng_e = _graph_engine_run(name, kw, False, ops)
    outs_g, stats_g, launches_g, eng_g = _graph_engine_run(name, kw, True, ops)
    assert outs_g == outs_e and len(outs_g) == 7
    assert stats_g == stats_e and launches_g == launches_e
    assert launches_g["lora_logits"] > 0
    for key in eng_e.buf:
        assert torch.equal(eng_g.buf[key], eng_e.buf[key]), key
    g = eng_g.graph_stats()
    assert g["captures"] >= 1 and g["replays"] > 0 and all(n > 0 for n in g["nodes"])
    # each graph holds the kernel nodes its capture counted (mangled names)
    once = {"decode_attention": "11decode_attn", "paged_decode_attention": "17paged_decode_attn",
            "verify_argmax": "14verify_partial", "lora_logits": "9lora_main",
            "ssd_scan": "10ssd_chunks"}
    for recorded, kernel_nodes in g["per_graph"]:
        assert recorded == {k: sum(c for name, c in kernel_nodes.items() if fn in name)
                            for k, fn in once.items()}
        assert recorded["lora_logits"] > 0
    assert eng_e.graph_stats()["captures"] == 0
    if kw["scheduler"] == "continuous":
        assert eng_g._pending is eng_g._runner.state["pending"]
        assert eng_g._cache is eng_g._runner.state["cache"]
        assert eng_g.buf is eng_g._runner.state["buf"]
        if cell == "vicuna_paged":
            assert stats_g["preemptions"] > 0 and eng_g.kv_stats()["used_pages"] == 0


CHUNK_GRAPH_CELLS = {
    "vicuna_paged_chunked": ("vicuna-7b", dict(GRAPH_CELLS["vicuna_paged"][1], prefill_chunk=4)),
    "mamba2_chunked": ("mamba2-370m", dict(GRAPH_CELLS["mamba2_continuous"][1],
                                           prefill_chunk=4)),
}


@pytest.mark.parametrize("cell", list(CHUNK_GRAPH_CELLS))
def test_graphed_chunked_engine_matches_eager(ops, cell):
    """Chunked prefill on the card, the chunk step replayed from its graph
    against the eager chunk step: bit-identical streams, equal counts and
    launches; the chunk graph replayed once a chunk step and holding one
    attention launch a layer (vicuna; none on mamba2) and no vocab kernel."""
    name, kw = CHUNK_GRAPH_CELLS[cell]
    outs_e, stats_e, launches_e, eng_e = _graph_engine_run(name, kw, False, ops)
    outs_g, stats_g, launches_g, eng_g = _graph_engine_run(name, kw, True, ops)
    assert outs_g == outs_e and len(outs_g) == 7
    assert stats_g == stats_e and launches_g == launches_e
    for key in ("prefill_chunks", "prefill_tokens", "max_tick_prefill_tokens"):
        assert eng_g.stats[key] == eng_e.stats[key] > 0, key
    chunk = eng_g._runner.chunk_step
    assert chunk.graph is not None and chunk.replays == eng_g.stats["prefill_chunks"]
    L = eng_g.model.cfg.num_layers
    want = {"decode_attention": 0, "paged_decode_attention": L if "paged" in cell else 0,
            "verify_argmax": 0, "lora_logits": 0, "ssd_scan": 0}
    assert chunk.counts["launches"] == want
    if "paged" in cell:
        assert eng_g.kv_stats()["used_pages"] == 0


def test_replays_count_launches_as_the_profiler_sees_them(ops):
    """Under replay ops.launches counts what the captures recorded, once a
    replay; the profiler sees the graphs' kernels, as many of each."""
    import re

    from torch.profiler import ProfilerActivity, profile
    name, kw = GRAPH_CELLS["vicuna_paged"]
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, _, launches, eng = _graph_engine_run(name, kw, True, ops, around=lambda: prof)
    assert eng.graph_stats()["replays"] > 0
    seen = {"verify_argmax": r"\bverify_partial\b", "lora_logits": r"\blora_main\b",
            "paged_decode_attention": r"(?<![A-Za-z_])paged_decode_attn\b"}
    counts = {kernel: sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and re.search(pat, e.name))
              for kernel, pat in seen.items()}
    assert counts == {kernel: launches[kernel] for kernel in seen} and counts["lora_logits"] > 0


def test_failed_capture_raises(ops):
    """A body that synchronises cannot be captured: the capture raises,
    nothing is counted for it and no graph is kept."""
    from repro_torch.core import graphs
    h = torch.randn(4, 64, device="cuda")
    w = torch.randn(64, 256, device="cuda")

    def body():
        ops.verify_argmax(h, w)
        float(h.sum())                   # a host sync: not allowed while capturing

    ops.reset_launches()
    with pytest.raises(RuntimeError):
        graphs.StepGraph(body, capture=True)
    torch.cuda.synchronize()
    assert ops.launches["verify_argmax"] == 1     # the warm-up's launch alone


# ---------------------------------------------------------------------------
# the Improve loop on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 64])
@pytest.mark.parametrize("T", [1, 8, 64, 65, 256, 512])
def test_lora_logits_gradient(ops, T, r):
    """The autograd.Function over the kernel (bf16 h and w, as the update
    feeds it) against autograd through ref.lora_logits: the forward within
    the kernel's bf16 tolerance, dA and dB within float32 summation order
    (rtol 1e-4, atol 1e-4 x the gradient's largest entry); one launch."""
    from repro_torch.kernels import ref
    d, V = 1024, 4000
    gen = torch.Generator(device="cuda").manual_seed(T * 7 + r)
    h = _randn(gen, T, d, dtype=torch.bfloat16)
    w = _randn(gen, d, V, dtype=torch.bfloat16, scale=d ** -0.5)
    a = _randn(gen, d, r, scale=d ** -0.5).requires_grad_()
    b = _randn(gen, r, V, scale=0.05).requires_grad_()
    G = _randn(gen, T, V)
    ops.reset_launches()
    out = ops.lora_logits(h, w, a, b, 2.0)
    assert ops.launches["lora_logits"] == 1 and out.requires_grad
    (out * G).sum().backward()
    da, db = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    plain = ref.lora_logits(h, w, a, b, 2.0)
    (plain * G).sum().backward()
    torch.testing.assert_close(out, plain.detach(), rtol=2e-3, atol=1e-3)
    for got, want in ((da, a.grad), (db, b.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    assert ops.launches["lora_logits"] == 1      # the backward launches none


def _update_setup(device):
    """Tiny vicuna in float32 with the same weights on `device` (drawn on the
    card, copied), a LoRA head with B != 0 and a replay buffer of random
    tuples; returns (model, params, state)."""
    from repro_torch.configs import get_config
    from repro_torch.core import online
    from repro_torch.models.model import build_model
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg, device=device)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = build_model(cfg).init(gen)
    params = {k: ({n: {kk: t.to(device) for kk, t in seg.items()} for n, seg in v.items()}
                  if k == "segments" else v.to(device)) for k, v in params.items()}
    rng = np.random.default_rng(0)
    d, V, r, S = cfg.d_model, cfg.vocab_size, cfg.dvi.lora_rank, cfg.dvi.buffer_slots
    dvi = {"A": torch.tensor(rng.standard_normal((d, r)) / np.sqrt(d), dtype=torch.float32),
           "B": torch.tensor(rng.standard_normal((r, V)) * 0.05, dtype=torch.float32)}
    state = online.init_trainer(model, dvi_params={k: v.to(device) for k, v in dvi.items()})
    rows = {"h_k": rng.standard_normal((S, d)), "h_L": rng.standard_normal((S, d)),
            "action": rng.integers(0, V, S), "reward": rng.random(S) < 0.6,
            "pos": rng.integers(1, 5, S), "prev": rng.integers(0, V, S),
            "age": rng.integers(3, 5, S)}
    for k, v in rows.items():
        state.buf[k].copy_(torch.tensor(v))
    for k, v in (("ptr", 300), ("count", 300), ("gen", 5)):
        state.buf[k].fill_(v)
    state.step.fill_(350)                     # inside the KL->RL ramp
    return model, params, state


def test_update_step_on_the_card_matches_the_cpu(ops, monkeypatch):
    """One make_update_fn step on the card (the lora_logits kernel in the
    forward, two launches) against the same step on the CPU (the plain
    version), the sampler pinned: metrics and the new A, B within float32
    tolerance (rtol 1e-4: the card's and the CPU's summation orders)."""
    from repro_torch.core import buffer, online

    def pinned(buf, gen, n):
        cnt = torch.clamp(buf["count"].long(), min=1)
        return buffer.rows_at(buf, (torch.arange(n, device=cnt.device) * 37 + 11) % cnt)

    monkeypatch.setattr(buffer, "sample", pinned)
    out = {}
    for device in ("cuda", "cpu"):
        model, params, state = _update_setup(device)
        ops.reset_launches()
        m = online.make_update_fn(model, "full", 1e-3)(params, state,
                                                       torch.Generator(device=device))
        out[device] = ({k: float(v) for k, v in m.items()},
                       {k: v.cpu() for k, v in state.dvi_params.items()},
                       dict(ops.launches))
    (m_g, ab_g, launches), (m_c, ab_c, _) = out["cuda"], out["cpu"]
    assert launches["lora_logits"] == 2
    for k, v in m_c.items():
        assert m_g[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    for k in ("A", "B"):
        torch.testing.assert_close(ab_g[k], ab_c[k], rtol=1e-4, atol=1e-6)


def test_update_dispatch_adds_no_host_sync(ops):
    """The update (the real sampler, its staging output) runs under sync
    debug mode "error": no operation in it synchronises with the host."""
    from repro_torch.core import online
    model, params, state = _update_setup("cuda")
    update = online.make_update_fn(model, "full", 1e-3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    staging = {k: torch.empty_like(v) for k, v in state.dvi_params.items()}
    before = {k: v.clone() for k, v in state.dvi_params.items()}
    update(params, state, gen, out=staging)           # first call: lazy set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = update(params, state, gen, out=staging)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v)) for v in m.values()) and int(state.step) == 352
    for k, v in state.dvi_params.items():
        assert torch.equal(v, before[k])               # the live A, B wait for the fold
        assert not torch.equal(staging[k], before[k])


@pytest.mark.parametrize("cell", ["vicuna_paged", "vicuna_sync"])
def test_graphed_learning_engine_matches_eager(ops, cell):
    """learn=True with graphs on and off on the card: bit-identical streams,
    update counts and final drafter state (A, B, moments, baseline, step);
    A and B keep their addresses."""
    from repro_torch.configs import get_config
    from repro_torch.core import graphs, lora, online
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    name, kw = GRAPH_CELLS[cell]
    cfg = get_config(name, tiny=True).replace(dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    res = {}
    for graphs_on in (False, True):
        state = online.init_trainer(model, dvi_params={k: v.clone() for k, v in dvi.items()})
        eng = ServingEngine(model, params, state, graphs=graphs_on, update_every=2, **kw)
        ptrs = graphs.drafter_ptrs(state.dvi_params)
        eng.warmup()
        rng = np.random.default_rng(0)
        for i in range(7):
            eng.submit_request(Request(i, rng.integers(2, cfg.vocab_size,
                                                       size=int(rng.choice([6, 9, 12])))
                                       .astype(np.int32), max_new=int(rng.choice([6, 10, 16]))))
        outs = {c.uid: c.gen_tokens.tolist() for c in eng.run(max_steps=1000)}
        torch.cuda.synchronize()
        assert graphs.drafter_ptrs(state.dvi_params) == ptrs and eng.stats["updates"] > 0
        res[graphs_on] = (outs, eng.stats["updates"], state)
    (o_e, u_e, s_e), (o_g, u_g, s_g) = res[False], res[True]
    assert o_g == o_e and u_g == u_e
    for k in ("A", "B"):
        assert torch.equal(s_g.dvi_params[k], s_e.dvi_params[k]), k
        assert torch.equal(s_g.opt_state["m"][k], s_e.opt_state["m"][k]), k
        assert torch.equal(s_g.opt_state["v"][k], s_e.opt_state["v"][k]), k
    assert torch.equal(s_g.baseline, s_e.baseline) and torch.equal(s_g.step, s_e.step)


# ---------------------------------------------------------------------------
# the training path: the scan's gradient and a pretraining step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Q,H,with_h0", [(8, 256, 128, 32, False), (2, 40, 8, 8, True)])
def test_ssd_scan_gradient(ops, dtype, B, T, Q, H, with_h0):
    """ops.ssd_scan with inputs requiring gradients (SsdScan): the forward
    is one kernel launch, within SSD_TOL of the plain version, and the
    backward's gradients in the conv output, dt's pre-activation, A_log and
    h0 equal autograd through ref.ssd_scan in float32 up to summation order
    (rtol 1e-4, atol 1e-4 x the gradient's largest entry); the backward
    launches no kernel."""
    from repro_torch.kernels import ref
    hd, ds = 64, 128 if H == 32 else 32
    gen = torch.Generator(device="cuda").manual_seed(B * T)
    xbc = _randn(gen, B, T, H * hd + 2 * ds, dtype=dtype).requires_grad_()
    dt_raw = _randn(gen, B, T, H).requires_grad_()
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda")).requires_grad_()
    h0 = _randn(gen, B, H, hd, ds).requires_grad_() if with_h0 else None
    gy = _randn(gen, B, T, H, hd)

    def run(scan):
        xh = xbc[..., :H * hd].reshape(B, T, H, hd)
        Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
        Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
        y, _ = scan(xh, Bc, Cc, torch.nn.functional.softplus(dt_raw - 2.0), -torch.exp(a_log),
                    Q, h0=h0)
        leaves = [xbc, dt_raw, a_log] + ([h0] if with_h0 else [])
        return y, torch.autograd.grad((y * gy).sum(), leaves)

    ops.reset_launches()
    y, got = run(ops.ssd_scan)
    assert ops.launches["ssd_scan"] == 1
    y_r, want = run(ref.ssd_scan)
    torch.testing.assert_close(y.detach(), y_r.detach(), **SSD_TOL)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    assert ops.launches["ssd_scan"] == 1


def test_pretrain_two_steps_on_the_card_match_the_cpu(ops):
    """Two make_pretrain_step steps of a narrow mamba2 (4 layers, d 256,
    float32) on the card (the ssd_scan kernel forward, SsdScan backward)
    against the same steps on the CPU from the same weights: losses and
    gnorms within rtol 1e-4, one scan launch a layer a step, lm_head equal
    to embed.T at its address after each step."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training import init_pretrain_state, make_pretrain_step
    cfg = get_config("mamba2-370m", tiny=True).replace(dtype="float32", num_layers=4)
    params_c = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (4, 64)))
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        params = {k: (v.to(device) if torch.is_tensor(v) else
                      {s: {n: w.to(device) for n, w in sp.items()} for s, sp in v.items()})
                  for k, v in params_c.items()}
        head, ptr = params["lm_head"], params["lm_head"].data_ptr()
        step = make_pretrain_step(model, 2e-3)
        st = init_pretrain_state(model, params)
        ops.reset_launches()
        losses = []
        for _ in range(2):
            _, _, m = step(params, st, tokens.to(device))
            losses.append((float(m["loss"]), float(m["gnorm"])))
            assert params["lm_head"] is head and head.data_ptr() == ptr
            assert torch.equal(head, params["embed"].T)
        out[device] = (losses, ops.launches["ssd_scan"])
    (l_g, n_g), (l_c, n_c) = out["cuda"], out["cpu"]
    assert n_g == 2 * cfg.num_layers and n_c == 0
    for (a, b), (c, d) in zip(l_g, l_c):
        assert a == pytest.approx(c, rel=1e-4) and b == pytest.approx(d, rel=1e-4)


# ---------------------------------------------------------------------------
# speculative sampling and adaptive depth on the card
# ---------------------------------------------------------------------------

def test_rejection_commit_on_the_card_without_a_sync(ops):
    """One drafted position drawn from q by Gumbel-max on a CUDA generator,
    then ``rejection_commit``, under sync debug mode "error": the emitted
    token's total variation from p is below 0.01 over 2^18 lanes."""
    from repro_torch.core import spec
    V, N = 8, 1 << 18
    p = torch.tensor([0.30, 0.22, 0.15, 0.12, 0.09, 0.06, 0.04, 0.02], device="cuda")
    q = torch.tensor([0.05, 0.05, 0.30, 0.20, 0.10, 0.10, 0.10, 0.10], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = torch.argmax(torch.log(q)[None] + spec.gumbel((N, V), gen, "cuda"), dim=-1)
        d_blk = torch.stack([d, d], dim=1).to(torch.int32)
        m, corr = spec.rejection_commit(d_blk, q.expand(N, 2, V), p.expand(N, 2, V),
                                        generator=gen)
        emitted = torch.where(m >= 1, d_blk[:, 0], corr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    freq = torch.bincount(emitted, minlength=V).double() / N    # bincount syncs
    tv = 0.5 * float((freq - p.double()).abs().sum())
    assert tv < 0.01, f"total variation {tv:.4f}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [2, 3, 4])
def test_attention_at_adaptive_verify_widths(ops, dtype, Tq):
    """The verify pass at K_blk + 1 = 2, 3 and 4 queries a lane: both
    attention kernels against their plain versions, vicuna's widths
    contiguous and the paged cases of ``test_paged_decode_attention``."""
    test_decode_attention(ops, dtype, 8, Tq, 32, 32, 128, 294)
    for G, ps in ((1, 16), (4, 4)):
        test_paged_decode_attention(ops, dtype, Tq, G, ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,G", [(32, 1), (128, 1), (64, 2)])
@pytest.mark.parametrize("paged", [False, True])
def test_attention_at_prefill_chunk_widths(ops, dtype, Tq, G, paged):
    """A chunk step's block of Tq queries a lane, its Tq * G rows a kv head
    cut into row tiles of 64 (1, 2 and 2 tiles; each lane split over C = 2
    CTAs at this capacity): a lane mid-prefill, one at exactly Tq, a lane
    riding along at a decode length below Tq (its first queries see
    nothing), an idle lane and one at the capacity (paged: a -1 entry
    mid-row, the idle lane all -1).  One launch; every query that sees a
    slot matches the plain version, the others are exactly 0."""
    from repro_torch.kernels import ref
    B, KV, hd, ps = 5, 4, 64, 16
    H = KV * G
    mps = 19
    cap = mps * ps
    gen = torch.Generator(device="cuda").manual_seed(Tq * G + paged)
    lens = np.array([Tq + 40, Tq, 20, 0, cap], np.int32)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    lens_t = torch.as_tensor(lens, device="cuda")
    ops.reset_launches()
    if paged:
        rng = np.random.default_rng(Tq * G)
        P = B * mps + 3
        tbl = rng.permutation(np.arange(1, P))[:B * mps].reshape(B, mps).astype(np.int32)
        tbl[0, 3] = -1
        tbl[3] = -1
        kp = _randn(gen, P, ps, KV, hd, dtype=dtype)
        vp = _randn(gen, P, ps, KV, hd, dtype=dtype)
        tbl_t = torch.as_tensor(tbl, device="cuda")
        out = ops.paged_decode_attention(q, kp, vp, lens_t, tbl_t)
        want = ref.paged_decode_attention(q, kp, vp, lens_t, tbl_t)
        page = tbl[:, np.arange(cap) // ps]
        visible = np.array([[bool(((page[b] >= 0) & (np.arange(cap) < min(int(n) - (Tq - 1 - t),
                                                                              cap))).any())
                             for t in range(Tq)] for b, n in enumerate(lens)])
        name = "paged_decode_attention"
    else:
        k = _randn(gen, B, cap, KV, hd, dtype=dtype)
        v = _randn(gen, B, cap, KV, hd, dtype=dtype)
        out = ops.decode_attention(q, k, v, lens_t)
        want = ref.decode_attention(q, k, v, lens_t)
        visible = np.array([[min(int(n) - (Tq - 1 - t), cap) > 0 for t in range(Tq)]
                            for n in lens])
        name = "decode_attention"
    assert ops.launches[name] == 1
    assert ops.attn_splits(cap, B * KV * ops.attn_row_tiles(Tq * G)) == 2
    _close_visible(out, want, visible, dtype)


def test_adaptive_engine_replays_a_graph_per_draft_width(ops):
    """A continuous paged engine with a depth controller that throttles
    fast (lanes admitted at depth 4, a fall-prone band, the default
    cooldown, so a lane's ceiling is its depth or one more): graphed equal
    to eager bit for bit, one graph per draft width captured ahead, more
    than one of them replayed, each holding the kernels its capture
    recorded."""
    from repro_torch.core.schedule import DepthConfig
    name, kw = GRAPH_CELLS["vicuna_paged"]
    dc = DepthConfig(k_min=1, k_max=4, k_init=4, ema_alpha=0.9, hi=0.95, lo=0.8, ema_init=0.9)
    kw = dict(kw, adaptive_k=True, depth_cfg=dc)
    outs_e, stats_e, launches_e, eng_e = _graph_engine_run(name, kw, False, ops)
    outs_g, stats_g, launches_g, eng_g = _graph_engine_run(name, kw, True, ops)
    assert outs_g == outs_e and len(outs_g) == 7
    assert stats_g == stats_e and launches_g == launches_e
    g = eng_g.graph_stats()
    assert g["captures"] == 4 and sorted(eng_g._runner.steps) == [1, 2, 3, 4]
    assert sum(step.replays > 0 for step in eng_g._runner.steps.values()) >= 2
    once = {"decode_attention": "11decode_attn", "paged_decode_attention": "17paged_decode_attn",
            "verify_argmax": "14verify_partial", "lora_logits": "9lora_main",
            "ssd_scan": "10ssd_chunks"}
    for recorded, kernel_nodes in g["per_graph"]:
        assert recorded == {k: sum(c for n, c in kernel_nodes.items() if fn in n)
                            for k, fn in once.items()}
    assert eng_g.kv_stats()["used_pages"] == 0


# the shapes of the baselines and the dense config copies: the qwen3 pair's
# verify heads (d 1024 / 2048, V 151936) and qwen2.5-14b's (d 5120, V 152064)
# at a block's 8 lanes and a verify pass's 40 rows; qwen2.5-14b's draft head
@pytest.mark.parametrize("T", [8, 40])
@pytest.mark.parametrize("d,V", [(1024, 151936), (2048, 151936), (5120, 152064)])
def test_verify_argmax_at_qwen_heads(ops, T, d, V):
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(T + d)
    h = _randn(gen, T, d, dtype=torch.bfloat16)
    w = _randn(gen, d, V, dtype=torch.bfloat16, scale=d ** -0.5)
    arg, mx = ops.verify_argmax(h, w)
    arg_r, mx_r = ref.verify_argmax(h, w)
    torch.testing.assert_close(mx, mx_r, rtol=1e-5, atol=1e-4)
    top = (h.float() @ w.float()).topk(2, dim=-1).values
    assert bool(((arg == arg_r) | ((top[:, 0] - top[:, 1]) <= 1e-4)).all())


def test_lora_logits_at_qwen25_14b(ops):
    from repro_torch.kernels import ref
    T, d, V, r = 8, 5120, 152064, 64
    gen = torch.Generator(device="cuda").manual_seed(14)
    h = _randn(gen, T, d, dtype=torch.bfloat16)
    w = _randn(gen, d, V, dtype=torch.bfloat16, scale=d ** -0.5)
    a = _randn(gen, d, r, scale=d ** -0.5)
    b = _randn(gen, r, V, scale=0.05)
    torch.testing.assert_close(ops.lora_logits(h, w, a, b, 2.0),
                               ref.lora_logits(h, w, a, b, 2.0), rtol=1e-5, atol=1e-4)


# qwen3's GQA group of 2 (16 query heads over 8) at a draft feed, Medusa's
# verify pass and SpS's, and qwen2.5-14b's group of 5 (40 over 8: 25 rows a
# kv head at Tq 5), which is not a power of two
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,H", [(1, 16), (4, 16), (5, 16), (1, 40), (5, 40)])
def test_decode_attention_at_qwen_groups(ops, dtype, Tq, H):
    from repro_torch.kernels import ref
    B, KV, hd, S = 8, 8, 128, 294
    gen = torch.Generator(device="cuda").manual_seed(H * 10 + Tq)
    q = _randn(gen, B, Tq, H, hd, dtype=dtype)
    k = _randn(gen, B, S, KV, hd, dtype=dtype)
    v = _randn(gen, B, S, KV, hd, dtype=dtype)
    lens = np.random.default_rng(H + Tq).integers(Tq, S + 1, size=B)
    lens[0] = Tq
    lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    torch.testing.assert_close(ops.decode_attention(q_in, k, v, lens),
                               ref.decode_attention(q_in, k, v, lens), **TOL[dtype])


def test_baseline_runners_graphed_match_eager(ops):
    """Two-model SpS (qwen3-0.6b-tiny drafting for qwen3-1.7b-tiny) and
    Medusa-lite (vicuna-7b-tiny, 3 heads) in bfloat16: the runners'
    replayed block-steps equal their eager ones and the functional loops
    bit for bit, each graph holding the kernels its capture recorded."""
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, graphs
    from repro_torch.models.model import build_model

    def model(name, seed):
        m = build_model(get_config(name, tiny=True), device="cuda")
        return m, m.init(torch.Generator(device="cuda").manual_seed(seed))

    (tt, tp), (dt, dp), (vm, vp) = (model("qwen3-1.7b", 0), model("qwen3-0.6b", 1),
                                    model("vicuna-7b", 2))
    heads = baselines.init_medusa_heads(torch.Generator(device="cuda").manual_seed(3), vm)
    prompts = torch.randint(2, 512, (4, 12), generator=torch.Generator(device="cuda")
                            .manual_seed(4), device="cuda", dtype=torch.int32)
    cases = [(lambda g: graphs.TwoModelRunner(tt, tp, dt, dp, max_new=16, graphs=g),
              lambda: baselines.two_model_generate(tt, tp, dt, dp, prompts, 16)),
             (lambda g: graphs.MedusaRunner(vm, vp, heads, max_new=16, graphs=g),
              lambda: baselines.medusa_generate(vm, vp, heads, prompts, 16))]
    for make, functional in cases:
        want = functional()
        for g in (False, True):
            runner = make(g)
            for _ in range(2):
                r = runner.generate(prompts)
                assert torch.equal(r.tokens, want.tokens) and torch.equal(r.lengths, want.lengths)
                assert r.steps == want.steps
        stats = runner.graph_stats()
        assert stats["captures"] == 1 and stats["replays"] == 2 * want.steps
        once = {"decode_attention": "11decode_attn", "verify_argmax": "14verify_partial"}
        for recorded, kernel_nodes in stats["per_graph"]:
            for k, fn in once.items():
                assert recorded[k] == sum(c for n, c in kernel_nodes.items() if fn in n) > 0


def _int8_kv(gen, shape, zero_slot=True):
    """K/V of `shape` (..., KV, hd) quantised as the int8 KV cache holds
    them (``kv_quantize``), with the first slot of the first lane all zeros
    (its scale at the 1e-6 floor): (int8 values, float32 scales)."""
    from repro_torch.models.layers import kv_quantize
    x = _randn(gen, *shape)
    if zero_slot:
        x[0, 0] = 0
    return kv_quantize(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("form", ["contiguous", "ring", "paged", "paged_counts"])
def test_attention_reads_the_int8_cache(ops, dtype, Tq, form):
    """The int8 forms of the three attention kernels (the int8 KV cache,
    ``kv_quant``) against the plain versions, which dequantise to the
    query's dtype first: a contiguous cache (GQA G 4, hd 128, a lane past
    its capacity), a ring at recurrentgemma's width (MQA hd 256, G 16,
    wrapped lanes and stale writes) and pooled pages (ps 16, -1 entries,
    with and without page counts); each cache's first slot of lane 0 is
    all zeros.  Every launch counts as an int8 one."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(Tq + len(form))
    ops.reset_launches()
    if form == "contiguous":
        B, H, KV, hd, S = 4, 8, 2, 128, 300
        q = _randn(gen, B, Tq, H, hd, dtype=dtype)
        (k, ks), (v, vs) = _int8_kv(gen, (B, S, KV, hd)), _int8_kv(gen, (B, S, KV, hd))
        lens = torch.tensor([Tq, 150, S, S + 3], dtype=torch.int32, device="cuda")
        args, kw = (k, v, lens), {}
    elif form == "ring":
        B, H, KV, hd, W = 3, 16, 1, 256, 256
        C = W + 128
        q = _randn(gen, B, Tq, H, hd, dtype=dtype)
        (k, ks), (v, vs) = _int8_kv(gen, (B, C, KV, hd)), _int8_kv(gen, (B, C, KV, hd))
        n = [Tq + 20, C + 1, 2 * C + 7]
        pos = torch.as_tensor(np.stack([_ring_pos(m, C, 3) for m in n]), device="cuda")
        lens = torch.as_tensor(n, dtype=torch.int32, device="cuda")
        args, kw = (k, v, lens), dict(pos=pos, window=W)
    else:
        B, H, KV, hd, ps, mps = 4, 16, 4, 128, 16, 6
        rng = np.random.default_rng(Tq)
        P = B * mps + 3
        tbl = rng.permutation(np.arange(1, P))[:B * mps].reshape(B, mps).astype(np.int32)
        tbl[1, 2] = -1
        q = _randn(gen, B, Tq, H, hd, dtype=dtype)
        (k, ks), (v, vs) = _int8_kv(gen, (P, ps, KV, hd)), _int8_kv(gen, (P, ps, KV, hd))
        tbl[0, 0] = 0                       # the all-zero slot sits on lane 0's first page
        lens = torch.tensor([mps * ps + 3, 3 * ps + 2, 40, 2 * ps], dtype=torch.int32,
                            device="cuda")
        args = (k, v, lens, torch.as_tensor(tbl, device="cuda"))
        kw = ({"page_counts": torch.tensor([2, 5, 0, 9], dtype=torch.int32, device="cuda")}
              if form == "paged_counts" else {})
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    fn = "paged_decode_attention" if form.startswith("paged") else "decode_attention"
    got = getattr(ops, fn)(q_in, *args, k_scale=ks, v_scale=vs, **kw)
    want = getattr(ref, fn)(q_in, *args, k_scale=ks, v_scale=vs, **kw)
    torch.testing.assert_close(got, want, **TOL[dtype])
    assert ops.launches[fn] == 1 and ops.attn_kv == {"model": 0, "int8": 1}


def test_int8_attention_rejects_what_it_does_not_take(ops):
    """int8 K/V need their float32 scales, hd a multiple of 16, and the
    causal or ring form: cross K/V stay in the model dtype."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    lens = torch.tensor([3, 4], device="cuda", dtype=torch.int32)
    q = _randn(gen, 2, 4, 40)
    k, ks = _int8_kv(gen, (2, 10, 4, 40), zero_slot=False)
    with pytest.raises(ValueError, match="hd % 16"):
        ops.decode_attention(q, k, k, lens, k_scale=ks, v_scale=ks)
    q = _randn(gen, 2, 4, 32)
    k, ks = _int8_kv(gen, (2, 10, 4, 32), zero_slot=False)
    with pytest.raises(ValueError, match="scales"):
        ops.decode_attention(q, k, k, lens)
    with pytest.raises(ValueError, match="float32"):
        ops.decode_attention(q, k, k, lens, k_scale=ks.bfloat16(), v_scale=ks.bfloat16())
    with pytest.raises(ValueError, match="non-causal"):
        ops.decode_attention(q, k, k, lens, causal=False, k_scale=ks, v_scale=ks)


@pytest.mark.parametrize("cell", ["vicuna_sync", "vicuna_paged"])
def test_int8_cache_paths_on_the_card(ops, cell):
    """Tiny vicuna in float32 with ``kv_quant`` on the card, graphed and
    eagerly: bit-identical streams, every attention launch int8, and each
    completion equal to the int8 model's own ``ar_generate``."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, online, spec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32", kv_quant=True)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab_size, size=int(rng.choice([6, 9, 12])))
                    .astype(np.int32), max_new=int(rng.choice([6, 10, 16]))) for i in range(7)]
    outs = {}
    for graphs_on in (False, True):
        eng = ServingEngine(model, params, online.init_trainer(model, dvi_params=dvi),
                            graphs=graphs_on, learn=False, **GRAPH_CELLS[cell][1])
        eng.warmup()
        for r in reqs:
            eng.submit_request(r)
        ops.reset_launches()
        outs[graphs_on] = {c.uid: c.gen_tokens.tolist() for c in eng.run(max_steps=1000)}
        attn = ops.launches["decode_attention"] + ops.launches["paged_decode_attention"]
        assert attn > 0 and ops.attn_kv == {"model": 0, "int8": attn}
    assert outs[True] == outs[False] and len(outs[True]) == 7
    if cell == "vicuna_sync":
        return                             # the sync engine pads prompts to its buckets
    for r in reqs:
        res = spec.ar_generate(model, params, torch.as_tensor(r.prompt, device="cuda")[None],
                               r.max_new)
        ar = res.tokens[0, len(r.prompt):int(res.lengths[0])].tolist()[:r.max_new]
        if 1 in ar:
            ar = ar[:ar.index(1) + 1]
        assert outs[True][r.uid] == ar, r.uid
