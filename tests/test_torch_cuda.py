"""The port's CUDA kernels against their plain versions on the card, over
shapes the main path does not use (ragged vocab and d, T > 48 rows, r = 1,
GQA groups, Tq > 1, lengths at and past the cache capacity), in float32 and
bfloat16, plus the greedy path on the card.

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
    assert ops.launches == {"verify_argmax": 2, "lora_logits": 0, "decode_attention": 0}


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
                            "lora_logits": (K + 1) * n, "verify_argmax": n}
