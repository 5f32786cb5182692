"""The vocab wrappers' launch plan, checked on the CPU: which loader the
kernels take comes from host integers alone (the pointers' alignment, d and
V), values on the device are never read, the scratch follows the 128-column
strip, and what the kernels do not take is refused before any launch.  The
wrappers' CUDA branch is driven here with its device, stream and launch
replaced; no kernel runs.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture
def launched(monkeypatch):
    """The wrappers' CUDA branch on CPU or meta tensors: returns the list of
    (kernel, launch arguments) they would have launched."""
    calls = []
    monkeypatch.setattr(ops, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(ops, "_stream", lambda dev: None)
    monkeypatch.setattr(ops, "_launch", lambda name, *args: calls.append((name, args)))
    ops.reset_launches()
    yield calls
    ops.reset_launches()


def _shifted(rows, cols, dtype, elems):
    """A contiguous (rows, cols) view that starts `elems` elements past a
    16-byte boundary."""
    flat = torch.zeros(rows * cols + 16, dtype=dtype)
    base = (-flat.data_ptr() % 16) // flat.element_size()
    return flat[base + elems:base + elems + rows * cols].reshape(rows, cols)


# (dtype, d, V): the 16-byte loader needs d and V rows of whole 16-byte
# multiples, so V % 8 == 0 in bf16 and V % 4 == 0 in float32 (d likewise)
LOADER_CASES = [
    (torch.bfloat16, 4096, 32000, True), (torch.bfloat16, 1024, 50280, True),
    (torch.bfloat16, 64, 128, True), (torch.bfloat16, 64, 120, True),
    (torch.bfloat16, 64, 127, False), (torch.bfloat16, 64, 129, False),
    (torch.bfloat16, 64, 1001, False), (torch.bfloat16, 60, 128, False),
    (torch.float32, 64, 128, True), (torch.float32, 64, 132, True),
    (torch.float32, 64, 130, False), (torch.float32, 62, 128, False),
]


@pytest.mark.parametrize("dtype,d,V,fast", LOADER_CASES)
def test_loader_follows_d_and_v(launched, dtype, d, V, fast):
    h = _shifted(3, d, dtype, 0)
    w = _shifted(d, V, dtype, 0)
    assert ops.vocab_fast(h, w) is fast
    ops.verify_argmax(h, w)
    ops.lora_logits(h, w, torch.zeros(d, 2), torch.zeros(2, V), 1.0)
    # verify: h, w, T, d, V, is_bf16, fast, ...; lora: h, w, a, b, gamma, T, d, V, r, is_bf16, fast
    (_, va), (_, la) = launched
    assert va[2:7] == (3, d, V, int(dtype == torch.bfloat16), int(fast))
    assert la[5:11] == (3, d, V, 2, int(dtype == torch.bfloat16), int(fast))
    want = {"fast": int(fast), "element": int(not fast)}
    assert ops.vocab_paths == {"verify_argmax": want, "lora_logits": want}


@pytest.mark.parametrize("which", ["h", "w"])
@pytest.mark.parametrize("elems", [1, 2, 4, 8])
def test_loader_follows_alignment(launched, which, elems):
    """h or w starting off a 16-byte boundary takes the element loader, in
    bf16 (2-byte elements: 8 elements are 16 bytes, the others are not)."""
    h = _shifted(5, 64, torch.bfloat16, elems if which == "h" else 0)
    w = _shifted(64, 256, torch.bfloat16, elems if which == "w" else 0)
    fast = elems % 8 == 0
    assert ops.vocab_fast(h, w) is fast
    ops.verify_argmax(h, w)
    assert launched[0][1][6] == int(fast)
    assert ops.vocab_paths["verify_argmax"] == {"fast": int(fast), "element": int(not fast)}


@pytest.mark.parametrize("T,V", [(40, 32000), (40, 50280), (8, 129), (67, 1001)])
def test_values_on_the_device_are_never_read(launched, T, V):
    """Meta tensors have shapes and no values: any read on the host raises.
    The wrappers plan and launch from their shapes alone."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    h, w = torch.empty((T, 64), **meta), torch.empty((64, V), **meta)
    a = torch.empty((64, 4), device="meta")
    b = torch.empty((4, V), device="meta")
    arg, mx = ops.verify_argmax(h, w)
    out = ops.lora_logits(h, w, a, b, 0.5)
    assert arg.shape == mx.shape == (T,) and out.shape == (T, V)
    assert arg.dtype == torch.int32 and mx.dtype == out.dtype == torch.float32
    assert [name for name, _ in launched] == ["verify_argmax", "lora_logits"]


@pytest.mark.parametrize("T,V,r", [(40, 32000, 64), (8, 50280, 64), (1, 127, 1),
                                   (9, 128, 512), (67, 129, 3)])
def test_scratch_follows_the_strip_width(launched, monkeypatch, T, V, r):
    """verify_argmax's partials hold one (max, arg) per row and 128-column
    strip, nblk = ceil(V / 128), passed to the kernel; lora_logits' u is
    (T, r) float32; the outputs are the kernels' own."""
    made = []
    real_empty = torch.empty

    def spy(shape, *args, **kw):
        made.append((tuple(shape), kw.get("dtype")))
        return real_empty(shape, *args, **kw)

    monkeypatch.setattr(ops.torch, "empty", spy)
    h = real_empty((T, 64), dtype=torch.bfloat16, device="meta")
    w = real_empty((64, V), dtype=torch.bfloat16, device="meta")
    ops.verify_argmax(h, w)
    nblk = -(-V // 128)
    assert ops.VOCAB_COLS == 128
    assert made == [((T, nblk), torch.float32), ((T, nblk), torch.int32),
                    ((T,), torch.int32), ((T,), torch.float32)]
    assert launched[0][1][9] == nblk
    made.clear()
    ops.lora_logits(h, w, real_empty((64, r), device="meta"),
                    real_empty((r, V), device="meta"), 1.0)
    assert made == [((T, r), torch.float32), ((T, V), torch.float32)]


def _refusals():
    bf, f32 = torch.bfloat16, torch.float32
    h, w = torch.zeros(4, 64, dtype=bf), torch.zeros(64, 100, dtype=bf)
    a, b = torch.zeros(64, 2), torch.zeros(2, 100)
    return [
        ("verify: h and w dtypes", lambda: ops.verify_argmax(h, w.float()), "dtype"),
        ("verify: float16", lambda: ops.verify_argmax(h.half(), w.half()), "float32 or bfloat16"),
        ("verify: w not contiguous", lambda: ops.verify_argmax(h, w.t().contiguous().t()),
         "contiguous"),
        ("verify: shapes", lambda: ops.verify_argmax(h, w[:32]), "must be"),
        ("verify: 3-D h", lambda: ops.verify_argmax(h[None], w), "must be"),
        ("lora: rank above 512", lambda: ops.lora_logits(h, w, torch.zeros(64, 513),
                                                         torch.zeros(513, 100), 1.0), "rank"),
        ("lora: a in bf16", lambda: ops.lora_logits(h, w, a.to(bf), b, 1.0), "float32"),
        ("lora: b in bf16", lambda: ops.lora_logits(h, w, a, b.to(bf), 1.0), "float32"),
        ("lora: b's shape", lambda: ops.lora_logits(h, w, a, b[:, :99], 1.0), "chain"),
        ("lora: h and w dtypes", lambda: ops.lora_logits(h.to(f32), w, a, b, 1.0), "dtype"),
        ("lora: a not contiguous", lambda: ops.lora_logits(h, w, torch.zeros(2, 64).t(), b, 1.0),
         "contiguous"),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())), ids=[c[0] for c in _refusals()])
def test_refuses_what_the_kernels_do_not_take(launched, case):
    _, call, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        call()
    assert launched == []
    assert ops.vocab_paths == {"verify_argmax": {"fast": 0, "element": 0},
                               "lora_logits": {"fast": 0, "element": 0}}


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launches()
    h, w = torch.randn(3, 16), torch.randn(16, 130)
    arg, _ = ops.verify_argmax(h, w)
    assert torch.equal(arg, (h @ w).argmax(-1).to(torch.int32))
    ops.lora_logits(h, w, torch.randn(16, 2), torch.randn(2, 130), 1.0)
    assert ops.launches["verify_argmax"] == ops.launches["lora_logits"] == 0
    assert ops.vocab_paths == {"verify_argmax": {"fast": 0, "element": 0},
                               "lora_logits": {"fast": 0, "element": 0}}
