"""The ssd_scan wrapper's launch plan, checked on the CPU: ``ops.ssd_plan``'s
split of each (head, lane) over P CTAs comes from host integers alone, the
scratch and outputs follow the contract, the kernel gets the strided views'
strides, and what the kernel does not take is refused before any launch.
The wrapper's CUDA branch is driven here with its device, stream and launch
replaced; no kernel runs.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the launch arguments of dvi_ssd_scan, by name (ops._ARGTYPES["ssd_scan"])
ARGS = ("xh", "Bc", "Cc", "dt", "A", "h0", "sxb", "sxt", "sbb", "sbt", "scb", "sct", "B",
        "T", "H", "hd", "ds", "Q", "is_bf16", "splits", "y", "hout", "stream")


@pytest.fixture
def launched(monkeypatch):
    """The wrapper's CUDA branch on CPU or meta tensors: returns the list of
    launch-argument dicts it would have launched."""
    calls = []
    monkeypatch.setattr(ops, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(ops, "_stream", lambda dev: None)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, *args: calls.append(dict(zip(ARGS, args), name=name)))
    ops.reset_launches()
    yield calls
    ops.reset_launches()


def _inputs(B, T, H, hd, ds, dtype=torch.bfloat16, device="meta"):
    """xh, Bc and Cc as strided views of one (B, T, H*hd + 2*ds) conv output,
    as ``models/ssm.py`` hands them over; dt and A float32."""
    xbc = torch.empty((B, T, H * hd + 2 * ds), dtype=dtype, device=device)
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
    dt = torch.empty((B, T, H), device=device)
    A = torch.empty((H,), device=device)
    return xh, Bc, Cc, dt, A


def test_arguments_match_the_c_interface():
    assert len(ops._ARGTYPES["ssd_scan"]) == len(ARGS)


M = get_config("mamba2-370m")
MH, MHD, MDS = (M.ssm.expand * M.d_model) // M.ssm.head_dim, M.ssm.head_dim, M.ssm.d_state
TINY = get_config("mamba2-370m", tiny=True)
TH, THD, TDS = ((TINY.ssm.expand * TINY.d_model) // TINY.ssm.head_dim, TINY.ssm.head_dim,
                TINY.ssm.d_state)


@pytest.mark.parametrize("B,H,hd,ds,T,Q,P", [
    (8, MH, MHD, MDS, 127, 127, 2),        # the sync path's bucket-128 prefill
    (1, MH, MHD, MDS, 95, 95, 4),          # a continuous admission of 96 tokens
    (1, MH, MHD, MDS, 63, 63, 4),          # an admission of 64 tokens
    (2, MH, MHD, MDS, 256, 128, 2),        # two lanes: 64 pairs
    (3, TH, THD, TDS, 40, 8, 8),           # the tiny config: 24 pairs, slices of 8
    (1, 4, 16, 16, 1, 1, 2),               # hd 16: slices of 16, then of 8
    (1, 8, 128, 128, 64, 64, 16),          # hd 128: from 4 slices of 32 to 16 of 8
])
def test_plan_at_the_paths_shapes(B, H, hd, ds, T, Q, P):
    assert (MH, MHD, MDS) == (32, 64, 128) and (TH, THD, TDS) == (8, 64, 32)
    assert ops.ssd_plan(B, H, hd, ds, T, Q) == P


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 40, 64, 96, 128])
@pytest.mark.parametrize("pairs", [1, 4, 31, 32, 64, 127, 128, 256, 1024])
def test_plan_rules(hd, pairs):
    """P splits hd into whole slices the kernel takes (32, 16 or 8 columns);
    it is the fewest CTAs that reach SSD_MIN_CTAS, else the narrowest slice;
    more pairs never take more splits."""
    P = ops.ssd_plan(pairs, 1, hd, 128, 128, 128)
    widths = [w for w in ops.SSD_SLICE_WIDTHS if hd % w == 0]
    assert hd % P == 0 and hd // P in widths
    i = widths.index(hd // P)
    if pairs * P < ops.SSD_MIN_CTAS:           # too few CTAs: the narrowest slice
        assert i == len(widths) - 1
    if i > 0:                                 # narrowed only while under the aim
        assert pairs * (hd // widths[i - 1]) < ops.SSD_MIN_CTAS
    assert ops.ssd_plan(2 * pairs, 1, hd, 128, 128, 128) <= P


@pytest.mark.parametrize("hd", [4, 12, 20])
def test_plan_refuses_hd_off_the_slices(hd):
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.ssd_plan(1, 32, hd, 128, 128, 128)


@pytest.mark.parametrize("B,T,Q,with_h0", [(8, 127, 127, False), (1, 95, 95, False),
                                           (2, 256, 128, True), (1, 63, 63, True)])
def test_launch_gets_strides_plan_and_scratch(launched, monkeypatch, B, T, Q, with_h0):
    """The kernel takes the views' strides and ssd_plan's P; the wrapper
    allocates y and the final state and no scratch (C.B^T stays on chip)."""
    made = []
    real_empty = torch.empty

    def spy(shape, *args, **kw):
        made.append((tuple(shape), kw.get("dtype")))
        return real_empty(shape, *args, **kw)

    xh, Bc, Cc, dt, A = _inputs(B, T, MH, MHD, MDS)
    h0 = real_empty((B, MH, MHD, MDS), device="meta") if with_h0 else None
    monkeypatch.setattr(ops.torch, "empty", spy)
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    (call,) = launched
    row = MH * MHD + 2 * MDS
    assert call["name"] == "ssd_scan"
    assert (call["sxb"], call["sxt"]) == (T * row, row) == xh.stride()[:2]
    assert (call["sbb"], call["sbt"]) == Bc.stride()[:2] and (call["scb"], call["sct"]) == \
        Cc.stride()[:2]
    assert (call["B"], call["T"], call["H"], call["hd"], call["ds"], call["Q"]) == \
        (B, T, MH, MHD, MDS, Q)
    assert call["is_bf16"] == 1
    assert call["splits"] == ops.ssd_plan(B, MH, MHD, MDS, T, Q)
    assert (call["h0"] is None) == (h0 is None)
    outs = [((B, T, MH, MHD), torch.float32), ((B, MH, MHD, MDS), torch.float32)]
    assert made == outs
    assert y.shape == (B, T, MH, MHD) and h.shape == (B, MH, MHD, MDS)
    assert y.dtype == h.dtype == torch.float32


def test_float32_inputs_launch_the_float32_instantiation(launched):
    xh, Bc, Cc, dt, A = _inputs(3, 40, TH, THD, TDS, dtype=torch.float32)
    ops.ssd_scan(xh, Bc, Cc, dt, A, 8)
    assert launched[0]["is_bf16"] == 0 and launched[0]["splits"] == 8


def _refusals():
    bf = torch.bfloat16
    xh, Bc, Cc, dt, A = _inputs(1, 64, 4, 64, 32, device="cpu")
    odd_hd = _inputs(1, 64, 4, 60, 32, device="cpu")
    odd_ds = _inputs(1, 64, 4, 64, 36, device="cpu")
    wide = _inputs(1, 64, 4, 64, 136, device="cpu")
    g2 = torch.zeros(1, 64, 2, 32, dtype=bf)
    return [
        ("chunk above 128", lambda: ops.ssd_scan(*_inputs(1, 130, 4, 64, 32, device="cpu"),
                                                 130), "chunk"),
        ("T % chunk", lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, 48), "chunk"),
        ("chunk 0", lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, 0), "chunk"),
        ("hd off the 8s", lambda: ops.ssd_scan(*odd_hd, 64), "multiples of 8"),
        ("ds off the 8s", lambda: ops.ssd_scan(*odd_ds, 64), "multiples of 8"),
        ("ds above 128", lambda: ops.ssd_scan(*wide, 64), "multiples of 8"),
        ("G = 2", lambda: ops.ssd_scan(xh, g2, g2, dt, A, 64), "G = 1"),
        ("dt in bf16", lambda: ops.ssd_scan(xh, Bc, Cc, dt.to(bf), A, 64), "float32"),
        ("xh in float32", lambda: ops.ssd_scan(xh.float(), Bc, Cc, dt, A, 64), "dtype"),
        ("xh's hd not packed", lambda: ops.ssd_scan(xh.transpose(2, 3).contiguous()
                                                    .transpose(2, 3), Bc, Cc, dt, A, 64),
         "packed"),
        ("dt not contiguous", lambda: ops.ssd_scan(xh, Bc, Cc, torch.zeros(1, 4, 64)
                                                   .transpose(1, 2), A, 64), "contiguous"),
        ("h0 shape", lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, 64,
                                          h0=torch.zeros(1, 4, 64, 31)), "h0"),
        ("h0 in bf16", lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, 64,
                                            h0=torch.zeros(1, 4, 64, 32, dtype=bf)), "h0"),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())), ids=[c[0] for c in _refusals()])
def test_refuses_what_the_kernel_does_not_take(launched, case):
    _, call, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        call()
    assert launched == []
    assert ops.launches["ssd_scan"] == 0


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    from repro_torch.kernels import ref
    ops.reset_launches()
    gen = torch.Generator().manual_seed(0)
    xh, Bc, Cc, dt, A = (torch.randn(s, generator=gen) for s in
                         ((1, 16, 2, 8), (1, 16, 1, 8), (1, 16, 1, 8), (1, 16, 2), (2,)))
    y, h = ops.ssd_scan(xh, Bc, Cc, dt.abs(), -A.abs(), 8)
    y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt.abs(), -A.abs(), 8)
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    assert ops.launches["ssd_scan"] == 0


# ---------------------------------------------------------------------------
# SsdScan: the gradient wrapper around the CUDA branch
# ---------------------------------------------------------------------------

@pytest.fixture
def filled(monkeypatch):
    """The CUDA branch with a launch that fills y and the final state from
    the plain version on the inputs the test registers in ``inputs``."""
    from repro_torch.kernels import ref
    made, inputs, calls = {}, {}, []
    real_empty = torch.empty

    def spy(shape, *args, **kw):
        t = real_empty(shape, *args, **kw)
        made[t.data_ptr()] = t
        return t

    def launch(name, *args):
        a = dict(zip(ARGS, args))
        assert a["xh"] == inputs["xh"].data_ptr() and a["dt"] == inputs["dt"].data_ptr()
        y, h = ref.ssd_scan(*(inputs[k].detach() for k in ("xh", "Bc", "Cc", "dt", "A")),
                            a["Q"], h0=None if inputs["h0"] is None else inputs["h0"].detach())
        made[a["y"]].copy_(y)
        made[a["hout"]].copy_(h)
        calls.append(name)

    monkeypatch.setattr(ops, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(ops, "_stream", lambda dev: None)
    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops.torch, "empty", spy)
    yield inputs, calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Q,with_h0", [(40, 8, False), (64, 64, True), (24, 24, False)])
def test_gradients_through_the_cuda_branch(filled, dtype, T, Q, with_h0):
    """ops.ssd_scan with an input requiring a gradient takes SsdScan: one
    launch forward, and the backward's gradients in the conv output (xh,
    Bc, Cc are its strided views), dt's pre-activation, A_log and h0 equal
    autograd through ref.ssd_scan on the same inputs (the backward
    recomputes with the plain version: equal up to float32 summation order,
    rtol 1e-5, atol 1e-6 x the gradient's largest entry)."""
    from repro_torch.kernels import ref
    inputs, calls = filled
    B, H, hd, ds = 2, TH, THD, TDS
    gen = torch.Generator().manual_seed(T)
    xbc = torch.randn((B, T, H * hd + 2 * ds), generator=gen).to(dtype).requires_grad_()
    dt_raw = torch.randn((B, T, H), generator=gen).requires_grad_()
    a_log = torch.log(torch.linspace(1.0, 16.0, H)).requires_grad_()
    h0 = torch.randn((B, H, hd, ds), generator=gen).requires_grad_() if with_h0 else None
    gy = torch.randn((B, T, H, hd), generator=gen)
    gh = torch.randn((B, H, hd, ds), generator=gen)

    def run(scan):
        xh = xbc[..., :H * hd].reshape(B, T, H, hd)
        Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
        Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
        dt = torch.nn.functional.softplus(dt_raw - 2.0)
        A = -torch.exp(a_log)
        inputs.update(xh=xh, Bc=Bc, Cc=Cc, dt=dt, A=A, h0=h0)
        y, h = scan(xh, Bc, Cc, dt, A, Q, h0=h0)
        leaves = [xbc, dt_raw, a_log] + ([h0] if with_h0 else [])
        return y, h, torch.autograd.grad((y * gy).sum() + (h * gh).sum(), leaves)

    y, h, got = run(ops.ssd_scan)
    assert calls == ["ssd_scan"] and y.requires_grad and h.requires_grad
    y_r, h_r, want = run(ref.ssd_scan)
    assert torch.equal(y.detach(), y_r.detach()) and torch.equal(h.detach(), h_r.detach())
    for g, w, name in zip(got, want, ("xBC", "dt", "A_log", "h0")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()),
                                   msg=name)
    assert calls == ["ssd_scan"]                     # the backward launches nothing


def test_no_gradient_takes_the_plain_call(filled):
    """Without autograd recording, or with no input requiring a gradient,
    ops.ssd_scan is the call it was: outputs without a grad_fn."""
    inputs, calls = filled
    xh, Bc, Cc, dt, A = _inputs(1, 16, TH, THD, TDS, dtype=torch.float32, device="cpu")
    inputs.update(xh=xh, Bc=Bc, Cc=Cc, dt=dt.zero_(), A=A.fill_(-1.0), h0=None)
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, 16)
    assert y.grad_fn is None and h.grad_fn is None
    with torch.no_grad():
        y, _ = ops.ssd_scan(xh, Bc, Cc, dt, A.requires_grad_(), 16)
    assert y.grad_fn is None and calls == ["ssd_scan", "ssd_scan"]


def test_plain_scan_gradient_stays_finite_where_the_decay_overflows():
    """A chunk of 128 with dt * |A| large: exp(seg) above the diagonal is
    inf.  The plain version masks inside the exp, so its gradient is
    finite."""
    from repro_torch.kernels import ref
    H = 4
    xh = torch.randn((1, 128, H, 8), generator=torch.Generator().manual_seed(0))
    Bc = torch.randn((1, 128, 1, 8), generator=torch.Generator().manual_seed(1))
    dt = torch.full((1, 128, H), 0.5, requires_grad=True)
    A = -torch.linspace(1.0, 16.0, H)
    y, _ = ref.ssd_scan(xh, Bc, Bc, dt, A, 128)
    (g,) = torch.autograd.grad(y.sum(), (dt,))
    assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(y).all())
