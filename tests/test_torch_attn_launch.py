"""The attention wrappers' launch plan, checked on the CPU: the choice of C,
the CTAs of one cluster that split a lane's slots, comes from host integers
(the capacity and the number of (lane, kv head) pairs, never the lengths on
the card), the shares cover a lane's live slots exactly, and the wrappers
pass C to the kernel and refuse what it does not take.  The wrappers' CUDA branch is driven here with
its device, stream and launch replaced; no kernel runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402


@pytest.mark.parametrize("pairs", [1, 8, 16, 33, 64, 132, 256, 4096])
def test_splits_are_cluster_sizes_non_decreasing_in_capacity(pairs):
    cs = [ops.attn_splits(cap, pairs) for cap in range(1, 5001)]
    assert set(cs) <= {1, 2, 4, 8}
    assert all(a <= b for a, b in zip(cs, cs[1:]))
    assert cs[0] == 1


def test_every_split_is_reachable_and_fewer_pairs_split_more():
    assert {ops.attn_splits(cap, 16) for cap in (64, 256, 512, 1024)} == set(ops.ATTN_SPLITS)
    assert ops.attn_splits(294, 8 * 32) == 1      # the vicuna paths: one CTA a pair
    for cap in (64, 300, 1000):
        cs = [ops.attn_splits(cap, pairs) for pairs in range(1, 600)]
        assert all(a >= b for a, b in zip(cs, cs[1:]))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_shares_cover_the_live_slots_once(splits):
    for n in range(0, 700):
        share = ops.attn_share(n, splits)
        assert share % ops.ATTN_SUBTILE == 0
        bounds = [(min(c * share, n), min((c + 1) * share, n)) for c in range(splits)]
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in bounds])
        assert np.array_equal(covered, np.arange(n))


@pytest.fixture
def launched(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: returns the list of
    (kernel, launch arguments) they would have launched."""
    calls = []
    monkeypatch.setattr(ops, "_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(ops, "_stream", lambda dev: None)
    monkeypatch.setattr(ops, "_launch", lambda name, *args: calls.append((name, args)))
    return calls


def _meta_lengths(B):
    """Lengths whose values cannot be read: any read on the host raises."""
    return torch.empty((B,), dtype=torch.int32, device="meta")


@pytest.mark.parametrize("S", [16, 64, 65, 200, 294, 1000])
def test_decode_attention_splits_by_capacity_never_by_lengths(launched, S):
    q = torch.zeros(3, 5, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(3, S, 2, 32, dtype=torch.bfloat16)
    ops.decode_attention(q, k, k, _meta_lengths(3))
    for lens in ([0, 0, 0], [S, S, S], [1, S + 7, S // 2]):
        ops.decode_attention(q, k, k, torch.tensor(lens, dtype=torch.int32))
    assert [name for name, _ in launched] == ["decode_attention"] * 4
    # q, k, v, lengths, out, B, Tq, H, KV, hd, S, scale, splits, is_bf16, stream
    assert {args[12] for _, args in launched} == {ops.attn_splits(S, 3 * 2)}
    assert {args[5:11] for _, args in launched} == {(3, 5, 4, 2, 32, S)}


@pytest.mark.parametrize("ps,mps", [(16, 1), (16, 4), (16, 19), (4, 74), (1, 300)])
def test_paged_decode_attention_splits_by_capacity_never_by_lengths(launched, ps, mps):
    q = torch.zeros(2, 4, 32, dtype=torch.bfloat16)
    kp = torch.zeros(9, ps, 4, 32, dtype=torch.bfloat16)
    tbl = torch.full((2, mps), -1, dtype=torch.int32)
    ops.paged_decode_attention(q, kp, kp, _meta_lengths(2), tbl)
    ops.paged_decode_attention(q, kp, kp, torch.tensor([0, mps * ps], dtype=torch.int32), tbl)
    # q, k_pages, v_pages, lengths, tables, out, B, Tq, H, KV, hd, ps, MPS,
    # scale, splits, is_bf16, stream
    assert {args[14] for _, args in launched} == {ops.attn_splits(mps * ps, 2 * 4)}
    assert {args[6:13] for _, args in launched} == {(2, 1, 4, 4, 32, ps, mps)}


@pytest.mark.parametrize("dtype,hd,ok", [
    (torch.bfloat16, 32, True), (torch.bfloat16, 48, True), (torch.bfloat16, 256, True),
    (torch.bfloat16, 40, False), (torch.bfloat16, 8, False), (torch.bfloat16, 272, False),
    (torch.float32, 36, True), (torch.float32, 4, True), (torch.float32, 38, False)])
def test_attention_head_dims_the_kernels_take(launched, dtype, hd, ok):
    q = torch.zeros(2, 4, hd, dtype=dtype)
    k = torch.zeros(2, 10, 4, hd, dtype=dtype)
    tbl = torch.tensor([[1, -1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    for call in (lambda: ops.decode_attention(q, k, k, lens),
                 lambda: ops.paged_decode_attention(q, k.reshape(4, 5, 4, hd),
                                                    k.reshape(4, 5, 4, hd), lens, tbl)):
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="hd"):
                call()
    assert len(launched) == (2 if ok else 0)


def test_attention_rows_and_alignment(launched):
    """Tq * G query rows past one CTA's 64 are cut into row tiles and still
    launch once (80 rows: 5 queries x 16 heads; 256 rows: a chunk of 128
    queries at G = 2); Tq past a prefill chunk's bound of 128 and K/V off
    16 bytes are refused."""
    lens = torch.tensor([3, 4], dtype=torch.int32)
    k = torch.zeros(2, 10, 1, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Tq <= 128"):
        ops.decode_attention(torch.zeros(2, 129, 1, 32, dtype=torch.bfloat16), k, k, lens)
    flat = torch.zeros(2 * 10 * 32 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 10 * 32].reshape(2, 10, 1, 32)     # 2 bytes past 16
    with pytest.raises(ValueError, match="16 bytes"):
        ops.decode_attention(torch.zeros(2, 4, 32, dtype=torch.bfloat16), shifted, shifted,
                             lens)
    assert launched == []
    ops.decode_attention(torch.zeros(2, 5, 16, 32, dtype=torch.bfloat16), k, k, lens)
    k2 = torch.zeros(2, 10, 4, 32, dtype=torch.bfloat16)
    ops.decode_attention(torch.zeros(2, 128, 8, 32, dtype=torch.bfloat16), k2, k2, lens)
    tbl = torch.tensor([[1, -1], [2, 3]], dtype=torch.int32)
    pages = k2.reshape(4, 5, 4, 32)
    ops.paged_decode_attention(torch.zeros(2, 128, 8, 32, dtype=torch.bfloat16), pages, pages,
                               lens, tbl)
    assert [name for name, _ in launched] == ["decode_attention"] * 2 + [
        "paged_decode_attention"]
    # B, Tq, H, KV: 80 rows in 2 tiles of one kv head, 256 rows in 4 tiles
    # of each of 4 kv heads; C from the (lane, kv head, row tile) triples
    assert launched[0][1][5:9] == (2, 5, 16, 1) and ops.attn_row_tiles(80) == 2
    assert launched[1][1][5:9] == (2, 128, 8, 4) and ops.attn_row_tiles(256) == 4
    assert launched[1][1][12] == ops.attn_splits(10, 2 * 4 * 4)
    assert launched[2][1][6:10] == (2, 128, 8, 4)
    assert launched[2][1][14] == ops.attn_splits(10, 2 * 4 * 4)


@pytest.mark.parametrize("rows,tiles", [(1, 1), (64, 1), (65, 2), (128, 2), (129, 3),
                                        (256, 4)])
def test_row_tiles_cover_the_rows(rows, tiles):
    assert ops.attn_row_tiles(rows) == tiles
    assert (tiles - 1) * ops.ATTN_MAX_ROWS < rows <= tiles * ops.ATTN_MAX_ROWS
