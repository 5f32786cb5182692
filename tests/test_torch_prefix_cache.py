"""The prefix cache on the port, held against the JAX package (the checks of
tests/test_prefix_cache.py): ``copy_page`` and the table-only splice
(``insert_slot(src=None, shared_len)``) equal the reference's on the same
paged cache; the continuous engine with ``prefix_cache=True`` over a pool
tight enough to preempt and evict commits the JAX engine's streams with the
same six prefix stats after each wave of traffic (shared system prompts, a
partly matched page copied on write, a wholly cached prompt), the port's
cold streams and its greedy AR streams; warm lanes decode the cold streams at the block
level, greedy and sampled; the refusals are the reference's.

Tiny vicuna-7b in float32 on the CPU, weights made once and handed to both
packages (``test_torch_chunked._pair``); caches are compared exactly (the
splice moves bits), tokens and counts to equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import KVPool, pages_for  # noqa: E402
from test_torch_chunked import _pair  # noqa: E402

PREFIX_STATS = ("prefix_lookups", "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_cow_copies", "prefix_evictions")
KW = dict(scheduler="continuous", num_slots=3, max_new=8, cache_len=40, kv_pages=14,
          kv_page_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def pair():
    return _pair("vicuna-7b")


def _shared_prefix_requests(cfg, n, sys_len=10, seed=7):
    """The reference's traffic: n requests of two tenants, each tenant's
    requests a shared system prompt of `sys_len` tokens and a short unique
    tail; (uid, prompt, max_new) triples."""
    rng = np.random.default_rng(seed)
    tenants = [rng.integers(2, cfg.vocab_size, sys_len).astype(np.int32) for _ in range(2)]
    out = []
    for i in range(n):
        tail = rng.integers(2, cfg.vocab_size, 3 + i % 3).astype(np.int32)
        out.append((i, np.concatenate([tenants[i % 2], tail]), 8))
    return out


def _waves(cfg):
    """The traffic, in waves each drained before the next: the reference's
    shared system prompts (two tenants, 6 requests over a pool tight enough
    to preempt); a donor whose prompt ends one token into a page; a request
    that copies that partial page on write; the same prompt again, wholly
    cached.  (uid, prompt, max_new) triples."""
    rng = np.random.default_rng(11)
    sysp = rng.integers(2, cfg.vocab_size, 10).astype(np.int32)
    donor = np.concatenate([sysp, rng.integers(2, cfg.vocab_size, 1).astype(np.int32)])
    cow = np.concatenate([sysp, rng.integers(2, cfg.vocab_size, 4).astype(np.int32)])
    return [_shared_prefix_requests(cfg, 6, sys_len=8, seed=5), [(10, donor, 6)],
            [(11, cow, 6)], [(12, cow.copy(), 6)]]


def _serve(eng, waves, req_cls):
    """Serve each wave to the end before submitting the next: ({uid:
    generated tokens}, the stats after each wave)."""
    out, after = {}, []
    for wave in waves:
        for uid, prompt, max_new in wave:
            eng.submit_request(req_cls(uid=uid, prompt=prompt, max_new=max_new))
        got = {c.uid: c.gen_tokens.tolist() for c in eng.run(max_steps=3000)}
        assert sorted(got) == sorted(uid for uid, _, _ in wave) and not eng.busy
        out.update(got)
        after.append({k: eng.stats[k] for k in PREFIX_STATS + ("prefill_tokens",)})
    return out, after


@pytest.fixture(scope="module")
def served(pair):
    """The waves through the port's engine with and without the prefix cache
    and through the JAX engine with it (one of each, 14 pages of 4),
    learn=False on all three: the drafter's updates sample differently in
    the two packages."""
    s = pair
    waves = _waves(s["cfg"])

    def port(prefix_cache):
        return ServingEngine(s["model_t"], s["params_t"],
                             tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"]),
                             learn=False, prefix_cache=prefix_cache, **KW)

    out = dict(waves=waves, warm=port(True), cold=port(False),
               ref=JEngine(s["model_j"], s["params_j"], s["state"], learn=False,
                           prefix_cache=True, **KW))
    for name in ("warm", "cold", "ref"):
        out["got_" + name], out["after_" + name] = _serve(
            out[name], waves, JRequest if name == "ref" else Request)
    return out


# ---------------------------------------------------------------------------
# 1) the cache surgery: copy_page and the table-only splice == the reference's
# ---------------------------------------------------------------------------

def test_copy_page_and_table_splice_match_jax(pair):
    cfg = pair["cfg"]
    rng = np.random.default_rng(0)
    cj = pair["model_j"].init_paged_cache(2, 8, 4, 4)
    cj = dict(cj, segs={n: dict(c, kp=jnp.asarray(rng.standard_normal(c["kp"].shape,
                                                                      np.float32)),
                                vp=jnp.asarray(rng.standard_normal(c["vp"].shape, np.float32)))
                        for n, c in cj["segs"].items()})
    ct = pair["model_t"].init_paged_cache(2, 8, 4, 4)
    for name, seg in ct["segs"].items():
        for key in ("kp", "vp"):
            seg[key].copy_(torch.from_numpy(np.array(cj["segs"][name][key])))
    row = np.array([3, 5, 6, -1], np.int32)
    cj = jtfm.copy_page(cj, jnp.int32(2), jnp.int32(6))
    cj = jtfm.map_slot_pages(cj, jnp.int32(1), jnp.asarray(row))
    cj = jtfm.insert_slot(cfg, cj, None, jnp.int32(1), shared_len=9)
    ptrs = {(n, k): t.data_ptr() for n, c in ct["segs"].items() for k, t in c.items()}
    lengths_ptr = ct["lengths"].data_ptr()
    out = tfm.copy_page(ct, 2, 6)
    tfm.map_slot_pages(out, 1, torch.from_numpy(row))
    out = tfm.insert_slot(cfg, out, None, 1, shared_len=9)
    for name, seg in out["segs"].items():
        for key in ("kp", "vp"):
            np.testing.assert_array_equal(seg[key].numpy(), np.asarray(cj["segs"][name][key]))
            np.testing.assert_array_equal(seg[key][:, 6].numpy(), seg[key][:, 2].numpy())
    np.testing.assert_array_equal(out["lengths"].numpy(), np.asarray(cj["lengths"]))
    np.testing.assert_array_equal(out["tbl"].numpy(), np.asarray(cj["tbl"]))
    # in place: the graphs hold these addresses
    assert {(n, k): t.data_ptr() for n, c in out["segs"].items() for k, t in c.items()} == ptrs
    assert out["lengths"].data_ptr() == lengths_ptr and out is ct
    # a tensor length works too
    tfm.insert_slot(cfg, ct, None, 0, shared_len=torch.tensor(5, dtype=torch.int32))
    assert int(ct["lengths"][0]) == 5


def test_table_splice_refusals_match_jax(pair):
    """Without ``shared_len`` and over a contiguous cache the splice raises
    what the reference raises."""
    cfg, model_j, model_t = pair["cfg"], pair["model_j"], pair["model_t"]
    cases = [(model_j.init_paged_cache(2, 8, 4, 4), model_t.init_paged_cache(2, 8, 4, 4), {}),
             (model_j.init_cache(2, 16), model_t.init_cache(2, 16), {"shared_len": 4})]
    for cj, ct, kw in cases:
        with pytest.raises(Exception) as ej:
            jtfm.insert_slot(cfg, cj, None, jnp.int32(0), **kw)
        with pytest.raises(Exception) as et:
            tfm.insert_slot(cfg, ct, None, 0, **kw)
        assert type(et.value) is type(ej.value)
        assert type(et.value) in (ValueError, NotImplementedError)


# ---------------------------------------------------------------------------
# 2) warm == cold at the block level, greedy and sampled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_shared_pages_match_cold_stream(pair, temperature):
    """Two lanes with one page-aligned prompt: both cold-prefilled, or lane
    1 splicing lane 0's prefix pages through its table alone.  The same
    draws give the same accept counts and committed tokens, greedy and with
    rejection sampling."""
    cfg, model, params, dvi = pair["cfg"], pair["model_t"], pair["params_t"], pair["dvi_t"]
    K = cfg.dvi.k_spec
    B, Tp, ps, mps = 2, 9, 4, 16                     # prompt[:-1] = 2 pages
    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, Tp).astype(np.int64)
    prompts = torch.from_numpy(np.tile(prompt[None], (B, 1)))

    def grow(cache, pool, lens):
        for b in range(B):
            need = pages_for(lens[b], ps)
            if need > len(pool.owned(b)):
                assert pool.ensure(b, need) is not None
                row = np.full(mps, -1, np.int32)
                owned = pool.owned(b)
                row[:len(owned)] = owned
                tfm.map_slot_pages(cache, b, torch.from_numpy(row))
        return cache

    def setup(shared):
        pool = KVPool(num_pages=2 * mps, page_size=ps)
        cache = model.init_paged_cache(B, pool.num_pages, ps, mps)
        grow(cache, pool, [Tp - 1 + K + 2] * B)
        _, pc = model.prefill(params, prompts[:1, :-1], max_len=Tp - 1)
        tfm.insert_slot(cfg, cache, pc, 0)
        if shared:
            pool.free(1)
            pool.publish_prefix(0, prompt[:-1].tolist())
            hit = pool.acquire_prefix(1, prompt[:-1].tolist())
            assert hit.tokens == Tp - 1 and hit.cow_tokens == 0
            assert pool.ensure(1, pages_for(Tp - 1 + K + 2, ps)) is not None
            owned = pool.owned(1)
            assert owned[:2] == pool.owned(0)[:2], "pages not shared"
            row = np.full(mps, -1, np.int32)
            row[:len(owned)] = owned
            tfm.map_slot_pages(cache, 1, torch.from_numpy(row))
            tfm.insert_slot(cfg, cache, None, 1, shared_len=Tp - 1)
        else:
            _, pc = model.prefill(params, prompts[1:, :-1], max_len=Tp - 1)
            tfm.insert_slot(cfg, cache, pc, 1)
        return pool, cache

    streams = {}
    for shared in (False, True):
        pool, cache = setup(shared)
        pending = prompts[:, -1].to(torch.int32)
        gen = torch.Generator().manual_seed(42)
        lens, out = [Tp - 1] * B, [[], []]
        for _ in range(5):
            grow(cache, pool, [t + K + 2 for t in lens])
            blk = tspec.spec_block_step(model, params, dvi, pending, cache,
                                        temperature=temperature,
                                        generator=gen if temperature > 0 else None)
            pending, cache = blk.pending, blk.cache
            for b in range(B):
                out[b] += blk.commit_vec[b, :int(blk.accept[b])].tolist()
            lens = [t + int(blk.accept[b]) for b, t in enumerate(lens)]
        streams[shared] = out
    assert streams[True] == streams[False], (
        f"sharing changed the committed stream (temperature={temperature})")
    if temperature == 0.0:               # greedy: both lanes hold one prompt
        assert streams[True][0] == streams[True][1]


# ---------------------------------------------------------------------------
# 3) the engine: == the JAX engine (streams and the six prefix stats), == cold
# ---------------------------------------------------------------------------

def test_engine_prefix_cache_matches_jax(served):
    """The JAX engine's streams and stats, wave by wave, and the cold
    streams; hits that save prefill work; a leak-free drain."""
    warm, ref, cold = served["warm"], served["ref"], served["cold"]
    assert served["got_warm"] == served["got_ref"] == served["got_cold"]
    assert served["after_warm"] == served["after_ref"]
    for key in ("prefill_chunks", "preemptions", "requests", "blocks", "committed",
                "accepted", "drafted", "dispatches", "host_syncs"):
        assert warm.stats[key] == ref.stats[key], key
    kv = warm.kv_stats()
    assert kv["prefix_hits"] > 0 and kv["prefix_hit_tokens"] >= kv["prefix_hits"]
    assert kv["prefix_hits"] + kv["prefix_misses"] == kv["prefix_lookups"]
    for key in ("prefix_lookups", "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_evictions"):
        assert kv[key] == warm.stats[key], key
    assert warm.stats["prefill_tokens"] < cold.stats["prefill_tokens"]
    assert cold.stats["prefix_lookups"] == 0, "the cold engine must not look up"
    # leak-free drain: nothing live, every page free or evictable-cached
    assert kv["used_pages"] == 0 and warm.active_slots == 0
    assert kv["free_pages"] + kv["cached_pages"] == kv["num_pages"]


def test_engine_prefix_cow_and_fully_cached(served):
    """The third wave copies the donor's partial page on write; the fourth
    is admitted wholly cached: no prefill token at all."""
    after = served["after_warm"]
    assert after[2]["prefix_cow_copies"] > after[1]["prefix_cow_copies"]
    assert after[2]["prefix_hit_tokens"] - after[1]["prefix_hit_tokens"] >= 10
    assert after[3]["prefix_hits"] == after[2]["prefix_hits"] + 1
    assert after[3]["prefill_tokens"] == after[2]["prefill_tokens"]
    assert after[3]["prefix_hit_tokens"] - after[2]["prefix_hit_tokens"] == 13
    assert served["got_warm"][12] == served["got_warm"][11]


def test_engine_prefix_cache_preemption_lossless(served, pair):
    """The tight pool preempts while prefixes are shared and evicts cached
    pages; replayed lanes re-acquire warm, and every stream is the port's
    greedy AR stream."""
    warm = served["warm"]
    assert warm.stats["preemptions"] > 0, "the pool was not tight enough to preempt"
    assert warm.stats["prefix_evictions"] > 0, "no cached page was evicted"
    model, params = pair["model_t"], pair["params_t"]
    for uid, prompt, max_new in [r for wave in served["waves"] for r in wave]:
        ar = tspec.ar_generate(model, params, torch.from_numpy(prompt.astype(np.int64))[None],
                               max_new)
        ref = ar.tokens[0, len(prompt):int(ar.lengths[0])].tolist()[:max_new]
        ref = ref[:ref.index(1) + 1] if 1 in ref else ref
        assert served["got_warm"][uid] == ref, uid


def test_engine_prefix_cache_rejects_bad_config(pair):
    """The reference's three refusals: no paged pool, no chunked prefill,
    a segment that is not attention."""
    s = pair
    state = tonline.init_trainer(s["model_t"], dvi_params=s["dvi_t"])
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(s["model_t"], s["params_t"], state, scheduler="continuous",
                      cache_len=40, prefix_cache=True)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(s["model_t"], s["params_t"], state, scheduler="continuous",
                      cache_len=40, kv_pages=20, kv_page_size=4, prefix_cache=True)
    cfg_m = get_config("mamba2-370m", tiny=True).replace(dtype="float32")
    model_m = build_model(cfg_m, device="cpu")
    params_m = model_m.init(torch.Generator().manual_seed(0))
    state_m = tonline.init_trainer(model_m, torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="attention"):
        ServingEngine(model_m, params_m, state_m, scheduler="continuous", cache_len=40,
                      kv_pages=20, kv_page_size=4, prefill_chunk=4, prefix_cache=True)
