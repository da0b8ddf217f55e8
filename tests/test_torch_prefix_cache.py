"""The port's prefix cache held to paddle_tpu's.

Unit parity: the refcount / allocator sequence of
tests/test_prefix_cache.py gives the same page ids, refcounts and free
counts in both packages; `chain_digests` bytes are equal;
`paged_gather_layers`, `paged_prefix_attention` (scalar and per-row
prefix_len) and `gpt_prefill_extend` match within rtol 1e-5, atol 1e-5
in float32 on the same seeded inputs.

Engine parity: both engines serve the bridged tiny GPT (float32, CPU)
with the prefix cache on. Greedy output is token-identical to the JAX
engine's and to the port's own cache-off run (and generate());
`stats()["compiles"]` matches the JAX engine's ledger key for key, and
the prefix numbers (hits, misses, hit tokens, evictions, nodes, cached
pages) are equal."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import paged_ops as jpo
from paddle_tpu.serving.kv_cache import PagedKVCache as JCache
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefix
from paddle_tpu.serving.prefix_cache import chain_digests as jdigests
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_ops as tpo
from paddle_tpu_torch.serving import GenerationEngine, PagedKVCache
from paddle_tpu_torch.serving.prefix_cache import PrefixCache, chain_digests

TOL = dict(rtol=1e-5, atol=1e-5)
# the prefix numbers both engines report under stats()["kv"]["prefix"]
PREFIX_KEYS = ("enabled", "max_pages", "nodes", "cached_pages",
               "evictable_pages", "hits", "misses", "hit_tokens",
               "evictions")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(4, 16),
           max_new_tokens=5, request_timeout_ms=0, prefix_cache=True)


def _shared_prefix_prompts(n=3, pfx=8, tail=3, seed=0, vocab=512):
    """n prompts sharing one `pfx`-token prefix (a multiple of the 4-token
    page) with distinct `tail` tokens."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, size=(pfx,)).astype("int64")
    return [np.concatenate([prefix, rng.randint(0, vocab, size=(tail,))
                            .astype("int64")]) for _ in range(n)]


def _generate(port, prompt, n):
    return port.generate(np.asarray(prompt)[None], max_new_tokens=n) \
        .numpy()[0]


def _serve(eng, script):
    """Run `script(eng)` -> outputs on an engine, then shut it down;
    returns (outputs, stats)."""
    with eng:
        outs = script(eng)
        stats = eng.stats()
    return outs, stats


def _both(pair, script, **kw):
    """The same script through the JAX engine, the port's engine and the
    port's engine with the prefix cache off."""
    ref, port = pair
    cfg = {**_KW, **kw}
    jout, jst = _serve(jserving.GenerationEngine(ref, **cfg), script)
    tout, tst = _serve(GenerationEngine(port, device="cpu", **cfg), script)
    off, _ = _serve(GenerationEngine(port, device="cpu",
                                     **{**cfg, "prefix_cache": False}),
                    script)
    for t, j, o in zip(tout, jout, off):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, o)
    assert tst["compiles"] == jst["compiles"]
    tp, jp = tst["kv"]["prefix"], jst["kv"]["prefix"]
    assert {k: tp[k] for k in PREFIX_KEYS} == {k: jp[k] for k in PREFIX_KEYS}
    return tout, tst, jst


# -- unit parity -------------------------------------------------------------

def _allocator_trace(cache_cls, index_cls, **dev):
    """tests/test_prefix_cache.py's refcount and index sequences, logging
    page ids, refcounts and free counts at every step."""
    log = []

    def snap(c, *extra):
        log.append((tuple(int(x) for x in extra), sorted(
            c.refcounts().items()), c.free_pages, c.pages_in_use,
            c.evictable_pages, c.reclaimable_pages))

    c = cache_cls(num_layers=2, num_heads=2, head_dim=4, page_size=4,
                  num_pages=16, pages_per_seq=4, **dev)
    row_a = c.alloc(1, 9)
    shared = [int(row_a[0]), int(row_a[1])]
    row_b = c.alloc_shared(2, 12, shared)
    snap(c, *row_a, *row_b)
    snap(c, *sorted(c.free(1)))
    snap(c, *sorted(c.free(2)))

    c = cache_cls(num_layers=1, num_heads=1, head_dim=4, page_size=4,
                  num_pages=8, pages_per_seq=4, **dev)
    row = c.alloc(1, 8)
    held = [int(row[0]), int(row[1])]
    c.cache_hold(held)
    snap(c, *row)
    snap(c, *c.free(1))
    log.append((c.can_admit(16), c.can_admit(28),
                sorted(c.headroom([8, 12, 28]).items())))
    c.alloc_shared(2, 8, held)
    new = c.cow_split(2, held[1])
    snap(c, new, *c.owned(2))
    with pytest.raises(Exception, match="not shared") as err:
        c.cow_split(2, new)
    log.append(type(err.value).__name__)
    snap(c, *c.cache_release(held))
    snap(c, *sorted(c.free(2)))

    c = cache_cls(num_layers=1, num_heads=1, head_dim=4, page_size=4,
                  num_pages=16, pages_per_seq=4, **dev)
    idx = index_cls(c, "t")
    prompt = np.arange(10, dtype=np.int64)
    digests, hit = idx.lookup(prompt)
    row = c.alloc(1, 10)
    idx.register(digests, row)
    snap(c, len(idx), *hit)
    _, hit2 = idx.lookup(np.arange(16, dtype=np.int64))
    diverged = np.concatenate([np.arange(4), np.arange(40, 44)])
    _, hit3 = idx.lookup(diverged.astype(np.int64))
    snap(c, *hit2, -1, *hit3)
    c.free(1)
    freed = idx.evict(2)
    snap(c, len(idx), idx.evictions, *sorted(freed))
    snap(c, *idx.lookup(prompt)[1])
    return log


def test_refcount_and_allocator_sequence_matches_jax():
    want = _allocator_trace(JCache, JPrefix)
    got = _allocator_trace(PagedKVCache, PrefixCache, device="cpu")
    assert got == want


def test_cache_hold_survives_free_and_evicts_lru_leaf_first():
    """Port-only detail of the index: a chain outlives its producer,
    eviction takes the least-recently-used leaf before its parent, and
    a refcount-1 leaf goes before one a live sequence shares."""
    c = PagedKVCache(num_layers=1, num_heads=1, head_dim=4, page_size=4,
                     num_pages=16, pages_per_seq=4, device="cpu")
    idx = PrefixCache(c, "t", max_pages=0)
    a = np.arange(8, dtype=np.int64)
    b = np.arange(100, 108, dtype=np.int64)
    row_a = c.alloc(1, 8)
    idx.register(idx.lookup(a)[0], row_a)
    row_b = c.alloc(2, 8)
    idx.register(idx.lookup(b)[0], row_b)
    assert c.free(1) == [] and c.evictable_pages == 2
    idx.lookup(a)                           # a is now the most recent
    freed = idx.evict(1)                    # b is live: a's leaf goes
    assert freed == [int(row_a[1])]
    assert idx.lookup(a)[1] == [int(row_a[0])]


@pytest.mark.parametrize("P", [1, 4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_digests_byte_equal(P, seed):
    toks = np.random.RandomState(seed).randint(0, 50304, size=(67,))
    for ids in (toks, toks.astype(np.int64), list(toks)):
        assert chain_digests(ids, P) == jdigests(np.asarray(ids), P)
    assert len(chain_digests(toks, P)) == 67 // P


def test_paged_gather_layers_matches():
    rng = np.random.RandomState(3)
    pages = rng.standard_normal((2, 3, 9, 4, 8)).astype(np.float32)
    pt = np.array([4, 1, 7, 0, 0], np.int32)
    want = np.asarray(jpo.paged_gather_layers(jnp.asarray(pages),
                                              jnp.asarray(pt)))
    got = tpo.paged_gather_layers(torch.from_numpy(pages),
                                  torch.from_numpy(pt)).numpy()
    assert got.shape == want.shape == (2, 3, 20, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_prefix_attention_matches(per_row, seed):
    rng = np.random.RandomState(seed)
    B, H, S, T, D = 3, 2, 5, 12, 8
    q, kt, vt = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                 for _ in range(3))
    kb, vb = (rng.standard_normal((B, H, T, D)).astype(np.float32)
              for _ in range(2))
    kb[:, :, 9:] = 1e3          # past every prefix: must contribute 0
    pl = (np.array([0, 4, 9], np.int32) if per_row else 7)
    args_j = [jnp.asarray(x) for x in (q, kb, vb, kt, vt)]
    want = np.asarray(jpo.paged_prefix_attention(
        *args_j, jnp.asarray(pl) if per_row else pl, 0.3))
    args_t = [torch.from_numpy(x) for x in (q, kb, vb, kt, vt)]
    got = tpo.paged_prefix_attention(
        *args_t, torch.from_numpy(pl) if per_row else pl, 0.3).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()


def test_gpt_prefill_extend_matches(pair):
    """A tail of 6 tokens at positions 8..13 over an 8-token cached
    prefix (the prefill's own K/V), attended through
    paged_prefix_attention in both packages."""
    ref, port = pair
    cfg = ref.gpt.config
    H = cfg.num_heads
    scale = 1.0 / (cfg.hidden_size // H) ** 0.5
    ids = np.random.RandomState(5).randint(0, 512, size=(1, 14))
    Wj, Wt = ref.decode_weights(), port.decode_weights()
    _, kj, vj = jgpt.gpt_prefill(Wj, jnp.asarray(ids[:, :8], jnp.int32),
                                 num_heads=H, scale=scale)
    pos = np.arange(8, 14)

    def jattend(layer, q, k, v):
        return jpo.paged_prefix_attention(q, kj[layer], vj[layer], k, v, 8,
                                          scale)

    hj, ksj, vsj = jgpt.gpt_prefill_extend(
        Wj, jnp.asarray(ids[:, 8:], jnp.int32), jnp.asarray(pos),
        jattend, num_heads=H, scale=scale)
    with torch.inference_mode():
        _, kt, vt = tgpt.gpt_prefill(Wt, torch.from_numpy(ids[:, :8]),
                                     num_heads=H, scale=scale)

        def tattend(layer, q, k, v):
            return tpo.paged_prefix_attention(q, kt[layer], vt[layer], k, v,
                                              8, scale)

        ht, kst, vst = tgpt.gpt_prefill_extend(
            Wt, torch.from_numpy(ids[:, 8:]), torch.from_numpy(pos),
            tattend, num_heads=H, scale=scale)
        lt = tgpt.gpt_logits(Wt, ht).numpy()
    np.testing.assert_allclose(kst.numpy(), np.asarray(ksj), **TOL)
    np.testing.assert_allclose(vst.numpy(), np.asarray(vsj), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(lt, np.asarray(jgpt.gpt_logits(Wj, hj)),
                               **TOL)


# -- engine parity -----------------------------------------------------------

def test_prefix_hit_identical_to_jax_engine(pair):
    _, port = pair
    prompts = _shared_prefix_prompts(n=3)
    h0 = monitor.stat_get("STAT_prefix_hits")
    out, st, _ = _both(pair, lambda e: [e.generate(p, max_new_tokens=5)
                                        for p in prompts])
    for o, p in zip(out, prompts):
        np.testing.assert_array_equal(o, _generate(port, p, 5))
    assert st["kv"]["prefix"]["hits"] == 2
    assert st["kv"]["prefix"]["hit_tokens"] == 16
    assert monitor.stat_get("STAT_prefix_hits") - h0 == 2
    assert st["compiles"] == {"prefill[b=4]": 1, "prefill_tail[b=4]": 1,
                              "prefill[b=16]": 1, "prefill_tail[b=16]": 1,
                              "cow_copy": 1, "decode[m=2]": 1}


def test_mid_decode_join_with_hit(pair):
    prompts = _shared_prefix_prompts(n=2, seed=3)

    def script(eng):
        fa = eng.submit(prompts[0], max_new_tokens=40)
        deadline = time.time() + 60
        while eng.stats()["steps"] < 3:
            assert time.time() < deadline, "engine never started stepping"
            time.sleep(0.002)
        fb = eng.submit(prompts[1], max_new_tokens=5)   # joins mid-decode
        return [fa.result(timeout=120), fb.result(timeout=120)]

    _, st, _ = _both(pair, script, num_pages=64)
    assert st["kv"]["prefix"]["hits"] == 1


def test_full_prompt_match_cow_split(pair):
    _, port = pair
    p8 = _shared_prefix_prompts(n=1, pfx=8, tail=0)[0]
    c0 = monitor.stat_get("STAT_cow_splits")
    out, st, _ = _both(pair, lambda e: [e.generate(p8, max_new_tokens=4)
                                        for _ in range(3)])
    ref = _generate(port, p8, 4)
    for o in out:
        np.testing.assert_array_equal(o, ref)
    # two full-prompt matches, each CoW-splitting the chain's last page,
    # which the cached chain keeps unwritten for the next hit
    assert monitor.stat_get("STAT_cow_splits") - c0 == 2
    assert st["kv"]["prefix"]["hit_tokens"] == 2 * 7


def test_eviction_before_alloc(pair):
    pa = _shared_prefix_prompts(n=1, pfx=8, tail=0, seed=5)[0]
    pb = _shared_prefix_prompts(n=1, pfx=8, tail=0, seed=6)[0]
    e0 = monitor.stat_get("STAT_prefix_evictions")
    seen = {}

    def script(eng):
        oa = eng.generate(pa, max_new_tokens=4)     # registers 2 pages
        seen.setdefault(type(eng).__module__, eng.stats()["kv"])
        ob = eng.generate(pb, max_new_tokens=4)     # evicts first
        oa2 = eng.generate(pa, max_new_tokens=4)    # evicted: a miss
        return [oa, ob, oa2]

    # 4 usable pages; one request needs 3 (8 prompt + 4 new)
    _, st, _ = _both(pair, script, max_slots=1, num_pages=5,
                     prefill_buckets=(16,), max_new_tokens=4)
    kv = seen["paddle_tpu_torch.serving.generation"]
    assert kv["evictable_pages"] == 2 and kv["reclaimable_pages"] == 4
    assert st["kv"]["prefix"]["evictions"] >= 1
    assert monitor.stat_get("STAT_prefix_evictions") > e0


def test_eager_eviction_under_max_pages(pair):
    rng = np.random.RandomState(41)
    prompts = [rng.randint(0, 512, size=(12,)).astype("int64")
               for _ in range(3)]
    cached = []

    def script(eng):
        outs = []
        for p in prompts:
            outs.append(eng.generate(p, max_new_tokens=4))
            cached.append(len(eng._cache.cached_pages()))
        return outs

    _, st, _ = _both(pair, script, prefix_cache_max_pages=3,
                     max_new_tokens=4)
    assert max(cached) <= 3
    assert st["kv"]["prefix"]["max_pages"] == 3
    assert st["kv"]["prefix"]["evictions"] > 0
    assert st["pages"]["pages_in_use"] <= 3


def test_multi_turn_suffix_registration(pair):
    """prompt 2 = prompt 1 + answer 1 + new tokens: the answer's written
    full pages were registered at completion, so turn 2 hits past the
    8 prompt-only tokens of turn 1."""
    _, port = pair
    p1 = np.random.RandomState(43).randint(0, 512, size=(8,))
    extra = np.random.RandomState(44).randint(0, 512, size=(3,))
    hits = []

    def script(eng):
        a1 = eng.generate(p1, max_new_tokens=8)
        h0 = eng.stats()["kv"]["prefix"].get("hit_tokens", 0)
        a2 = eng.generate(np.concatenate([a1, extra]), max_new_tokens=5)
        hits.append(eng.stats()["kv"]["prefix"].get("hit_tokens", 0) - h0)
        return [a1, a2]

    out, _, _ = _both(pair, script, prefill_buckets=(4, 16, 64),
                      max_new_tokens=8)
    np.testing.assert_array_equal(
        out[1], _generate(port, np.concatenate([out[0], extra]), 5))
    # JAX engine, port engine, port engine with the cache off
    assert hits[0] == hits[1] >= 12 and hits[2] == 0


def test_freeing_a_sharer_never_zeroes_shared_pages(pair):
    """Zero-on-free keys on refcount: after a sharer of a cached chain
    completes, the chain's pages keep their K/V bit for bit; a drained
    engine holds only cache-held pages, each with refcount 1."""
    _, port = pair
    prompts = _shared_prefix_prompts(n=4, seed=21)
    eng = GenerationEngine(port, device="cpu", **{**_KW, "max_slots": 3})
    eng.generate(prompts[0], max_new_tokens=4)
    chain = sorted(eng._cache.cached_pages())
    assert len(chain) == 3      # 2 prompt pages + 1 of prompt and answer
    before = eng._cache.k_pages[:, :, chain].clone()
    assert before.abs().max() > 0
    futs = [eng.submit(p, max_new_tokens=4) for p in prompts[1:]]
    for f, p in zip(futs, prompts[1:]):
        np.testing.assert_array_equal(f.result(timeout=60),
                                      _generate(port, p, 4))
    eng.shutdown(drain=True, timeout_s=60)
    assert torch.equal(eng._cache.k_pages[:, :, chain], before)
    cache = eng._cache
    refs = cache.refcounts()
    assert cache.owners() == {}
    assert set(refs) == set(cache.cached_pages())
    assert set(refs.values()) == {1}
    assert cache.pages_in_use == cache.evictable_pages == len(refs)
