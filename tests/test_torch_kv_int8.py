"""The port's int8 KV pages held to paddle_tpu's.

Op parity (numpy inputs from a seed, the same through both packages):
`paged_write_quantized` in its decode form (a token whose abs-max widens
its page's grid, so the page requantizes; inactive slots parked on the
scratch page) and its prefill form (several tokens a page, so the
scatter-max meets duplicate page ids; `requant=True` onto pages that hold
content), and `paged_gather_quantized` / `paged_gather_layers(scales=)`:
int8 codes equal, scales equal, dequantized views equal, except on the
scratch page, whose duplicate writes keep an unspecified one in either
package.

Cache parity: the int8 `PagedKVCache`'s scale pools, byte and budget
arithmetic and `can_admit` capacity at equal bytes equal the JAX cache's
numbers.

Engine parity: both engines serve the bridged tiny GPT (float32, CPU)
with `kv_cache_dtype="int8"`, plain and with the prefix cache (a CoW
split), speculation and chunked prefill. Greedy output is token-identical
to the JAX int8 engine, with equal ledgers and equal `stats()["pages"]`;
and the reference's own contract against float32 pools holds (first
token exact, token agreement >= 0.9). Zero-on-free resets scales, bucket
padding never touches a real page's scale, and a poisoned sequence's
scale rows are scrubbed."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import paged_ops as jpo
from paddle_tpu.serving.kv_cache import PagedKVCache as JCache
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import FatalError, InvalidArgumentError
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.ops import paged_ops as tpo
from paddle_tpu_torch.serving import (GenerationConfig, GenerationEngine,
                                      PagedKVCache)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def _prompts(n=3, S=11, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(n, S)).astype("int64")


_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(4, 16),
           max_new_tokens=6, request_timeout_ms=0, kv_cache_dtype="int8")
# stats()["pages"] keys both engines report
PAGE_KEYS = ("dtype", "quantized", "hbm_bytes", "page_size", "usable_pages",
             "pages_in_use", "free_pages", "pages_per_seq", "sequences",
             "free_low_water", "free_high_water", "cached_pages")


def _serve(eng, script):
    with eng:
        outs = script(eng)
        stats = eng.stats()
    return outs, stats


def _both(pair, script, **kw):
    """One script through the JAX int8 engine and the port's: tokens,
    ledgers and page stats equal."""
    ref, port = pair
    cfg = {**_KW, **kw}
    jout, jst = _serve(jserving.GenerationEngine(ref, **cfg), script)
    tout, tst = _serve(GenerationEngine(port, device="cpu", **cfg), script)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t, j)
    assert tst["compiles"] == jst["compiles"]
    assert {k: tst["pages"][k] for k in PAGE_KEYS} == \
        {k: jst["pages"][k] for k in PAGE_KEYS}
    return tout, tst, jst


# -- op parity -----------------------------------------------------------------

def _pools(L, H, N, P, D):
    """Empty int8 pools and scales in both packages."""
    return (jnp.zeros((L, H, N, P, D), "int8"),
            jnp.zeros((L, H, N), "float32"),
            torch.zeros(L, H, N, P, D, dtype=torch.int8),
            torch.zeros(L, H, N, dtype=torch.float32))


def _same(jp, js, tp, ts, skip_trash=False):
    """int8 codes and float32 scales equal (the scratch page 0 left out
    when duplicate writes landed there)."""
    a, b = np.asarray(jp), tp.numpy()
    sa, sb = np.asarray(js), ts.numpy()
    if skip_trash:
        a, b, sa, sb = a[:, :, 1:], b[:, :, 1:], sa[:, :, 1:], sb[:, :, 1:]
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(sb, sa)


def test_paged_write_quantized_prefill_decode_requant_match_jax():
    rng = np.random.RandomState(0)
    L, H, N, P, D = 2, 3, 8, 4, 5
    jp, js, tp, ts = _pools(L, H, N, P, D)
    # prefill: 7 tokens over pages 1, 2 (duplicate page ids in the
    # scatter-max), the pad tail of the bucket routed to the scratch page
    row = np.array([1, 2, 0, 0], np.int32)
    pos = np.arange(8)
    pids = np.where(pos < 7, row[pos // P], 0).astype(np.int32)
    offs = np.where(pos < 7, pos % P, 0).astype(np.int32)
    vals = rng.standard_normal((L, H, 8, D)).astype("float32")
    jp, js = jpo.paged_write_quantized(jp, js, None, jnp.asarray(pids),
                                       jnp.asarray(offs), jnp.asarray(vals))
    tpo.paged_write_quantized(tp, ts, None, torch.from_numpy(pids),
                              torch.from_numpy(offs), torch.from_numpy(vals))
    _same(jp, js, tp, ts, skip_trash=True)
    # decode: slot 0 appends at position 7 (page 2) with 3x the magnitude,
    # so page 2's grid widens and its content requantizes; slots 1 and 2
    # are parked on the scratch page (duplicate ids)
    dp = np.array([2, 0, 0], np.int32)
    do = np.array([3, 0, 0], np.int32)
    v = rng.standard_normal((3, H, D)).astype("float32") * 3.0
    for layer in range(L):
        s_before = ts[layer][:, 2].clone()
        jp, js = jpo.paged_write_quantized(jp, js, layer, jnp.asarray(dp),
                                           jnp.asarray(do), jnp.asarray(v))
        tpo.paged_write_quantized(tp, ts, layer, torch.from_numpy(dp),
                                  torch.from_numpy(do), torch.from_numpy(v))
        assert bool((ts[layer][:, 2] > s_before).any())   # grid widened
    _same(jp, js, tp, ts, skip_trash=True)
    # requant=True: a second prefill-shaped write lands on pages 2 and 3,
    # page 2 already holding content and a scale (the tail program's case)
    pids = np.array([3, 3, 2, 0], np.int32)
    offs = np.array([0, 1, 3, 0], np.int32)
    vals = rng.standard_normal((L, H, 4, D)).astype("float32") * 5.0
    jp, js = jpo.paged_write_quantized(jp, js, None, jnp.asarray(pids),
                                       jnp.asarray(offs), jnp.asarray(vals),
                                       requant=True)
    tpo.paged_write_quantized(tp, ts, None, torch.from_numpy(pids),
                              torch.from_numpy(offs), torch.from_numpy(vals),
                              requant=True)
    _same(jp, js, tp, ts, skip_trash=True)
    # dequantized reads of the real pages: one layer, and all layers of a
    # row at once
    pt = np.array([[1, 2, 3, 4]], np.int32)
    for layer in range(L):
        want = np.asarray(jpo.paged_gather_quantized(
            jp[layer], js[layer], jnp.asarray(pt)))
        got = tpo.paged_gather_quantized(tp[layer], ts[layer],
                                         torch.from_numpy(pt)).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jpo.paged_gather_layers(jp, jnp.asarray(pt[0]), js))
    got = tpo.paged_gather_layers(tp, torch.from_numpy(pt[0]), ts).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantized_attention_takes_no_kernel_and_matches_jax():
    """paged_attention with scale pools is the dequantizing gather +
    cached_attention in both packages (rtol 1e-5, atol 1e-6: float32
    einsum order), and it counts quantized reads, not kernel calls."""
    rng = np.random.RandomState(1)
    H, N, P, D = 2, 6, 4, 8
    q8 = rng.randint(-127, 128, size=(H, N, P, D)).astype(np.int8)
    sc = rng.uniform(0.01, 0.1, size=(H, N)).astype(np.float32)
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    pt = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
    pos = np.array([6, 10], np.int32)
    want = np.asarray(jpo.paged_attention(
        jnp.asarray(q), jnp.asarray(q8), jnp.asarray(q8), jnp.asarray(pt),
        jnp.asarray(pos), 0.3, jnp.asarray(sc), jnp.asarray(sc)))
    r0 = monitor.stat_get("STAT_kv_quant_reads")
    got = tpo.paged_attention(torch.from_numpy(q), torch.from_numpy(q8),
                              torch.from_numpy(q8), torch.from_numpy(pt),
                              torch.from_numpy(pos), 0.3,
                              torch.from_numpy(sc), torch.from_numpy(sc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert monitor.stat_get("STAT_kv_quant_reads") == r0 + 2
    assert tpo.paged_attention.launches == 0


# -- the cache -------------------------------------------------------------------

def test_int8_cache_scale_pools_and_byte_arithmetic_equal_jax():
    c = PagedKVCache(2, 3, 8, 4, 16, 4, dtype="int8", device="cpu")
    j = JCache(2, 3, 8, 4, 16, 4, dtype="int8")
    assert c.quantized and j.quantized and c.k_pages.dtype == torch.int8
    assert tuple(c.k_scales.shape) == tuple(j.k_scales.shape) == (2, 3, 16)
    assert c.hbm_bytes() == j.hbm_bytes()
    f = PagedKVCache(2, 3, 8, 4, 16, 4, device="cpu")
    assert not f.quantized and f.k_scales is None
    assert f.hbm_bytes() == JCache(2, 3, 8, 4, 16, 4).hbm_bytes()
    for dims in (dict(num_layers=2, num_heads=3, head_dim=8, page_size=4),
                 dict(num_layers=12, num_heads=12, head_dim=64,
                      page_size=16)):
        for dt in ("float32", "bfloat16", "int8"):
            assert PagedKVCache.page_hbm_bytes(dtype=dt, **dims) == \
                JCache.page_hbm_bytes(dtype=dt, **dims)
            budget = 64 * JCache.page_hbm_bytes(dtype="float32", **dims)
            assert PagedKVCache.pages_for_budget(budget, dtype=dt, **dims) \
                == JCache.pages_for_budget(budget, dtype=dt, **dims)
    assert c.stats()["dtype"] == "int8" and c.stats()["quantized"]


def test_can_admit_capacity_at_equal_bytes_equals_jax():
    """The same budget admits the same number of 2-page requests in both
    packages: 4 at float32, at least 1.9x that at int8."""
    dims = dict(num_layers=2, num_heads=2, head_dim=8, page_size=4)
    budget = JCache.page_hbm_bytes(dtype="float32", **dims) * 9

    def capacity(cache):
        n = 0
        while cache.can_admit(8):
            cache.alloc(n, 8)
            n += 1
        return n

    caps = {}
    for dt in ("float32", "int8"):
        n = PagedKVCache.pages_for_budget(budget, dtype=dt, **dims)
        caps[dt] = capacity(PagedKVCache(page_size=4, num_pages=n,
                                         pages_per_seq=2, num_layers=2,
                                         num_heads=2, head_dim=8, dtype=dt,
                                         device="cpu"))
        assert caps[dt] == capacity(JCache(page_size=4, num_pages=n,
                                           pages_per_seq=2, num_layers=2,
                                           num_heads=2, head_dim=8,
                                           dtype=dt))
    assert caps["float32"] == 4 and caps["int8"] >= 1.9 * caps["float32"]


def test_generation_config_takes_int8_and_refuses_the_unported():
    assert GenerationConfig(kv_cache_dtype="int8").kv_cache_dtype == "int8"
    # the host tier is ported: int8 pools take it with the prefix cache
    assert GenerationConfig(kv_cache_dtype="int8", prefix_cache=True,
                            kv_tier=True).kv_tier
    # tp lanes are ported: int8 pools shard their scale grids with them
    assert GenerationConfig(kv_cache_dtype="int8", tp=2).tp == 2
    # the program store is ported: int8 pools key their programs there
    assert GenerationConfig(kv_cache_dtype="int8",
                            program_store="/x").program_store == "/x"
    with pytest.raises(InvalidArgumentError, match="kv_cache_dtype"):
        GenerationConfig(kv_cache_dtype="int4")


# -- the engine ---------------------------------------------------------------------

def test_int8_engine_identical_to_jax_int8_engine(pair):
    prompts = _prompts(n=3, seed=1)
    q0 = monitor.stat_get("STAT_kv_quant_writes")
    out, st, jst = _both(pair, lambda e: [f.result(timeout=120) for f in [
        e.submit(p, max_new_tokens=6) for p in prompts]])
    assert st["compiles"] == {"prefill[b=4]": 1, "prefill[b=16]": 1,
                              "decode[m=2]": 1}
    assert st["pages"]["dtype"] == "int8" and st["pages"]["quantized"]
    assert st["pages"]["pages_in_use"] == 0
    assert monitor.stat_get("STAT_kv_quant_writes") > q0


def test_int8_engine_with_prefix_cache_and_cow_split(pair):
    """A prompt sharing two full pages with the first, then a repeat of a
    whole 12-token prompt (a full-prompt match: one CoW split, which
    clones the scale row too), identical to the JAX int8 engine."""
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, 512, size=(8,)).astype("int64")
    a = np.concatenate([prefix, rng.randint(0, 512, size=(4,))])
    b = np.concatenate([prefix, rng.randint(0, 512, size=(3,))])
    cow0 = monitor.stat_get("STAT_cow_splits")

    def script(eng):
        return [eng.generate(p, max_new_tokens=5) for p in (a, b, a)]

    out, st, jst = _both(pair, script, prefix_cache=True)
    assert monitor.stat_get("STAT_cow_splits") == cow0 + 1
    for k in ("hits", "misses", "hit_tokens", "nodes", "cached_pages"):
        assert st["kv"]["prefix"][k] == jst["kv"]["prefix"][k], k
    assert st["kv"]["prefix"]["hits"] >= 2
    assert "cow_copy" in st["compiles"]


def test_int8_engine_with_speculation(pair):
    prompts = [np.resize(np.arange(5, 9), 12).astype("int64"),
               _prompts(n=1, seed=5)[0]]
    out, st, jst = _both(pair, lambda e: [e.generate(p, max_new_tokens=8)
                                          for p in prompts],
                         spec_k=3, max_new_tokens=8)
    assert st["compiles"] == jst["compiles"]
    assert "verify[k=3]" in st["compiles"]
    for k in ("drafted", "accepted"):
        assert st["spec"][k] == jst["spec"][k], k


def test_int8_engine_with_chunked_prefill(pair):
    rng = np.random.RandomState(7)
    long_p = rng.randint(0, 512, size=(40,)).astype("int64")
    out, st, jst = _both(pair, lambda e: [e.generate(long_p,
                                                     max_new_tokens=6)],
                         prefill_buckets=(16, 64), prefill_chunk=16)
    assert st["prefill_chunks"] == jst["prefill_chunks"] == 3


def test_int8_against_float32_pools_reference_contract(pair):
    """The JAX package's own contract (tests/test_quantized_serving.py):
    the first generated token is exact (prefill never reads the int8
    pages) and token agreement with float32 pools is >= 0.9; the int8
    engine is bit-stable over two runs."""
    _, port = pair
    prompts = _prompts(n=4, S=12, seed=3)

    def run(kv):
        with GenerationEngine(port, device="cpu", **{
                **_KW, "max_slots": 4, "kv_cache_dtype": kv,
                "max_new_tokens": 8}) as eng:
            return [f.result(timeout=120) for f in [
                eng.submit(p, max_new_tokens=8) for p in prompts]]

    f32, q8, q8b = run("float32"), run("int8"), run("int8")
    S = prompts.shape[1]
    for a, b, c in zip(f32, q8, q8b):
        assert a[S] == b[S]
        np.testing.assert_array_equal(b, c)
    agree = np.mean([np.mean(a[S:] == b[S:]) for a, b in zip(f32, q8)])
    assert agree >= 0.9, agree


def test_pad_tail_never_touches_a_real_page_scale(pair):
    """A 12-token prompt in bucket 16: the pages holding positions 12..
    (decode reserve) keep scale 0 until decode writes there, as
    `test_prefill_pad_tail_never_touches_real_page_scales` holds the JAX
    engine."""
    _, port = pair
    seen = []

    def hook(eng):
        req = eng._slots[0]
        if req is not None and not seen:
            pages = eng._cache.owned(req.rid)
            ks = eng._cache.k_scales.clone()
            seen.append((ks[:, :, pages[:3]], ks[:, :, pages[3:]]))

    eng = GenerationEngine(port, device="cpu", **{
        **_KW, "prefill_buckets": (16,), "max_new_tokens": 8})
    try:
        eng._pre_step_hook = hook
        eng.generate(_prompts(n=1, S=12)[0], max_new_tokens=8)
    finally:
        eng.shutdown()
    real, reserve = seen[0]
    assert bool((real > 0).all())
    assert bool((reserve == 0).all())


def test_zero_on_free_resets_scales_and_poison_is_isolated(pair):
    """A poisoned sequence (int8 pages at 127, NaN scales) fails alone;
    its neighbour decodes exactly; the freed pages' codes and scales are
    0; a later request on the reused pages decodes exactly."""
    _, port = pair
    prompts = _prompts(n=2, S=11, seed=9)
    with GenerationEngine(port, device="cpu", **{
            **_KW, "max_new_tokens": 12}) as eng:
        want = eng.generate(prompts[0], max_new_tokens=12)
        c = eng._cache
        assert bool((c.k_scales == 0).all()) and bool((c.v_scales == 0)
                                                      .all())
    fired, poisoned = [], []

    def hook(eng):
        req = eng._slots[1]
        if not fired and req is not None and len(req.toks) >= 2:
            pages = eng._cache.owned(req.rid)
            eng._cache.k_pages[:, :, pages] = 127
            eng._cache.k_scales[:, :, pages] = float("nan")
            poisoned.extend(pages)
            fired.append(req.rid)

    p0 = monitor.stat_get("STAT_gen_poisoned")
    eng = GenerationEngine(port, device="cpu", **{**_KW,
                                                  "max_new_tokens": 12})
    try:
        eng._pre_step_hook = hook
        fa = eng.submit(prompts[0], max_new_tokens=12)
        fb = eng.submit(prompts[1], max_new_tokens=12)
        with pytest.raises(FatalError):
            fb.result(timeout=120)
        out_a = fa.result(timeout=120)
        eng._pre_step_hook = None
        c = eng._cache
        assert bool((c.k_scales[:, :, poisoned] == 0).all())
        assert bool((c.k_pages[:, :, poisoned] == 0).all())
        np.testing.assert_array_equal(
            eng.generate(prompts[0], max_new_tokens=12), want)
        assert eng.stats()["pages"]["pages_in_use"] == 0
    finally:
        eng.shutdown()
    assert fired
    np.testing.assert_array_equal(out_a, want)
    assert monitor.stat_get("STAT_gen_poisoned") > p0
