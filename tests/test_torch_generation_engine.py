"""paddle_tpu_torch.serving.GenerationEngine held to paddle_tpu's.

Both engines serve the same bridged tiny GPT (float32, CPU; the port's
decode attention takes its plain version here). Greedy outputs must be
token-identical to the JAX engine and to the port's own generate(), and
`stats()["compiles"]` must match the JAX engine's ledger key for key.
The scheduler tests mirror tests/test_generation_engine.py."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import (ExecutionTimeoutError,
                                               FatalError,
                                               InvalidArgumentError,
                                               ResourceExhaustedError,
                                               UnavailableError)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.serving import (EngineOverloaded, GenerationConfig,
                                      GenerationEngine, PagedKVCache)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def _prompts(n=2, S=7, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(n, S)).astype("int64")


_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(8,),
           max_new_tokens=5, request_timeout_ms=0)


def _engine(model, **kw):
    return GenerationEngine(model, device="cpu", **{**_KW, **kw})


def _generate(port, prompt, n):
    return port.generate(np.asarray(prompt)[None], max_new_tokens=n) \
        .numpy()[0]


def test_greedy_identical_to_jax_engine_and_compiles_ledger(pair):
    ref, port = pair
    ids = _prompts(n=3, seed=1)
    with jserving.GenerationEngine(ref, **_KW) as jeng:
        want = [f.result(timeout=120)
                for f in [jeng.submit(p, max_new_tokens=5) for p in ids]]
        jstats = jeng.stats()
    with _engine(port) as eng:
        got = [f.result(timeout=120)
               for f in [eng.submit(p, max_new_tokens=5) for p in ids]]
        stats = eng.stats()
    for g, w, p in zip(got, want, ids):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _generate(port, p, 5))
    assert stats["compiles"] == jstats["compiles"] == {
        "prefill[b=8]": 1, "decode[m=2]": 1}
    assert stats["pages"]["pages_in_use"] == 0


def test_paged_allocator_basics():
    c = PagedKVCache(num_layers=2, num_heads=2, head_dim=4, page_size=4,
                     num_pages=8, pages_per_seq=3, device="cpu")
    assert c.usable_pages == 7           # page 0 reserved scratch
    assert c.pages_needed(1) == 1 and c.pages_needed(4) == 1
    assert c.pages_needed(5) == 2
    assert c.fits(12) and not c.fits(13)  # pages_per_seq bound
    row = c.alloc(1, 9)                   # 3 pages
    assert row.shape == (3,) and (row[:3] > 0).all()
    assert c.pages_in_use == 3 and c.can_admit(9)
    c.alloc(2, 9)
    c.alloc(3, 4)
    assert c.pages_in_use == 7 and not c.can_admit(1)
    assert monitor.stat_get("STAT_kv_pages_inuse") == 7
    with pytest.raises(ResourceExhaustedError):
        c.alloc(4, 1)
    with pytest.raises(InvalidArgumentError):
        c.alloc(1, 1)                     # double alloc same seq
    freed = c.free(2)
    assert len(freed) == 3 and c.can_admit(9)
    assert c.free(2) == []                # idempotent double free
    assert monitor.stat_get("STAT_kv_pages_inuse") == 4
    with pytest.raises(InvalidArgumentError):
        c.alloc(9, 13)                    # wider than the page table


def test_mid_decode_join(pair):
    _, port = pair
    ids = _prompts()
    with _engine(port) as eng:
        fa = eng.submit(ids[0], max_new_tokens=40)
        deadline = time.time() + 60
        while eng.stats()["steps"] < 3:
            assert time.time() < deadline, "engine never started stepping"
            time.sleep(0.002)
        joined_at = eng.stats()["steps"]
        fb = eng.submit(ids[1], max_new_tokens=5)
        out_b = fb.result(timeout=120)
        out_a = fa.result(timeout=120)
        s = eng.stats()
    assert joined_at >= 3
    np.testing.assert_array_equal(out_a, _generate(port, ids[0], 40))
    np.testing.assert_array_equal(out_b, _generate(port, ids[1], 5))
    assert s["compiles"] == {"prefill[b=8]": 1, "decode[m=2]": 1}


def test_eos_frees_pages_same_step(pair):
    _, port = pair
    ids = _prompts()
    ref = _generate(port, ids[0], 5)
    S = ids.shape[1]
    gen = ref[S:]
    eos = int(gen[2])
    stop = int(np.where(gen == eos)[0][0])
    assert stop < len(gen) - 1, "eos must cut the stream short"
    seen = []

    def hook(eng):          # runs before each decode step
        seen.append(eng.stats()["pages"]["pages_in_use"])

    with _engine(port) as eng:
        eng._pre_step_hook = hook
        out = eng.generate(ids[0], max_new_tokens=5, eos_token_id=eos)
        pages_after = eng.stats()["pages"]["pages_in_use"]
    np.testing.assert_array_equal(out, ref[:S + stop + 1])  # EOS included
    assert pages_after == 0
    assert len(seen) == stop       # no step ran after the EOS token


def test_request_that_can_never_fit_fails_fast(pair):
    _, port = pair
    with _engine(port, num_pages=4) as eng:
        with pytest.raises(ResourceExhaustedError):
            eng.submit(_prompts()[0], max_new_tokens=20)  # > pool
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.arange(20), max_new_tokens=2)   # > bucket
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.zeros((0,), np.int64))
        with pytest.raises(InvalidArgumentError):
            eng.submit(_prompts()[0], max_new_tokens=0)
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.zeros((2, 3), np.int64))


@pytest.mark.parametrize("knob", [
    dict(kv_tier=True), dict(program_store="/nonexistent"), dict(tp=2),
    dict(tp=4)])
def test_unported_knob_raises(knob, pair):
    """The knobs not ported yet raise; the host tier is ported and
    raises only where the JAX engine's config does: without the prefix
    cache it has nothing to demote. tp is ported: the config takes it,
    and an engine built outside a process group of tp ranks raises,
    naming init_parallel_env and the launcher (never serving at tp 1).
    The program store is ported: the config takes its root as the JAX
    engine's does (tests/test_torch_program_store.py drives it)."""
    if "program_store" in knob:
        cfg = GenerationConfig(**knob)
        assert cfg.program_store == knob["program_store"]
        assert cfg.program_store_force is False
        return
    if "tp" in knob:
        cfg = GenerationConfig(**knob)
        assert cfg.tp == knob["tp"]
        with pytest.raises(InvalidArgumentError,
                           match="init_parallel_env"):
            GenerationEngine(pair[1], cfg, device="cpu")
        return
    match = ("requires prefix_cache" if "kv_tier" in knob
             else "not yet ported")
    with pytest.raises(InvalidArgumentError, match=match):
        GenerationConfig(**knob)


@pytest.mark.parametrize("knob,programs", [
    (dict(prefix_cache=True), {"prefill_tail[b=8]", "cow_copy",
                               "decode[m=2]"}),
    (dict(spec_k=2), {"verify[k=2]"}),
    (dict(prefill_chunk=4), {"prefill_tail[b=8]", "decode[m=2]"}),
    (dict(prefix_cache=True, kv_tier=True, kv_tier_chunk_pages=2),
     {"prefill_tail[b=8]", "cow_copy", "tier_gather", "tier_write[w=2]",
      "decode[m=2]"})])
def test_ported_knob_builds_and_serves(pair, knob, programs):
    """The knobs the JAX engine schedules with (prefix cache, speculative
    decoding, chunked prefill, the host tier) build a config and an
    engine that serves
    greedy requests token-identical to generate(), with each mode's
    programs in the ledger (tests/test_torch_prefix_cache.py and
    tests/test_torch_spec_decode.py hold them to the JAX engine)."""
    _, port = pair
    cfg = GenerationConfig(**{**_KW, **knob})
    for k, v in knob.items():
        assert getattr(cfg, k) == v
    ids = _prompts(n=2, seed=7)
    with GenerationEngine(port, cfg, device="cpu") as eng:
        outs = [eng.generate(p, max_new_tokens=5) for p in ids]
        s = eng.stats()
    for o, p in zip(outs, ids):
        np.testing.assert_array_equal(o, _generate(port, p, 5))
    assert set(s["compiles"]) == programs | {"prefill[b=8]"}
    assert s["pages"]["pages_in_use"] == s["pages"]["cached_pages"]


def test_unported_knobs_accept_their_off_state():
    cfg = GenerationConfig(prefix_cache=False, spec_k=0, prefill_chunk=0,
                           kv_tier=False, program_store="", tp=1)
    assert cfg.max_slots >= 1


def test_exhaustion_defers_admission_then_serves(pair):
    _, port = pair
    ids = _prompts()
    blocked0 = monitor.stat_get("STAT_gen_admit_blocked")
    # pool sized for exactly one sequence: ceil((7+5)/4) = 3 pages + trash
    with _engine(port, num_pages=4) as eng:
        fa = eng.submit(ids[0], max_new_tokens=5)
        fb = eng.submit(ids[1], max_new_tokens=5)
        out_a = fa.result(timeout=120)
        out_b = fb.result(timeout=120)
    assert out_a.shape == out_b.shape == (12,)
    np.testing.assert_array_equal(out_b, _generate(port, ids[1], 5))
    assert monitor.stat_get("STAT_gen_admit_blocked") > blocked0


def test_deadline_expiry_mid_decode_cancels_only_that_future(pair):
    _, port = pair
    ids = _prompts()
    t0 = monitor.stat_get("STAT_gen_timeouts")
    with _engine(port) as eng:
        slow = lambda e: time.sleep(0.002)   # noqa: E731
        eng._pre_step_hook = slow
        fa = eng.submit(ids[0], max_new_tokens=40)          # no deadline
        fb = eng.submit(ids[1], max_new_tokens=100, timeout_ms=60)
        with pytest.raises(ExecutionTimeoutError):
            fb.result(timeout=120)
        out_a = fa.result(timeout=120)
        pages_after = eng.stats()["pages"]["pages_in_use"]
    assert out_a.shape == (47,)
    assert pages_after == 0
    assert monitor.stat_get("STAT_gen_timeouts") > t0


def test_poisoned_sequence_fails_alone_and_pages_scrub(pair):
    _, port = pair
    ids = _prompts()
    fired = []

    def hook(eng):
        req = eng._slots[1]
        if not fired and req is not None and len(req.toks) >= 2:
            pages = eng._cache.owned(req.rid)
            eng._cache.k_pages[:, :, pages] = float("nan")
            fired.append(req.rid)

    with _engine(port) as eng:
        eng._pre_step_hook = hook
        fa = eng.submit(ids[0], max_new_tokens=12)
        fb = eng.submit(ids[1], max_new_tokens=12)
        with pytest.raises(FatalError):
            fb.result(timeout=120)
        out_a = fa.result(timeout=120)
        eng._pre_step_hook = None
        # the poisoned pages were zeroed on free: a wider request reusing
        # them decodes exactly the clean-run tokens
        out_c = eng.generate(ids[0], max_new_tokens=17)
        assert torch.isfinite(eng._cache.k_pages).all()
        pages_after = eng.stats()["pages"]["pages_in_use"]
    assert fired
    np.testing.assert_array_equal(out_a, _generate(port, ids[0], 12))
    np.testing.assert_array_equal(out_c, _generate(port, ids[0], 17))
    assert pages_after == 0


def test_stream_tokens_concat_to_result(pair):
    _, port = pair
    ids = _prompts(seed=5)
    with _engine(port) as eng:
        st = eng.submit_stream(ids[0], max_new_tokens=6)
        toks = list(st)
        full = st.result(timeout=60)
    assert toks == list(full[ids.shape[1]:])
    np.testing.assert_array_equal(full, _generate(port, ids[0], 6))


def test_sampling_is_engine_deterministic(pair):
    _, port = pair
    ids = _prompts(seed=3)[0]

    def run(seed):
        with _engine(port, seed=seed) as eng:
            return eng.generate(ids, max_new_tokens=6, do_sample=True,
                                temperature=0.9)
    a, b = run(42), run(42)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (ids.size + 6,)


def test_backpressure_shutdown_and_health(pair):
    _, port = pair
    ids = _prompts(n=4, seed=9)
    with _engine(port, max_queue_depth=0) as eng:
        with pytest.raises(EngineOverloaded):
            eng.submit(ids[0], max_new_tokens=2)
    eng = _engine(port)
    h = eng.health()
    assert h["ready"] and h["reason"] == "ok" and h["live_lanes"] == 1
    futs = [eng.submit(p, max_new_tokens=4) for p in ids]
    eng.shutdown(drain=True, timeout_s=120)
    for f in futs:
        assert f.result(timeout=1).shape == (11,)
    assert not eng.health()["ready"]
    assert eng.health()["reason"] == "draining"
    with pytest.raises(UnavailableError):
        eng.submit(ids[0])
    eng = _engine(port)
    futs = [eng.submit(p, max_new_tokens=100) for p in _prompts(n=5,
                                                                  seed=21)]
    eng.shutdown(drain=False, timeout_s=120)
    for f in futs:
        with pytest.raises(UnavailableError):
            f.result(timeout=5)


def test_head_dim_96_gpt_identical_to_jax_engine():
    """ROADMAP C7: a GPT with head dim 96 (hidden 768, 8 heads, 2 layers),
    which the JAX package serves, is served by the port's engine
    token-identical to the JAX engine and to the port's generate(), on
    weights carried across by `load_reference_state` (on the card its
    decode attention is K1, built for D 96)."""
    paddle.seed(5)
    kw = dict(hidden_size=768, num_heads=8, intermediate_size=3072,
              dropout=0.0)
    ref = JGPT(JConfig.tiny(**kw))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    assert port.gpt.config.hidden_size // port.gpt.config.num_heads == 96
    ids = _prompts(n=3, seed=4)
    with jserving.GenerationEngine(ref, **_KW) as jeng:
        want = [f.result(timeout=120)
                for f in [jeng.submit(p, max_new_tokens=5) for p in ids]]
    with _engine(port) as eng:
        got = [f.result(timeout=120)
               for f in [eng.submit(p, max_new_tokens=5) for p in ids]]
    for g, w, p in zip(got, want, ids):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _generate(port, p, 5))


@pytest.mark.parametrize("knob", [dict(), dict(prefix_cache=True,
                                               kv_tier=True)])
def test_warmup_false_fills_the_ledger_at_first_use(pair, knob):
    """ROADMAP C13: `GenerationConfig(warmup=False)` skips the
    construction-time run of every program, as the JAX engine's does:
    the ledger is empty before the first request and, after one, holds
    exactly the programs that request ran, key for key the JAX engine's;
    the tokens are the warmed engine's."""
    ref, port = pair
    ids = _prompts(n=1, seed=3)
    kw = {**_KW, **knob, "warmup": False}
    with jserving.GenerationEngine(ref, **kw) as jeng:
        jbefore = dict(jeng.stats()["compiles"])
        want = jeng.generate(ids[0], max_new_tokens=4)
        jafter = jeng.stats()["compiles"]
        jhealth = jeng.health()["warmup_complete"]
    with _engine(port, **knob, warmup=False) as eng:
        before = dict(eng.stats()["compiles"])
        got = eng.generate(ids[0], max_new_tokens=4)
        after = eng.stats()["compiles"]
        health = eng.health()["warmup_complete"]
    assert before == jbefore == {}
    assert after == jafter and set(after) >= {"prefill[b=8]",
                                              "decode[m=2]"}
    assert health is jhealth is True
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _generate(port, ids[0], 4))


def test_head_dim_36_gpt_identical_to_jax_engine():
    """A GPT with head dim 36 (hidden 144, 4 heads, 36 % 8 != 0), which
    the JAX package serves: the port's engine serves it token-identical
    to the JAX engine and to its own generate(), its decode attention on
    the CPU counted as the plain path in STAT_paged_attn_reference (on
    the card it runs K1 at the padded width 64,
    tests/test_torch_kernels_chip.py)."""
    paddle.seed(6)
    kw = dict(hidden_size=144, num_heads=4, intermediate_size=288,
              dropout=0.0)
    ref = JGPT(JConfig.tiny(**kw))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    assert port.gpt.config.hidden_size // port.gpt.config.num_heads == 36
    ids = _prompts(n=3, seed=8)
    with jserving.GenerationEngine(ref, **_KW) as jeng:
        want = [f.result(timeout=120)
                for f in [jeng.submit(p, max_new_tokens=5) for p in ids]]
    r0 = monitor.stat_get("STAT_paged_attn_reference")
    with _engine(port) as eng:
        got = [f.result(timeout=120)
               for f in [eng.submit(p, max_new_tokens=5) for p in ids]]
        steps = eng.stats()["steps"]
    assert monitor.stat_get("STAT_paged_attn_reference") - r0 >= \
        (steps + 1) * 2
    for g, w, p in zip(got, want, ids):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _generate(port, p, 5))
