"""The port's speculative decoding and chunked prefill held to
paddle_tpu's.

Unit parity: `NGramProposer` gives equal proposals on 50 seeded
histories; `gpt_spec_verify` (per-row context lengths through
`paged_prefix_attention`) matches within rtol 1e-5, atol 1e-5 in
float32.

Engine parity: both engines serve the bridged tiny GPT (float32, CPU).
Greedy output is token-identical to the JAX engine's and to the port's
own run with speculation and chunking off (and to generate());
`stats()["compiles"]` matches the JAX engine's ledger key for key, and
the `spec` and `prefill_chunks` numbers of `stats()` are equal. Sampled
slots under the verify program are held to the port's own determinism
(sampling is not comparable across packages)."""
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
from paddle_tpu.serving.spec_decode import NGramProposer as JProposer
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_ops as tpo
from paddle_tpu_torch.serving import GenerationEngine, NGramProposer

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_KEYS = ("enabled", "k", "drafted", "accepted", "acceptance_rate")


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
           max_new_tokens=8, request_timeout_ms=0)


def _prompts(n=3, size=11, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=(size,)).astype("int64")
            for _ in range(n)]


def _generate(port, prompt, n):
    return port.generate(np.asarray(prompt)[None], max_new_tokens=n) \
        .numpy()[0]


class _OracleProposer:
    """Drafts from the known continuation: forces full acceptance."""

    def __init__(self, fulls):
        self.fulls = [np.asarray(f, np.int32) for f in fulls]

    def propose(self, tokens, k):
        toks = np.asarray(tokens, np.int32)
        for full in self.fulls:
            if toks.size <= full.size and np.array_equal(full[:toks.size],
                                                         toks):
                return full[toks.size:toks.size + k].astype(np.int32)
        return np.zeros((0,), np.int32)


class _RejectProposer:
    """Drafts that never match the greedy continuation."""

    def propose(self, tokens, k):
        t = np.asarray(tokens, np.int32)
        return ((np.repeat(t[-1:], k) + 7) % 512).astype(np.int32)


def _serve(eng, script, proposer):
    with eng:
        if proposer is not None:
            eng._proposer = proposer
        outs = script(eng)
        stats = eng.stats()
    return outs, stats


def _both(pair, script, proposer=None, **kw):
    """The same script through the JAX engine, the port's engine and the
    port's engine with speculation and chunking off."""
    ref, port = pair
    cfg = {**_KW, **kw}
    jout, jst = _serve(jserving.GenerationEngine(ref, **cfg), script,
                       proposer)
    tout, tst = _serve(GenerationEngine(port, device="cpu", **cfg), script,
                       proposer)
    off, _ = _serve(GenerationEngine(port, device="cpu", **{
        **cfg, "spec_k": 0, "prefill_chunk": 0}), script, None)
    for t, j, o in zip(tout, jout, off):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, o)
    assert tst["compiles"] == jst["compiles"]
    assert {k: tst["spec"][k] for k in SPEC_KEYS} == \
        {k: jst["spec"][k] for k in SPEC_KEYS}
    assert tst["prefill_chunks"] == jst["prefill_chunks"]
    if "prefix" in jst["kv"] and jst["kv"]["prefix"]["enabled"]:
        for k in ("hits", "misses", "hit_tokens", "nodes"):
            assert tst["kv"]["prefix"][k] == jst["kv"]["prefix"][k], k
    return tout, tst


# -- unit parity -------------------------------------------------------------

def test_ngram_proposer_matches_jax_on_50_histories():
    rng = np.random.RandomState(0)
    for i in range(50):
        T = int(rng.randint(1, 60))
        # small vocabularies so n-grams repeat; some periodic tails
        toks = rng.randint(0, int(rng.randint(2, 12)), size=(T,))
        if i % 5 == 0:
            toks = np.resize(toks[:max(1, T // 4)], T)
        for n in (1, 3):
            for k in (0, 1, 4):
                want = JProposer(n).propose(toks, k)
                got = NGramProposer(n).propose(toks, k)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    with pytest.raises(InvalidArgumentError):
        NGramProposer(0)


def test_gpt_spec_verify_matches(pair):
    """Blocks of 4 tokens for 3 rows with per-row context lengths 5, 9
    and 0 over one cached prefix (the full prefill's K/V)."""
    ref, port = pair
    cfg = ref.gpt.config
    H = cfg.num_heads
    scale = 1.0 / (cfg.hidden_size // H) ** 0.5
    rng = np.random.RandomState(6)
    ctx = rng.randint(0, 512, size=(3, 12))
    blk = rng.randint(0, 512, size=(3, 4))
    pos0 = np.array([5, 9, 0], np.int32)
    positions = pos0[:, None] + np.arange(4)[None]
    Wj, Wt = ref.decode_weights(), port.decode_weights()
    _, kj, vj = jgpt.gpt_prefill(Wj, jnp.asarray(ctx, jnp.int32),
                                 num_heads=H, scale=scale)

    def jattend(layer, q, k, v):
        return jpo.paged_prefix_attention(q, kj[layer], vj[layer], k, v,
                                          jnp.asarray(pos0), scale)

    hj, ksj, vsj = jgpt.gpt_spec_verify(
        Wj, jnp.asarray(blk, jnp.int32), jnp.asarray(positions), jattend,
        num_heads=H)
    with torch.inference_mode():
        _, kt, vt = tgpt.gpt_prefill(Wt, torch.from_numpy(ctx),
                                     num_heads=H, scale=scale)

        def tattend(layer, q, k, v):
            return tpo.paged_prefix_attention(q, kt[layer], vt[layer], k, v,
                                              torch.from_numpy(pos0), scale)

        ht, kst, vst = tgpt.gpt_spec_verify(
            Wt, torch.from_numpy(blk), torch.from_numpy(positions),
            tattend, num_heads=H)
        lt = tgpt.gpt_logits(Wt, ht).numpy()
    np.testing.assert_allclose(kst.numpy(), np.asarray(ksj), **TOL)
    np.testing.assert_allclose(vst.numpy(), np.asarray(vsj), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(lt, np.asarray(jgpt.gpt_logits(Wj, hj)),
                               **TOL)


# -- engine parity: speculation ----------------------------------------------

def test_ngram_speculation_identical_to_jax_engine(pair):
    _, port = pair
    prompts = _prompts(n=3)
    out, st = _both(pair, lambda e: [e.generate(p, max_new_tokens=8)
                                     for p in prompts], spec_k=3)
    for o, p in zip(out, prompts):
        np.testing.assert_array_equal(o, _generate(port, p, 8))
    assert st["compiles"] == {"prefill[b=4]": 1, "prefill[b=16]": 1,
                              "verify[k=3]": 1}
    assert st["spec"]["enabled"] and st["spec"]["k"] == 3


def test_oracle_drafts_accept_all_multi_token_steps(pair):
    _, port = pair
    p = _prompts(n=1)[0]
    ref = _generate(port, p, 10)
    out, st = _both(pair, lambda e: [e.generate(p, max_new_tokens=10)],
                    proposer=_OracleProposer([ref]), spec_k=3,
                    max_new_tokens=10)
    np.testing.assert_array_equal(out[0], ref)
    assert st["spec"]["accepted"] > 0
    assert st["spec"]["acceptance_rate"] == 1.0
    assert st["steps"] <= 4          # 9 decode tokens in <= 4 verify steps
    assert st["spec"]["tokens_per_step"] > 1.0


def test_rejected_drafts_never_reach_a_later_owner(pair):
    """Every draft is wrong every step: both sequences stay exact, and a
    later request reusing their freed pages decodes the clean tokens."""
    prompts = _prompts(n=2, seed=9)
    a0 = monitor.stat_get("STAT_spec_accepted")

    def script(eng):
        fa = eng.submit(prompts[0], max_new_tokens=12)
        fb = eng.submit(prompts[1], max_new_tokens=12)
        outs = [fa.result(timeout=120), fb.result(timeout=120)]
        outs.append(eng.generate(prompts[0], max_new_tokens=17))
        assert eng.stats()["pages"]["pages_in_use"] == 0
        return outs

    _, st = _both(pair, script, proposer=_RejectProposer(), spec_k=3,
                  max_new_tokens=20)
    assert st["spec"]["drafted"] > 0 and st["spec"]["accepted"] == 0
    assert monitor.stat_get("STAT_spec_accepted") == a0


def test_eos_inside_accepted_drafts(pair):
    _, port = pair
    p = _prompts(n=1, seed=5)[0]
    ref = _generate(port, p, 12)
    eos = int(ref[p.size + 4])      # the 5th generated token acts as EOS
    out, _ = _both(pair, lambda e: [e.generate(p, max_new_tokens=12,
                                               eos_token_id=eos)],
                   proposer=_OracleProposer([ref]), spec_k=4,
                   max_new_tokens=12)
    assert int(out[0][-1]) == eos and out[0].size < p.size + 12


def test_spec_mid_decode_join(pair):
    prompts = _prompts(n=2, seed=3)

    def script(eng):
        fa = eng.submit(prompts[0], max_new_tokens=40)
        deadline = time.time() + 60
        while eng.stats()["steps"] < 3:
            assert time.time() < deadline, "engine never stepped"
            time.sleep(0.002)
        fb = eng.submit(prompts[1], max_new_tokens=5)
        return [fa.result(timeout=120), fb.result(timeout=120)]

    ref, port = pair
    cfg = {**_KW, "spec_k": 2, "max_new_tokens": 40}
    jout, jst = _serve(jserving.GenerationEngine(ref, **cfg), script, None)
    tout, st = _serve(GenerationEngine(port, device="cpu", **cfg), script,
                      None)
    for t, j, p, n in zip(tout, jout, prompts, (40, 5)):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, _generate(port, p, n))
    assert st["compiles"] == jst["compiles"]
    assert st["compiles"]["verify[k=2]"] == 1


def test_sampled_slots_take_no_drafts_and_are_deterministic(pair):
    _, port = pair
    p = _prompts(n=1, seed=7)[0]

    def run():
        with GenerationEngine(port, device="cpu", spec_k=3, seed=42,
                              **_KW) as eng:
            out = eng.generate(p, max_new_tokens=6, do_sample=True,
                               temperature=0.9)
            return out, eng.stats()
    (a, sa), (b, sb) = run(), run()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (p.size + 6,)
    assert sa["spec"]["drafted"] == sb["spec"]["drafted"] == 0
    assert sa["compiles"] == {"prefill[b=4]": 1, "prefill[b=16]": 1,
                              "verify[k=3]": 1}


# -- engine parity: chunked prefill ------------------------------------------

def test_chunked_prefill_interleaves_with_decode(pair):
    """A 60-token prompt joins while a short one decodes; it prefills in
    16-token chunks between decode steps (the live sequence gains tokens
    while the chunks advance), token-exact."""
    rng = np.random.RandomState(23)
    long_p = rng.randint(0, 512, size=(60,)).astype("int64")
    short_p = _prompts(n=1, seed=25)[0]
    progress = {}

    def script(eng):
        fa = eng.submit(short_p, max_new_tokens=40)
        deadline = time.time() + 60
        while eng.stats()["steps"] < 3:
            assert time.time() < deadline
            time.sleep(0.002)
        steps0 = eng.stats()["steps"]
        fb = eng.submit(long_p, max_new_tokens=4)
        outs = [fb.result(timeout=120), fa.result(timeout=120)]
        progress[type(eng).__module__] = eng.stats()["steps"] - steps0
        return outs

    _, st = _both(pair, script, prefill_buckets=(16, 64), max_new_tokens=40,
                  prefill_chunk=16)
    assert st["prefill_chunks"] == 4            # ceil(60 / 16)
    assert progress["paddle_tpu_torch.serving.generation"] >= 4
    assert st["compiles"] == {"prefill[b=16]": 1, "prefill_tail[b=16]": 1,
                              "prefill[b=64]": 1, "prefill_tail[b=64]": 1,
                              "decode[m=2]": 1}


def test_chunk_plus_prefix_hit_chunks_only_the_tail(pair):
    rng = np.random.RandomState(27)
    pfx = rng.randint(0, 512, size=(16,)).astype("int64")
    prompts = [np.concatenate([pfx, rng.randint(0, 512, size=(36,))
                               .astype("int64")]) for _ in range(2)]
    chunks = []

    def script(eng):
        o0 = eng.generate(prompts[0], max_new_tokens=5)
        c0 = eng.stats()["prefill_chunks"]
        o1 = eng.generate(prompts[1], max_new_tokens=5)     # prefix hit
        chunks.append(eng.stats()["prefill_chunks"] - c0)
        return [o0, o1]

    _, st = _both(pair, script, prefill_buckets=(16, 64), max_new_tokens=5,
                  prefill_chunk=16, prefix_cache=True)
    assert st["kv"]["prefix"]["hits"] == 1
    # the hit chunked only its 36-token tail (3 chunks), not 52 tokens (4)
    assert chunks[:2] == [3, 3] and chunks[2] == 0


def test_spec_chunk_and_prefix_together(pair):
    _, port = pair
    long_p = np.random.RandomState(31).randint(0, 512, size=(50,))

    def script(eng):
        return [eng.generate(long_p, max_new_tokens=6) for _ in range(2)]

    out, st = _both(pair, script, prefill_buckets=(16, 64), max_new_tokens=6,
                    prefill_chunk=16, prefix_cache=True, spec_k=2)
    np.testing.assert_array_equal(out[0], _generate(port, long_p, 6))
    assert st["compiles"] == {"prefill[b=16]": 1, "prefill_tail[b=16]": 1,
                              "prefill[b=64]": 1, "prefill_tail[b=64]": 1,
                              "cow_copy": 1, "verify[k=2]": 1}
    assert st["kv"]["owners"] == []
    assert st["pages"]["pages_in_use"] == st["pages"]["cached_pages"]
