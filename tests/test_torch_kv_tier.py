"""The port's host KV tier held to paddle_tpu's (tests/test_kv_tier.py,
test for test).

Unit parity: `HostTier` runs the same put / get / pop / LRU / protect /
refusal sequence as the JAX package's store and reports the same digests,
byte ledger and counters.

Engine parity: every engine test runs the JAX engine and the port's
engine (float32 or int8 pools, CPU) on the same weights, carried across
through `models.load_reference_state`, through one script, and asserts
identical tokens (and identity with generate() / a never-evicted chain),
identical `stats()["kv"]["prefix"]` tier numbers and ledgers, identical
multisets of audit codes per request, and, after both failpoints
(`kv_tier.promote_upload`, `kv_tier.demote_gather`), no leaked page on
either tier."""
import collections
import importlib.util
import json
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.serving import failpoints as jfailpoints
from paddle_tpu.serving.kv_tier import HostEntry as JEntry
from paddle_tpu.serving.kv_tier import HostTier as JTier
import paddle_tpu_torch
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.serving import GenerationEngine, failpoints
from paddle_tpu_torch.serving.kv_tier import HostEntry, HostTier

# the tier numbers both engines report under stats()["kv"]["prefix"]
TIER_KEYS = ("tier_enabled", "host_bytes", "host_entries", "host_nodes",
             "demotions", "promotions", "tier_hits", "tier_evictions",
             "tier_abandons", "tier_hit_rate", "hits", "misses",
             "hit_tokens", "evictions", "nodes", "cached_pages")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    jfailpoints.reset()
    yield
    _set_both(FLAGS_failpoints="")
    failpoints.reset()
    jfailpoints.reset()


def _set_both(**kw):
    paddle.set_flags(kw)
    paddle_tpu_torch.set_flags(kw)


@contextmanager
def flags(**kw):
    old = paddle_tpu_torch.get_flags(list(kw))
    _set_both(**kw)
    try:
        yield
    finally:
        _set_both(**old)


_KW = dict(max_slots=2, page_size=4, num_pages=12,   # 11 usable: floods evict
           prefill_buckets=(16,), max_new_tokens=4, request_timeout_ms=0,
           prefix_cache=True, kv_tier=True, kv_tier_host_bytes=64 << 20,
           kv_tier_chunk_pages=2)


def _prompts(n=8, pfx=8, tail=3, seed=0, vocab=512):
    """n prompts with DISTINCT pfx-token leads (each registers its own
    2-page chain at the 4-token page) + tail tokens."""
    rng = np.random.RandomState(seed)
    return [np.concatenate([rng.randint(0, vocab, size=(pfx,)),
                            rng.randint(0, vocab, size=(tail,))])
            .astype("int64") for _ in range(n)]


def _generate(port, prompt, n):
    return port.generate(np.asarray(prompt)[None], max_new_tokens=n) \
        .numpy()[0]


def _tier_consistent(tier, eng=None) -> bool:
    """Byte ledger reconciles exactly with the stored entries, and (the
    port's engine) its host slab holds a slot for each entry and no
    other."""
    slab = getattr(eng, "_slab", None)
    return (tier.host_bytes == sum(e.nbytes for e in tier._entries.values())
            and (slab is None or slab.held == len(tier)))


def _pool_reconciles(eng) -> bool:
    """No live sequences: every allocated page is cache-held, one
    reference per cached page."""
    cache = eng._cache
    refs = cache.refcounts()
    cached = set(cache.cached_pages())
    return (cache.owners() == {} and set(refs) == cached
            and sum(refs.values()) == len(cached)
            and cache.pages_in_use == len(cached))


def _audit_by_request(eng):
    """The audit codes as one multiset per request, in order of each
    request's first event, plus the request-less (rid None) codes: the
    shape that compares across packages, whose rids differ."""
    per, order, loose = {}, [], collections.Counter()
    for ev in eng._audit.tail(2048):
        rid = ev["rid"]
        if rid is None:
            loose[ev["reason"]] += 1
            continue
        if rid not in per:
            per[rid] = collections.Counter()
            order.append(rid)
        per[rid][ev["reason"]] += 1
    return [per[r] for r in order], loose


def _run(eng, script):
    """Run `script(eng)` and snapshot what the comparison reads, before
    shutdown."""
    with eng:
        outs = script(eng)
        st = eng.stats()
        audits = _audit_by_request(eng)
        tier = eng._tier.stats()
        clean = _tier_consistent(eng._tier, eng) and _pool_reconciles(eng)
    return outs, st, audits, tier, clean


def _both(pair, script, **kw):
    """The same script through the JAX engine and the port's engine;
    asserts token identity, equal tier numbers, ledgers and per-request
    audit multisets; returns the port's (outputs, stats, audits, tier
    stats, leak-free)."""
    ref, port = pair
    cfg = {**_KW, **kw}
    failpoints.reset()
    jfailpoints.reset()
    j = _run(jserving.GenerationEngine(ref, **cfg), script)
    failpoints.reset()
    t = _run(GenerationEngine(port, device="cpu", **cfg), script)
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a, b)
    tp, jp = t[1]["kv"]["prefix"], j[1]["kv"]["prefix"]
    assert {k: tp[k] for k in TIER_KEYS} == {k: jp[k] for k in TIER_KEYS}
    assert t[1]["compiles"] == j[1]["compiles"]
    assert t[2] == j[2]
    assert t[3] == j[3]
    assert t[4] and j[4]
    return t


# -- HostTier store (unit) ---------------------------------------------------

def _entries(nbytes=16):
    half = nbytes // 2
    return (HostEntry(torch.zeros(half, dtype=torch.int8),
                      torch.zeros(half, dtype=torch.int8)),
            JEntry(np.zeros(half, np.int8), np.zeros(half, np.int8)))


def _both_tiers(max_bytes, name):
    return HostTier(max_bytes, engine=name), JTier(max_bytes, engine=name)


def test_host_tier_put_get_pop_accounting():
    tiers = _both_tiers(64, "tier_unit")
    for t, which in zip(tiers, (0, 1)):
        stored, evicted = t.put(b"a", _entries()[which])
        assert stored and evicted == []
        assert t.host_bytes == 16 and len(t) == 1 and b"a" in t
        # re-put under the same digest replaces without double counting
        stored, _ = t.put(b"a", _entries(32)[which])
        assert stored and t.host_bytes == 32 and len(t) == 1
        assert t.get(b"a") is not None and t.get(b"zz") is None
        e = t.pop(b"a")
        assert e is not None and e.nbytes == 32
        assert t.host_bytes == 0 and len(t) == 0
        assert t.pop(b"a") is None
        assert t.evictions == 0              # plain pops aren't evictions
        t.put(b"b", _entries()[which])
        t.pop(b"b", final=True)              # a cascade discard is
        assert t.evictions == 1
        assert _tier_consistent(t)
    assert tiers[0].stats() == tiers[1].stats()
    assert tiers[0].stats()["demotions"] == 3


def test_host_tier_lru_eviction_respects_recency_and_protect():
    logs = []
    for t, which in zip(_both_tiers(40, "tier_lru"), (0, 1)):
        log = [t.put(b"a", _entries()[which]),
               t.put(b"b", _entries()[which]),
               t.put(b"c", _entries()[which]),   # 48 > 40: LRU "a" goes
               t.digests(), t.host_bytes]
        t.get(b"b")                              # touch: "c" is now LRU
        log.append(t.put(b"d", _entries()[which]))
        # a protected digest survives even as the LRU victim
        log.append(t.put(b"e", _entries()[which], protect=(b"b",)))
        log += [t.digests(), t.stats()]
        assert _tier_consistent(t) and b"b" in t
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][2] == (True, [b"a"]) and logs[0][5] == (True, [b"c"])


def test_host_tier_refuses_entry_alone_over_budget():
    for t, which in zip(_both_tiers(8, "tier_reject"), (0, 1)):
        stored, evicted = t.put(b"big", _entries(16)[which])
        assert not stored and evicted == []
        assert len(t) == 0 and t.host_bytes == 0
        assert t.rejects == 1 and t.demotions == 0


# -- engine demote/promote round trip ----------------------------------------

def test_demote_promote_token_identical_fp32(pair):
    prompts = _prompts(n=8, seed=31)
    ref = [_generate(pair[1], p, 4) for p in prompts]

    def script(eng):
        flood = [eng.generate(p, max_new_tokens=4) for p in prompts]
        pfx = eng.stats()["kv"]["prefix"]
        assert pfx["tier_enabled"] and pfx["demotions"] >= 2
        assert pfx["host_nodes"] >= 2 and pfx["host_bytes"] > 0
        # revisit the LRU-evicted (earliest) chain: misses the device,
        # hits the host tier, promotes through the chunked uploads
        return flood + [eng.generate(prompts[0], max_new_tokens=4)]

    outs, s, audits, tier, _ = _both(pair, script, name="tier_fp32")
    for o, r in zip(outs, ref + ref[:1]):
        np.testing.assert_array_equal(o, r)
    assert tier["promotions"] >= 2 and tier["hits"] >= 1
    assert audits[1]["KV_DEMOTE"] >= 2
    assert audits[0][-1]["KV_PROMOTE"] == 1
    assert s["kv"]["prefix"]["tier_hit_rate"] > 0
    assert s["compiles"]["tier_gather"] == 1
    assert s["compiles"]["tier_write[w=2]"] == 1


def test_promoted_int8_chain_token_identical_to_never_evicted(pair):
    """An int8 chain demoted (pages + fp32 scale rows copied to host
    tensors) and promoted back decodes exactly like the never-evicted
    original: the raw bytes round-trip."""
    prompts = _prompts(n=8, seed=37)

    def script(eng):
        base = eng.generate(prompts[0], max_new_tokens=4)   # cold
        warm = eng.generate(prompts[0], max_new_tokens=4)   # device hit
        for p in prompts[1:]:
            eng.generate(p, max_new_tokens=4)
        assert eng.stats()["kv"]["prefix"]["demotions"] >= 2
        return [base, warm, eng.generate(prompts[0], max_new_tokens=4)]

    (base, warm, promoted), _, audits, tier, _ = _both(
        pair, script, kv_cache_dtype="int8", name="tier_int8")
    np.testing.assert_array_equal(base, warm)
    np.testing.assert_array_equal(promoted, base)
    assert tier["promotions"] >= 2
    assert audits[0][-1]["KV_PROMOTE"] == 1


# -- failpoints: no leak on either tier --------------------------------------

def test_promote_upload_failpoint_falls_back_cold_no_leak(pair):
    """Abandon mid-upload (after the first 1-page chunk): the written
    target page is zeroed, the admission falls back to cold prefill with
    the same tokens, exactly one KV_PROMOTE_ABANDON is audited, and
    neither tier leaks a page."""
    prompts = _prompts(n=8, seed=41)

    def script(eng):
        base = eng.generate(prompts[0], max_new_tokens=4)
        for p in prompts[1:]:
            eng.generate(p, max_new_tokens=4)
        assert eng.stats()["kv"]["prefix"]["demotions"] >= 2
        with flags(FLAGS_failpoints="kv_tier.promote_upload@2"):
            out = eng.generate(prompts[0], max_new_tokens=4)
        tier = eng._tier
        assert tier.abandons == 1 and tier.promotions == 0
        assert _tier_consistent(tier, eng) and _pool_reconciles(eng)
        abandons = [ev for ev in eng._audit.tail(256)
                    if ev["reason"] == "KV_PROMOTE_ABANDON"]
        assert len(abandons) == 1
        assert abandons[0]["pages"] == 2 and abandons[0]["written"] == 1
        # the cold prefill re-registered the chain: a revisit is a plain
        # device hit again
        return [base, out, eng.generate(prompts[0], max_new_tokens=4)]

    (base, out, again), _, _, _, clean = _both(
        pair, script, kv_cache_dtype="int8", kv_tier_chunk_pages=1,
        name="tier_abandon")
    np.testing.assert_array_equal(out, base)
    np.testing.assert_array_equal(again, base)
    assert clean


def test_demote_gather_failpoint_degrades_to_plain_eviction(pair):
    """Every demote gather fails: evictions proceed as with no tier
    (content discarded), the tier stays empty, nothing leaks."""
    prompts = _prompts(n=8, seed=43)
    ref = _generate(pair[1], prompts[0], 4)

    def script(eng):
        with flags(FLAGS_failpoints="kv_tier.demote_gather@every:1"):
            for p in prompts:
                eng.generate(p, max_new_tokens=4)
            out = eng.generate(prompts[0], max_new_tokens=4)
        pfx = eng.stats()["kv"]["prefix"]
        assert len(eng._tier) == 0 and eng._tier.host_bytes == 0
        assert eng._tier.demotions == 0 and pfx["host_nodes"] == 0
        assert pfx["evictions"] >= 1
        return [out]

    (out,), _, audits, _, clean = _both(pair, script, name="tier_nogather")
    np.testing.assert_array_equal(out, ref)
    assert "KV_DEMOTE" not in audits[1] and clean


# -- config validation -------------------------------------------------------

def test_kv_tier_requires_prefix_cache(pair):
    ref, port = pair
    with pytest.raises(InvalidArgumentError, match="requires prefix_cache"):
        GenerationEngine(port, device="cpu",
                         **{**_KW, "prefix_cache": False, "name": "tier_cfg"})
    with pytest.raises(Exception, match="requires prefix_cache"):
        jserving.GenerationEngine(ref, **{**_KW, "prefix_cache": False,
                                          "name": "tier_cfg"})


# -- observability plumbing --------------------------------------------------

def _engine_report():
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    spec = importlib.util.spec_from_file_location(
        "engine_report", os.path.join(tools, "engine_report.py"))
    er = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(er)
    return er


def test_step_ring_pressure_and_report_carry_tier_fields(pair, tmp_path):
    from paddle_tpu_torch.profiler import step_log

    d0 = monitor.stat_get("STAT_kv_tier_demotions")
    p0 = monitor.stat_get("STAT_kv_tier_promotions")
    prompts = _prompts(n=8, seed=47)
    got = {}

    def script(eng):
        for p in prompts:
            eng.generate(p, max_new_tokens=4)
        out = eng.generate(prompts[0], max_new_tokens=4)   # promote
        if isinstance(eng, GenerationEngine):
            got["payload"] = step_log.steps_payload()
            got["pressure"] = eng._compute_pressure()
        return [out]

    _both(pair, script, name="tier_obs")
    recs = got["payload"]["engines"]["tier_obs"]["records"]
    assert sum(r["tier_demotions"] for r in recs) >= 2
    assert sum(r["tier_promotions"] for r in recs) >= 2
    assert monitor.stat_get("STAT_kv_tier_demotions") - d0 >= 2
    assert monitor.stat_get("STAT_kv_tier_promotions") - p0 >= 2
    assert got["pressure"]["tier"]["hit_rate"] > 0
    assert got["pressure"]["tier"]["host_bytes"] >= 0
    er = _engine_report()
    summ = er.summarize(recs)
    assert summ["tier_demotions"] >= 2 and summ["tier_promotions"] >= 2
    path = str(tmp_path / "steps.json")
    with open(path, "w") as f:
        json.dump(got["payload"], f)
    assert er.main([path, "--engine", "tier_obs"]) == 0


def test_host_slab_slots_return_when_entries_drop(pair, monkeypatch):
    """The port's entries live in a host slab (pinned on the card) that
    grows by segments: an entry holds a slot until the tier drops it
    (refused, replaced, evicted or popped), then the slot is free again;
    a slab with every slot held raises instead of overwriting."""
    from paddle_tpu_torch.framework.errors import ResourceExhaustedError
    from paddle_tpu_torch.serving.kv_tier import HostSlab
    parts = [((2, 3), torch.float32), ((5,), torch.int8)]
    slab = HostSlab(parts, 3, pin=False)
    assert slab.slot_bytes == 24 + 8 and slab.held == 0
    assert slab.segments == 1 and slab.reserved_bytes == 3 * 32
    tier = HostTier(2 * 29, engine="slab_unit", slab=slab)

    def entry():
        slot, (k, v) = slab.take()
        k.fill_(float(slot))
        return HostEntry(k, v, slot=slot)
    for d in (b"a", b"b"):
        assert tier.put(d, entry())[0]
    assert slab.held == 2 and tier.get(b"a").nbytes == 24 + 5
    # a replaced entry returns its slot, and so does an LRU eviction
    assert tier.put(b"b", entry())[0] and slab.held == 2
    stored, evicted = tier.put(b"c", entry())
    assert stored and evicted == [b"a"] and slab.held == 2
    # an entry that alone exceeds the budget is refused and returns it
    slot, (k, v) = slab.take()
    big = HostEntry(k, v, torch.zeros(64), slot=slot)
    assert tier.put(b"big", big) == (False, []) and slab.held == 2
    tier.pop(b"b")
    assert slab.held == 1
    for _ in range(2):
        slab.take()
    with pytest.raises(ResourceExhaustedError):
        slab.take()
    # the engine's slab: every tier entry in it, slots back after the drain
    prompts = _prompts(n=8, seed=53)
    with GenerationEngine(pair[1], device="cpu", name="tier_slab",
                          **_KW) as eng:
        for p in prompts + prompts[:2]:
            eng.generate(p, max_new_tokens=4)
        held = len(eng._tier)
        assert held and eng._slab.held == held
    # segments: allocated as slots are taken, never past `slots`
    monkeypatch.setattr(HostSlab, "SEGMENT_BYTES", 64)
    grown = HostSlab(parts, 5, pin=False)
    assert grown.segments == 1 and grown.reserved_bytes == 2 * 32
    taken = [grown.take()[0] for _ in range(5)]
    assert sorted(taken) == list(range(5)) and grown.segments == 3
    assert grown.reserved_bytes == 5 * 32
    with pytest.raises(ResourceExhaustedError):
        grown.take()
    grown.release(taken[0])
    assert grown.take()[0] == taken[0] and grown.segments == 3


def test_gather_batch_lands_each_slot_once(pair):
    """The port's demotion copies land in one batch at the end of an
    eviction pass (`_tier_gather_flush`): every queued page reaches its
    slot byte for byte, and a slot released and taken again within the
    pass holds the later page."""
    with GenerationEngine(pair[1], device="cpu", name="tier_flush",
                          **_KW) as eng:
        eng.generate(_prompts(n=1, seed=61)[0], max_new_tokens=4)
        cache, slab = eng._cache, eng._slab
        gen = torch.Generator().manual_seed(0)
        for pool in eng._pools():
            pool[:, :, 5:8] = torch.randn(
                pool[:, :, 5:8].shape, generator=gen).to(pool.dtype)
        a = eng._tier_gather(5)
        b = eng._tier_gather(6)
        slab.release(b.slot)
        c = eng._tier_gather(7)
        assert c.slot == b.slot and len(eng._gather_q) == 3
        eng._tier_gather_flush()
        assert eng._gather_q == []
        for entry, page in ((a, 5), (c, 7)):
            for got, pool in zip((entry.k, entry.v),
                                 (cache.k_pages, cache.v_pages)):
                assert torch.equal(got, pool[:, :, page])
        for e in (a, c):
            slab.release(e.slot)
