"""The port's supervised restart, request replay and degraded modes held
to paddle_tpu's.

Restart primitives: `RestartBackoff` and `CrashBreaker` of both packages
take the same calls and give the same schedules and verdicts.

Engine parity (the tiny GPT carried across through
`models.load_reference_state`, CPU): every engine test drives the JAX
package's `EngineSupervisor` and the port's over the same weights with
the same failpoint schedule armed in both registries, and holds them to
each other request by request (tokens), in the audit ring's reason
multiset, in `supervisor_stats()` counts and in the ledger's keys; every
greedy output is also held to the port's fault-free `generate()`. The
requests of a test are submitted while the engine's lock is held, so the
step thread admits them in one pass in both packages and the schedule,
and so the audit trail, is the same.

Port only: a dead engine's pools are released before the rebuild
allocates the next set (the JAX engine donates them into the failing
call); the port's `/steps` records and reqspans carry the incarnation
through the unchanged `tools/engine_report.py` and
`tools/latency_report.py`; a seeded chaos run over three failpoint
schedules resolves every request success-or-typed, survivors identical to
the JAX engine's fault-free outputs."""
import collections
import gc
import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from contextlib import contextmanager

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.serving import failpoints as jfailpoints
from paddle_tpu.serving import generation as jgeneration
from paddle_tpu.serving import restart as jrestart
import paddle_tpu_torch
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import (FatalError,
                                               ResourceExhaustedError,
                                               UnavailableError)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.profiler import exporter, tracer
from paddle_tpu_torch.serving import (EngineSupervisor, GenerationEngine,
                                      failpoints)
from paddle_tpu_torch.serving import generation as tgeneration
from paddle_tpu_torch.serving import restart as trestart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


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


@pytest.fixture(autouse=True)
def _clean():
    failpoints.reset()
    jfailpoints.reset()
    yield
    _set_both(FLAGS_failpoints="")
    failpoints.reset()
    jfailpoints.reset()


_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(8,),
           max_new_tokens=5, request_timeout_ms=0)
_COUNTS = ("incarnation", "restarts", "replayed_requests",
           "retry_exhausted", "replay_impossible")


def _prompts(n=4, S=7, seed=0, vocab=512):
    return list(np.random.RandomState(seed).randint(
        0, vocab, size=(n, S)).astype("int64"))


def _generate(port, prompt, n):
    return port.generate(np.asarray(prompt)[None], max_new_tokens=n) \
        .numpy()[0]


def _sup(pkg, pair, name, **kw):
    kw = {**_KW, **kw}
    if pkg == "jax":
        return jserving.EngineSupervisor(pair[0], name=name, **kw)
    return EngineSupervisor(pair[1], name=name, device="cpu", **kw)


def _submit_all(sup, prompts, stream=False, **kw):
    """Submit every prompt while holding the current engine's lock, so
    its step thread admits them in one pass."""
    with sup.engine._cv:
        return [(sup.submit_stream if stream else sup.submit)(p, **kw)
                for p in prompts]


def _snapshot(sup):
    """What the cross-package comparison reads, before shutdown."""
    s = sup.supervisor_stats()
    return {"counts": {k: s[k] for k in _COUNTS},
            "reasons": collections.Counter(
                e["reason"] for e in sup.engine._audit.tail(4096)),
            "ledger": sorted(sup.engine._ledger)}


def _both(pair, name, script, fp="", **kw):
    """`script(sup, pkg)` through the JAX package's supervisor, then the
    port's, each with the failpoint spec `fp` armed in both registries
    from a reset. Returns {pkg: (script result, snapshot)} after
    asserting the two snapshots equal."""
    out = {}
    for pkg in ("jax", "port"):
        failpoints.reset()
        jfailpoints.reset()
        with flags(FLAGS_failpoints=fp, FLAGS_gen_restart_backoff_ms=5.0):
            sup = _sup(pkg, pair, name, **kw)
            try:
                res = script(sup, pkg)
                snap = _snapshot(sup)
            finally:
                sup.shutdown()
        out[pkg] = (res, snap)
    assert out["port"][1] == out["jax"][1], (out["port"][1], out["jax"][1])
    return out


def _same_tokens(out, refs):
    for pkg in ("jax", "port"):
        for a, b in zip(out[pkg][0], refs):
            np.testing.assert_array_equal(a, b)


# -- restart primitives ------------------------------------------------------

_PRIM = pytest.mark.parametrize("mod", [jrestart, trestart],
                                ids=["jax", "port"])


@_PRIM
def test_restart_backoff_schedule_and_reset(mod):
    b = mod.RestartBackoff(10.0)
    assert [b.next_delay_ms() for _ in range(4)] == [10.0, 20.0, 40.0,
                                                    80.0]
    b.reset()
    assert b.next_delay_ms() == 10.0
    for _ in range(20):      # capped at 32x the base
        d = b.next_delay_ms()
    assert d == 320.0 == b.max_delay_ms


@_PRIM
def test_crash_breaker_opens_and_latches(mod):
    br = mod.CrashBreaker(threshold=3, window_s=60.0)
    assert not br.record(now=0.0)
    assert not br.record(now=1.0)
    assert br.record(now=2.0)       # third death in the window: open
    assert br.is_open
    assert br.record(now=500.0)     # latched
    st = br.state()
    assert st["open"] and st["threshold"] == 3
    br.reset()
    assert not br.is_open


@_PRIM
def test_crash_breaker_window_expiry(mod):
    br = mod.CrashBreaker(threshold=2, window_s=5.0)
    assert not br.record(now=0.0)
    assert not br.record(now=10.0)  # the first event aged out
    assert br.record(now=11.0)


@_PRIM
def test_backoff_note_death_quiet_window(mod):
    b = mod.RestartBackoff(10.0)
    assert not b.note_death(30.0, now=0.0)
    assert b.next_delay_ms() == 10.0
    assert not b.note_death(30.0, now=5.0)   # consecutive: escalates
    assert b.next_delay_ms() == 20.0
    assert b.note_death(30.0, now=100.0)     # quiet gap: resets
    assert b.next_delay_ms() == 10.0


@_PRIM
def test_crash_breaker_trip_latches(mod):
    br = mod.CrashBreaker(threshold=100, window_s=60.0)
    br.trip()
    assert br.is_open
    assert br.record()


# -- supervised restart and replay --------------------------------------------

def test_decode_fault_restart_token_identical(pair):
    prompts = _prompts(4)

    def script(sup, pkg):
        led0 = dict(sup.engine._ledger)
        futs = _submit_all(sup, prompts, max_new_tokens=5)
        outs = [f.result(timeout=60) for f in futs]
        assert sup.restarts == 1 and sup.incarnation == 1
        assert sup.replayed >= 1
        # the rebuilt engine ran no new program shape
        assert dict(sup.engine._ledger) == led0
        assert {r["incarnation"]
                for r in sup.engine._step_log.tail(4096)} == {0, 1}
        h = sup.health()
        assert h["ready"] and h["incarnation"] == 1 and h["restarts"] == 1
        s = sup.stats()
        assert s["supervisor"]["last_recovery_ms"] is not None
        assert s["incarnation"] == 1
        assert s["pages"]["pages_in_use"] == 0
        return outs

    out = _both(pair, "rs_decode", script, fp="decode_step_raise@3")
    _same_tokens(out, [_generate(pair[1], p, 5) for p in prompts])
    reasons = out["port"][1]["reasons"]
    assert reasons["ENGINE_RESTART"] == 1
    assert reasons["REPLAY_ADMIT"] == out["port"][1]["counts"][
        "replayed_requests"] >= 1
    assert "ENGINE_DIED" not in reasons   # supervised: nothing stranded


def test_stream_exactly_once_across_restart(pair):
    prompts = _prompts(3, seed=5)

    def script(sup, pkg):
        streams = _submit_all(sup, prompts, stream=True, max_new_tokens=8)
        collected = [[] for _ in streams]

        def drain(i):
            for tok in streams[i]:
                collected[i].append(tok)

        ts = [threading.Thread(target=drain, args=(i,), daemon=True)
              for i in range(len(streams))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert sup.restarts == 1
        outs = [st.result(timeout=30) for st in streams]
        for i, o in enumerate(outs):
            # exactly once: the streamed tokens are the generated part,
            # no duplicate and no gap across the restart
            assert collected[i] == o[len(prompts[i]):].tolist()
        return outs

    out = _both(pair, "rs_stream", script, fp="decode_step_raise@4",
                prefill_buckets=(8, 16), max_new_tokens=8)
    _same_tokens(out, [_generate(pair[1], p, 8) for p in prompts])


def test_prefill_fault_restart(pair):
    prompts = _prompts(2, seed=9)

    def script(sup, pkg):
        outs = [sup.submit(p, max_new_tokens=5).result(timeout=60)
                for p in prompts]
        assert sup.restarts == 1
        assert sup.stats()["pages"]["pages_in_use"] == 0
        return outs

    out = _both(pair, "rs_prefill", script, fp="prefill_raise@1")
    _same_tokens(out, [_generate(pair[1], p, 5) for p in prompts])


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_retry_exhausted_and_breaker_open(pair):
    """Every step dies: the request spends its retry budget, then the
    crash storm opens the breaker; the port's `/readyz` over 127.0.0.1
    answers 503 with the breaker reason."""
    def script(sup, pkg):
        fut = sup.submit(_prompts(1)[0], max_new_tokens=5)
        with pytest.raises(Exception, match="replay budget exhausted"):
            fut.result(timeout=60)
        with pytest.raises(Exception):
            sup.submit(_prompts(1)[0], max_new_tokens=5).result(timeout=60)
        deadline = time.time() + 30
        while not sup._breaker.is_open and time.time() < deadline:
            time.sleep(0.02)
        h = sup.health()
        assert not h["ready"] and h["breaker_open"]
        assert "breaker open" in h["reason"]
        with pytest.raises(Exception, match="breaker open"):
            sup.submit(_prompts(1)[0], max_new_tokens=5)
        s = sup.stats()["supervisor"]
        assert s["breaker"]["open"] and s["retry_exhausted"] == 1
        if pkg == "port":
            assert isinstance(fut.exception(), UnavailableError)
            srv = exporter.MetricsServer(0)
            try:
                status, body = _get(srv.url + "/readyz")
            finally:
                srv.close()
            assert status == 503
            entry = json.loads(body)["engines"]["rs_breaker"]
            assert not entry["ready"] and entry["breaker_open"]
            assert "breaker open" in entry["reason"]
        return []

    out = _both(pair, "rs_breaker", script, fp="decode_step_raise@every:1",
                retry_limit=1, breaker_threshold=3, breaker_window_s=60.0)
    reasons = out["port"][1]["reasons"]
    assert reasons["BREAKER_OPEN"] == 1 and reasons["RETRY_EXHAUSTED"] == 1


def test_rebuild_failure_trips_breaker_and_fails_typed(pair):
    """A rebuild that raises (a lost CUDA context after a real device
    fault fails every rebuild) counts as another death: both packages
    trip the breaker within `threshold` attempts and fail every entry
    typed, never looping with the gate held."""
    prompts = _prompts(3, seed=12)

    def script(sup, pkg):
        def broken(incarnation, carry):
            raise RuntimeError("device lost (injected rebuild failure)")

        sup._build_engine = broken
        futs = _submit_all(sup, prompts, max_new_tokens=5)
        for f in futs:
            with pytest.raises(Exception, match="rebuild keeps failing"):
                f.result(timeout=60)
            if pkg == "port":
                assert isinstance(f.exception(), UnavailableError)
        assert all(f.done() for f in futs)
        h = sup.health()
        assert not h["ready"] and "rebuild keeps failing" in h["reason"]
        assert sup._breaker.is_open and sup.restarts == 0
        with pytest.raises(Exception, match="breaker open"):
            sup.submit(prompts[0])
        return []

    out = _both(pair, "rs_rebuild", script, fp="decode_step_raise@1",
                breaker_threshold=3)
    assert out["port"][1]["counts"]["incarnation"] == 2


@pytest.mark.parametrize("mod", [jgeneration, tgeneration],
                         ids=["jax", "port"])
def test_die_resolution_race_dedupes_by_rid(pair, mod):
    """A request whose outcome is already STAGED when the engine dies
    observes that outcome and never the death error too."""
    if mod is jgeneration:
        eng = jserving.GenerationEngine(pair[0], name="rs_race", **_KW)
    else:
        eng = GenerationEngine(pair[1], name="rs_race", device="cpu", **_KW)
    eng.shutdown()   # step loop parked; white-box staging below
    stream = mod.TokenStream(Future())
    req = mod._GenRequest(np.arange(4, dtype=np.int32), 3, None, False,
                          1.0, stream.future, None, 0.0, None,
                          stream=stream)
    eng._slots[0] = req   # slot-resident, as mid-iteration
    done = np.arange(7, dtype=np.int32)
    eng._resolve_req_later(req, result=done)
    assert eng._die(RuntimeError("mid-iteration death")) is False
    np.testing.assert_array_equal(req.future.result(timeout=5), done)
    assert list(stream) == []   # ended cleanly, no error queued
    eng._slots[0] = None


@pytest.mark.parametrize("mod", [jgeneration, tgeneration],
                         ids=["jax", "port"])
def test_replay_entry_delivered_keeps_residual_skip(mod):
    """A from-scratch stream replay interrupted by a SECOND death keeps
    the suppressions it still owes: `delivered` = generated here + owed."""
    stream = mod.TokenStream(Future())
    req = mod._GenRequest(np.arange(4, dtype=np.int32), 8, None, False,
                          1.0, stream.future, None, 0.0, None,
                          stream=stream)
    req.toks = [5, 6]       # re-derived so far (both suppressed)
    req.skip_stream = 3     # still owed from delivered=5
    entry = mod.ReplayEntry(req, queued=False)
    assert entry.delivered == 5
    assert max(0, entry.delivered - len(entry.toks)) == 3
    req2 = mod._GenRequest(np.arange(4, dtype=np.int32), 8, None, False,
                           1.0, Future(), None, 0.0, None)
    req2.toks = [5, 6]
    assert mod.ReplayEntry(req2, queued=False).delivered == 0
    m = mod.CrashManifest("e", 0, RuntimeError("x"), [entry], True,
                          {"stats": {}}, {"decode[m=2]": 1})
    assert m.summary()["entries"] == [
        {"rid": req.rid, "queued": False, "generated": 2, "delivered": 5,
         "stream": True, "retries": 0}]


# -- degraded modes ----------------------------------------------------------

def test_poison_storm_flips_spec_off(pair):
    prompt = _prompts(1, seed=3)[0]

    def script(sup, pkg):
        eng = sup.engine
        led0 = dict(eng._ledger)
        # with the degrade armed, BOTH step programs were warmed
        assert any(k.startswith("verify[") for k in led0)
        assert any(k.startswith("decode[") for k in led0)
        with flags(FLAGS_failpoints="decode_poison_nan@every:1"):
            for _ in range(2):
                with pytest.raises(Exception, match="non-finite"):
                    sup.submit(prompt, max_new_tokens=5).result(timeout=30)
        assert eng.stats()["degraded"]["spec_off"]
        # the engine keeps serving through the warmed decode step, and
        # the ledger does not move
        out = sup.submit(prompt, max_new_tokens=5).result(timeout=30)
        assert dict(eng._ledger) == led0
        return [out]

    with flags(FLAGS_gen_poison_degrade_k=2,
               FLAGS_gen_degraded_window_s=60.0):
        out = _both(pair, "rs_poison", script, spec_k=2)
    _same_tokens(out, [_generate(pair[1], prompt, 5)])
    assert out["port"][1]["reasons"]["DEGRADED_SPEC_OFF"] == 1


def test_degraded_spec_off_survives_restart(pair):
    prompt = _prompts(1, seed=4)[0]

    def script(sup, pkg):
        with flags(FLAGS_failpoints="decode_poison_nan@1"):
            with pytest.raises(Exception, match="non-finite"):
                sup.submit(prompt, max_new_tokens=5).result(timeout=30)
        assert sup.stats()["degraded"]["spec_off"]
        with flags(FLAGS_failpoints="decode_step_raise@1"):
            failpoints.reset()
            jfailpoints.reset()
            out = sup.submit(prompt, max_new_tokens=5).result(timeout=60)
        assert sup.restarts == 1
        # the manifest carried the verdict: incarnation 1 starts degraded
        st = sup.stats()
        assert st["degraded"]["spec_off"] and st["incarnation"] == 1
        return [out]

    with flags(FLAGS_gen_poison_degrade_k=1,
               FLAGS_gen_degraded_window_s=60.0):
        out = _both(pair, "rs_spec_restart", script, spec_k=2)
    _same_tokens(out, [_generate(pair[1], prompt, 5)])


def test_exhaust_clamp_fails_fast_then_clears(pair):
    pA = _prompts(1, seed=1)[0]

    def script(sup, pkg):
        eng = sup.engine
        # pool sized so request A's worst case takes EVERY usable page
        futA = sup.submit(pA, max_new_tokens=40)
        futB = sup.submit(pA, max_new_tokens=5)
        futC = sup.submit(pA, max_new_tokens=5)
        deadline = time.time() + 20
        while not eng._admit_clamped and time.time() < deadline:
            time.sleep(0.01)
        assert eng._admit_clamped
        with pytest.raises(Exception, match="admission clamped"):
            sup.submit(pA, max_new_tokens=5)
        if pkg == "port":
            with pytest.raises(ResourceExhaustedError):
                sup.submit(pA, max_new_tokens=5)
        assert eng.stats()["degraded"]["admit_clamped"]
        outs = [f.result(timeout=90) for f in (futA, futB, futC)]
        deadline = time.time() + 10
        while eng._admit_clamped and time.time() < deadline:
            time.sleep(0.01)
        assert not eng._admit_clamped
        _set_both(FLAGS_failpoints="")
        outs.append(sup.submit(pA, max_new_tokens=5).result(timeout=30))
        return outs

    with flags(FLAGS_gen_exhaust_clamp_k=5,
               FLAGS_gen_degraded_window_s=60.0):
        out = _both(pair, "rs_clamp", script, fp="slow_step_ms@every:1:25",
                    max_slots=3, num_pages=13, max_new_tokens=40)
    _same_tokens(out, [_generate(pair[1], pA, n) for n in (40, 5, 5, 5)])
    assert out["port"][1]["reasons"]["DEGRADED_ADMIT_CLAMP"] == 1


# -- port only: the pools, the reports, chaos ---------------------------------

def test_dead_pools_released_before_rebuild(pair):
    """The JAX engine donates its pools into the failing call, so a
    restart never holds two sets; the port's dead engine releases its
    pools (and their residency gauge) before the supervisor builds the
    next engine, and the traceback keeps no frame locals."""
    seen = {}
    with flags(FLAGS_failpoints="decode_step_raise@2",
               FLAGS_gen_restart_backoff_ms=1.0):
        sup = _sup("port", pair, "rs_pools")
        dead = sup.engine
        hbm = dead._cache.hbm_bytes()
        gc.collect()
        g0 = monitor.stat_get("STAT_kv_cache_hbm_bytes")
        real = sup._build_engine

        def probe(incarnation, carry):
            seen["gauge"] = monitor.stat_get("STAT_kv_cache_hbm_bytes")
            seen["numel"] = (dead._cache.k_pages.numel()
                             + dead._cache.v_pages.numel())
            tb = dead._death.__traceback__
            seen["locals"] = []
            while tb is not None:
                if tb.tb_frame.f_code.co_name != "_loop":
                    seen["locals"].append(dict(tb.tb_frame.f_locals))
                tb = tb.tb_next
            return real(incarnation, carry)

        sup._build_engine = probe
        try:
            out = sup.submit(_prompts(1)[0], max_new_tokens=5).result(
                timeout=60)
            assert sup.restarts == 1
            assert seen["numel"] == 0 and dead._cache.hbm_bytes() == 0
            assert seen["gauge"] == g0 - hbm
            assert seen["locals"] and not any(seen["locals"])
            assert sup.engine._cache.hbm_bytes() == hbm
            assert monitor.stat_get("STAT_kv_cache_hbm_bytes") == g0
            # the manifest kept the dead layout for the crash record
            assert dead._cache.stats()["hbm_bytes"] == 0
        finally:
            sup.shutdown()
    np.testing.assert_array_equal(out, _generate(pair[1], _prompts(1)[0], 5))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reports_carry_incarnation(pair, tmp_path):
    """The port's `/steps` records and reqspans carry the incarnation:
    `tools/engine_report.py` counts the restart in the window and
    `tools/latency_report.py` the post-restart requests, unchanged."""
    er, lr = _tool("engine_report"), _tool("latency_report")
    prompts = _prompts(4, seed=21)
    tracer.clear()
    with flags(FLAGS_failpoints="decode_step_raise@5",
               FLAGS_gen_restart_backoff_ms=1.0):
        sup = _sup("port", pair, "rs_report")
        try:
            futs = _submit_all(sup, prompts, max_new_tokens=5)
            for f in futs:
                f.result(timeout=60)
            srv = exporter.MetricsServer(0)
            try:
                status, body = _get(srv.url + "/steps")
            finally:
                srv.close()
        finally:
            sup.shutdown()
    assert status == 200
    steps = json.loads(body)
    recs = steps["engines"]["rs_report"]["records"]
    summ = er.summarize(recs)
    assert summ["incarnations"] == [0, 1]
    assert summ["restarts_in_window"] == 1
    path = tmp_path / "steps.json"
    path.write_text(json.dumps(steps))
    assert er.main([str(path), "--engine", "rs_report"]) == 0
    evs = [e for e in tracer.chrome_trace()["traceEvents"]
           if str(e.get("name", "")).startswith("reqspan:")]
    gens = [g for g in lr.parse_gen_trace(None, events=evs)
            if g["engine"] == "rs_report"]
    assert len(gens) == len(prompts)
    rep = lr.gen_report(gens)
    assert rep["incarnations"] == [0, 1]
    assert rep["post_restart_requests"] == sum(g["inc"] == 1 for g in gens)
    assert rep["post_restart_requests"] >= 1


def _chaos(pair, n, schedules, spec_k, seed, settle):
    """Seeded failpoint schedule over `n` mixed requests (streams and
    futures, prefix hits and misses) in one window a schedule (`settle`:
    each window's requests resolve before the next schedule is armed):
    every request resolves, success or typed; survivors equal the JAX
    engine's fault-free outputs and streams deliver exactly once; no
    page leaks past the prefix index."""
    ref, port = pair
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 512, size=(8,)).astype("int64")
    prompts = []
    for _ in range(n):
        tail = rng.randint(0, 512, size=(int(rng.randint(2, 5)),))
        prompts.append(np.concatenate([shared, tail]).astype("int64")
                       if rng.rand() < 0.6 else
                       rng.randint(0, 512, size=(6 + tail.size,))
                       .astype("int64"))
    cfg = dict(max_slots=4, page_size=4, num_pages=128,
               prefill_buckets=(16,), max_new_tokens=6,
               request_timeout_ms=0, max_queue_depth=2 * n,
               prefix_cache=True, spec_k=spec_k)
    refs = {}
    with jserving.GenerationEngine(ref, name=f"chaos_ref{spec_k}",
                                   **cfg) as eng:
        for p in prompts:
            if p.tobytes() not in refs:
                refs[p.tobytes()] = eng.submit(
                    p, max_new_tokens=6).result(timeout=60)
    with flags(FLAGS_gen_restart_backoff_ms=2.0):
        sup = EngineSupervisor(port, name=f"chaos{spec_k}", device="cpu",
                               retry_limit=4, breaker_threshold=10 ** 6,
                               breaker_window_s=60.0, **cfg)
        handles, drains = [], []
        collected = [[] for _ in range(n)]

        def drain(i, stream):
            try:
                for tok in stream:
                    collected[i].append(tok)
            except Exception:  # noqa: BLE001 — typed errors held below
                pass

        per = -(-n // len(schedules))
        for i in range(n):
            if i % per == 0:
                _set_both(FLAGS_failpoints=schedules[i // per])
            if i % 2 == 0:
                st = sup.submit_stream(prompts[i], max_new_tokens=6)
                handles.append(("stream", st))
                t = threading.Thread(target=drain, args=(i, st),
                                     daemon=True)
                t.start()
                drains.append(t)
            else:
                handles.append(("future",
                                sup.submit(prompts[i], max_new_tokens=6)))
            if i % per == per - 1:
                if settle:
                    # the window's schedule stays armed until its
                    # requests have resolved
                    for kind, h in handles[i + 1 - per:]:
                        (h.future if kind == "stream" else h).exception(
                            timeout=180)
                else:
                    time.sleep(0.02 * (1 + rng.randint(3)))
        _set_both(FLAGS_failpoints="")
        ok = failed = 0
        try:
            for i, (kind, h) in enumerate(handles):
                fut = h.future if kind == "stream" else h
                try:
                    out = fut.result(timeout=180)
                except (UnavailableError, FatalError):
                    failed += 1
                    continue
                ok += 1
                np.testing.assert_array_equal(out,
                                              refs[prompts[i].tobytes()])
                if kind == "stream":
                    for t in drains:
                        t.join(30)
                    assert collected[i] == out[len(prompts[i]):].tolist()
            assert ok + failed == n and ok > 0
            restarts = sup.restarts
            eng = sup.engine
        finally:
            sup.shutdown(drain=True)
    assert eng._cache.owners() == {}
    assert eng._cache.pages_in_use == len(eng._cache.cached_pages())
    return restarts


@pytest.mark.parametrize("spec_k", [0, 2])
def test_chaos_short(pair, spec_k):
    restarts = _chaos(pair, 24, ["decode_step_raise@every:5",
                                 "decode_poison_nan@every:5",
                                 "slow_step_ms@every:3:5;"
                                 "decode_step_raise@every:4"],
                      spec_k, seed=77 + spec_k, settle=True)
    assert restarts >= 2


@pytest.mark.slow
@pytest.mark.parametrize("spec_k", [0, 2])
def test_chaos_soak(pair, spec_k):
    _chaos(pair, 104, ["", "decode_step_raise@every:29",
                       "decode_poison_nan@every:37", "",
                       "decode_step_raise@every:23",
                       "slow_step_ms@every:11:5", ""],
           spec_k, seed=1234 + spec_k, settle=False)
