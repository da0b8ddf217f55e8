"""The port's serving observability held to paddle_tpu's.

Unit parity: `AuditLog`, `StepLog`, `slo`, `trace_context` and
`failpoints` of `paddle_tpu_torch.profiler` / `.serving` take the same
calls as the JAX package's and give the same rings, payloads, burn rates,
ids and fire schedules; `monitor` keeps the residency gauge
`STAT_kv_cache_hbm_bytes` (ROADMAP C12) as the JAX package does.

Engine parity (the tiny GPT carried across through
`models.load_reference_state`, CPU): the step ring's sums equal
`stats()` and every record's six `attr_*` buckets sum exactly to its
`attr_wall_ms`, as in the JAX engine; after the same workload both
engines' exporters show the same set of moved `/metrics` names (device
telemetry aside: the port's comes from torch.cuda and there is no card
here); `decode_step_raise@1` and `decode_poison_nan@1` dump the same
flight records; `tools/engine_report.py` reads the port's `/steps`
payload, scraped over 127.0.0.1, as it reads the JAX engine's."""
import collections
import gc
import importlib.util
import json
import os
import re
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import audit as jaudit
from paddle_tpu.profiler import slo as jslo
from paddle_tpu.profiler import step_log as jstep_log
from paddle_tpu.profiler import trace_context as jtc
from paddle_tpu.serving import failpoints as jfailpoints
import paddle_tpu_torch
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import (FatalError,
                                               InvalidArgumentError,
                                               UnavailableError)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.profiler import (audit, device_telemetry, slo,
                                       step_log, trace_context)
from paddle_tpu_torch.serving import GenerationEngine, failpoints
from paddle_tpu_torch.serving.kv_cache import PagedKVCache

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


_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(8, 16),
           max_new_tokens=6, request_timeout_ms=0)


def _prompts(n=4, S=7, seed=0, vocab=512):
    return list(np.random.RandomState(seed).randint(
        0, vocab, size=(n, S)).astype("int64"))


def _engine_report():
    spec = importlib.util.spec_from_file_location(
        "engine_report", os.path.join(ROOT, "tools", "engine_report.py"))
    er = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(er)
    return er


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


# -- unit parity -------------------------------------------------------------

def _strip_t(evs):
    return [{k: v for k, v in e.items() if k != "t"} for e in evs]


def test_audit_log_matches_reference(tmp_path):
    assert audit.REASONS == jaudit.REASONS
    logs = []
    for mod, set_flags, sink in (
            (audit, paddle_tpu_torch.set_flags, tmp_path / "t.jsonl"),
            (jaudit, paddle.set_flags, tmp_path / "j.jsonl")):
        set_flags({"FLAGS_gen_audit_log": str(sink)})
        try:
            log = mod.AuditLog("obs_audit", capacity=4)
            log.audit("ADMIT", rid=1, slot=0, pages=3)
            log.audit("DEFER_SLOTS", rid=2, queue_depth=1)
            for r in range(3, 6):
                log.audit("COMPLETE_MAX_NEW", rid=r, generated=5)
            with pytest.raises(Exception, match="unknown audit reason"):
                log.audit("NOT_A_CODE", rid=9)
            log.flush_sink()
            logs.append((log.recorded, _strip_t(log.tail(10)),
                         _strip_t(mod.tail_for("obs_audit", 2)),
                         _strip_t([json.loads(x) for x in
                                   sink.read_text().splitlines()])))
            log.close()
            assert mod.tail_for("obs_audit") == []
        finally:
            set_flags({"FLAGS_gen_audit_log": ""})
    assert logs[0] == logs[1]
    assert logs[0][0] == 5 and len(logs[0][1]) == 4 and len(logs[0][3]) == 5


def test_step_log_matches_reference():
    assert step_log._FIELDS == jstep_log._FIELDS
    out = []
    for mod in (step_log, jstep_log):
        log = mod.StepLog("obs_steps", capacity=3)
        for i in range(1, 6):
            log.record(mod.StepRecord(
                it=i, step=i - 1, t=float(i), live=i % 3, tokens=i,
                admitted=i % 2, decode_ms=0.5 * i, queue_depth=i % 2,
                oldest_age_ms=1.0, attr_wall_ms=2.0 * i,
                attr_bookkeep_ms=i))
        p = mod.steps_payload(last=2)["engines"]["obs_steps"]
        out.append((log.recorded, log.tail(10), p["records"],
                    p["ring_capacity"], p["recorded_total"],
                    len(mod.chrome_counter_events(pid=1))))
        mod.unregister(log)
    assert out[0] == out[1]
    assert [r["it"] for r in out[0][1]] == [3, 4, 5]


def test_slo_burn_rates_match_reference():
    res = []
    with flags(FLAGS_slo_ttft_p99_ms=10.0, FLAGS_slo_error_rate=0.2,
               FLAGS_slo_max_burn_rate=1.0):
        for mod in (slo, jslo):
            mod.reset()
            for ms in (1.0, 2.0, 50.0, 3.0):
                mod.observe_ttft("obs_slo", ms)
            for ok in (True, True, False, True, True):
                mod.observe_request("obs_slo", ok=ok)
            ev = mod.evaluate("obs_slo", set_gauges=False)["obs_slo"]
            res.append(({o: [(c["seconds"], c["count"], c["violations"],
                              round(c["burn_rate"], 6), c["violated"])
                             for c in v["windows"]]
                         for o, v in ev.items()},
                        mod.objectives(), mod.windows(),
                        mod.shed_verdict("obs_slo")))
            mod.forget("obs_slo")
    assert res[0] == res[1]
    assert res[0][0]["ttft"][0][2] == 1 and res[0][3] is not None
    assert slo.shed_verdict("obs_slo") is None      # objectives off again


def test_trace_context_matches_reference():
    tid = trace_context.new_trace_id()
    assert trace_context.is_trace_id(tid) and jtc.is_trace_id(tid)
    for s in (tid, "0123456789abcdef", "XYZ", "0123456789ABCDEF", 7):
        assert trace_context.is_trace_id(s) == jtc.is_trace_id(s)
    for s in (tid, "ffffffffffffffff", "0000000000000001"):
        assert trace_context.flow_id(s) == jtc.flow_id(s)


@pytest.mark.parametrize("spec", [
    "decode_step_raise@3", "decode_poison_nan@every:2",
    "slow_step_ms@every:3:40", "prefill_raise@1;alloc_exhaust@every:2",
    "kv_tier.promote_upload@2", "kv_tier.demote_gather@every:1"])
def test_failpoint_schedules_match_reference(spec):
    assert failpoints.SITES == jfailpoints.SITES
    with flags(FLAGS_failpoints=spec):
        got = [[mod.fire(site) for _ in range(7)
                for site in failpoints.SITES]
               for mod in (failpoints, jfailpoints)]
        snaps = [failpoints.snapshot(), jfailpoints.snapshot()]
    assert got[0] == got[1] and snaps[0] == snaps[1]
    assert any(v is not None for v in got[0])


@pytest.mark.parametrize("spec", ["decode_step_raise", "nosuch@1",
                                  "prefill_raise@0", "slow_step_ms@x",
                                  "alloc_exhaust@1;alloc_exhaust@2"])
def test_malformed_failpoints_raise_in_both(spec):
    with flags(FLAGS_failpoints=spec):
        with pytest.raises(InvalidArgumentError):
            failpoints.fire("decode_step_raise")
        with pytest.raises(Exception):
            jfailpoints.fire("decode_step_raise")
    with flags(FLAGS_failpoints="decode_step_raise@1"):
        with pytest.raises(failpoints.InjectedFault):
            failpoints.maybe_raise("decode_step_raise")


def test_kv_cache_hbm_gauge_tracks_live_caches():
    """ROADMAP C12: every live cache adds its pool (and scale-pool)
    bytes to STAT_kv_cache_hbm_bytes and a collected one takes them
    back, a level gauge, as tests/test_quantized_serving.py holds the
    JAX package's."""
    gc.collect()
    k0 = monitor.stat_get("STAT_kv_cache_hbm_bytes")
    c1 = PagedKVCache(2, 2, 8, 4, 16, 2, device="cpu")
    c2 = PagedKVCache(2, 2, 8, 4, 16, 2, dtype="int8", device="cpu")
    assert monitor.stat_get("STAT_kv_cache_hbm_bytes") == \
        k0 + c1.hbm_bytes() + c2.hbm_bytes()
    keep = c2.hbm_bytes()
    del c1
    gc.collect()
    assert monitor.stat_get("STAT_kv_cache_hbm_bytes") == k0 + keep
    assert monitor.gauge_kind("STAT_kv_cache_hbm_bytes") == "level"
    del c2
    gc.collect()
    assert monitor.stat_get("STAT_kv_cache_hbm_bytes") == k0


def test_cache_finalizer_never_takes_the_monitor_lock():
    """A cache's gauge finalizer runs wherever a garbage collection
    starts, which may be inside a locked monitor call on the same thread
    (a finalizer that took the lock would deadlock that thread): a
    collection inside the lock completes, and the next read sees the
    bytes taken back."""
    import threading
    gc.collect()
    k0 = monitor.stat_get("STAT_kv_cache_hbm_bytes")
    done = threading.Event()

    def run():
        c = PagedKVCache(2, 2, 8, 4, 16, 2, device="cpu")
        assert monitor.stat_get("STAT_kv_cache_hbm_bytes") == \
            k0 + c.hbm_bytes()
        with monitor._lock:
            del c
            gc.collect()
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(30)
    assert done.is_set(), "the finalizer took the monitor's lock"
    assert monitor.stat_get("STAT_kv_cache_hbm_bytes") == k0


def test_device_telemetry_without_cuda_has_no_device_gauges():
    snap = device_telemetry.sample()
    assert snap["devices"] == {} and snap["mfu_bp"] is None
    assert not any(re.match(r"STAT_device\d+_hbm", n)
                   for n in monitor.all_stats())
    assert device_telemetry.snapshot()["flops_per_step"] >= 0


def test_record_event_and_chrome_export(tmp_path):
    with profiler.RecordEvent("obs::scope"):
        pass

    @profiler.RecordEvent("obs::decorated")
    def f():
        return 3

    assert f() == 3
    path = str(tmp_path / "trace.json")
    profiler.export_chrome_tracing(path)
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    assert {"obs::scope", "obs::decorated"} <= names


# -- engines -----------------------------------------------------------------

def _workload(eng, prompts):
    futs = [eng.submit(p, max_new_tokens=6 - i % 3)
            for i, p in enumerate(prompts)]
    return [f.result(timeout=120) for f in futs]


def _ring_sums(recs):
    return {k: sum(r[k] for r in recs)
            for k in ("tokens", "admitted", "completed", "freed",
                      "expired", "poisoned")}


def test_step_ring_sums_and_attribution_reconcile(pair):
    ref, port = pair
    prompts = _prompts(n=5, seed=2)
    sums, outs = [], []
    for mod, eng in ((jstep_log, jserving.GenerationEngine(
            ref, name="obs_ring", **_KW)),
                     (step_log, GenerationEngine(
            port, device="cpu", name="obs_ring", **_KW))):
        with eng:
            outs.append(_workload(eng, prompts))
            st = eng.stats()
            recs = mod.steps_payload()["engines"]["obs_ring"]["records"]
        s = _ring_sums(recs)
        assert s["tokens"] == st["tokens"]
        assert s["admitted"] == s["completed"] == len(prompts)
        assert st["step_log"]["recorded"] == len(recs)
        attributed = [r for r in recs if r["attr_wall_ms"] > 0]
        assert attributed
        for r in attributed:
            total = (r["attr_admit_ms"] + r["prefill_ms"]
                     + r["attr_promote_ms"] + r["decode_ms"]
                     + r["attr_bookkeep_ms"] + r["attr_idle_ms"])
            assert abs(total - r["attr_wall_ms"]) < 1e-9, r
        assert sum(r["prefill_ms"] for r in recs) > 0
        assert sum(r["decode_ms"] for r in recs) > 0
        sums.append(s)
    assert sums[0] == sums[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _scrape_names(url):
    """{metric name: value} of a /metrics page, one entry per sample
    line (histograms by their _count line)."""
    _, text = _get(url + "/metrics")
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or "_bucket{" in line:
            continue
        name, val = line.rsplit(" ", 1)
        out[name] = float(val)
    return out


def _moved(before, after):
    return {n for n, v in after.items() if before.get(n) != v}


# set aside: device telemetry (jax memory_stats and the compile-ms ledger
# there, torch.cuda here), the trace rings' own gauges, and the paged
# attention counters, which the JAX package bumps once per trace (warmup)
# and the port once per call (see the port's monitor docstring)
def _comparable(names):
    return {n for n in names
            if not re.match(r"paddle_tpu_stat_(device\d+_|compile_ms_|"
                            r"paged_attn_)", n)
            and not n.startswith("paddle_tpu_trace_")}


def test_metrics_names_match_jax_exporter(pair):
    """After the same workload, the `/metrics` names that moved are the
    same for both engines' exporters, and the port's page holds the C12
    gauge and one ttft_ms / tpot_ms count per request."""
    ref, port = pair
    prompts = _prompts(n=3, seed=5)
    moved = []
    # an engine name of its own: the JAX package's monitor histograms are
    # process-wide, and tests/test_observability.py counts the requests
    # of its "obs_metrics" engine when both files share a test process
    for make in (lambda: jserving.GenerationEngine(
            ref, name="obs_metrics_gen", metrics_port=0, **_KW),
                 lambda: GenerationEngine(port, device="cpu",
                                          name="obs_metrics_gen",
                                          metrics_port=0, **_KW)):
        eng = make()
        with eng:
            url = eng.metrics_server.url
            before = _scrape_names(url)
            _workload(eng, prompts)
            after = _scrape_names(url)
        moved.append(_comparable(_moved(before, after)))
        if isinstance(eng, GenerationEngine):
            port_before, port_after = before, after
    assert moved[1] == moved[0], (moved[1] ^ moved[0])
    for h in ("ttft_ms", "tpot_ms"):
        n = f"paddle_tpu_{h}_count"
        assert port_after[n] - port_before.get(n, 0) == len(prompts)
    assert "paddle_tpu_stat_kv_cache_hbm_bytes" in port_after


def test_exporter_endpoints_and_engine_report(pair, tmp_path):
    """The port's exporter over 127.0.0.1: /healthz and /readyz 200
    while serving, /stats carries the engine, /slo, /trace and /history
    are JSON, and `tools/engine_report.py` renders the /steps payload
    (records reconciling with stats()) as it renders the JAX engine's;
    /readyz turns 503 under an SLO burn and back."""
    ref, port = pair
    er = _engine_report()
    prompts = _prompts(n=3, seed=6)
    payloads = []
    with GenerationEngine(port, device="cpu", name="obs_http",
                          metrics_port=0, **_KW) as eng:
        url = eng.metrics_server.url
        assert url.startswith("http://127.0.0.1:")
        _workload(eng, prompts)
        assert _get(url + "/healthz")[0] == 200
        status, body = _get(url + "/readyz")
        assert status == 200 and json.loads(body)["engines"]["obs_http"][
            "ready"]
        stats = json.loads(_get(url + "/stats")[1])
        assert stats["engines"]["obs_http"]["tokens"] == \
            eng.stats()["tokens"]
        assert "device_telemetry" in stats and "flight_recorder" in stats
        for ep in ("/slo", "/trace", "/history"):
            json.loads(_get(url + ep)[1])
        payloads.append(json.loads(_get(url + "/steps")[1]))
        with flags(FLAGS_slo_ttft_p99_ms=0.001,
                   FLAGS_slo_max_burn_rate=1.0):
            _workload(eng, prompts[:1])     # samples land while it is on
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(url + "/readyz")
            assert e.value.code == 503
        assert _get(url + "/readyz")[0] == 200
    with jserving.GenerationEngine(ref, name="obs_http", **_KW) as jeng:
        _workload(jeng, prompts)
        payloads.append(jstep_log.steps_payload())
    for p in payloads:
        recs = p["engines"]["obs_http"]["records"]
        assert _ring_sums(recs)["completed"] == len(prompts)
        path = str(tmp_path / "steps.json")
        with open(path, "w") as f:
            json.dump(p, f)
        assert er.main([path, "--engine", "obs_http"]) == 0
    assert (er.summarize(payloads[0]["engines"]["obs_http"]["records"])
            .keys() == er.summarize(
                payloads[1]["engines"]["obs_http"]["records"]).keys())


def _dumps(d):
    out = []
    for path in sorted(os.listdir(d)):
        rec = json.load(open(os.path.join(d, path)))
        out.append((rec["reason"], sorted(rec["extra"]),
                    collections.Counter(e["reason"] for e in
                                        rec["extra"]["audit_tail"])))
    return out


@pytest.mark.parametrize("spec,err", [
    ("decode_step_raise@1", UnavailableError),
    ("decode_poison_nan@1", FatalError)])
def test_flight_dumps_on_failpoints(pair, tmp_path, spec, err):
    """An engine death (decode_step_raise) and a poisoned sequence
    (decode_poison_nan) dump the same flight records, with step-log and
    audit tails, from both engines; the failing request's error is the
    JAX engine's kind."""
    ref, port = pair
    prompts = _prompts(n=2, seed=9)
    got = []
    for name, make in (("j", lambda: jserving.GenerationEngine(
            ref, name="obs_flight", **_KW)),
                       ("t", lambda: GenerationEngine(
            port, device="cpu", name="obs_flight", **_KW))):
        d = tmp_path / name
        with flags(FLAGS_flight_recorder_dir=str(d)):
            eng = make()
            failpoints.reset()
            jfailpoints.reset()
            with flags(FLAGS_failpoints=spec):
                f = eng.submit(prompts[0], max_new_tokens=4)
                with pytest.raises(Exception) as e:
                    f.result(timeout=120)
            if name == "t":
                assert isinstance(e.value, err)
            eng.shutdown()
        got.append(_dumps(d))
    assert got[0] == got[1] and got[1]
    reason, keys, codes = got[1][0]
    assert reason == ("gen_engine_death" if "raise" in spec
                      else "gen_poisoned_sequence")
    assert {"step_log_tail", "audit_tail"} <= set(keys)
    assert codes[("ENGINE_DIED" if "raise" in spec else "POISON_DECODE")]
