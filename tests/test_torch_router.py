"""The port's prefix-affinity Router held to paddle_tpu's.

Every router test of `tests/test_router.py` drives the JAX package's
Router and the port's over the same tiny GPT (carried across through
`models.load_reference_state`, CPU) with the same traffic, and holds them
to each other in the placements per replica and the router audit ring's
`ROUTE_*` multiset; every output is held to the port's fault-free
`generate()` (so to the JAX package's too). Where the reference asserts
"success or typed", so do these. Then the fleet-trace cases of
`tests/test_fleet_observability.py`: one trace id per request across a
re-route and across a supervised restart, and `tools/fleet_trace.py`
merging the port's router and replica events into resolved chains; and
`tools/router_report.py` rendering the port's `/stats`."""
import collections
import importlib.util
import json
import os
import sys
import threading
import types
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.framework import errors as jerrors
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler import audit as jaudit
from paddle_tpu.profiler import exporter as jexporter
from paddle_tpu.profiler import slo as jslo
from paddle_tpu.profiler import trace_context as jtc
from paddle_tpu.profiler import tracer as jtracer
from paddle_tpu.serving import failpoints as jfailpoints
import paddle_tpu_torch
from paddle_tpu_torch.framework import errors as terrors
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.profiler import audit as taudit
from paddle_tpu_torch.profiler import exporter as texporter
from paddle_tpu_torch.profiler import slo as tslo
from paddle_tpu_torch.profiler import trace_context as ttc
from paddle_tpu_torch.profiler import tracer as ttracer
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import failpoints as tfailpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each package's modules, under one set of names
PKG = {
    "jax": types.SimpleNamespace(
        serving=jserving, errors=jerrors, audit=jaudit, exporter=jexporter,
        slo=jslo, tc=jtc, tracer=jtracer, failpoints=jfailpoints),
    "port": types.SimpleNamespace(
        serving=tserving, errors=terrors, audit=taudit, exporter=texporter,
        slo=tslo, tc=ttc, tracer=ttracer, failpoints=tfailpoints),
}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(17)
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
    for p in PKG.values():
        p.failpoints.reset()
    yield
    _set_both(FLAGS_failpoints="")
    for p in PKG.values():
        p.failpoints.reset()


_RKW = dict(num_replicas=2, max_slots=2, page_size=4, num_pages=64,
            prefill_buckets=(16,), max_new_tokens=5, request_timeout_ms=0,
            prefix_cache=True, pressure_ttl_ms=0.0)


def _router(pkg, pair, name, **kw):
    kw = {**_RKW, **kw}
    if pkg == "jax":
        return jserving.Router(pair[0], name=name, **kw)
    return tserving.Router(pair[1], name=name, device="cpu", **kw)


def _prompts_shared_prefix(n, prefix_pages=2, page=4, tail=4, seed=3,
                           vocab=200):
    """n prompts sharing `prefix_pages` FULL pages, distinct tails."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, size=prefix_pages * page)
    return [np.concatenate([prefix, rng.randint(0, vocab, size=tail)])
            .astype("int64") for _ in range(n)]


def _generate(port, prompt, n):
    return port.generate(np.asarray(prompt)[None], max_new_tokens=n) \
        .numpy()[0]


def _reasons(router):
    return [e["reason"] for e in router.stats()["router"]["audit_tail"]]


def _snapshot(router):
    return {"placements": {rep.name: rep.placements
                           for rep in router._replicas},
            "route": collections.Counter(_reasons(router))}


def _both(pair, name, script, **kw):
    """`script(router, pkg)` through the JAX package's Router, then the
    port's; returns {pkg: script result} after asserting equal placements
    per replica and equal ROUTE_* multisets."""
    out, snaps = {}, {}
    for pkg in ("jax", "port"):
        PKG[pkg].failpoints.reset()
        r = _router(pkg, pair, name, **kw)
        try:
            out[pkg] = script(r, pkg)
            snaps[pkg] = _snapshot(r)
        finally:
            r.shutdown()
    assert snaps["port"] == snaps["jax"], snaps
    return out


def _same_tokens(outs, refs):
    for a, b in zip(outs, refs):
        np.testing.assert_array_equal(a, b)


# -- one digest implementation ------------------------------------------------

def test_chain_digests_is_the_shared_implementation():
    p = np.arange(13, dtype=np.int64)
    d4 = tserving.chain_digests(p, 4)
    assert d4 == jserving.chain_digests(p, 4)
    assert tserving.chain_digests(p, 8) == jserving.chain_digests(p, 8)
    assert len(d4) == 3 and all(len(d) == 16 for d in d4)
    # an extended prompt re-derives the same leading digests: the
    # replica independence affinity routing rests on
    assert tserving.chain_digests(p[:8], 4) == d4[:2]
    q = p.copy()
    q[1] += 1
    assert tserving.chain_digests(q, 4)[0] != d4[0]
    assert tserving.chain_digests(p, 8)[0] != d4[0]


def test_prefix_cache_digests_delegate(pair):
    p = np.arange(12, dtype=np.int64)

    def script(r, pkg):
        eng = r._replicas[0].sup.engine
        d = eng._prefix.digests(p)
        assert d == PKG[pkg].serving.chain_digests(p, 4)
        return d

    out = _both(pair, "rtr_digest", script, num_replicas=1)
    assert out["jax"] == out["port"]


# -- the pressure snapshot ----------------------------------------------------

def test_pressure_snapshot_shape_and_live_queue_overlay(pair):
    prompts = _prompts_shared_prefix(5, seed=21)

    def script(r, pkg):
        sup = r._replicas[0].sup
        p = sup.pressure()
        assert p["queue_depth"] == 0 and p["oldest_age_ms"] == 0.0
        assert p["slots_free"] == 2 and p["live"] == 0
        assert p["headroom"] == sup.stats()["kv"]["admit_headroom"]
        assert p["free_pages"] > 0 and p["queue_limit"] > 0
        # a full engine shows its queue through pressure() at once
        futs = [sup.submit(q, max_new_tokens=5) for q in prompts]
        assert sup.pressure()["queue_depth"] >= 1
        outs = [f.result(timeout=60) for f in futs]
        assert sup.pressure()["queue_depth"] == 0
        return p["headroom"], outs

    out = _both(pair, "rtr_pressure", script, num_replicas=1)
    assert out["jax"][0] == out["port"][0]
    _same_tokens(out["port"][1], [_generate(pair[1], q, 5)
                                  for q in prompts])


# -- affinity steering ---------------------------------------------------------

def test_affinity_steers_to_warm_replica(pair):
    prompts = _prompts_shared_prefix(6, seed=7)

    def script(r, pkg):
        outs = [r.submit(prompts[0], max_new_tokens=5).result(timeout=60)]
        first = [rep for rep in r._replicas if rep.placements == 1][0]
        cold = [rep for rep in r._replicas if rep is not first][0]
        for q in prompts[1:]:
            outs.append(r.submit(q, max_new_tokens=5).result(timeout=60))
        # every follow-up stuck to the warm replica, whose prefix cache
        # served its leading pages; the cold replica saw none
        assert first.placements == len(prompts) and cold.placements == 0
        assert first.sup.engine._prefix.hits == len(prompts) - 1
        assert cold.sup.engine._prefix.hits == 0
        assert _reasons(r).count("ROUTE_AFFINITY") == len(prompts) - 1
        assert r.stats()["router"]["replicas"][first.name][
            "sketch_digests"] >= 2
        return outs

    out = _both(pair, "rtr_affinity", script)
    _same_tokens(out["port"], [_generate(pair[1], q, 5) for q in prompts])
    _same_tokens(out["jax"], out["port"])


def test_affinity_off_is_round_robin(pair):
    prompts = _prompts_shared_prefix(6, seed=8)

    def script(r, pkg):
        outs = [r.submit(q, max_new_tokens=5).result(timeout=60)
                for q in prompts]
        assert sorted(rep.placements for rep in r._replicas) == [3, 3]
        assert "ROUTE_AFFINITY" not in _reasons(r)
        return outs

    out = _both(pair, "rtr_rr", script, affinity=False)
    _same_tokens(out["port"], [_generate(pair[1], q, 5) for q in prompts])


# -- least-pressure fallback ------------------------------------------------------

def test_least_pressure_fallback_avoids_loaded_replica(pair):
    rng = np.random.RandomState(31)
    busy_p = [rng.randint(0, 200, size=6).astype("int64") for _ in range(3)]
    probe = rng.randint(0, 200, size=3).astype("int64")

    def script(r, pkg):
        r0, r1 = r._replicas
        # load r0 directly (slots full, one queued) so its snapshot reads
        # worse on every axis the fallback scores
        busy = [r0.sup.submit(q, max_new_tokens=40) for q in busy_p]
        assert r0.sup.pressure()["queue_depth"] >= 1
        # a prompt with NO full page falls through affinity
        out = r.submit(probe, max_new_tokens=5).result(timeout=60)
        assert r1.placements == 1 and r0.placements == 0
        assert "ROUTE_LEAST_PRESSURE" in _reasons(r)
        return [out] + [f.result(timeout=120) for f in busy]

    out = _both(pair, "rtr_pressure_lb", script)
    _same_tokens(out["port"], [_generate(pair[1], probe, 5)]
                 + [_generate(pair[1], q, 40) for q in busy_p])


# -- drain on SLO burn ------------------------------------------------------------

def test_drain_on_burn_rate_stops_placements(pair):
    prompts = _prompts_shared_prefix(4, seed=9)

    def script(r, pkg):
        slo = PKG[pkg].slo
        slo.reset()
        r0, r1 = r._replicas
        try:
            with flags(FLAGS_slo_error_rate=0.5, FLAGS_slo_max_burn_rate=1.0):
                for _ in range(4):
                    slo.observe_request(r0.name, ok=False)
                assert not r0.sup.health()["ready"]
                outs = [r.submit(q, max_new_tokens=5).result(timeout=60)
                        for q in prompts]
                # the burning replica took nothing; the drain edge is
                # audited
                assert r0.placements == 0 and r1.placements == 4
                assert "ROUTE_DRAIN" in _reasons(r)
                h = r.health()
                assert h["ready"] and h["placeable"] == 1
                assert not h["replicas"][r0.name]["ready"]
                slo.reset()      # recovery: the replica re-enters
                assert r.health()["placeable"] == 2
            drains = [e for e in r.stats()["router"]["audit_tail"]
                      if e["reason"] == "ROUTE_DRAIN"]
            assert {d["drained"] for d in drains} == {True, False}
        finally:
            slo.reset()
        return outs

    out = _both(pair, "rtr_drain", script)
    _same_tokens(out["port"], [_generate(pair[1], q, 5) for q in prompts])


def test_all_drained_raises_typed(pair):
    def script(r, pkg):
        slo = PKG[pkg].slo
        slo.reset()
        try:
            with flags(FLAGS_slo_error_rate=0.5, FLAGS_slo_max_burn_rate=1.0):
                for rep in r._replicas:
                    for _ in range(4):
                        slo.observe_request(rep.name, ok=False)
                with pytest.raises(PKG[pkg].errors.UnavailableError):
                    r.submit(np.arange(6, dtype=np.int64),
                             max_new_tokens=5)
                assert not r.health()["ready"]
        finally:
            slo.reset()

    _both(pair, "rtr_alldrain", script)


# -- placement-time re-route ------------------------------------------------------

def test_reroute_on_placement_failure(pair):
    prompts = _prompts_shared_prefix(2, seed=11)

    def script(r, pkg):
        # warm the sketch so affinity pins the follow-up to `first`
        outs = [r.submit(prompts[0], max_new_tokens=5).result(timeout=60)]
        first = [rep for rep in r._replicas if rep.placements == 1][0]
        other = [rep for rep in r._replicas if rep is not first][0]
        real = first.sup.submit

        def overloaded_once(prompt_ids, **kw):
            first.sup.submit = real
            raise PKG[pkg].serving.EngineOverloaded("queue full (injected)")

        first.sup.submit = overloaded_once
        outs.append(r.submit(prompts[1], max_new_tokens=5).result(
            timeout=60))
        assert other.placements == 1
        assert "ROUTE_REROUTE" in _reasons(r)
        return outs

    out = _both(pair, "rtr_reroute", script)
    _same_tokens(out["port"], [_generate(pair[1], q, 5) for q in prompts])


# -- replica death mid-load ----------------------------------------------------------

def test_replica_kill_mid_load_success_or_typed_token_identical(pair):
    prompts = _prompts_shared_prefix(8, seed=13)

    def script(r, pkg):
        ledgers = [dict(rep.sup.engine._ledger) for rep in r._replicas]
        futs = [r.submit(q, max_new_tokens=5) for q in prompts]
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=120))
            except PKG[pkg].errors.UnavailableError:
                outs.append(None)      # typed, within the budget
        assert sum(rep.sup.restarts for rep in r._replicas) == 1
        # the resurrection ran no new program shape on any replica
        assert [dict(rep.sup.engine._ledger)
                for rep in r._replicas] == ledgers
        return outs

    with flags(FLAGS_failpoints="decode_step_raise@6",
               FLAGS_gen_restart_backoff_ms=5.0):
        out = _both(pair, "rtr_kill", script)
    refs = [_generate(pair[1], q, 5) for q in prompts]
    for pkg in ("jax", "port"):
        # one death is within the default retry limit: every request
        # succeeds, token-identical to the fault-free run
        assert all(o is not None for o in out[pkg])
        _same_tokens(out[pkg], refs)


def test_stream_exactly_once_through_router_across_replay(pair):
    prompts = _prompts_shared_prefix(3, seed=14, tail=3)

    def script(r, pkg):
        streams = [r.submit_stream(q, max_new_tokens=8) for q in prompts]
        collected = [[] for _ in streams]

        def drain(i):
            for tok in streams[i]:
                collected[i].append(tok)

        ts = [threading.Thread(target=drain, args=(i,), daemon=True)
              for i in range(len(streams))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert sum(rep.sup.restarts for rep in r._replicas) == 1
        outs = [st.result(timeout=60) for st in streams]
        for i, o in enumerate(outs):
            # exactly once through the router across the replica's
            # restart: no duplicate, no gap
            assert collected[i] == o[len(prompts[i]):].tolist()
        return outs

    with flags(FLAGS_failpoints="decode_step_raise@4",
               FLAGS_gen_restart_backoff_ms=5.0):
        out = _both(pair, "rtr_stream", script, max_new_tokens=8)
    _same_tokens(out["port"], [_generate(pair[1], q, 8) for q in prompts])
    _same_tokens(out["jax"], out["port"])


# -- observability and lifecycle ---------------------------------------------------

def test_router_registers_with_exporter_and_readyz(pair):
    def script(r, pkg):
        exp = PKG[pkg].exporter
        ready = exp.readiness_payload()
        assert ready["engines"]["rtr_export"]["ready"]
        assert ready["engines"]["rtr_export-r0"]["ready"]
        rs = exp.stats_payload()["engines"]["rtr_export"]["router"]
        assert rs["placements_total"] == 0
        assert set(rs["replicas"]) == {"rtr_export-r0", "rtr_export-r1"}
        r.submit(np.arange(6, dtype=np.int64),
                 max_new_tokens=5).result(timeout=60)
        tl = r.pressure_timeline()
        assert tl and set(tl[-1]["replicas"]) == set(rs["replicas"])
        return exp

    out = _both(pair, "rtr_export", script)
    for exp in out.values():
        assert "rtr_export" not in exp.readiness_payload()["engines"]


def test_router_constructor_validation(pair):
    for pkg, model in (("jax", pair[0]), ("port", pair[1])):
        err = PKG[pkg].errors
        Router = PKG[pkg].serving.Router
        with pytest.raises(err.InvalidArgumentError):
            Router(model, num_replicas=0)
        with pytest.raises(err.InvalidArgumentError):
            Router(replicas=[])
        r = _router(pkg, pair, "rtr_valid", num_replicas=1)
        try:
            with pytest.raises(err.InvalidArgumentError):
                Router(model, replicas=[r._replicas[0].sup])
            r.shutdown()
            with pytest.raises(err.UnavailableError):
                r.submit(np.arange(6, dtype=np.int64))
        finally:
            r.shutdown()   # idempotent


# -- fleet traces ------------------------------------------------------------------

def _reqspan_tids(tracer):
    out = {}
    for name, *_ in tracer.events(with_threads=True):
        if name.startswith("reqspan:") and ",tid=" in name:
            rid = name.split(":")[1]
            out.setdefault(rid, []).append(name.rsplit(",tid=", 1)[1])
    return out


def test_trace_id_stable_across_reroute(pair):
    prompts = _prompts_shared_prefix(2, seed=11)

    def script(r, pkg):
        p = PKG[pkg]
        p.tracer.clear()
        r.submit(prompts[0], max_new_tokens=5).result(timeout=60)
        first = [rep for rep in r._replicas if rep.placements == 1][0]
        real = first.sup.submit

        def overloaded_once(prompt_ids, **kw):
            first.sup.submit = real
            raise p.serving.EngineOverloaded("queue full (injected)")

        first.sup.submit = overloaded_once
        r.submit(prompts[1], max_new_tokens=5).result(timeout=60)
        evs = r.stats()["router"]["audit_tail"]
        reroute = [e for e in evs if e["reason"] == "ROUTE_REROUTE"]
        assert reroute and p.tc.is_trace_id(reroute[-1]["trace"])
        tid = reroute[-1]["trace"]
        # the SAME id on the attempts before and after the re-route
        assert len([e for e in evs if e.get("trace") == tid]) >= 3
        assert tid in [t for ts in _reqspan_tids(p.tracer).values()
                       for t in ts]

    _both(pair, "fleet_reroute", script)


def test_trace_id_stable_across_supervised_restart(pair):
    prompts = _prompts_shared_prefix(4, seed=13)

    def script(r, pkg):
        p = PKG[pkg]
        p.tracer.clear()
        for f in [r.submit(q, max_new_tokens=5) for q in prompts]:
            f.result(timeout=120)
        assert sum(rep.sup.restarts for rep in r._replicas) == 1
        replay_tids = {e["trace"] for rep in r._replicas
                       for e in p.audit.tail_for(rep.name, 256)
                       if e["reason"] == "REPLAY_ADMIT"}
        assert replay_tids and all(p.tc.is_trace_id(t)
                                   for t in replay_tids)
        # a replayed request FINISHES under the id it was placed with
        finished = {t for ts in _reqspan_tids(p.tracer).values()
                    for t in ts}
        carried = replay_tids & finished
        assert carried, (replay_tids, finished)
        fid = p.tc.flow_id(next(iter(carried)))
        phs = [ph.split("#")[0] for name, ph, *_ in
               p.tracer.events(with_threads=True)
               if name == "fleet_request" and ph.endswith(f"#{fid}")]
        # one start, a step an incarnation's span, at least one finish
        assert phs.count("s") == 1 and phs.count("t") >= 2
        assert phs.count("f") >= 1
        return len(replay_tids)

    with flags(FLAGS_failpoints="decode_step_raise@6",
               FLAGS_gen_restart_backoff_ms=5.0):
        out = _both(pair, "fleet_restart", script)
    assert out["jax"] == out["port"]


def _tool(name):
    # the report tools import each other as top-level modules
    if os.path.join(ROOT, "tools") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_trace_merges_port_router_and_replicas(pair, tmp_path):
    """The port's chrome trace, split into the router's hop (the flow
    starts, on the submitting thread) and the replicas' events (steps,
    finishes, reqspans), merges through `tools/fleet_trace.py` into one
    resolved multi-hop chain a request, the replayed ones with more than
    one step; a file with the replica half lost exits 1."""
    ft = _tool("fleet_trace")
    prompts = _prompts_shared_prefix(4, seed=13)
    ttracer.clear()
    with flags(FLAGS_failpoints="decode_step_raise@6",
               FLAGS_gen_restart_backoff_ms=5.0):
        r = _router("port", pair, "fleet_merge")
        try:
            for f in [r.submit(q, max_new_tokens=5) for q in prompts]:
                f.result(timeout=120)
            assert sum(rep.sup.restarts for rep in r._replicas) == 1
        finally:
            r.shutdown()
    evs = ttracer.chrome_trace()["traceEvents"]
    hop = [e for e in evs
           if e.get("name") == "fleet_request" and e.get("ph") == "s"]
    rest = [e for e in evs if e not in hop]
    a, b = tmp_path / "router.json", tmp_path / "replicas.json"
    a.write_text(json.dumps({"traceEvents": hop}))
    b.write_text(json.dumps({"traceEvents": rest}))
    _, report = ft.merge([str(a), str(b)])
    assert report["chains"] == report["resolved"] == len(prompts)
    assert report["multi_hop"] == len(prompts)
    assert report["replayed"] >= 1 and not report["unresolved"]
    assert len(report["trace_ids"]) == len(prompts)
    assert ft.main([str(a), str(b), "--json"]) == 0
    assert ft.main([str(a), "--json"]) == 1


def test_router_report_renders_port_stats(pair, tmp_path):
    rr = _tool("router_report")
    prompts = _prompts_shared_prefix(3, seed=5)
    r = _router("port", pair, "rtr_report")
    try:
        for q in prompts:
            r.submit(q, max_new_tokens=5).result(timeout=60)
        srv = texporter.MetricsServer(0)
        try:
            with urllib.request.urlopen(srv.url + "/stats",
                                        timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        finally:
            srv.close()
    finally:
        r.shutdown()
    path = tmp_path / "stats.json"
    path.write_text(json.dumps(payload))
    routers = rr.load_routers(str(path))
    summ = rr.summarize(routers["rtr_report"])
    assert summ["placements_total"] == len(prompts)
    assert summ["restarts_total"] == 0
    assert rr.main([str(path), "--router", "rtr_report"]) == 0
    assert rr.main([str(path), "--json"]) == 0
