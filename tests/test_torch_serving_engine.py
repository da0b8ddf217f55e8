"""paddle_tpu_torch.serving.InferenceEngine held to
paddle_tpu.serving.InferenceEngine.

Each scenario is a function of one package (`JAX` or `PORT` below: its
serving, inference, monitor and error modules) and returns what the
traffic fixes: outputs, the exceptions' types, stats() and STAT deltas.
Each test runs it through both packages and asserts the same summary,
beside the scenario's own gates (the single-device cases of
tests/test_serving_engine.py and tests/test_serving_multilane.py, and
the three lane-restart cases of tests/test_engine_resurrection.py).
Models: the serving MLP (8 -> 16 -> tanh -> 4) saved by each package's
`jit.save` from the same weights (module fixture; the port's Predictor
on the CPU, `Config.disable_gpu()`), or numpy callables, which both
engines run alike. Float outputs of the two artifacts agree within 1e-5
x max(1, max |ref|); callables' outputs exactly. Latency numbers are
not compared (host timing), their counts are.
"""
import threading
import time
from collections import deque
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu import serving as jserving
from paddle_tpu.framework import errors as jerrors
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.static.input_spec import InputSpec as JSpec
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import inference, jit, serving
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import errors, flags as tflags, monitor
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.static import InputSpec

TOL = 1e-5


class _JMlp(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(paddle.tanh(self.fc1(x)))


class _TMlp(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16)
        self.fc2 = tnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(tpkg.tanh(self.fc1(x)))


def _save_pair(d, shape, seed):
    paddle.seed(seed)
    jnet, tnet = _JMlp(), _TMlp()
    load_reference_state(tnet, {k: np.asarray(v.numpy())
                                for k, v in jnet.state_dict().items()})
    paddle.jit.save(jnet, str(d / "jax"), input_spec=[JSpec(shape,
                                                            "float32")])
    jit.save(tnet, str(d / "port"), input_spec=[InputSpec(shape,
                                                          "float32")])
    return {"jax": str(d / "jax"), "port": str(d / "port")}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _save_pair(tmp_path_factory.mktemp("engine"), [None, 8], 7)


def _port_predictor(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


@contextmanager
def _jflags(**kw):
    old = paddle.get_flags(list(kw))
    paddle.set_flags(kw)
    try:
        yield
    finally:
        paddle.set_flags(old)


@contextmanager
def _tflags(**kw):
    old = tflags.get_flags(list(kw))
    tflags.set_flags(kw)
    try:
        yield
    finally:
        tflags.set_flags(old)


JAX = SimpleNamespace(
    name="jax", serving=jserving, monitor=jmonitor, errors=jerrors,
    predictor=lambda p: jinference.create_predictor(jinference.Config(p)),
    flags=_jflags)
PORT = SimpleNamespace(
    name="port", serving=serving, monitor=monitor, errors=errors,
    predictor=_port_predictor, flags=_tflags)


def _both(scenario, *args):
    """Run `scenario` through both packages; returns (jax, port)."""
    return scenario(JAX, *args), scenario(PORT, *args)


def _x(rows, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (rows, 8)).astype("float32")


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g, w, rtol=TOL, atol=TOL * max(1.0, float(np.abs(w).max())))


def _delta(P, names):
    base = {n: P.monitor.stat_get(n) for n in names}
    return lambda: {n: P.monitor.stat_get(n) - base[n] for n in names}


# -- micro-batcher correctness (tests/test_serving_engine.py) ----------------

def _padding(P, prefixes):
    pred = P.predictor(prefixes[P.name])
    eng = P.serving.InferenceEngine(pred, batch_buckets=(1, 4, 16),
                                    max_batch_size=16,
                                    max_batch_delay_ms=30.0)
    try:
        xs = [_x(r, seed=r) for r in (1, 2, 3)]  # 6 rows -> bucket 16
        futs = [eng.submit(x) for x in xs]
        res = [f.result(timeout=30)[0] for f in futs]
        oracle = pred.run([np.concatenate(
            xs + [np.zeros((10, 8), "float32")])])[0]
        off = 0
        for x, r in zip(xs, res):
            np.testing.assert_array_equal(r, oracle[off:off + len(x)])
            off += len(x)
        alone = eng.submit(np.concatenate(xs)).result(timeout=30)[0]
        np.testing.assert_array_equal(alone, oracle[:6])
        return res
    finally:
        eng.shutdown()


def test_batched_results_bit_identical_under_padding(artifacts):
    want, got = _both(_padding, artifacts)
    _close(got, want)


def _load(P, prefixes):
    pred = P.predictor(prefixes[P.name])
    c0 = P.monitor.stat_get("STAT_predictor_compiles")
    delta = _delta(P, ["STAT_serving_requests", "STAT_serving_batch_rows",
                       "STAT_serving_bucket_compiles"])
    eng = P.serving.InferenceEngine(pred, batch_buckets=(1, 4, 16),
                                    max_batch_size=16,
                                    max_batch_delay_ms=2.0,
                                    name=f"{P.name}_one_compile")
    try:
        warm = P.monitor.stat_get("STAT_predictor_compiles") - c0
        futs = [eng.submit(_x(1 + i % 3, seed=i)) for i in range(40)]
        outs = [f.result(timeout=30)[0] for f in futs]
        assert all(o.dtype == np.float32 for o in outs)
        s = eng.stats()
        assert s["latency_ms"]["p99"] >= s["latency_ms"]["p50"] > 0
        assert sorted(s["phases"]) == ["serving_device_ms", "serving_pad_ms",
                                       "serving_queue_ms",
                                       "serving_resolve_ms"]
        return dict(outs=outs, warm=warm,
                    live=P.monitor.stat_get("STAT_predictor_compiles")
                    - c0 - warm,
                    compiles={b: v["compiles"]
                              for b, v in s["buckets"].items()},
                    latency_count=s["latency_ms"]["count"],
                    rows_served=s["rows_served"], queue=s["queue_depth"],
                    lanes=[(l["alive"], l["rows"], l["bucket_compiles"])
                           for l in s["lanes"]],
                    stats=delta())
    finally:
        eng.shutdown()


def test_one_compile_per_bucket_under_load(artifacts):
    want, got = _both(_load, artifacts)
    assert want["warm"] == got["warm"] == 3
    assert want["live"] == got["live"] == 0
    assert got["compiles"] == want["compiles"] == {1: 1, 4: 1, 16: 1}
    assert got["latency_count"] == want["latency_count"] == 40
    _close(got.pop("outs"), want.pop("outs"))
    assert got == want


def _occupancy(P, prefixes):
    eng = P.serving.InferenceEngine(P.predictor(prefixes[P.name]),
                                    batch_buckets=(1, 4, 16),
                                    max_batch_size=16,
                                    max_batch_delay_ms=50.0)
    delta = _delta(P, ["STAT_serving_batches", "STAT_serving_requests",
                       "STAT_serving_queue_depth"])
    try:
        results, lock = {}, threading.Lock()

        def client(i):
            out = eng.run(_x(1, seed=i), timeout_ms=0)
            with lock:
                results[i] = out[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        d = delta()
        assert d["STAT_serving_batches"] < d["STAT_serving_requests"] == 24
        assert eng.stats()["mean_occupancy"] > 0
        return [results[i] for i in range(24)], \
            d["STAT_serving_requests"], d["STAT_serving_queue_depth"]
    finally:
        eng.shutdown()


def test_occupancy_under_concurrent_submitters(artifacts):
    want, got = _both(_occupancy, artifacts)
    _close(got[0], want[0])
    assert got[1:] == want[1:] == (24, 0)


def _fixed(P, prefixes):
    pred = P.predictor(prefixes[P.name])
    eng = P.serving.InferenceEngine(pred, max_batch_delay_ms=1.0)
    try:
        assert eng._cfg.batch_buckets == (2,)
        res = eng.run(_x(1))[0]
        np.testing.assert_array_equal(res, pred.run([np.concatenate(
            [_x(1), np.zeros((1, 8), "float32")])])[0][:1])
        return res
    finally:
        eng.shutdown()


def test_fixed_shape_artifact_collapses_buckets(tmp_path):
    prefixes = _save_pair(tmp_path, [2, 8], 3)
    want, got = _both(_fixed, prefixes)
    assert got.shape == (1, 4)
    _close([got], [want])


# -- backpressure, timeout, poison, shutdown ------------------------------------

class _Gate:
    """Callable model whose batches block until released; 666 in the input
    kills the lane (a BaseException, not a poisoned request)."""

    class Death(BaseException):
        pass

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = 0

    def __call__(self, arrays):
        a = np.asarray(arrays[0])
        self.calls += 1
        self.entered.set()
        assert self.release.wait(30)
        if (a == 666.0).any():
            raise _Gate.Death("replica wedged")
        return [np.asarray(a, "float32") * 2.0]


def _gated(P, **kw):
    gate = _Gate()
    kw.setdefault("max_inflight", 1)
    eng = P.serving.InferenceEngine(
        gate, input_spec=[([None, 4], "float32")], warmup=False, **kw)
    return eng, gate


def _v(val, rows=1):
    return np.full((rows, 4), float(val), "float32")


def _overload(P):
    eng, gate = _gated(P, max_queue_depth=2, max_batch_size=1,
                       batch_buckets=(1,), max_batch_delay_ms=0.0)
    try:
        first = eng.submit(_v(1))
        assert gate.entered.wait(10)
        q1, q2 = eng.submit(_v(2)), eng.submit(_v(3))
        rej0 = P.monitor.stat_get("STAT_serving_rejected")
        with pytest.raises(P.serving.EngineOverloaded,
                           match="queue depth") as e:
            eng.submit(_v(4))
        rejected = P.monitor.stat_get("STAT_serving_rejected") - rej0
        gate.release.set()
        return [f.result(timeout=30)[0] for f in (first, q1, q2)], \
            rejected, str(e.value)
    finally:
        gate.release.set()
        eng.shutdown()


def test_overload_rejection():
    want, got = _both(_overload)
    assert got[1] == want[1] == 1
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


def _queued_timeout(P):
    eng, gate = _gated(P, max_batch_size=1, batch_buckets=(1,),
                       max_batch_delay_ms=0.0)
    try:
        first = eng.submit(_v(1))
        assert gate.entered.wait(10)
        stale = eng.submit(_v(2), timeout_ms=1.0)
        time.sleep(0.05)
        fresh = eng.submit(_v(3), timeout_ms=0)
        gate.release.set()
        with pytest.raises(P.errors.ExecutionTimeoutError):
            stale.result(timeout=30)
        assert isinstance(stale.exception(), TimeoutError)
        return [fresh.result(timeout=30)[0], first.result(timeout=30)[0]]
    finally:
        gate.release.set()
        eng.shutdown()


def test_request_timeout_while_queued():
    want, got = _both(_queued_timeout)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _poison(P):
    def model(arrays):
        a = np.asarray(arrays[0])
        if (a == 777.0).any():
            raise RuntimeError("poisoned batch")
        return [a + 1.0]

    eng = P.serving.InferenceEngine(
        model, input_spec=[([None, 4], "float32")], warmup=False,
        batch_buckets=(1, 8), max_batch_size=8, max_batch_delay_ms=50.0)
    delta = _delta(P, ["STAT_serving_batch_retries",
                       "STAT_serving_request_errors"])
    try:
        good1 = eng.submit(_v(1))
        poison = eng.submit(_v(777))
        good2 = eng.submit(_v(3, rows=2))
        out = [good1.result(timeout=30)[0], good2.result(timeout=30)[0]]
        with pytest.raises(RuntimeError, match="poisoned"):
            poison.result(timeout=30)
        out.append(eng.run(np.zeros((1, 4), "float32"))[0])
        return out, delta()
    finally:
        eng.shutdown()


def test_poisoned_request_only_fails_its_future():
    want, got = _both(_poison)
    np.testing.assert_array_equal(got[0][0], _v(2))
    np.testing.assert_array_equal(got[0][1], _v(4, rows=2))
    np.testing.assert_array_equal(got[0][2], _v(1))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]


def _drain(P, prefixes):
    eng = P.serving.InferenceEngine(P.predictor(prefixes[P.name]),
                                    batch_buckets=(1, 4), max_batch_size=4,
                                    max_batch_delay_ms=5.0)
    futs = [eng.submit(_x(1, seed=i)) for i in range(9)]
    eng.shutdown()
    outs = [f.result(timeout=1)[0] for f in futs]
    with pytest.raises(P.errors.UnavailableError):
        eng.submit(_x(1))
    return outs


def test_shutdown_drains_and_rejects_new_work(artifacts):
    want, got = _both(_drain, artifacts)
    _close(got, want)


def _config_errors(P):
    msgs = []
    for kw in (dict(max_batch_size=64, batch_buckets=(1, 128)),
               dict(max_batch_size=8, batch_buckets=(0, 4)),
               dict(max_inflight=0)):
        with pytest.raises(ValueError) as e:
            P.serving.EngineConfig(**kw)
        msgs.append(str(e.value))
    return msgs, P.serving.EngineConfig(max_batch_size=8).batch_buckets


def test_engine_config_checks():
    want, got = _both(_config_errors)
    assert got == want
    assert got[1] == (1, 4, 8)


def _non_batch_major(P):
    def model(arrays):
        a = np.asarray(arrays[0])
        return [np.asarray([a.mean()], "float32")]

    eng = P.serving.InferenceEngine(
        model, input_spec=[([None, 4], "float32")], warmup=False,
        batch_buckets=(8,), max_batch_size=8, max_batch_delay_ms=50.0)
    u0 = P.monitor.stat_get("STAT_serving_unsliceable_batches")
    try:
        f1 = eng.submit(np.ones((2, 4), "float32"))
        f2 = eng.submit(np.full((1, 4), 2.0, "float32"))
        got = [float(f1.result(timeout=30)[0][0]),
               float(f2.result(timeout=30)[0][0])]
        got.append(float(eng.submit(np.full((3, 4), 3.0, "float32"))
                         .result(timeout=30)[0][0]))
        assert P.monitor.stat_get("STAT_serving_unsliceable_batches") > u0
        return got
    finally:
        eng.shutdown()


def test_non_batch_major_output_never_comingled_or_padded():
    want, got = _both(_non_batch_major)
    assert got == want == [1.0, 2.0, 3.0]


def _validation(P):
    eng = P.serving.InferenceEngine(
        lambda arrays: [np.asarray(arrays[0])],
        input_spec=[([None, 4], "float32")], warmup=False,
        max_batch_size=8, batch_buckets=(8,), max_batch_delay_ms=0.0)
    msgs = []
    try:
        for bad in (np.zeros((3,), "float32"), np.zeros((1, 5), "float32"),
                    np.zeros((9, 4), "float32"), np.zeros((0, 4), "float32"),
                    [np.zeros((1, 4), "float32")] * 2):
            with pytest.raises(ValueError) as e:
                eng.submit(bad)
            msgs.append(str(e.value))
        return msgs
    finally:
        eng.shutdown()


def test_engine_input_validation_messages_match_jax():
    want, got = _both(_validation)
    assert got == want
    for frag, msg in zip(("rank 2", "dim 1 must be 4",
                          "exceeds max_batch_size", "empty request",
                          "expects 1 input"), got):
        assert frag in msg


# -- lanes (tests/test_serving_multilane.py, single device) -------------------

def _user_predictor(P, prefixes):
    pred = P.predictor(prefixes[P.name])
    eng = P.serving.InferenceEngine(pred, batch_buckets=(1,),
                                    max_batch_size=1,
                                    max_batch_delay_ms=0.0)
    try:
        assert eng._lanes[0].predictor is pred
        return len(eng.stats()["lanes"]), eng.run(_x(1))[0]
    finally:
        eng.shutdown()


def test_user_predictor_stays_single_lane(artifacts):
    want, got = _both(_user_predictor, artifacts)
    assert got[0] == want[0] == 1
    _close([got[1]], [want[1]])


def test_port_device_specs(artifacts):
    prefix = artifacts["port"]
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    for model, devices in ((cfg, None), (prefix, "cpu")):
        eng = serving.InferenceEngine(model, devices=devices,
                                      batch_buckets=(1,), max_batch_size=1,
                                      max_batch_delay_ms=0.0)
        try:
            lanes = eng.stats()["lanes"]
            assert [l["device"] for l in lanes] == ["cpu"]
            assert eng._lanes[0].stream is None
            assert eng.run(_x(1))[0].shape == (1, 4)
        finally:
            eng.shutdown()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="host has"):
        serving.InferenceEngine(prefix, devices=n + 5)
    if not n:
        # the default is the card: without one, asking for it raises
        with pytest.raises(errors.UnavailableError):
            serving.InferenceEngine(prefix)


def _pipeline(P):
    gate = _Gate()
    eng = P.serving.InferenceEngine(
        gate, input_spec=[([None, 4], "float32")], warmup=False,
        max_batch_size=1, batch_buckets=(1,), max_batch_delay_ms=0.0,
        max_inflight=2, name=f"{P.name}_pipe")
    try:
        f1 = eng.submit(_v(1))
        assert gate.entered.wait(10)
        f2, f3 = eng.submit(_v(2)), eng.submit(_v(3))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            s = eng.stats()
            if s["lanes"][0]["inflight"] == 2 and s["queue_depth"] == 1:
                break
            time.sleep(0.005)
        s = eng.stats()
        seen = (s["lanes"][0]["inflight"], s["queue_depth"])
        gate.release.set()
        outs = [f.result(timeout=30)[0] for f in (f1, f2, f3)]
        return seen, outs, eng.stats()["inflight_depth"]["max"]
    finally:
        gate.release.set()
        eng.shutdown()


def test_inflight_bound_pipelines_and_backpressures():
    want, got = _both(_pipeline)
    assert got[0] == want[0] == (2, 1)
    for g, w, v in zip(got[1], want[1], (2.0, 4.0, 6.0)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _v(v))
    assert got[2] == want[2] == 2


def _failover(P):
    g0, g1 = _Gate(), _Gate()
    eng = P.serving.InferenceEngine(
        [g0, g1], input_spec=[([None, 4], "float32")], warmup=False,
        max_batch_size=1, batch_buckets=(1,), max_batch_delay_ms=0.0,
        max_inflight=2, name=f"{P.name}_failover")
    d0 = P.monitor.stat_get("STAT_serving_lane_deaths")
    try:
        f1 = eng.submit(_v(666))
        assert g0.entered.wait(10)
        f2 = eng.submit(_v(2))
        assert g1.entered.wait(10)
        f3, f4 = eng.submit(_v(3)), eng.submit(_v(4))
        deadline = time.monotonic() + 5
        while (time.monotonic() < deadline
               and eng.stats()["lanes"][0]["inflight"] < 2):
            time.sleep(0.005)
        g0.release.set()
        for f in (f1, f3):
            with pytest.raises(P.errors.UnavailableError,
                               match="lane0.*died"):
                f.result(timeout=30)
        g1.release.set()
        outs = [f2.result(timeout=30)[0], f4.result(timeout=30)[0]]
        outs += [eng.run(_v(5))[0] for _ in range(4)]
        s = eng.stats()
        return (outs, P.monitor.stat_get("STAT_serving_lane_deaths") - d0,
                [l["alive"] for l in s["lanes"]], g1.calls >= 6)
    finally:
        g0.release.set()
        g1.release.set()
        eng.shutdown()


def test_lane_failover_only_kills_own_inflight():
    want, got = _both(_failover)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1:] == want[1:] == (1, [False, True], True)


def _all_dead(P):
    gate = _Gate()
    eng = P.serving.InferenceEngine(
        gate, input_spec=[([None, 4], "float32")], warmup=False,
        max_batch_size=1, batch_buckets=(1,), max_batch_delay_ms=0.0,
        max_inflight=1, name=f"{P.name}_alldead")
    f1 = eng.submit(_v(666))
    assert gate.entered.wait(10)
    f2 = eng.submit(_v(2))
    gate.release.set()
    kinds = []
    for f in (f1, f2):
        with pytest.raises(P.errors.UnavailableError):
            f.result(timeout=30)
        kinds.append(type(f.exception()).__name__)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not eng._closed:
        time.sleep(0.005)
    with pytest.raises(P.errors.UnavailableError, match="shut down"):
        eng.submit(_v(1))
    eng.shutdown()
    return kinds


def test_all_lanes_dead_closes_engine():
    want, got = _both(_all_dead)
    assert got == want


def _completion_deadline(P):
    gate = _Gate()
    eng = P.serving.InferenceEngine(
        gate, input_spec=[([None, 4], "float32")], warmup=False,
        max_batch_size=1, batch_buckets=(1,), max_batch_delay_ms=0.0,
        max_inflight=1, name=f"{P.name}_deadline")
    t0 = P.monitor.stat_get("STAT_serving_timeouts")
    try:
        f = eng.submit(_v(1), timeout_ms=30.0)
        assert gate.entered.wait(10)
        time.sleep(0.08)
        gate.release.set()
        with pytest.raises(P.errors.ExecutionTimeoutError,
                           match="in flight"):
            f.result(timeout=30)
        return (P.monitor.stat_get("STAT_serving_timeouts") - t0,
                eng.run(_v(3), timeout_ms=0)[0])
    finally:
        gate.release.set()
        eng.shutdown()


def test_deadline_enforced_at_completion():
    want, got = _both(_completion_deadline)
    assert got[0] == want[0] == 1
    np.testing.assert_array_equal(got[1], want[1])


def _race(P):
    accepted = 0
    for _ in range(3):
        eng = P.serving.InferenceEngine(
            lambda arrays: [np.asarray(arrays[0]) + 1.0],
            input_spec=[([None, 4], "float32")], warmup=False,
            max_batch_size=8, batch_buckets=(8,), max_batch_delay_ms=0.2,
            name=f"{P.name}_race")
        futs, lock, stop = [], threading.Lock(), threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    f = eng.submit(np.ones((1, 4), "float32"),
                                   timeout_ms=0)
                except (P.errors.UnavailableError,
                        P.serving.EngineOverloaded):
                    return
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        eng.shutdown()
        stop.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert futs
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=10)[0],
                                          np.full((1, 4), 2.0, "float32"))
        accepted += len(futs)
        with pytest.raises(P.errors.UnavailableError):
            eng.submit(np.ones((1, 4), "float32"))
    return accepted > 0


def test_shutdown_during_submit_race():
    assert _both(_race) == (True, True)


def test_reset_all_stats():
    """The registries are process-wide, and tests/test_serving_multilane.py
    probes the JAX one under the same name: start from whatever an
    earlier test in this process left, and leave the probe at 0."""
    for P in (JAX, PORT):
        base = P.monitor.stat_get("STAT_reset_probe")
        P.monitor.stat_add("STAT_reset_probe", 7)
        P.monitor.histogram("reset_probe_ms").observe(3.0)
        assert P.monitor.stat_get("STAT_reset_probe") == base + 7
        P.monitor.reset_all_stats()
        assert P.monitor.stat_get("STAT_reset_probe") == 0
        assert P.monitor.histogram("reset_probe_ms").count == 0
        P.monitor.stat_add("STAT_reset_probe")
        assert P.monitor.stat_get("STAT_reset_probe") == 1
        P.monitor.stat_sub("STAT_reset_probe")


# -- per-lane restart (tests/test_engine_resurrection.py) ----------------------

class _LaneKiller(BaseException):
    pass


def _restart(P):
    calls = {"n": 0}

    def flaky(arrays):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _LaneKiller("transient")
        return [np.asarray(arrays[0]) * 2.0]

    with P.flags(FLAGS_serving_lane_restarts=2,
                 FLAGS_gen_restart_backoff_ms=5.0):
        eng = P.serving.InferenceEngine(
            [flaky], name=f"{P.name}_lane_restart", max_batch_size=4,
            max_batch_delay_ms=0.5, batch_buckets=(4,),
            request_timeout_ms=0, warmup=False)
        x = np.ones((1, 3), np.float32)
        first = eng.run([x])[0]
        with pytest.raises(P.errors.UnavailableError):
            eng.run([x])
        out = eng.run([x], timeout_ms=10000)[0]
        lane = eng.stats()["lanes"][0]
        ready = eng.health()["ready"]
        eng.shutdown()
    return first, out, lane["alive"], lane["restarts"], ready


def test_lane_restart_restores_capacity():
    want, got = _both(_restart)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][0, 0] == got[1][0, 0] == 2.0
    assert got[2:] == want[2:] == (True, 1, True)


def _exhaust(P):
    def always_dies(arrays):
        raise _LaneKiller("permanent")

    with P.flags(FLAGS_serving_lane_restarts=1,
                 FLAGS_gen_restart_backoff_ms=1.0):
        eng = P.serving.InferenceEngine(
            [always_dies], name=f"{P.name}_lane_exhaust", max_batch_size=4,
            max_batch_delay_ms=0.5, batch_buckets=(4,),
            request_timeout_ms=0, warmup=False)
        x = np.ones((1, 3), np.float32)
        with pytest.raises(P.errors.UnavailableError):
            eng.run([x])
        with pytest.raises(P.errors.UnavailableError):
            eng.run([x], timeout_ms=10000)
        deadline = time.time() + 10
        while time.time() < deadline:
            if not any(l["alive"] for l in eng.stats()["lanes"]):
                break
            time.sleep(0.02)
        alive = [l["alive"] for l in eng.stats()["lanes"]]
        eng.shutdown()
    return alive


def test_lane_restart_budget_exhausts_to_permanent_death():
    want, got = _both(_exhaust)
    assert got == want == [False]


def _legacy(P):
    def dies_once(arrays):
        raise _LaneKiller("boom")

    eng = P.serving.InferenceEngine(
        [dies_once], name=f"{P.name}_lane_legacy", max_batch_size=4,
        max_batch_delay_ms=0.5, batch_buckets=(4,),
        request_timeout_ms=0, warmup=False)
    x = np.ones((1, 3), np.float32)
    with pytest.raises(P.errors.UnavailableError):
        eng.run([x])
    lane = eng.stats()["lanes"][0]
    eng.shutdown()
    return lane["alive"], lane["restarts"]


def test_lane_restarts_default_off_keeps_legacy_death():
    want, got = _both(_legacy)
    assert got == want == (False, 0)


# -- observability ----------------------------------------------------------------

def _observed(P, prefixes):
    name = f"{P.name}_observed"
    P.monitor.histogram(f"{name}_request_ms").reset()
    eng = P.serving.InferenceEngine(P.predictor(prefixes[P.name]),
                                    batch_buckets=(1, 4), max_batch_size=4,
                                    max_batch_delay_ms=1.0, name=name)
    try:
        pending = deque(eng.submit(_x(1, seed=i)) for i in range(12))
        while pending:
            pending.popleft().result(timeout=30)
        h = eng.health()
        return (h["ready"], h["reason"], h["live_lanes"],
                eng.stats()["latency_ms"]["count"],
                P.monitor.stat_get("STAT_serving_queue_depth"))
    finally:
        eng.shutdown()


def test_health_and_latency_counts(artifacts):
    want, got = _both(_observed, artifacts)
    assert got == want == (True, "ok", 1, 12, 0)


def _exported(P, prefixes):
    """An engine with its own ephemeral metrics server (metrics_port=0):
    the /stats engine entry and the serving names /metrics renders."""
    import json
    import re
    import urllib.request
    name = f"{P.name}_exported"
    eng = P.serving.InferenceEngine(P.predictor(prefixes[P.name]),
                                    batch_buckets=(1, 4), max_batch_size=4,
                                    max_batch_delay_ms=1.0, name=name,
                                    metrics_port=0)
    try:
        for i in range(6):
            eng.run(_x(1, seed=i))
        url = eng.metrics_server.url
        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            entry = json.loads(r.read())["engines"][name]
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        with urllib.request.urlopen(url + "/readyz", timeout=10) as r:
            ready = r.status
        names = sorted(set(re.findall(
            r"^(paddle_tpu_(?:serving_(?:queue|pad|device|resolve)_ms"
            r"|stat_serving_queue_depth|stat_predictor_compiles))"
            r"(?:_bucket|_sum|_count)?[ {]",
            text, re.M)))
        return (sorted(entry["phases"]), entry["rows_served"],
                entry["latency_ms"]["count"], names, ready)
    finally:
        eng.shutdown()


def test_exporter_serves_the_engine(artifacts):
    want, got = _both(_exported, artifacts)
    assert got == want
    assert got[0] == ["serving_device_ms", "serving_pad_ms",
                      "serving_queue_ms", "serving_resolve_ms"]
    assert got[1:3] == (6, 6) and got[4] == 200
    assert len(got[3]) == 6, got[3]
