"""Live metrics export surface (reference `platform/monitor.h`
StatRegistry::publish → here rendered straight to Prometheus text, plus
a tiny stdlib HTTP server so the process is observable from OUTSIDE —
curl, a Prometheus scraper, or a dashboard — instead of only via
in-process `all_stats()` calls).

Endpoints (`MetricsServer`, 127.0.0.1, daemon threads, zero deps):

- `/metrics` — Prometheus text: every monitor counter (`counter`, or
  `gauge` for up-down/level stats — queue depth, device telemetry) and
  every `StatHistogram` as a real `histogram` — the log-spaced buckets
  map one-to-one onto cumulative `_bucket{le=...}` lines (zero-delta
  runs coalesced), plus `_sum`/`_count`. A scrape refreshes the device
  telemetry gauges so HBM/MFU are never interval-stale.
- `/stats` — JSON: counters, histogram snapshots, every registered
  engine's `stats()` (`GenerationEngine`: slots, pages, prefix and tier
  numbers, the ledger; `InferenceEngine`: lanes, buckets, occupancy and
  the `phases` breakdown of the four `serving_*_ms` histograms),
  device-telemetry snapshot (with the first-run ledger), trace-ring
  state, and the
  flight recorder's last-dump summaries (reason, timestamp, path) so
  operators see recent postmortems without filesystem access.
- `/steps` — JSON of every generation engine's scheduler step ring
  (per-iteration admitted/freed/expired counts, queue depth + oldest
  age, page occupancy, prefill-vs-decode wall) plus the decision-audit
  tail — the input of `tools/engine_report.py`.
- `/slo` — SLO objectives, per-engine multi-window burn rates and
  violated flags (`profiler/slo.py`).
- `/trace` — the current chrome trace (same payload
  `export_chrome_tracing` writes, scheduler + history counter tracks
  included), so a live timeline is one curl away.
- `/history` — the time-series metrics rings (`profiler/timeseries.py`:
  counters-as-rates, gauges-as-levels, per-replica pressure ticks),
  bounded by FLAGS_metrics_history_samples — the trend view `/stats`
  cannot give, and the input of `tools/router_report.py --history`.
- `/healthz` — liveness: 200 whenever the process can answer.
- `/readyz` — readiness: 200 iff ≥1 registered engine is warmed up,
  has a live step loop (or, for an `InferenceEngine`, a live lane), is
  not draining, and its queue is below the rejection threshold; 503
  otherwise, always with per-engine (and per-lane) JSON detail.

Metric names keep the JAX package's `paddle_tpu_` prefix, so one
dashboard reads both packages. Wire-up: `GenerationEngine(metrics_port=)`
or `InferenceEngine(metrics_port=)` / `FLAGS_metrics_port`, or
`start_metrics_server(port)` directly (port 0 binds an ephemeral port —
read it back from `.port`).
"""
from __future__ import annotations

import json
import os
import re
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..framework import monitor
from ..framework.flags import flag
from . import (device_telemetry, flight_recorder, slo, step_log,
               timeseries, tracer)

__all__ = ["render_prometheus", "MetricsServer", "start_metrics_server",
           "register_engine", "unregister_engine", "live_engines",
           "stats_payload", "readiness_payload"]

_PREFIX = "paddle_tpu_"


def _is_gauge(name: str) -> bool:
    # monitor is the single registry of gauge names: level gauges
    # self-register through stat_set/stat_gauge_add, up/down counters
    # register explicitly via monitor.register_gauge(..., updown=True)
    return monitor.is_gauge_name(name)


def _metric_name(name: str) -> str:
    return _PREFIX + re.sub(r"[^a-zA-Z0-9_]", "_", name).lower()


def _fmt(v: float) -> str:
    return "+Inf" if v == float("inf") else f"{v:.6g}"


def render_prometheus() -> str:
    """Prometheus exposition text of every registered counter and
    histogram (reference StatRegistry publish, Prometheus-shaped)."""
    try:  # refresh device-memory/MFU gauges at scrape time (no-op
        #   without a CUDA device)
        device_telemetry.sample()
    except Exception:
        pass
    try:  # refresh SLO burn-rate gauges the same way (no-op when off)
        if slo.enabled():
            slo.evaluate()
        else:
            slo.clear_gauges()  # disabling an objective must also stop
            # its last burn value from rendering forever
    except Exception:
        pass
    lines = []
    for name, v in monitor.all_stats().items():
        m = _metric_name(name)
        typ = "gauge" if _is_gauge(name) else "counter"
        lines.append(f"# TYPE {m} {typ}")
        lines.append(f"{m} {v}")
    for name, h in sorted(monitor.registered_histograms().items()):
        m = _metric_name(name)
        buckets = h.buckets()          # one consistent cumulative pass
        count = buckets[-1][1]
        lines.append(f"# TYPE {m} histogram")
        # sparse `le` sets are valid Prometheus, but histogram_quantile
        # interpolates linearly across whatever gap it sees — so a run of
        # equal cumulative counts must keep its LAST bucket (the tight
        # lower bound of the next occupied bucket), or quantiles read up
        # to the full run width low. Emit every change point plus the
        # bucket immediately before it.
        prev = None
        last_idx = -1
        for i, (le, cum) in enumerate(buckets[:-1]):
            if cum != prev:
                if i - 1 > last_idx:
                    ple, pcum = buckets[i - 1]
                    lines.append(f'{m}_bucket{{le="{_fmt(ple)}"}} {pcum}')
                lines.append(f'{m}_bucket{{le="{_fmt(le)}"}} {cum}')
                prev = cum
                last_idx = i
        if count != prev and last_idx < len(buckets) - 2:
            ple, pcum = buckets[-2]
            lines.append(f'{m}_bucket{{le="{_fmt(ple)}"}} {pcum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{m}_sum {h.sum:.6g}")
        lines.append(f"{m}_count {count}")
    for name, v in sorted(tracer.ring_stats().items()):
        m = f"{_PREFIX}trace_{name}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {v}")
    return "\n".join(lines) + "\n"


# -- engine registry (the `/stats` "engines" section) ----------------------

_engines_lock = threading.Lock()
_engines = {}  # engine name -> weakref


def register_engine(engine) -> None:
    with _engines_lock:
        _engines[engine.name] = weakref.ref(engine)


def unregister_engine(engine) -> None:
    with _engines_lock:
        ref = _engines.get(engine.name)
        if ref is not None and ref() in (engine, None):
            del _engines[engine.name]


def live_engines() -> dict:
    """`{name: engine}` of the still-alive registered engines — the
    registry surface the time-series sampler takes `pressure()` ticks
    from (weakrefs resolved, dead entries skipped but not reaped: the
    reaping stays with `_engines_snapshot`, the only mutating reader)."""
    with _engines_lock:
        items = list(_engines.items())
    out = {}
    for name, ref in items:
        eng = ref()
        if eng is not None:
            out[name] = eng
    return out


def _engines_snapshot() -> dict:
    with _engines_lock:
        items = list(_engines.items())
    out = {}
    for name, ref in items:
        eng = ref()
        if eng is None:
            with _engines_lock:
                if _engines.get(name) is ref:
                    del _engines[name]
            continue
        try:
            out[name] = eng.stats()
        except Exception as e:  # a dying engine must not break the page
            out[name] = {"error": repr(e)}
    return out


def stats_payload() -> dict:
    return {"stats": monitor.all_stats(),
            "histograms": monitor.all_histograms(),
            "engines": _engines_snapshot(),
            "device_telemetry": device_telemetry.snapshot(),
            "trace": tracer.ring_stats(),
            "flight_recorder": {"enabled": flight_recorder.enabled(),
                                "dumps": flight_recorder.dump_records()}}


def readiness_payload() -> dict:
    """`(ready, detail)` shape for `/readyz`: the process is ready iff
    at least one registered engine can take traffic right now — warmed
    up, ≥1 live lane, not draining, queue below the rejection
    threshold. Per-engine/per-lane detail always included so a router
    can tell "warming up" from "draining" from "overloaded"."""
    with _engines_lock:
        items = list(_engines.items())
    engines = {}
    for name, ref in items:
        eng = ref()
        if eng is None:
            continue
        try:
            engines[name] = eng.health()
        except Exception as e:  # a dying engine reads as not-ready
            engines[name] = {"ready": False, "reason": repr(e)}
    ready = any(h.get("ready") for h in engines.values())
    out = {"ready": ready, "engines": engines}
    if not engines:
        out["reason"] = "no engines registered"
    return out


# -- HTTP surface ----------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch-metrics"

    def log_message(self, *args):  # no per-scrape stderr chatter
        pass

    def do_GET(self):
        monitor.stat_add("STAT_metrics_requests")
        path = self.path.split("?", 1)[0]
        status = 200
        try:
            if path in ("/", "/metrics"):
                body = render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/stats":
                body = json.dumps(stats_payload(), default=str).encode()
                ctype = "application/json"
            elif path == "/steps":
                body = json.dumps(step_log.steps_payload(),
                                  default=str).encode()
                ctype = "application/json"
            elif path == "/slo":
                body = json.dumps(slo.payload(), default=str).encode()
                ctype = "application/json"
            elif path == "/trace":
                tracer.sample_counters()
                trace = tracer.chrome_trace()
                # scheduler state as counter tracks under the request
                # timeline (step ring → "C" events), plus the history
                # rings' rate/level series
                trace["traceEvents"].extend(
                    step_log.chrome_counter_events())
                trace["traceEvents"].extend(
                    timeseries.chrome_counter_events())
                body = json.dumps(trace, default=str).encode()
                ctype = "application/json"
            elif path == "/history":
                body = json.dumps(timeseries.history_payload(),
                                  default=str).encode()
                ctype = "application/json"
            elif path == "/healthz":
                body = json.dumps({"status": "ok",
                                   "pid": os.getpid()}).encode()
                ctype = "application/json"
            elif path == "/readyz":
                payload = readiness_payload()
                status = 200 if payload["ready"] else 503
                body = json.dumps(payload, default=str).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown endpoint (have /metrics "
                                     "/stats /steps /slo /trace "
                                     "/history /healthz /readyz)")
                return
        except Exception as e:  # noqa: BLE001 — a scrape never kills us
            self.send_error(500, repr(e))
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsServer:
    """Threaded stdlib HTTP server bound to 127.0.0.1; `port=0` binds an
    ephemeral port (read `.port` back). Serves until `close()`."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._closed = False
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"paddle_tpu_torch-metrics-{self.port}")
        self._thread.start()
        flight_recorder.touch()   # metrics users want the samplers running
        device_telemetry.touch()
        timeseries.touch()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        if self._closed:  # idempotent: engine shutdown + caller may race
            return
        self._closed = True
        with _servers_lock:
            for k, v in list(_servers.items()):
                if v is self:
                    del _servers[k]
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_servers_lock = threading.Lock()
_servers = {}  # requested port -> MetricsServer


def start_metrics_server(port: Optional[int] = None) -> \
        Optional[MetricsServer]:
    """Start (or return the already-running) metrics server. `port=None`
    resolves `FLAGS_metrics_port`, where 0 means OFF (returns None);
    an explicit `port=0` binds an ephemeral port. Idempotent per
    requested port — every engine pointing at the same port shares one
    server."""
    from_flag = port is None
    port = int(flag("FLAGS_metrics_port")) if port is None else int(port)
    if from_flag and port == 0:
        return None
    with _servers_lock:
        srv = _servers.get(port)
        if srv is not None:
            return srv
        srv = MetricsServer(port)
        if port != 0:  # ephemeral requests are never shared
            _servers[port] = srv
        return srv
