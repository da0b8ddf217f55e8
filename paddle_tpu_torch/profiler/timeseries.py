"""Time-series metrics ring: continuous-in-time history for the fleet.

`/metrics` and `/stats` are point-in-time — a scrape says the queue is
9 deep, never whether it got there over one second or one hour. Once a
Router supervises N replicas, the operator question changes shape from
"what is the value" to "what is the trend, per replica", and answering
it by polling from outside means every consumer re-implements rate
math. This module answers it in-process with one bounded sampler (the
device-telemetry lazy-thread lifecycle: `touch()`d by engines and the
`MetricsServer`, idles at interval 0, honors runtime flag flips in both
directions) that every tick records:

- every registered monitor **counter as a rate** (delta / wall seconds,
  clamped at 0 so a restart's counter reset reads as idle, not as a
  negative spike), and
- every registered **gauge as a level** (the monitor gauge registry is
  the single source of kind truth — same `is_gauge_name` table the
  Prometheus exporter renders TYPE lines from), and
- per-registered-engine `pressure()` ticks (queue depth, free pages,
  oldest queued age — the step-thread-published snapshot the router
  balances on, so sampling it is lock-free on the engine side)

into per-name rings bounded by `FLAGS_metrics_history_samples` (oldest
drop first; `FLAGS_metrics_history_interval_s` sets the cadence). The
rings serve three ways: `/history` JSON (`history_payload()` — the
input of `tools/router_report.py --history` sparklines), chrome "C"
counter tracks merged into `/trace` (`chrome_counter_events()`), and
direct `series()` reads in tests.

Locking: one module lock guards the rings and the rate anchors — the
sampler thread is the usual writer, but `sample()` is also callable
from tests and scrape paths, and a `/history` read racing an engine
`_die()` must see a consistent ring, so everything mutating or copying
ring state takes the lock. Engine `pressure()` reads are GIL-atomic
snapshot reads by design and take no engine-side lock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..framework import monitor
from ..framework.flags import flag

__all__ = ["touch", "active", "sample", "series", "history_payload",
           "chrome_counter_events", "clear"]

_lock = threading.Lock()
_sampler = [None]             # lazy daemon thread, one per process
_series: Dict[str, dict] = {}  # name -> {"kind", "points": deque}
_prev = {}                    # counter name -> (t, value) rate anchor


def active() -> bool:
    """True while history is wanted AND enabled: some subsystem has
    touch()ed the sampler and the interval flag is currently positive
    (same contract as device_telemetry.active)."""
    return (_sampler[0] is not None
            and float(flag("FLAGS_metrics_history_interval_s")) > 0)


def touch() -> None:
    """Start the sampler thread (idempotent, lazy). Starts even while
    the interval flag is 0 — it idles cheaply and honors a later
    runtime set_flags(interval>0) instead of being permanently
    unenableable because the flag happened to be 0 at touch() time."""
    with _lock:
        if _sampler[0] is None:
            t = threading.Thread(target=_sampler_loop, daemon=True,
                                 name="paddle_tpu_torch-metrics-history")
            _sampler[0] = t
            t.start()


def _sampler_loop():
    while True:
        iv = float(flag("FLAGS_metrics_history_interval_s"))
        time.sleep(max(iv, 0.5) if iv > 0 else 5.0)
        if iv > 0:
            try:
                sample()
            except Exception:
                pass


def _cap() -> int:
    return max(1, int(flag("FLAGS_metrics_history_samples")))


def _record_locked(name: str, kind: str, t: float, value) -> None:
    s = _series.get(name)
    if s is None:
        s = _series[name] = {"kind": kind, "points": deque()}
    s["points"].append((t, value))
    cap = _cap()
    while len(s["points"]) > cap:
        s["points"].popleft()


def sample() -> int:
    """Take one history tick across every registered stat and engine;
    returns the number of series updated. Safe from any thread."""
    t = time.perf_counter()
    snap = monitor.all_stats()
    # engine pressure ticks OUTSIDE the module lock: pressure() is a
    # lock-free snapshot read, but a misbehaving engine property must
    # not be able to deadlock against a concurrent /history render
    pressures = {}
    from . import exporter
    for name, eng in exporter.live_engines().items():
        try:
            p = getattr(eng, "pressure", None)
            p = p() if callable(p) else None
        except Exception:
            p = None
        if isinstance(p, dict):
            pressures[name] = p
    n = 0
    with _lock:
        for name, v in snap.items():
            if monitor.is_gauge_name(name):
                _record_locked(name, "level", t, v)
            else:
                prev = _prev.get(name)
                _prev[name] = (t, v)
                if prev is None or t <= prev[0]:
                    continue
                rate = max(0.0, (v - prev[1]) / (t - prev[0]))
                _record_locked(name, "rate", t, round(rate, 6))
            n += 1
        for ename, p in pressures.items():
            for field in ("queue_depth", "live", "free_pages",
                          "oldest_age_ms"):
                if field in p:
                    _record_locked(f"pressure:{ename}:{field}",
                                   "level", t, p[field])
                    n += 1
    return n


def series(name: str) -> List[tuple]:
    """One series' points as a list copy (tests)."""
    with _lock:
        s = _series.get(name)
        return list(s["points"]) if s else []


def history_payload() -> dict:
    """The `/history` JSON: every series with its kind and bounded
    points — `{"series": {name: {"kind": "rate"|"level",
    "points": [[t, v], ...]}}}` (t = perf_counter seconds, the same
    clock every trace event uses, so histories and timelines align)."""
    with _lock:
        out = {name: {"kind": s["kind"],
                      "points": [[round(t, 3), v]
                                 for t, v in s["points"]]}
               for name, s in sorted(_series.items())}
    return {"enabled": active(),
            "interval_s": float(flag("FLAGS_metrics_history_interval_s")),
            "samples": _cap(),
            "series": out}


def chrome_counter_events(since: Optional[float] = None,
                          pid: Optional[int] = None) -> List[dict]:
    """History rings as chrome-trace "C" counter events, one track per
    series that is ever nonzero in the window (all-zero tracks are
    noise, not signal) — merged into `/trace` under the request
    timeline next to the step-ring scheduler tracks."""
    import os
    pid = os.getpid() if pid is None else pid
    with _lock:
        items = [(name, s["kind"], list(s["points"]))
                 for name, s in sorted(_series.items())]
    out = []
    for name, kind, pts in items:
        if not any(v for _, v in pts):
            continue
        for t, v in pts:
            if since is not None and t < since:
                continue
            out.append({"name": f"history:{name}", "ph": "C",
                        "pid": pid, "tid": 0, "ts": t * 1e6,
                        "args": {kind: v}})
    return out


def clear() -> None:
    """Drop every series and rate anchor (tests)."""
    with _lock:
        _series.clear()
        _prev.clear()
