"""SLO objectives + multi-window burn-rate evaluation.

The histograms answer "what latency have we EVER served"; an SLO needs
"are we meeting the objective RIGHT NOW, and how fast are we spending
the error budget". Three configurable objectives, all off by default:

- **TTFT p99** (`FLAGS_slo_ttft_p99_ms`): at most 1% of delivered
  requests per window may see first-token latency above the target.
- **TPOT p99** (`FLAGS_slo_tpot_p99_ms`): same budget for the steady
  decode cadence.
- **error rate** (`FLAGS_slo_error_rate`): at most this fraction of
  finished requests may fail (timeout / poison / engine death).

Each objective is evaluated over the rolling windows of
`FLAGS_slo_windows_s` (shortest first). The **burn rate** is the
classic SRE multi-window form: `bad_fraction / budget_fraction` — 1.0
means the budget is being consumed exactly as fast as the window
allows, >1.0 means the objective will be violated if the window's rate
holds, and the short window reacts in seconds while the long window
filters blips. Burn rates export three ways:

- `/slo` JSON (`payload()`), per engine per objective per window;
- Prometheus gauges `STAT_slo_<obj>_burn_bp_w<w>` (basis points,
  refreshed at `/metrics` scrape time like device telemetry);
- `GenerationEngine.health()`: with `FLAGS_slo_max_burn_rate` > 0 an
  engine whose FAST-window burn reaches the threshold reports
  not-ready, so `/readyz` sheds load BEFORE the budget is gone.

Observations are fed by the GenSpan resolve path (ttft/tpot) and the
engine's outcome paths (`observe_request`); everything is a bounded
deque append under one lock — recording never syncs the device and the
trackers are inert (no-ops) until some objective flag is set.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..framework import monitor
from ..framework.flags import flag

__all__ = ["enabled", "objectives", "windows", "observe_ttft",
           "observe_tpot", "observe_request", "evaluate", "payload",
           "shed_verdict", "clear_gauges", "forget", "reset"]

_MAX_SAMPLES = 65536      # per-series bound (oldest pruned)
_SHED_TTL_S = 0.5         # shed_verdict caches its (O(samples)) verdict

_lock = threading.Lock()
# engine -> {"ttft": deque[(t, ms)], "tpot": deque[(t, ms)],
#            "requests": deque[(t, ok)]}
_trackers: Dict[str, Dict[str, deque]] = {}
_gauge_names: set = set()  # STAT_slo_* names the last evaluate() wrote
# (engine, thresh, objectives) -> (wall, verdict): health()/readyz are
# router hot paths — a full evaluate() per poll rescans every sample
_shed_cache: Dict[tuple, Tuple[float, Optional[str]]] = {}


def objectives() -> Dict[str, float]:
    """{objective: target} of the ACTIVE objectives (flag > 0)."""
    out = {}
    ttft = float(flag("FLAGS_slo_ttft_p99_ms"))
    if ttft > 0:
        out["ttft"] = ttft
    tpot = float(flag("FLAGS_slo_tpot_p99_ms"))
    if tpot > 0:
        out["tpot"] = tpot
    err = float(flag("FLAGS_slo_error_rate"))
    if err > 0:
        out["error_rate"] = err
    return out


def enabled() -> bool:
    return bool(objectives())


def windows() -> List[float]:
    """Rolling-window lengths in seconds, shortest first (the first is
    the fast-burn window readiness shedding keys on)."""
    raw = str(flag("FLAGS_slo_windows_s"))
    out = sorted({float(w) for w in raw.split(",") if w.strip()
                  and float(w) > 0})
    return out or [60.0, 300.0]


def _series(engine: str, kind: str) -> deque:
    with _lock:
        tr = _trackers.setdefault(engine, {})
        s = tr.get(kind)
        if s is None:
            s = tr[kind] = deque(maxlen=_MAX_SAMPLES)
        return s


def _prune(s: deque, horizon: float) -> None:
    # oldest-first deque; drop everything older than the longest window
    while s and s[0][0] < horizon:
        s.popleft()


def observe_ttft(engine: str, ms: float) -> None:
    if enabled():
        _series(engine, "ttft").append((time.monotonic(), float(ms)))


def observe_tpot(engine: str, ms: float) -> None:
    if enabled():
        _series(engine, "tpot").append((time.monotonic(), float(ms)))


def observe_request(engine: str, ok: bool) -> None:
    """One finished request outcome (delivered vs timeout/poison/death)
    — the error-rate objective's sample stream."""
    if enabled():
        _series(engine, "requests").append((time.monotonic(), bool(ok)))


def _burn_cells(samples: List[Tuple[float, float]], now: float,
                wins: List[float], bad, budget: float) -> List[dict]:
    """All of one objective's (window, burn) cells in ONE pass over the
    samples: each sample is bucketed into the smallest window (`wins` is
    ascending) that contains it, and running prefix sums give every
    wider window's totals — O(samples + windows), not their product."""
    k = len(wins)
    totals = [0] * k
    viols = [0] * k
    for t, v in samples:
        age = now - t
        i = next((j for j in range(k) if age <= wins[j]), None)
        if i is None:
            continue
        totals[i] += 1
        if bad(v):
            viols[i] += 1
    cells = []
    total = viol = 0
    for j in range(k):
        total += totals[j]
        viol += viols[j]
        frac = viol / total if total else 0.0
        burn = frac / budget if total else 0.0
        cells.append({"seconds": wins[j], "count": total,
                      "violations": viol,
                      "bad_fraction": round(frac, 6),
                      "burn_rate": round(burn, 4),
                      "violated": bool(total) and burn >= 1.0})
    return cells


def evaluate(engine: Optional[str] = None,
             set_gauges: bool = True) -> dict:
    """Evaluate every active objective over every window for `engine`
    (or all tracked engines) and refresh the burn-rate gauges.

    Gauges are PER OBJECTIVE (max across engines — one process usually
    hosts one engine; the per-engine split lives in `/slo`), in basis
    points so a Prometheus alert on `> 10000` fires at burn 1.0."""
    objs = objectives()
    now = time.monotonic()
    wins = windows()
    horizon = now - max(wins)
    with _lock:
        names = ([engine] if engine is not None
                 else sorted(_trackers.keys()))
        snap = {}
        for name in names:
            tr = _trackers.get(name, {})
            series = {}
            for kind in ("ttft", "tpot", "requests"):
                s = tr.get(kind)
                if s is not None:
                    _prune(s, horizon)
                series[kind] = list(s) if s is not None else []
            snap[name] = series
    out = {}
    peak: Dict[str, float] = {}
    for name, series in snap.items():
        per_obj = {}
        for obj, target in objs.items():
            if obj == "error_rate":
                samples, bad, budget = (series["requests"],
                                        (lambda ok: not ok), target)
            else:
                samples, bad, budget = (series[obj],
                                        (lambda ms, t=target: ms > t),
                                        0.01)
            cells = _burn_cells(samples, now, wins, bad, budget)
            per_obj[obj] = {"target": target, "windows": cells,
                            "violated": any(c["violated"]
                                            for c in cells)}
            for c in cells:
                key = (obj, c["seconds"])
                peak[key] = max(peak.get(key, 0.0), c["burn_rate"])
        out[name] = per_obj
    if set_gauges:
        written = set()
        for (obj, w), burn in sorted(peak.items()):
            name = f"STAT_slo_{obj}_burn_bp_w{int(w)}"
            monitor.stat_set(name, int(round(burn * 10000)))
            written.add(name)
        # an objective that was just disabled (or a window that was
        # removed) must not keep exporting its last burn forever
        with _lock:
            stale = _gauge_names - written
            _gauge_names.clear()
            _gauge_names.update(written)
        for name in stale:
            monitor.stat_set(name, 0)
    return out


def clear_gauges() -> None:
    """Zero every burn-rate gauge the last evaluate() wrote — called by
    the exporter when SLOs are disabled so a stale burn can't keep a
    Prometheus alert firing on an objective that no longer exists."""
    with _lock:
        stale = set(_gauge_names)
        _gauge_names.clear()
    for name in stale:
        monitor.stat_set(name, 0)


def payload() -> dict:
    """The `/slo` JSON surface."""
    return {"enabled": enabled(),
            "objectives": objectives(),
            "windows_s": windows(),
            "max_burn_rate": float(flag("FLAGS_slo_max_burn_rate")),
            "engines": evaluate()}


def shed_verdict(engine: str) -> Optional[str]:
    """Readiness folding: a human reason string when `engine` should
    shed load (fast-window burn of any objective >=
    FLAGS_slo_max_burn_rate), else None. Called from
    GenerationEngine.health() — cheap when SLOs are off."""
    thresh = float(flag("FLAGS_slo_max_burn_rate"))
    objs = objectives()
    if thresh <= 0 or not objs:
        return None
    # TTL-cached: evaluate() rescans every sample, and health() is a
    # router hot path; a flag change invalidates through the key
    key = (engine, thresh, tuple(sorted(objs.items())))
    now = time.monotonic()
    with _lock:
        hit = _shed_cache.get(key)
        if hit is not None and now - hit[0] < _SHED_TTL_S:
            return hit[1]
    verdict = None
    per_obj = evaluate(engine, set_gauges=False).get(engine)
    for obj, res in sorted((per_obj or {}).items()):
        fast = res["windows"][0]
        if fast["count"] and fast["burn_rate"] >= thresh:
            verdict = (f"slo {obj} fast-window burn "
                       f"{fast['burn_rate']:.2f} >= {thresh:g} "
                       f"({fast['violations']}/{fast['count']} over "
                       f"{fast['seconds']:g}s, target {res['target']:g})")
            break
    with _lock:
        if len(_shed_cache) > 64:
            _shed_cache.clear()
        _shed_cache[key] = (now, verdict)
    return verdict


def forget(engine: str) -> None:
    """Drop one engine's samples + cached verdicts (engine shutdown —
    without this a process that churns uniquely-named engines grows a
    tracker per name forever and /slo keeps listing dead replicas)."""
    with _lock:
        _trackers.pop(engine, None)
        for k in [k for k in _shed_cache if k[0] == engine]:
            del _shed_cache[k]


def reset() -> None:
    """Drop every tracked sample (tests/benches on a warm process)."""
    with _lock:
        _trackers.clear()
        _shed_cache.clear()
