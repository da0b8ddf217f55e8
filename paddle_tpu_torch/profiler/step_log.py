"""Per-step scheduler timeline for the generation engine.

Spans explain ONE request's latency; this ring explains the
*scheduler's* behavior between requests: which iteration admitted or
evicted whom, how deep the queue ran, how close the page pool was to
exhaustion. The step thread records one compact `StepRecord` per engine
iteration into a bounded per-engine ring (`FLAGS_gen_step_log_size`,
oldest overwritten — the same bounding discipline as the trace rings):

    it            iteration ordinal (monotone per engine)
    step          decode-step total AFTER the iteration (unchanged when
                  the iteration only admitted/expired)
    live          occupied decode slots after the iteration
    admitted / completed / expired / poisoned / aborted / freed
                  scheduler decisions taken THIS iteration (freed =
                  slots released; completed+expired+poisoned+aborted
                  partition the request outcomes, so the ring's sums
                  reconcile exactly with STAT_gen_completions /
                  STAT_gen_timeouts / STAT_gen_poisoned)
    queue_depth / oldest_age_ms
                  intake pressure after the iteration (FIFO → the head
                  is the oldest)
    pages_in_use / free_pages
                  page-pool occupancy after the iteration
    prefix_tokens / cow_splits
                  prompt tokens served from cached prefix pages and
                  copy-on-write page splits performed THIS iteration
                  (the prefix-cache effectiveness signal)
    tokens / spec_drafted / spec_accepted / prefill_chunks
                  tokens delivered THIS iteration (prefill first
                  tokens + decode/verify), speculative draft tokens
                  proposed and accepted, and prefill chunks run
                  (tokens > live on a decode iteration is speculation
                  paying off)
    prefill_ms / decode_ms
                  wall spent in prefill calls vs the decode step this
                  iteration. The port's decode call returns host arrays
                  (the step's one device-to-host copy), so decode_ms
                  includes the device sync: it is the step's device
                  time plus the host's launch work, not launch alone
    tier_demotions / tier_promotions
                  prefix-cache pages demoted to / promoted back from
                  the host tier THIS iteration (the cross-tier traffic
                  signal)
    attr_admit_ms / attr_promote_ms / attr_bookkeep_ms / attr_idle_ms /
    attr_wall_ms  per-iteration goodput attribution: with
                  prefill_ms and decode_ms these six buckets tile the
                  step thread's mark-to-mark wall EXACTLY (bookkeeping
                  is the remainder of the rounded siblings), feeding
                  the STAT_gen_step_attr_* histogram family

The ring is exported three ways: `/steps` JSON
(`steps_payload()` — per-engine records + audit-log tail, the input of
`tools/engine_report.py`), chrome-trace counter tracks
(`chrome_counter_events()` merged into `/trace` and
`export_chrome_tracing`, so the scheduler state renders as "C" series
under the request timeline), and two histograms — `engine_step_ms`
(decode-step wall) and `gen_queue_age_ms` (oldest queued request's age,
observed every iteration the queue is non-empty).

Recording is single-writer (the engine's step thread owns every
append); readers take GIL-consistent list copies like the tracer rings.
Everything is gated by `FLAGS_gen_step_log` (default on).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..framework import monitor
from ..framework.flags import flag
from ._engine_registry import EngineRegistry

__all__ = ["StepRecord", "StepLog", "enabled", "register", "unregister",
           "steps_payload", "chrome_counter_events"]

_FIELDS = ("it", "step", "t", "live", "admitted", "completed", "expired",
           "poisoned", "aborted", "freed", "queue_depth", "oldest_age_ms",
           "pages_in_use", "free_pages", "prefix_tokens", "cow_splits",
           "prefill_ms", "decode_ms", "tokens", "spec_drafted",
           "spec_accepted", "prefill_chunks",
           # which engine GENERATION (supervised-restart ordinal)
           # recorded this iteration
           "incarnation",
           # prefix-cache pages demoted to / promoted from the host
           # tier THIS iteration
           "tier_demotions", "tier_promotions",
           # the engine's tensor-parallel degree (1 = one card)
           "tp",
           # per-iteration goodput attribution. Six buckets —
           # attr_admit_ms (scheduler work net of nested device calls),
           # prefill_ms (above), attr_promote_ms (tier re-upload),
           # decode_ms (above), attr_bookkeep_ms (host bookkeeping:
           # record/flush/slice — computed as the remainder of the
           # ROUNDED siblings, so the stored buckets sum EXACTLY to
           # attr_wall_ms), attr_idle_ms (cv waits) — tile the step
           # thread's mark-to-mark iteration wall. attr_wall_ms == 0
           # marks a record from before this era (or the abort-path
           # flush record, which never owned a full iteration)
           "attr_admit_ms", "attr_promote_ms", "attr_bookkeep_ms",
           "attr_idle_ms", "attr_wall_ms")


def enabled() -> bool:
    return bool(flag("FLAGS_gen_step_log"))


class StepRecord:
    """One engine iteration's scheduler state (compact: slots only)."""

    __slots__ = _FIELDS

    def __init__(self, **kw):
        for f in _FIELDS:
            setattr(self, f, kw.get(f, 0))

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in _FIELDS}


_hists_lock = threading.Lock()
_hists = None
_attr_hists = None


def _step_hists():
    global _hists
    if _hists is None:
        with _hists_lock:
            if _hists is None:
                # literal names: the check_stats lint reads these
                _hists = (monitor.histogram("engine_step_ms"),
                          monitor.histogram("gen_queue_age_ms"))
    return _hists


def _step_attr_hists():
    global _attr_hists
    if _attr_hists is None:
        with _hists_lock:
            if _attr_hists is None:
                # literal names: the check_stats lint reads these
                _attr_hists = (
                    monitor.histogram("STAT_gen_step_attr_admit_ms"),
                    monitor.histogram("STAT_gen_step_attr_prefill_ms"),
                    monitor.histogram("STAT_gen_step_attr_promote_ms"),
                    monitor.histogram("STAT_gen_step_attr_decode_ms"),
                    monitor.histogram("STAT_gen_step_attr_bookkeep_ms"),
                    monitor.histogram("STAT_gen_step_attr_idle_ms"))
    return _attr_hists


class StepLog:
    """One engine's bounded step ring. The owning step thread is the
    only writer; `snapshot()`/`tail()` are GIL-consistent copies."""

    def __init__(self, engine: str, capacity: Optional[int] = None):
        self.engine = engine
        self.cap = max(1, int(flag("FLAGS_gen_step_log_size")
                              if capacity is None else capacity))
        self._buf: List[StepRecord] = []
        self._idx = 0           # oldest slot once full
        self.recorded = 0       # total records ever appended
        register(self)

    def record(self, rec: StepRecord) -> None:
        """Append one iteration record (step thread only) and feed the
        step/queue-age histograms. One list append + two histogram
        observes — nothing here syncs the device."""
        step_h, age_h = _step_hists()
        if rec.decode_ms > 0:
            step_h.observe(rec.decode_ms)
        if rec.queue_depth:
            age_h.observe(max(0.0, rec.oldest_age_ms))
        if rec.attr_wall_ms > 0:
            # goodput attribution: one observe per bucket
            # per iteration — "where did this replica's ms go" as a
            # fleet-scrapeable histogram family
            for h, v in zip(_step_attr_hists(),
                            (rec.attr_admit_ms, rec.prefill_ms,
                             rec.attr_promote_ms, rec.decode_ms,
                             rec.attr_bookkeep_ms, rec.attr_idle_ms)):
                h.observe(max(0.0, v))
        if len(self._buf) < self.cap:
            self._buf.append(rec)
        else:
            self._buf[self._idx] = rec
            self._idx = (self._idx + 1) % self.cap
        self.recorded += 1

    def snapshot(self) -> List[StepRecord]:
        buf = list(self._buf)   # one GIL-atomic copy — consistent
        if len(buf) < self.cap:
            return buf
        # _idx may be stale relative to the copy (the step thread can
        # record() between the copy and the read), which would rotate
        # the true oldest record to the newest position — rotate on the
        # records' own monotone iteration counter instead
        lo = min(range(len(buf)), key=lambda i: buf[i].it)
        return buf[lo:] + buf[:lo] if lo else buf

    def tail(self, n: int) -> List[dict]:
        """Last `n` records as dicts, oldest-first (flight dumps,
        `/steps`)."""
        return [r.to_dict() for r in self.snapshot()[-max(0, int(n)):]]


# -- registry (the `/steps` surface) ----------------------------------------

_logs = EngineRegistry()


def register(log: StepLog) -> None:
    _logs.register(log.engine, log)


def unregister(log: StepLog) -> None:
    _logs.unregister(log.engine, log)


def _live_logs() -> Dict[str, StepLog]:
    return _logs.live()


def steps_payload(last: int = 0, audit_tail: int = 256) -> dict:
    """The `/steps` JSON: per-engine iteration records (all retained, or
    the last `last`) + the engine's decision-audit tail + the two step
    histograms — everything `tools/engine_report.py` needs to render a
    human timeline."""
    from . import audit
    step_h, age_h = _step_hists()
    engines = {}
    for name, log in sorted(_live_logs().items()):
        recs = [r.to_dict() for r in log.snapshot()]
        if last > 0:
            recs = recs[-last:]
        engines[name] = {
            "records": recs,
            "recorded_total": log.recorded,
            "ring_capacity": log.cap,
            "audit": audit.tail_for(name, audit_tail),
        }
    return {"enabled": enabled(),
            "engines": engines,
            "histograms": {"engine_step_ms": step_h.snapshot(),
                           "gen_queue_age_ms": age_h.snapshot()}}


def chrome_counter_events(since: Optional[float] = None,
                          pid: Optional[int] = None) -> List[dict]:
    """Step-ring records as chrome-trace "C" counter events — one event
    per record carrying the scheduler's live/queue/pages series, so the
    timeline shows slot occupancy and pool pressure UNDER the request
    scopes. Merged into `/trace` and `export_chrome_tracing`."""
    import os
    pid = os.getpid() if pid is None else pid
    out = []
    for name, log in sorted(_live_logs().items()):
        for r in log.snapshot():
            if since is not None and r.t < since:
                continue
            out.append({"name": f"{name} scheduler", "ph": "C",
                        "pid": pid, "tid": 0, "ts": r.t * 1e6,
                        "args": {"live_slots": r.live,
                                 "queue_depth": r.queue_depth,
                                 "pages_in_use": r.pages_in_use,
                                 "free_pages": r.free_pages}})
    return out
