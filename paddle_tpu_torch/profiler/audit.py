"""Structured decision audit log for the generation scheduler.

The step ring (`step_log.py`) says WHAT the scheduler's state was each
iteration; this log says WHY each request moved — every
admit/defer/evict/expire/poison decision appends one reason-coded event
to a bounded per-engine ring, so a postmortem answers "why did this
request wait/die" from the engine's own words instead of inference over
counters.

Reason codes are a CLOSED set (`REASONS` below), the JAX package's
codes one for one: `AuditLog.audit` rejects an unknown code. The set
keeps the supervisor and router codes that later slices emit.

Storage: a `collections.deque(maxlen=...)` per engine (appends are
atomic under the GIL, so the submit thread's REJECT_QUEUE_FULL events
interleave safely with the step thread's decisions), plus an optional
JSONL sink (`FLAGS_gen_audit_log` = path; '' keeps the ring only). The
sink write sits on scheduler paths and therefore never raises. The tail
rides flight-recorder dumps (`gen_engine_death`, poison, exhaustion)
and the `/steps` payload.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..framework import monitor
from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from ._engine_registry import EngineRegistry

__all__ = ["REASONS", "AuditLog", "tail_for"]

# The closed reason-code vocabulary. Codes are past-tense facts about one
# request.
REASONS = frozenset({
    "ADMIT",               # request took a slot + worst-case pages
    "ADMIT_PREFIX_HIT",    # admit whose prompt prefix mapped cached
                           # pages read-only; only the tail prefilled
    "COW_SPLIT",           # shared page split private before the one
                           # divergent write (full-prompt match)
    "EVICT_PREFIX_LRU",    # refcount-0 cached chain pages reclaimed
                           # LRU, before an admission's alloc
    "EVICT_PREFIX_BUDGET",  # cached chains evicted eagerly at
                            # register() to hold the page-count budget
                            # (FLAGS_gen_prefix_cache_max_pages)
    "DEFER_PAGES",         # admission deferred: free pages < worst case
    "DEFER_SLOTS",         # admission deferred: every decode slot busy
    "REJECT_QUEUE_FULL",   # submit shed by EngineOverloaded backpressure
    "EXPIRE_QUEUED",       # deadline passed while waiting in the queue
    "EXPIRE_DECODE",       # deadline passed mid-decode; sequence evicted
    "EXPIRE_LATE",         # finished the same instant it expired —
                           # delivered as a timeout, not a completion
    "COMPLETE_EOS",        # finished on the eos token
    "COMPLETE_MAX_NEW",    # finished by exhausting max_new_tokens
    "POISON_PREFILL",      # non-finite prefill logits; request isolated
    "POISON_DECODE",       # non-finite decode logits; sequence isolated
    "CANCELLED",           # future cancelled before the request ran
    "EVICT_SHUTDOWN",      # live sequence evicted by shutdown/abort
    "EVICT_SHUTDOWN_QUEUED",  # queued (never admitted) request dropped
                              # by shutdown(drain=False)
    "ENGINE_DIED",         # stranded by engine death (step-loop error)
    "ENGINE_RESTART",      # supervisor rebuilt the engine after a death
                           # (detail: incarnation, backoff)
    "REPLAY_ADMIT",        # crash-manifest request re-enqueued on the
                           # rebuilt engine (continuation or scratch)
    "RETRY_EXHAUSTED",     # request failed typed: its replay budget
                           # (FLAGS_gen_retry_limit) ran out
    "REPLAY_IMPOSSIBLE",   # request failed typed: no exactly-once
                           # replay exists (sampled stream whose
                           # continuation exceeds the prefill buckets)
                           # — no retry-limit tuning can fix this
    "BREAKER_OPEN",        # crash-storm circuit breaker opened — the
                           # supervisor stays down (/readyz 503)
    "DEGRADED_SPEC_OFF",   # poison storm flipped speculation off for
                           # this engine (FLAGS_gen_poison_degrade_k)
    "DEGRADED_ADMIT_CLAMP",  # repeated allocator exhaustion clamped
                             # admission: uncoverable submits now fail
                             # fast (FLAGS_gen_exhaust_clamp_k)
    "ROUTE_AFFINITY",      # router placed the request on the replica
                           # whose sketch held its longest prompt
                           # prefix chain (detail: replica,
                           # matched_pages)
    "ROUTE_LEAST_PRESSURE",  # no replica held the prefix (or affinity
                             # off/tied): placed by best headroom /
                             # shortest queue / youngest head
    "ROUTE_DRAIN",         # replica left (or re-entered) the placement
                           # set: SLO burn / breaker-open / not-ready
                           # — live streams on it finish untouched
    "ROUTE_REROUTE",       # placement failed typed on the chosen
                           # replica (breaker/shutdown/overload); the
                           # router retried the next-best replica
    "KV_DEMOTE",           # prefix-cache eviction demoted a chain
                           # page's content to the host tier instead of
                           # discarding it (detail: pages)
    "KV_PROMOTE",          # admission re-uploaded a host-tier chain
                           # run to the device, ahead of the tail
                           # prefill (detail: pages, tokens)
    "KV_TIER_EVICT",       # host-tier entries finally dropped — LRU
                           # byte-budget pressure or a cascade drop of
                           # orphaned descendants (demote-of-demoted =
                           # final eviction; detail: entries)
    "KV_PROMOTE_ABANDON",  # promotion abandoned mid-upload (fault /
                           # request expiry): written target pages
                           # zeroed, admission fell back to cold
                           # prefill — no leak on either tier
})

_CAP = 2048   # per-engine ring bound (≈ a few minutes of decisions)


class AuditLog:
    """One engine's bounded decision ring + optional JSONL sink."""

    def __init__(self, engine: str, capacity: int = _CAP):
        self.engine = engine
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._sink_lock = threading.Lock()
        self._sink_path = None   # open JSONL handle, kept across events
        self._sink = None
        # events awaiting their JSONL write: audit() runs on scheduler
        # paths (often under the engine lock), so disk I/O is deferred
        # to flush_sink() on a caller that can afford it; bounded so a
        # flush that never comes can't grow without bound (the sink is
        # best-effort — the ring is the source of truth)
        self._pending: deque = deque(maxlen=16384)
        self._count_lock = threading.Lock()
        self.recorded = 0        # total events ever appended
        _register(self)

    def audit(self, reason: str, rid: Optional[int] = None, **detail):
        """Append one reason-coded decision event. `reason` must be a
        registered code — an unknown code is a programming bug surfaced
        immediately (tests), not a silently-invented vocabulary."""
        if reason not in REASONS:
            raise InvalidArgumentError(
                f"unknown audit reason code {reason!r}; registered: "
                f"{sorted(REASONS)} (add new codes to profiler/audit.py "
                f"REASONS)")
        ev = {"t": time.time(), "engine": self.engine, "reason": reason,
              "rid": rid}
        if detail:
            ev.update(detail)
        self._ring.append(ev)
        with self._count_lock:
            # audit() runs on the step thread AND on submit threads
            # (REJECT_QUEUE_FULL) — an unlocked += loses increments
            self.recorded += 1
        monitor.stat_add("STAT_gen_audit_events")
        path = str(flag("FLAGS_gen_audit_log")).strip()
        if path or self._sink is not None:
            # no I/O here: audit sites often hold the engine lock, and
            # a disk flush under it would stall every submit() caller
            self._pending.append(ev)
        return ev

    def flush_sink(self) -> None:
        """Write every pending event to the JSONL sink (never raises).
        Called OUTSIDE any engine lock: once per iteration by the step
        loop, by a rejecting submit() (the rejecting client pays for
        its own event, not the step thread), and by close()."""
        if not self._pending:
            return
        try:  # the sink is best-effort — never raise
            path = str(flag("FLAGS_gen_audit_log")).strip()
            with self._sink_lock:
                if path != self._sink_path:
                    # flag changed at runtime: swap the handle
                    if self._sink is not None:
                        self._sink.close()
                    self._sink = open(path, "a") if path else None
                    self._sink_path = path or None
                if self._sink is None:
                    self._pending.clear()
                    return
                wrote = False
                while self._pending:
                    ev = self._pending.popleft()
                    self._sink.write(json.dumps(ev, default=str) + "\n")
                    wrote = True
                if wrote:
                    # one flush per batch — the handle stays open (an
                    # open/close or flush per decision would put disk
                    # latency on the scheduler path)
                    self._sink.flush()
        except Exception:
            pass

    def tail(self, n: int = 256) -> List[dict]:
        """Last `n` events, oldest-first (GIL-consistent copy)."""
        evs = list(self._ring)
        return [dict(e) for e in evs[-max(0, int(n)):]]

    def close(self) -> None:
        """Drop the registry entry and release the sink handle (engine
        shutdown; the in-memory ring stays readable)."""
        unregister(self)
        self.flush_sink()
        with self._sink_lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except Exception:
                    pass
                self._sink = None
                self._sink_path = None


# -- registry (flight dumps + /steps read audit tails by engine name) -------

_logs = EngineRegistry()


def _register(log: AuditLog) -> None:
    _logs.register(log.engine, log)


def unregister(log: AuditLog) -> None:
    _logs.unregister(log.engine, log)


def tail_for(engine: str, n: int = 256) -> List[dict]:
    log = _logs.get(engine)
    return log.tail(n) if log is not None else []
