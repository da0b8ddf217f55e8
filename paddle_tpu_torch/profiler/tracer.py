"""Thread-aware bounded trace store (reference `platform/profiler.h`:
per-thread `EventList` + `GetEventList()` thread_local, merged at export
— the same structure CUPTI's `device_tracer` merges device streams
into).

Each thread owns ONE bounded ring buffer; appends touch only
thread-local state (no lock on the hot path — the ring is created once
per thread and registered under a lock, after which the owning thread is
the only writer). Readers (chrome export, the flight recorder, the
`/trace` endpoint) take a best-effort snapshot: under the GIL a list
copy is always well-formed, at worst missing the very newest events.

Recording is active whenever the profiler is started *or* the flight
recorder flag is on (the default), so a crash dump always has recent
context; memory stays bounded at `FLAGS_trace_ring_size` events per
thread — the ring overwrites its oldest events instead of growing.

Counter samples are a separate (small, locked) ring of
`(t, {stat: value})` snapshots taken by `Profiler.step()`, the flight
recorder's periodic sampler, and chrome export — they render as "C"
phase counter tracks in chrome://tracing.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..framework.flags import flag

# event: (name, ph, t0, t1) — ph "X" = complete scope, "i" = instant,
# "s#<id>"/"t#<id>"/"f#<id>" = chrome flow start/step/finish carrying the
# flow id (per-request spans link a submit scope to its lane's
# dispatch/complete scopes across threads).
_Event = Tuple[str, str, float, float]

_MAX_RINGS = 512        # bound on remembered threads (oldest evicted)
_COUNTER_CAP = 4096     # bound on counter samples

_registry_lock = threading.Lock()
_rings: List["_Ring"] = []
_next_track = [1]       # chrome tid allocator (0 = counter track)

_counter_lock = threading.Lock()
_counter_samples: List[Tuple[float, Dict[str, int]]] = []

_profiler_enabled = False
_t_start = 0.0          # perf_counter at the last start_profiler()


class _Ring:
    """One thread's bounded event ring. Only the owning thread appends."""

    __slots__ = ("os_tid", "track", "thread_name", "cap", "buf", "idx",
                 "overwritten", "_thread_ref")

    def __init__(self, thread, cap: int):
        self.os_tid = thread.ident
        self.thread_name = thread.name
        self.cap = max(1, int(cap))
        self.buf: List[_Event] = []
        self.idx = 0            # oldest slot once the ring is full
        self.overwritten = 0
        # weakref: liveness probe for registry eviction without keeping
        # dead Thread objects reachable
        import weakref
        self._thread_ref = weakref.ref(thread)

    def alive(self) -> bool:
        t = self._thread_ref()
        return t is not None and t.is_alive()

    def append(self, ev: _Event) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(ev)
        else:
            self.buf[self.idx] = ev
            self.idx = (self.idx + 1) % self.cap
            self.overwritten += 1

    def snapshot(self) -> List[_Event]:
        buf = list(self.buf)    # atomic-enough copy under the GIL
        idx = self.idx
        if len(buf) < self.cap or idx == 0:
            return buf
        return buf[idx:] + buf[:idx]


class _Local(threading.local):
    ring: Optional[_Ring] = None


_local = _Local()


def _my_ring() -> _Ring:
    r = _local.ring
    if r is None:
        t = threading.current_thread()
        r = _Ring(t, int(flag("FLAGS_trace_ring_size")))
        with _registry_lock:
            r.track = _next_track[0]
            _next_track[0] += 1
            _rings.append(r)
            if len(_rings) > _MAX_RINGS:
                # evict oldest DEAD rings only: a live thread keeps
                # appending through its thread-local reference, and
                # unregistering it would silently drop its events from
                # every export (the exact bug this store exists to fix).
                # Recently-dead rings stay while there is room — their
                # events are postmortem context. Only a pathological
                # >_MAX_RINGS *live* threads can still overflow, in
                # which case the registry grows with them.
                overflow = len(_rings) - _MAX_RINGS
                i = 0
                while overflow > 0 and i < len(_rings) - 1:
                    if not _rings[i].alive():
                        del _rings[i]
                        overflow -= 1
                    else:
                        i += 1
        _local.ring = r
    return r


def _active() -> bool:
    return _profiler_enabled or bool(flag("FLAGS_flight_recorder"))


# -- recording -------------------------------------------------------------

def record_complete(name: str, t0: float, t1: float) -> None:
    """One closed scope on the calling thread (perf_counter seconds)."""
    if _active():
        _my_ring().append((name, "X", t0, t1))


def instant(name: str, t: Optional[float] = None) -> None:
    """One instant marker on the calling thread (step boundaries,
    flight-recorder notes)."""
    if _active():
        t = time.perf_counter() if t is None else t
        _my_ring().append((name, "i", t, t))


def flow(name: str, ph: str, flow_id: int, t: Optional[float] = None) -> None:
    """One chrome flow event on the calling thread: ph "s" (start), "t"
    (step) or "f" (finish). Events with the same id render as arrows
    linking the enclosing slices across threads — emit INSIDE the scope
    the arrow should attach to."""
    if ph not in ("s", "t", "f"):
        raise ValueError(f"flow ph must be s/t/f, got {ph!r}")
    if _active():
        t = time.perf_counter() if t is None else t
        _my_ring().append((name, f"{ph}#{int(flow_id)}", t, t))


def sample_counters(names=None) -> None:
    """Append one `(t, {stat: value})` snapshot of the monitor counters
    to the bounded counter-sample ring."""
    if not _active():
        return
    from ..framework import monitor
    snap = monitor.all_stats()
    if names is not None:
        names = set(names)
        snap = {k: v for k, v in snap.items() if k in names}
    with _counter_lock:
        _counter_samples.append((time.perf_counter(), snap))
        if len(_counter_samples) > _COUNTER_CAP:
            del _counter_samples[: len(_counter_samples) - _COUNTER_CAP]


# -- profiler session ------------------------------------------------------

def enable() -> None:
    global _profiler_enabled, _t_start
    _t_start = time.perf_counter()
    _profiler_enabled = True


def disable() -> None:
    global _profiler_enabled
    _profiler_enabled = False


def profiler_enabled() -> bool:
    return _profiler_enabled


def session_start() -> float:
    return _t_start


def clear() -> None:
    """Drop every recorded event and counter sample (tests)."""
    with _registry_lock:
        for r in _rings:
            r.buf = []
            r.idx = 0
            r.overwritten = 0
    with _counter_lock:
        del _counter_samples[:]


# -- reading ---------------------------------------------------------------

def _ring_list() -> List[_Ring]:
    with _registry_lock:
        return list(_rings)


def events(since: Optional[float] = None, with_threads: bool = False):
    """Flat event list across every thread, oldest-first.

    with_threads=False → [(name, t0, t1)] of complete scopes only (what
    `summary` aggregates); with_threads=True →
    [(name, ph, t0, t1, track, os_tid, thread_name)].
    """
    out = []
    for r in _ring_list():
        for name, ph, t0, t1 in r.snapshot():
            if since is not None and t0 < since:
                continue
            if with_threads:
                out.append((name, ph, t0, t1, r.track, r.os_tid,
                            r.thread_name))
            elif ph == "X":
                out.append((name, t0, t1))
    out.sort(key=lambda e: e[-5] if with_threads else e[1])
    return out


def tail_events(n: int):
    """The ~n most recent events across all threads, oldest-first, in
    the `with_threads` tuple shape — bounded work (each ring contributes
    at most n events, one sort) so failure-path dumps stay cheap even
    with large rings and many threads."""
    out = []
    for r in _ring_list():
        for name, ph, t0, t1 in r.snapshot()[-n:] if n > 0 else []:
            out.append((name, ph, t0, t1, r.track, r.os_tid,
                        r.thread_name))
    out.sort(key=lambda e: e[3])  # by scope end time
    return out[-n:] if n > 0 else out


def counter_samples(since: Optional[float] = None):
    with _counter_lock:
        samples = list(_counter_samples)
    if since is not None:
        samples = [s for s in samples if s[0] >= since]
    return samples


def ring_stats() -> dict:
    rings = _ring_list()
    return {"threads": len(rings),
            "events": sum(len(r.buf) for r in rings),
            "overwritten": sum(r.overwritten for r in rings),
            "ring_capacity": int(flag("FLAGS_trace_ring_size"))}


def chrome_trace(since: Optional[float] = None) -> dict:
    """chrome://tracing JSON object: per-thread named tracks (metadata
    "M" events carry real thread names), "X" scopes with real tids, "i"
    markers, and "C" counter tracks from the sampled monitor stats."""
    pid = os.getpid()
    trace = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
              "args": {"name": f"paddle_tpu_torch (pid {pid})"}}]
    for r in _ring_list():
        evs = [e for e in r.snapshot()
               if since is None or e[2] >= since]
        if not evs:
            continue
        trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                      "tid": r.track, "args": {"name": r.thread_name}})
        trace.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                      "tid": r.track, "args": {"sort_index": r.track}})
        for name, ph, t0, t1 in evs:
            if ph == "X":
                trace.append({"name": name, "ph": "X", "pid": pid,
                              "tid": r.track, "ts": t0 * 1e6,
                              "dur": (t1 - t0) * 1e6})
            elif "#" in ph:
                p, fid = ph.split("#", 1)
                ev = {"name": name, "cat": "serving", "ph": p,
                      "id": int(fid), "pid": pid, "tid": r.track,
                      "ts": t0 * 1e6}
                if p == "f":
                    ev["bp"] = "e"  # bind to enclosing slice's end
                trace.append(ev)
            else:
                trace.append({"name": name, "ph": "i", "s": "t",
                              "pid": pid, "tid": r.track, "ts": t0 * 1e6})
    # counter tracks: one "C" series per stat that is ever nonzero in
    # the sampled window (all-zero tracks are noise, not signal)
    samples = counter_samples(since)
    live = sorted({n for _, snap in samples for n, v in snap.items() if v})
    for t, snap in samples:
        for n in live:
            if n in snap:
                trace.append({"name": n, "ph": "C", "pid": pid, "tid": 0,
                              "ts": t * 1e6, "args": {"value": snap[n]}})
    return {"traceEvents": trace,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "paddle_tpu_torch.profiler"}}
