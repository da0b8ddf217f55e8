"""Crash flight recorder: always-on bounded postmortem context.

Black-box-recorder pattern: the per-thread trace rings (`tracer.py`)
keep recording the last `FLAGS_trace_ring_size` events per thread even
with the profiler stopped (gated by `FLAGS_flight_recorder`, default
on), and a lazy background sampler snapshots the monitor counters every
`FLAGS_flight_recorder_interval_s`. When one of the generation
engine's failure paths fires (engine death `gen_engine_death`, a
poisoned sequence `gen_poisoned_sequence`, allocator exhaustion
`gen_allocator_exhausted`, each with its step-log and audit tails),
`dump(reason, extra)` writes one JSON artifact with the tail of the
merged event timeline (real tids + thread names), the counter-sample
history, and a final consistent counter/histogram snapshot, so the
exception the caller sees comes with the seconds of runtime context
that led up to it. `dump` never raises (it sits on failure paths) and
prunes itself to `FLAGS_flight_recorder_max_dumps` files per process.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Optional

from ..framework.flags import flag
from . import tracer

__all__ = ["enabled", "dump", "touch", "dump_dir", "last_dumps",
           "dump_records"]

_lock = threading.Lock()
_dumps = []            # {"path","reason","wall_time"} records, oldest first
_seq = [0]
_sampler = [None]      # the lazy background counter-sampler thread


def enabled() -> bool:
    return bool(flag("FLAGS_flight_recorder"))


def dump_dir() -> str:
    d = str(flag("FLAGS_flight_recorder_dir")).strip()
    if not d:
        d = os.path.join(tempfile.gettempdir(), "paddle_tpu_flightrec")
    return d


def last_dumps():
    """Paths of the dumps written by this process, oldest first."""
    with _lock:
        return [r["path"] for r in _dumps]


def dump_records():
    """`{path, reason, wall_time}` summaries of this process's dumps,
    oldest first — the `/stats` postmortem index, so an operator sees
    recent failures without filesystem access."""
    with _lock:
        return [dict(r) for r in _dumps]


def _sampler_loop():
    while True:
        iv = float(flag("FLAGS_flight_recorder_interval_s"))
        time.sleep(max(iv, 0.25) if iv > 0 else 5.0)
        if enabled() and iv > 0:
            try:
                tracer.sample_counters()
            except Exception:
                pass


def touch() -> None:
    """Start the periodic counter sampler (idempotent, lazy). Called by
    the long-running subsystems the recorder covers — serving engines,
    `Model.fit`, the multiprocess DataLoader — so a process that never
    uses them never pays for the thread."""
    if not enabled() or float(flag("FLAGS_flight_recorder_interval_s")) <= 0:
        return
    with _lock:
        if _sampler[0] is None:
            t = threading.Thread(target=_sampler_loop, daemon=True,
                                 name="paddle_tpu_torch-flightrec-sampler")
            _sampler[0] = t
            t.start()


def dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Write one postmortem artifact; returns its path (None when the
    recorder is off or the write failed — this sits on failure paths and
    must never raise over the exception it documents)."""
    if not enabled():
        return None
    try:
        from ..framework import monitor
        tracer.instant(f"flightrec::{reason}")
        # bounded tail, not a full-store merge: this runs inline on
        # failure paths (e.g. between a poisoned batch and its
        # per-request reruns), so co-rider requests must not wait on a
        # sort of every ring
        evs = tracer.tail_events(int(flag("FLAGS_flight_recorder_events")))
        record = {
            "reason": reason,
            "wall_time": time.time(),
            "perf_time": time.perf_counter(),
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
            "extra": extra or {},
            "stats": monitor.all_stats(),
            "histograms": monitor.all_histograms(),
            "counter_samples": [
                {"t": t, "stats": snap}
                for t, snap in tracer.counter_samples()[-64:]],
            "ring": tracer.ring_stats(),
            "events": [
                {"name": name, "ph": ph, "ts_us": t0 * 1e6,
                 "dur_us": (t1 - t0) * 1e6, "tid": track,
                 "os_tid": os_tid, "thread": tname}
                for name, ph, t0, t1, track, os_tid, tname in evs],
        }
        d = dump_dir()
        os.makedirs(d, exist_ok=True)
        with _lock:
            _seq[0] += 1
            path = os.path.join(
                d, f"flightrec-{os.getpid()}-{_seq[0]:03d}-{reason}.json")
            with open(path, "w") as f:
                json.dump(record, f, default=str)
            _dumps.append({"path": path, "reason": reason,
                           "wall_time": record["wall_time"]})
            keep = max(1, int(flag("FLAGS_flight_recorder_max_dumps")))
            while len(_dumps) > keep:
                old = _dumps.pop(0)
                try:
                    os.remove(old["path"])
                except OSError:
                    pass
        monitor.stat_add("STAT_flight_recorder_dumps")
        sys.stderr.write(f"[paddle_tpu_torch] flight recorder: {reason} -> "
                         f"{path}\n")
        return path
    except Exception:
        return None
