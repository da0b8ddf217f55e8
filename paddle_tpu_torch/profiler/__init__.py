"""Profiler (reference `paddle/fluid/platform/profiler.h:127` RecordEvent /
`:210` EnableProfiler, CUPTI `device_tracer.h`, Python `fluid/profiler.py`).

Port of `paddle_tpu.profiler`. RecordEvent scopes wrap host-side work;
on a CUDA build each scope also pushes an NVTX range
(`torch.cuda.nvtx.range_push`/`range_pop`), so its name shows in an
Nsight timeline. The device side is `torch.profiler`: `Profiler(log_dir)`
runs a `torch.profiler.profile` session (CPU and, on the card, CUDA
activities) that writes a Chrome trace into `log_dir`. Host events land
in a thread-aware bounded trace store (`tracer.py` — per-thread rings,
real tids and thread names), so one `export_chrome_tracing` file renders
the engine's step thread and its callers as separate named tracks, plus
"C" counter tracks sampled from `framework.monitor`. The same store feeds the crash flight recorder
(`flight_recorder.py`) and the live `/trace` endpoint
(`exporter.MetricsServer`). The reference's summary table is reproduced
from host timings via `summary()` — `stop_profiler` returns rows and
never prints.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from typing import Optional

import torch

from . import tracer

__all__ = ["RecordEvent", "Profiler", "profiler", "start_profiler",
           "stop_profiler", "export_chrome_tracing", "summary"]


_nvtx = []   # [bool]: NVTX ranges available (a CUDA build), probed once


def _nvtx_on() -> bool:
    if not _nvtx:
        _nvtx.append(torch.cuda.is_available())
    return _nvtx[0]


class RecordEvent:
    """RAII scope (reference platform/profiler.h RecordEvent). Usable as a
    context manager or decorator; on a CUDA build it also pushes an NVTX
    range so the name shows up in an Nsight trace. Events are recorded
    into the calling thread's own ring with its real tid/thread name."""

    def __init__(self, name: str):
        self.name = name
        # a stack, not a scalar: one RecordEvent instance may be entered
        # re-entrantly (recursive decorated function, nested `with ev:`)
        self._t0s = []

    def __enter__(self):
        self.begin()
        return self

    def begin(self):
        self._t0s.append(time.perf_counter())
        if _nvtx_on():
            torch.cuda.nvtx.range_push(self.name)

    def end(self):
        """Close the innermost open scope. Safe to call when none is open
        (idempotent tail call), and pops the NVTX range even if host-side
        bookkeeping raises."""
        if not self._t0s:
            return
        t0 = self._t0s.pop()
        try:
            tracer.record_complete(self.name, t0, time.perf_counter())
        finally:
            if _nvtx_on():
                torch.cuda.nvtx.range_pop()

    def __exit__(self, *exc):
        # runs on the exception path too — the scope must not leak an open
        # NVTX range or a dangling _t0 when the body raises
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        return wrapper


def start_profiler(state="All", tracer_option="Default"):
    tracer.enable()


def _aggregate(events):
    """[(name, t0, t1)] → rows sorted by total ms:
    (name, [calls, total_ms, min_ms, max_ms])."""
    agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    for name, t0, t1 in events:
        dt = (t1 - t0) * 1000
        a = agg[name]
        a[0] += 1
        a[1] += dt
        a[2] = min(a[2], dt)
        a[3] = max(a[3], dt)
    return sorted(agg.items(), key=lambda kv: -kv[1][1])


def summary(rows=None, sorted_key="total", file=None) -> str:
    """Format the reference profiler's event table. `rows` defaults to
    the current session's aggregation; writes to `file` when given (pass
    `sys.stdout` for the old print behavior) and returns the string."""
    if rows is None:
        rows = _aggregate(tracer.events(since=tracer.session_start()))
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min':>10}"
             f"{'Max':>10}{'Ave':>10}"]
    for name, (calls, total, mn, mx) in rows:
        lines.append(f"{name:<40}{calls:>8}{total:>12.3f}{mn:>10.3f}"
                     f"{mx:>10.3f}{total / max(calls, 1):>10.3f}")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text


def stop_profiler(sorted_key="total", profile_path=None, file=None):
    """End the profiling session and return the aggregated rows. Quiet by
    default (library users and pytest runs stay clean); pass
    `file=sys.stdout` — or call `summary()` — for the table."""
    events = tracer.events(since=tracer.session_start())
    tracer.sample_counters()
    tracer.disable()
    rows = _aggregate(events)
    if file is not None:
        summary(rows, sorted_key, file)
    if profile_path:
        export_chrome_tracing(profile_path)
    return rows


def export_chrome_tracing(path: str):
    """chrome://tracing json of host events: named per-thread tracks plus
    counter tracks (reference profiler chrome trace export merged with
    device_tracer-style per-stream lanes)."""
    tracer.sample_counters()  # at least one sample → counter tracks render
    since = tracer.session_start() or None
    trace = tracer.chrome_trace(since=since)
    from . import step_log
    trace["traceEvents"].extend(step_log.chrome_counter_events(since))
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profiler(state="All", tracer_option="Default", profile_path=None,
             sorted_key="total", file=None):
    """fluid.profiler.profiler context manager. Pass `file=sys.stdout`
    to print the summary table on exit (the old unconditional print is
    gone — see `summary()`)."""
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path, file=file)


class Profiler:
    """paddle.profiler.Profiler 2.x-style wrapper. With `log_dir` it also
    runs a `torch.profiler.profile` session (CPU activity, plus CUDA on a
    CUDA build) and writes its Chrome trace to
    `log_dir/torch_trace_<pid>.json` at `stop()`.

    `step()` is a real step marker: it closes a `ProfilerStep#N` scope on
    the calling thread and snapshots the monitor counters, so the chrome
    trace shows step boundaries and live counter tracks."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._torch_prof = None
        self._step_n = 0
        self._step_t0 = None

    def start(self):
        start_profiler()
        self._step_n = 0
        self._step_t0 = time.perf_counter()
        if self.log_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._torch_prof = torch.profiler.profile(activities=acts)
            self._torch_prof.__enter__()
        return self

    def stop(self):
        if self._torch_prof is not None:
            prof, self._torch_prof = self._torch_prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.log_dir, f"torch_trace_{os.getpid()}.json"))
        self.step()  # close the open ProfilerStep scope
        self._step_t0 = None
        stop_profiler()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def step(self):
        """Mark a train-step boundary: one `ProfilerStep#N` scope since
        the previous call plus a counter snapshot."""
        t = time.perf_counter()
        if self._step_t0 is not None:
            tracer.record_complete(f"ProfilerStep#{self._step_n}",
                                   self._step_t0, t)
            self._step_n += 1
        self._step_t0 = t
        tracer.sample_counters()

    def summary(self, sorted_key="total", file=None, **kwargs):
        return summary(sorted_key=sorted_key,
                       file=file if file is not None else sys.stdout)
