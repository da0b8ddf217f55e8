"""Device telemetry: live device memory, the first-run ledger, MFU gauges.

A lazy periodic sampler (same lifecycle as the flight recorder's counter
sampler: `touch()`d by long-running subsystems, the serving engines and
the `MetricsServer`, so a process that never serves never pays for the
thread) sets, for every CUDA device of the process:

- **live device memory**: torch's caching-allocator bytes in use
  (`torch.cuda.memory_stats(i)["allocated_bytes.all.current"]`, the
  counterpart of the JAX package's `bytes_in_use`) and the card's total
  memory (`torch.cuda.mem_get_info(i)[1]`) as
  `STAT_device<i>_hbm_bytes_in_use` / `STAT_device<i>_hbm_bytes_limit`
  gauges. With no CUDA device (or CUDA never initialised in this
  process) there are no device gauges.
- **FLOPs / MFU**: a caller that knows its train step's FLOPs reports
  them once through `note_train_step_flops()`. The sampler turns the
  `STAT_train_steps` delta per wall interval into achieved FLOP/s and
  divides by the card's peak (table below, or `FLAGS_device_peak_flops`)
  times the participating devices -> `STAT_train_mfu_bp` (basis points).
  Cards the table does not name export no MFU unless the flag is set.
- **first-run ledger**: the serving lanes' exact per-replica counters
  (`Predictor.compile_count`) detect the first run of a (device, bucket)
  pair; `note_compile()` adds that call's dispatch wall to a cumulative
  per-(device, bucket) ledger, exported as `STAT_compile_ms_<key>`
  counters and in `snapshot()` -> `/stats`. The port runs programs
  eagerly, so there is no compile in it: the wall is the first run's
  (the JAX package's is its XLA compile).

All values live in the ordinary monitor registry, so they render as
Prometheus gauges in `/metrics` and as "C" counter tracks in the chrome
trace.
"""
from __future__ import annotations

import threading
import time

import torch

from ..framework import monitor
from ..framework.flags import flag

__all__ = ["touch", "active", "sample", "note_compile",
           "note_train_step_flops", "snapshot", "peak_flops"]

# peak FLOP/s per card by device-name substring, first hit wins: NVIDIA's
# published dense bf16 rate of the H100 (SXM part, 700 W)
_PEAK_TABLE = (
    ("h100", 989e12),
)

_lock = threading.Lock()
_sampler = [None]             # lazy daemon thread, one per process
_flops_per_step = [0.0]       # from the last note_train_step_flops
_train_devices = [1]          # devices participating in that step
_mfu_prev = [None]            # (t, STAT_train_steps) at the last window
_compile_ledger = {}          # (device_key, bucket) -> cumulative seconds
# shortest steps/sec window: every sample() caller (the periodic thread
# and each /metrics scrape) shares one anchor, advanced only after a
# window this long, so a scrape right after a tick cannot measure one
# step over a few milliseconds
_MIN_MFU_WINDOW_S = 0.5


def active() -> bool:
    """True while some subsystem has touch()ed the sampler and the
    interval flag is positive."""
    return (_sampler[0] is not None
            and float(flag("FLAGS_device_telemetry_interval_s")) > 0)


def touch() -> None:
    """Start the sampler thread (idempotent, lazy). It starts even while
    the interval flag is 0: it idles and honours a later set_flags."""
    with _lock:
        if _sampler[0] is None:
            t = threading.Thread(target=_sampler_loop, daemon=True,
                                 name="paddle_tpu_torch-device-telemetry")
            _sampler[0] = t
            t.start()


def _sampler_loop():
    while True:
        iv = float(flag("FLAGS_device_telemetry_interval_s"))
        time.sleep(max(iv, 0.5) if iv > 0 else 5.0)
        if iv > 0:
            try:
                sample()
            except Exception:  # noqa: BLE001 — telemetry never kills
                pass


def peak_flops(index: int) -> float:
    """Peak FLOP/s of CUDA device `index`: the flag override when set,
    else the device-name table; 0.0 = unknown (no MFU gauge)."""
    override = float(flag("FLAGS_device_peak_flops"))
    if override > 0:
        return override
    name = torch.cuda.get_device_name(index).lower()
    for sub, peak in _PEAK_TABLE:
        if sub in name:
            return peak
    return 0.0


def _devices():
    """Indices of the CUDA devices this process has initialised (never
    initialises CUDA itself: a CPU-only process has no device gauges)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return list(range(torch.cuda.device_count()))


def sample() -> dict:
    """Take one telemetry sample, set the gauges, and return it (also
    called at `/metrics` scrape time, so a scrape never reads a value an
    interval old)."""
    out = {"devices": {}, "mfu_bp": None,
           "flops_per_step": int(_flops_per_step[0])}
    devices = _devices()
    peak_total = 0.0
    for i in devices:
        in_use = int(torch.cuda.memory_stats(i).get(
            "allocated_bytes.all.current", 0))
        limit = int(torch.cuda.mem_get_info(i)[1])
        monitor.stat_set(f"STAT_device{i}_hbm_bytes_in_use", in_use)
        monitor.stat_set(f"STAT_device{i}_hbm_bytes_limit", limit)
        out["devices"][str(i)] = {"hbm_bytes_in_use": in_use,
                                  "hbm_bytes_limit": limit}
        peak_total += peak_flops(i)
    steps = monitor.stat_get("STAT_train_steps")
    now = time.perf_counter()
    flops = _flops_per_step[0]
    window = None
    with _lock:
        prev = _mfu_prev[0]
        if prev is None:
            _mfu_prev[0] = (now, steps)
        elif now - prev[0] >= _MIN_MFU_WINDOW_S:
            _mfu_prev[0] = (now, steps)
            window = (now - prev[0], steps - prev[1])
    if flops > 0 and window is not None and devices:
        peak = peak_total / len(devices) * max(1, int(_train_devices[0]))
        if peak > 0:
            dt, dsteps = window
            # an idle trainer decays to 0, not to its last busy window
            out["mfu_bp"] = int(round(flops * max(0, dsteps) / dt
                                      / peak * 10000))
            monitor.stat_set("STAT_train_mfu_bp", out["mfu_bp"])
    return out


def note_train_step_flops(flops: float, n_devices: int = 1) -> None:
    """Record the FLOPs of one train step (counted from its shapes by the
    caller) for the MFU gauge."""
    if flops > 0:
        _flops_per_step[0] = float(flops)
        _train_devices[0] = max(1, int(n_devices))
        monitor.stat_set("STAT_train_step_flops", int(flops))


def note_compile(device_key, bucket, seconds: float) -> None:
    """Add one first run's wall seconds to the cumulative (device,
    bucket) ledger. Called by serving lanes when their exact per-replica
    counters detect the first run of a bucket."""
    key = (str(device_key), bucket)
    with _lock:
        _compile_ledger[key] = _compile_ledger.get(key, 0.0) + seconds
    monitor.stat_add(f"STAT_compile_ms_{device_key}",
                     int(round(seconds * 1000)))


def snapshot() -> dict:
    """The `/stats` section: the first-run ledger per (device, bucket),
    FLOPs and device count of the last reported step, sampler state."""
    with _lock:
        ledger = {f"{dev}/b{bkt}": round(s, 6)
                  for (dev, bkt), s in sorted(_compile_ledger.items())}
    return {"compile_seconds": ledger,
            "flops_per_step": int(_flops_per_step[0]),
            "train_devices": int(_train_devices[0]),
            "sampler_active": active(),
            "interval_s": float(flag("FLAGS_device_telemetry_interval_s"))}
