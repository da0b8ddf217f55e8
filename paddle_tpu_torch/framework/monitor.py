"""Process-wide STAT counters, gauges and latency histograms.

The subset of `paddle_tpu.framework.monitor` the ported slices write:

- serving: `STAT_kv_pages_inuse`, the `STAT_gen_*` family, and
  `STAT_paged_attn_kernel` / `STAT_paged_attn_reference`, which here
  count CALLS (PyTorch runs eagerly; there are no traces to count);
- flash attention: `STAT_flash_attention_fwd` counts launches of the
  forward kernel, `STAT_flash_attention_bwd` launches of the two backward
  kernels (dQ and dK/dV, so two per backward pass); the plain CPU path
  counts nothing;
- splash attention: `STAT_splash_attention_fwd` / `_bwd` count kernel
  launches as the flash counters do, `STAT_splash_dispatches` the
  `F.scaled_dot_product_attention(segment_ids=...)` calls routed to
  splash attention (CPU tensors included);
- `STAT_attention_wide_head_fallback` (the port's own): flash or splash
  gate calls refused only because the head dim lies in (256, 512], which
  the JAX package's kernels take and K2-K7 are not built for;
- int8 KV pages: `STAT_kv_quant_writes` / `STAT_kv_quant_reads` count
  calls of `paged_write_quantized` / `paged_gather_quantized` (the JAX
  package counts traces);
- packing (`io.PackingCollator`): `STAT_packing_packs`,
  `STAT_packing_sequences`, `STAT_packing_tokens` (real),
  `STAT_packing_slots` (rows * max_tokens), `STAT_packing_fill_ratio_pct`
  (cumulative per-pack percentage: divide by `STAT_packing_packs` for
  the mean fill), `STAT_packing_dropped_seqs`,
  `STAT_packing_truncated_seqs`; and `STAT_tail_pad_batches`, which the
  JAX package bumps for each row-padded tail batch. The port pads no
  rows, so it stays 0 (tests read it as the JAX tests do);
- training (`hapi.Model`): `STAT_train_steps`, `STAT_train_step_ns` (host
  wall time of `train_batch`, which returns before the device finishes)
  and `STAT_train_host_syncs` (losses fit forced to a host float)."""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict

__all__ = ["stat_add", "stat_sub", "stat_get", "stat_set", "register_gauge",
           "is_gauge_name", "histogram"]

_lock = threading.Lock()
_stats: Dict[str, int] = {}
_gauges: Dict[str, bool] = {}      # name -> updown
_hists: Dict[str, "StatHistogram"] = {}


def register_gauge(name: str, updown: bool = False) -> None:
    """Declare `name` a gauge (a level, not a monotonic counter);
    `updown` gauges move both ways through stat_add/stat_sub."""
    with _lock:
        _gauges[name] = bool(updown)


def is_gauge_name(name: str) -> bool:
    return name in _gauges


def stat_add(name: str, n: int = 1) -> int:
    with _lock:
        v = _stats[name] = _stats.get(name, 0) + int(n)
        return v


def stat_sub(name: str, n: int = 1) -> int:
    return stat_add(name, -int(n))


def stat_set(name: str, v: int) -> int:
    with _lock:
        _stats[name] = int(v)
        return int(v)


def stat_get(name: str) -> int:
    with _lock:
        return _stats.get(name, 0)


class StatHistogram:
    """Latency histogram over fixed log-spaced buckets (ms), with
    count/sum/min/max and bucket-interpolated percentiles."""

    # 0.01 ms .. ~1e5 ms, 8 buckets per decade
    _EDGES = [10 ** (e / 8.0) for e in range(-16, 41)]

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._EDGES) + 1)
            self._n = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self._EDGES, v)] += 1
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._n:
                return 0.0
            rank = p / 100.0 * self._n
            seen = 0
            for i, c in enumerate(self._counts):
                if c and seen + c >= rank:
                    lo = self._EDGES[i - 1] if i > 0 else self._min
                    hi = self._EDGES[i] if i < len(self._EDGES) else self._max
                    lo, hi = max(lo, self._min), min(hi, self._max)
                    return lo + (hi - lo) * (rank - seen) / c
                seen += c
            return self._max

    def snapshot(self) -> Dict[str, float]:
        n = self._n
        return {"count": n, "sum": self._sum,
                "mean": self._sum / n if n else 0.0,
                "min": self._min if n else 0.0,
                "max": self._max if n else 0.0,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


def histogram(name: str) -> StatHistogram:
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = StatHistogram(name)
        return h
