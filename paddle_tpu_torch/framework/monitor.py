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
  and `STAT_train_host_syncs` (losses fit forced to a host float);
- supervised restart and degraded modes: `STAT_gen_restarts`,
  `STAT_gen_replay_ms` (cumulative ms of death handling: rebuild and
  replay), `STAT_gen_replayed_requests`, `STAT_gen_breaker_open`,
  `STAT_gen_degraded_spec_off`, `STAT_gen_admit_clamped`;
- the router: `STAT_router_requests`, `STAT_router_affinity_hits`,
  `STAT_router_affinity_pages`, `STAT_router_least_pressure`,
  `STAT_router_reroutes`, `STAT_router_drains`,
  `STAT_router_pressure_refreshes`;
- residency gauges: `STAT_kv_cache_hbm_bytes`, the pool (and scale-pool)
  bytes of every live `serving.PagedKVCache`, added at construction and
  subtracted when the cache is collected (`stat_gauge_add`).

Gauges come in two kinds, as in the JAX package: "level" (an absolute
level; `stat_set` and `stat_gauge_add` mark their names so) and
"updown" (a counter that moves both ways, registered by its owner). The
exporter renders both as Prometheus gauges (`gauge_kind`)."""
from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Dict

__all__ = ["stat_add", "stat_sub", "stat_get", "stat_set", "stat_gauge_add",
           "stat_gauge_add_later", "register_gauge", "gauge_kind",
           "is_gauge_name", "histogram", "all_stats", "all_histograms",
           "registered_histograms"]

_lock = threading.Lock()
_stats: Dict[str, int] = {}
_gauges: Dict[str, str] = {}       # name -> "level" | "updown"
_hists: Dict[str, "StatHistogram"] = {}
# gauge deltas from weakref.finalize callbacks: a finalizer runs wherever
# a garbage collection starts, possibly inside a locked section below on
# the same thread, so it must not take _lock; it queues its delta here (a
# deque append takes no lock) and the next locked call applies it
_later: deque = deque()


def _apply_later() -> None:
    # caller holds _lock
    while _later:
        name, n = _later.popleft()
        _stats[name] = _stats.get(name, 0) + n
        _note_level_gauge(name)


def register_gauge(name: str, updown: bool = False) -> None:
    """Declare `name` a gauge (a level, not a monotonic counter);
    `updown` gauges move both ways through stat_add/stat_sub."""
    with _lock:
        _gauges[name] = "updown" if updown else "level"


def _note_level_gauge(name: str) -> None:
    # caller holds _lock; an explicit updown registration wins
    if _gauges.get(name) != "updown":
        _gauges[name] = "level"


def gauge_kind(name: str):
    """"level" / "updown" / None (a plain monotone counter)."""
    with _lock:
        _apply_later()
        return _gauges.get(name)


def is_gauge_name(name: str) -> bool:
    """Should `name` render as a Prometheus gauge?"""
    return gauge_kind(name) is not None


def stat_add(name: str, n: int = 1) -> int:
    with _lock:
        _apply_later()
        v = _stats[name] = _stats.get(name, 0) + int(n)
        return v


def stat_sub(name: str, n: int = 1) -> int:
    return stat_add(name, -int(n))


def stat_set(name: str, v: int) -> int:
    """Set an absolute level (marks `name` a level gauge)."""
    with _lock:
        _apply_later()
        _stats[name] = int(v)
        _note_level_gauge(name)
        return int(v)


def stat_gauge_add(name: str, n: int) -> int:
    """Move a level gauge by a (possibly negative) delta: residency
    gauges whose owners add on construction and subtract on teardown."""
    with _lock:
        _apply_later()
        v = _stats[name] = _stats.get(name, 0) + int(n)
        _note_level_gauge(name)
        return v


def stat_gauge_add_later(name: str, n: int) -> None:
    """`stat_gauge_add` for a weakref.finalize callback: takes no lock
    (see `_later`); every later monitor call sees the delta applied."""
    _later.append((name, int(n)))


def all_stats() -> Dict[str, int]:
    """Snapshot of every counter and gauge, sorted by name."""
    with _lock:
        _apply_later()
        return dict(sorted(_stats.items()))


def stat_get(name: str) -> int:
    with _lock:
        _apply_later()
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

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def buckets(self):
        """Cumulative `[(upper_bound, cumulative_count)]`, ending with
        `(inf, count)`: the shape of a Prometheus `_bucket{le=...}`
        series."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for i, c in enumerate(counts):
            cum += c
            out.append((self._EDGES[i] if i < len(self._EDGES)
                        else float("inf"), cum))
        return out

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


def all_histograms() -> Dict[str, Dict[str, float]]:
    """`{name: snapshot}` of every histogram, sorted by name."""
    with _lock:
        items = sorted(_hists.items())
    return {n: h.snapshot() for n, h in items}


def registered_histograms() -> Dict[str, StatHistogram]:
    """The live histogram objects (the exporter renders `buckets()`)."""
    with _lock:
        return dict(_hists)
