"""Per-request latency attribution for the generation engine.

A `GenSpan` is assigned at `GenerationEngine.submit()` and rides the
request through slot admission, prefill and every decode step; each
stage stamps one monotonic phase timestamp (`GEN_PHASES`). On resolve
the stamps feed the process-global `ttft_ms` / `tpot_ms` histograms and
the rolling-window SLO samples (`slo.py`), and drop one self-contained
`reqspan:` instant into the trace ring, which `tools/latency_report.py`
reads offline from an exported trace. Chrome flow events (`gen_request`,
and `fleet_request` keyed by the trace id) link a request's scopes
across threads in the timeline.

Spans on timed-out or failed requests are abandoned (no histogram
samples: the phase latencies describe delivered work) but still appear
in flight-recorder dumps as the dying engine's in-flight spans.

Everything is gated by `FLAGS_serving_spans` (default on); the cost per
request is a handful of `perf_counter()` calls, dict stores and bounded
ring appends. The one-shot `InferenceEngine`'s pipeline spans come with
that engine (a later slice).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ..framework import monitor
from ..framework.flags import flag
from . import tracer

__all__ = ["enabled", "GenSpan", "start_gen", "GEN_PHASES"]

_next_id = itertools.count(1)
_hists_lock = threading.Lock()


def enabled() -> bool:
    return bool(flag("FLAGS_serving_spans"))


# -- generation spans (continuous-batching token latency) -------------------
#
# A generative request's latency story is not the serving pipeline's
# queue/pad/device/resolve: what operators tune against is **TTFT**
# (time to first token — queue + prefill) and **TPOT** (time per output
# token — the steady decode cadence). A GenSpan rides a
# GenerationEngine request through submit → slot admission → prefill →
# every decode step, and on resolve feeds two process-global histograms
# that telescope into the existing end-to-end accounting:
#
#     ttft_ms + (n_tokens - 1) * tpot_ms  ==  queued → last_token
#
# with the engine's own `<name>_request_ms` histogram carrying the full
# queued → resolved wall (the resolve tail is host bookkeeping). Each
# resolved request also drops one self-contained `reqspan:` instant
# (slot-flavored: `reqspan:<rid>:<engine>:slot<k>:n=<tok>:
# ttft=…,tpot=…,e=…,pfx=<hit>`, `pfx` = prompt tokens served from the
# prefix cache) so `tools/latency_report.py` reconstructs TTFT/TPOT
# p50/p99 and slowest-request offenders offline from an exported trace.

GEN_PHASES = ("queued", "admitted", "prefilled", "first_token",
              "last_token", "resolved")

_gen_hists = None


def _gen_phase_hists():
    global _gen_hists
    if _gen_hists is None:
        with _hists_lock:
            if _gen_hists is None:
                # literal names: the check_stats lint reads these
                _gen_hists = (monitor.histogram("ttft_ms"),
                              monitor.histogram("tpot_ms"))
    return _gen_hists


class GenSpan:
    """One generative request's token clock (single-writer: the engine's
    step thread owns every stamp after `queued`). `prefix_tokens` is the
    count of prompt tokens served from cached prefix pages: it rides
    the reqspan instant (`pfx=`) so offline TTFT attribution can split
    hit from miss requests. `spec_tokens` is the count of accepted
    speculative draft tokens (`acc=`). `trace_id` is the 16-hex trace
    id: it rides the instant as `tid=` and is re-emitted as
    cross-process-stable `fleet_request` flow events."""

    __slots__ = ("rid", "engine", "slot", "stamps", "prefix_tokens",
                 "spec_tokens", "incarnation", "trace_id")

    def __init__(self, engine: str, incarnation: int = 0,
                 trace_id: Optional[str] = None):
        self.rid = next(_next_id)
        self.engine = engine
        self.slot: Optional[int] = None
        self.stamps = {}
        self.prefix_tokens = 0
        self.spec_tokens = 0
        # which engine generation served this request (a supervised
        # restart bumps it); rides the reqspan as `inc=`
        self.incarnation = int(incarnation)
        # trace id; None when propagation is off
        self.trace_id = trace_id

    def stamp(self, phase: str, t: Optional[float] = None) -> None:
        self.stamps[phase] = time.perf_counter() if t is None else t

    def flow(self, ph: str) -> None:
        tracer.flow("gen_request", ph, self.rid)

    def fleet_flow(self, ph: str) -> None:
        """Emit the fleet-wide flow event for this request's trace id —
        the flow id is derived from the 16-hex id itself, so every
        process that handled the same request emits under the same id
        and the merged timeline draws one chain."""
        if self.trace_id is None:
            return
        from . import trace_context
        tracer.flow("fleet_request", ph, trace_context.flow_id(self.trace_id))

    def finish(self, n_tokens: int,
               prefix_tokens: Optional[int] = None,
               spec_tokens: Optional[int] = None) -> None:
        """Called once per DELIVERED request after `resolved` is
        stamped: feed ttft_ms/tpot_ms and drop the reqspan instant."""
        if prefix_tokens is not None:
            self.prefix_tokens = int(prefix_tokens)
        if spec_tokens is not None:
            self.spec_tokens = int(spec_tokens)
        s = self.stamps
        if "queued" not in s or "first_token" not in s:
            return
        ttft_h, tpot_h = _gen_phase_hists()
        ttft = (s["first_token"] - s["queued"]) * 1000.0
        last = s.get("last_token", s["first_token"])
        tpot = ((last - s["first_token"]) * 1000.0
                / max(1, n_tokens - 1)) if n_tokens > 1 else 0.0
        ttft_h.observe(max(0.0, ttft))
        if n_tokens > 1:
            tpot_h.observe(max(0.0, tpot))
        # rolling-window SLO samples ride the same resolve path (no-ops
        # until an FLAGS_slo_* objective is configured)
        from . import slo
        slo.observe_ttft(self.engine, max(0.0, ttft))
        if n_tokens > 1:
            slo.observe_tpot(self.engine, max(0.0, tpot))
        e2e = (s.get("resolved", last) - s["queued"]) * 1000.0
        # pfx/acc ride the VALUES segment (after e=) so the colon-
        # separated head keeps its field count — downstream parsers
        # split on ":", and each appended value is regex-optional so
        # older traces (and older parsers) keep working both ways
        tid = f",tid={self.trace_id}" if self.trace_id else ""
        tracer.instant(
            f"reqspan:{self.rid}:{self.engine}:slot{self.slot}:"
            f"n={n_tokens}:ttft={ttft:.3f},tpot={tpot:.3f},e={e2e:.3f},"
            f"pfx={self.prefix_tokens},acc={self.spec_tokens},"
            f"inc={self.incarnation}{tid}",
            t=s.get("resolved", last))
        self.fleet_flow("f")

    def to_dict(self) -> dict:
        now = time.perf_counter()
        return {"rid": self.rid, "engine": self.engine, "slot": self.slot,
                "phases": dict(self.stamps),
                "age_ms": round((now - self.stamps["queued"]) * 1000.0, 3)
                if "queued" in self.stamps else None}


def start_gen(engine: str, incarnation: int = 0,
              trace_id: Optional[str] = None,
              trace_root: bool = True) -> Optional[GenSpan]:
    """GenSpan for one accepted generative request (None when spans are
    off — same FLAGS_serving_spans gate as the serving pipeline).

    `trace_root=False` means an upstream hop (the Router) already
    opened the fleet flow chain for `trace_id`, so admission emits a
    flow STEP ("t"); a locally-minted id opens the chain here ("s")."""
    if not enabled():
        return None
    span = GenSpan(engine, incarnation, trace_id=trace_id)
    span.stamp("queued")
    span.flow("s")
    span.fleet_flow("s" if trace_root else "t")
    return span
