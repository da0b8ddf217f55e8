"""Per-request latency attribution for the serving engines.

`InferenceEngine` (micro-batching, one-shot requests): a `Span` is
assigned at `submit()` and rides the request through collector -> lane
dispatch -> device completion -> slice/resolve; each stage stamps one
monotonic phase timestamp (`PHASES`): queued, claimed (the collector
popped it into a batch), padded (concat + pad to the bucket), dispatched
(the program was enqueued on the lane's CUDA stream), device_done (the
completer's wait on the lane's event returned), sliced, resolved. On
resolve the consecutive stamp deltas feed four process-global histograms
- `serving_queue_ms` (queued->claimed), `serving_pad_ms`
(claimed->dispatched), `serving_device_ms` (dispatched->device_done),
`serving_resolve_ms` (device_done->resolved) - whose sum telescopes
exactly to resolved-queued, and drop one `reqspan:` instant into the
trace ring; chrome flow events (`serving_request`) link the submit,
dispatch and complete scopes.

`GenerationEngine` (continuous batching): a `GenSpan` is assigned at
`submit()` and rides the request through slot admission, prefill and
every decode step; each stage stamps one phase (`GEN_PHASES`). On
resolve the stamps feed the process-global `ttft_ms` / `tpot_ms`
histograms and the rolling-window SLO samples (`slo.py`), and drop one
`reqspan:` instant, which `tools/latency_report.py` reads offline from an
exported trace. Chrome flow events (`gen_request`, and `fleet_request`
keyed by the trace id) link a request's scopes across threads.

Spans on timed-out or failed requests are abandoned (no histogram
samples: the phase latencies describe delivered work) but still appear
in flight-recorder dumps as the dying engine's or lane's in-flight
spans.

Everything is gated by `FLAGS_serving_spans` (default on); the cost per
request is a handful of `perf_counter()` calls, dict stores and bounded
ring appends.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ..framework import monitor
from ..framework.flags import flag
from . import tracer

__all__ = ["Span", "enabled", "start", "phase_snapshot", "PHASES",
           "GenSpan", "start_gen", "GEN_PHASES"]

_next_id = itertools.count(1)
_hists_lock = threading.Lock()


def enabled() -> bool:
    return bool(flag("FLAGS_serving_spans"))


# -- serving-pipeline spans (InferenceEngine) --------------------------------

PHASES = ("queued", "claimed", "padded", "dispatched", "device_done",
          "sliced", "resolved")

# (histogram, from_stamp, to_stamp): consecutive, so the sums telescope
_PHASE_HISTS = (("serving_queue_ms", "queued", "claimed"),
                ("serving_pad_ms", "claimed", "dispatched"),
                ("serving_device_ms", "dispatched", "device_done"),
                ("serving_resolve_ms", "device_done", "resolved"))

_hists = None


def _phase_hists():
    global _hists
    if _hists is None:
        with _hists_lock:
            if _hists is None:
                # literal names: the check_stats lint reads these
                _hists = (monitor.histogram("serving_queue_ms"),
                          monitor.histogram("serving_pad_ms"),
                          monitor.histogram("serving_device_ms"),
                          monitor.histogram("serving_resolve_ms"))
    return _hists


def phase_snapshot() -> dict:
    """{phase_histogram_name: snapshot}: the engine.stats() breakdown.
    Process-global like every STAT counter: engines share the four
    histograms (the per-engine split lives in `<name>_request_ms`)."""
    return {spec[0]: h.snapshot()
            for spec, h in zip(_PHASE_HISTS, _phase_hists())}


class Span:
    """One request's phase clock. Single-writer per stage (the request
    moves collector -> dispatcher -> completer hand to hand), so plain
    dict stores under the GIL are enough."""

    __slots__ = ("rid", "engine", "lane", "bucket", "stamps")

    def __init__(self, engine: str):
        self.rid = next(_next_id)
        self.engine = engine
        self.lane: Optional[int] = None
        self.bucket: Optional[int] = None
        self.stamps = {}

    def stamp(self, phase: str, t: Optional[float] = None) -> None:
        # latest wins: a poisoned-batch retry re-runs the dispatch-side
        # phases; overwriting keeps the stamps monotone, so the deltas
        # stay non-negative and telescope to end to end
        self.stamps[phase] = time.perf_counter() if t is None else t

    def flow(self, ph: str) -> None:
        """Emit the chrome flow event for this request on the CALLING
        thread, inside the scope the arrow should attach to."""
        tracer.flow("serving_request", ph, self.rid)

    def phase_ms(self) -> Optional[dict]:
        """{hist_name: ms} for the four consecutive phases; None until
        every boundary stamp exists."""
        s = self.stamps
        out = {}
        for name, a, b in _PHASE_HISTS:
            if a not in s or b not in s:
                return None
            out[name] = (s[b] - s[a]) * 1000.0
        return out

    def finish(self) -> None:
        """Called once per DELIVERED request, after `resolved` is
        stamped: feed the phase histograms and drop one self-contained
        `reqspan:` instant into the trace ring."""
        phases = self.phase_ms()
        if phases is None:
            return
        for (name, _, _), h in zip(_PHASE_HISTS, _phase_hists()):
            h.observe(max(0.0, phases[name]))
        e2e = (self.stamps["resolved"] - self.stamps["queued"]) * 1000.0
        q, p, d, r = (phases[n] for n, _, _ in _PHASE_HISTS)
        tracer.instant(
            f"reqspan:{self.rid}:{self.engine}:lane{self.lane}:"
            f"b{self.bucket}:q={q:.3f},p={p:.3f},d={d:.3f},r={r:.3f},"
            f"e={e2e:.3f}", t=self.stamps["resolved"])

    def to_dict(self) -> dict:
        """Postmortem shape for flight-recorder dumps (the in-flight
        spans of a dying lane)."""
        now = time.perf_counter()
        return {"rid": self.rid, "engine": self.engine, "lane": self.lane,
                "bucket": self.bucket,
                "phases": dict(self.stamps),
                "age_ms": round((now - self.stamps["queued"]) * 1000.0, 3)
                if "queued" in self.stamps else None}


def start(engine: str) -> Optional[Span]:
    """Span for one accepted request (None when spans are off). Stamps
    `queued` and emits the flow start: call inside the submit scope."""
    if not enabled():
        return None
    span = Span(engine)
    span.stamp("queued")
    span.flow("s")
    return span


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
