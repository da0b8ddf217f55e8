"""The router tier: one front door over N self-healing replicas.

Port of `paddle_tpu.serving.router`. Orca's split, fleet-scale: the
engine decides per STEP (continuous batching), the router decides per
REQUEST. Each replica is an `EngineSupervisor`-wrapped
`GenerationEngine`, already self-healing and already exposing drain and
pressure surfaces, so the router stays thin: placement policy plus the
same `submit()`/`submit_stream()`/`generate()` surface, and everything
below it keeps its exactly-once semantics.

Placement is **prefix-affinity first** (SGLang's RadixAttention
insight, lifted above the replica): the blake2b chain digests of a
prompt's leading FULL pages (`prefix_cache.chain_digests`, the same
implementation the engine's cache index uses, so the two sides cannot
drift) are content-only and therefore replica-independent. The router
keeps a bounded per-replica LRU sketch of the chains it has placed;
an incoming prompt steers to the replica holding its LONGEST chain —
session stickiness for agent loops (turn N+1's prompt extends turn N's,
so its digests re-match) with ZERO session state in the router: lose
the sketch and you lose warmth, never correctness. Ties and misses fall
back to least-pressure balancing on a cached per-replica
`pressure()` snapshot: KV headroom at the request's covering shape,
then queue depth, then oldest-queue-age, with a rotating tiebreak so
equal replicas alternate. `affinity=False` (FLAGS_router_affinity)
degrades placement to pure round-robin, the A/B arm.

Health folds in the engine's and the supervisor's surfaces: a replica
whose `health()` says not-ready (SLO fast-window burn past
FLAGS_slo_max_burn_rate, breaker open, draining, queue at rejection
threshold) is DRAINED: no new
placements while its live streams finish untouched. A request stranded
by a replica death never reaches the router at all: the replica's own
supervisor replays it exactly-once under the existing
retry-budget/typed-failure semantics. The router only re-routes
failures raised AT placement time (breaker open, shutdown, queue-full
backpressure), when nothing has been delivered yet — so streams stay
exactly-once by construction.

Every placement decision is one event in the router's own closed-
vocabulary audit ring (ROUTE_AFFINITY / ROUTE_LEAST_PRESSURE /
ROUTE_DRAIN / ROUTE_REROUTE) and the router registers with the
exporter like any engine: `/readyz` is ready while >= 1 replica is
placeable, `/stats` carries placements, sketches, and a bounded
per-replica pressure timeline (`tools/router_report.py` renders both).

Tensor-parallel replicas (`tp` > 1): every rank of the lanes builds the
router, as it builds each lane's engine. The lanes' first ranks route:
a replica whose lane another rank leads is never a candidate here, and
on a rank that leads no replica `submit` / `generate` refuse as a
follower engine's do, while `shutdown` waits for that rank's followers
to end. Lanes may share ranks (each has its own groups,
`serving.tp_lane`), as the JAX router's replicas share one process.

Locking: one plain lock around the sketch/snapshot/pick state, held
only for host bookkeeping — never across a replica call. Replica
`pressure()` reads are lock-free on the engine side by design
(step-thread-published snapshot), so router polling cannot contend any
step loop.
"""
from __future__ import annotations

import copy
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..framework import monitor
from ..framework.errors import (InvalidArgumentError, ResourceExhaustedError,
                                UnavailableError)
from ..framework.flags import flag
from ..profiler import audit, exporter, trace_context, tracer
from .generation import GenerationConfig, TokenStream
from .prefix_cache import chain_digests
from .supervisor import EngineSupervisor

__all__ = ["Router"]


class _Replica:
    """Router-side state for one supervised replica."""

    __slots__ = ("sup", "name", "sketch", "placements", "drained",
                 "pressure", "health")

    def __init__(self, sup: EngineSupervisor):
        self.sup = sup
        self.name = sup.name
        self.sketch: OrderedDict = OrderedDict()  # digest -> None, LRU
        self.placements = 0
        self.drained = False     # last refresh verdict
        self.pressure: dict = {}
        self.health: dict = {}


class Router:
    """N supervised replicas, one `submit()/submit_stream()` front door.

    Either pass `model` (+ config/overrides) and the router builds
    `num_replicas` EngineSupervisors named `{name}-r{i}`, or pass
    prebuilt `replicas=[EngineSupervisor, ...]`. The router owns its
    replicas either way: `shutdown()` shuts them down. `device=` rides
    the overrides through to every replica (default: the CUDA card)."""

    def __init__(self, model=None, config: Optional[GenerationConfig] = None,
                 num_replicas: Optional[int] = None, name: str = "router",
                 replicas: Optional[Sequence[EngineSupervisor]] = None,
                 affinity: Optional[bool] = None,
                 sketch_digests: Optional[int] = None,
                 pressure_ttl_ms: Optional[float] = None,
                 metrics_port: Optional[int] = None, **overrides):
        self.name = name
        self._affinity = bool(flag("FLAGS_router_affinity")
                              if affinity is None else affinity)
        self._sketch_cap = int(flag("FLAGS_router_sketch_digests")
                               if sketch_digests is None else sketch_digests)
        self._ttl_ms = float(flag("FLAGS_router_pressure_ttl_ms")
                             if pressure_ttl_ms is None else pressure_ttl_ms)
        own_replicas = replicas is None
        if own_replicas:
            if model is None:
                raise InvalidArgumentError(
                    "Router needs either a model or prebuilt replicas")
            n = int(flag("FLAGS_router_replicas")
                    if num_replicas is None else num_replicas)
            if n < 1:
                raise InvalidArgumentError(
                    f"Router needs >= 1 replica, got {n}")
            built: List[EngineSupervisor] = []
            try:
                for i in range(n):
                    cfg = copy.copy(config) if config is not None else None
                    built.append(EngineSupervisor(
                        model, cfg, name=f"{name}-r{i}", **overrides))
            except Exception:
                for sup in built:
                    sup.shutdown(drain=False, timeout_s=5)
                raise
            replicas = built
        elif model is not None or config is not None or overrides:
            raise InvalidArgumentError(
                "pass either prebuilt replicas or model/config/overrides, "
                "not both")
        if not replicas:
            raise InvalidArgumentError("Router needs >= 1 replica")
        names = [sup.name for sup in replicas]
        if len(set(names)) != len(names):
            raise InvalidArgumentError(
                f"replica names must be unique, got {names}")
        self._replicas = [_Replica(sup) for sup in replicas]
        # affinity hashing + pressure-bucket arithmetic use replica 0's
        # shape config; heterogeneous page sizes would silently break
        # digest sharing with the engines' cache indexes, so refuse
        page_sizes = {sup._cfg.page_size for sup in replicas}
        if len(page_sizes) != 1:
            raise InvalidArgumentError(
                f"replicas disagree on page_size: {sorted(page_sizes)} — "
                "chain digests would not be comparable across the fleet")
        self._page_size = page_sizes.pop()
        self._default_max_new = replicas[0]._cfg.max_new_tokens
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._snap_t_ms = -1e18   # force first refresh
        self._timeline: deque = deque(maxlen=512)
        self._closed = False
        self._audit = audit.AuditLog(name)
        exporter.register_engine(self)
        self._owns_metrics_server = (metrics_port is not None
                                     and int(metrics_port) == 0)
        self.metrics_server = None
        try:
            self.metrics_server = exporter.start_metrics_server(
                metrics_port)
        except Exception:
            self.shutdown(drain=False, timeout_s=5)
            raise

    # -- placement ----------------------------------------------------------

    def _refresh_locked(self, force: bool = False) -> None:
        """Re-poll every replica's pressure + health when the cached
        snapshot is older than FLAGS_router_pressure_ttl_ms. Drain
        transitions (either direction) are audited ROUTE_DRAIN once per
        edge, not per placement."""
        now_ms = time.perf_counter() * 1000.0
        if not force and (now_ms - self._snap_t_ms) < self._ttl_ms:
            return
        self._snap_t_ms = now_ms
        monitor.stat_add("STAT_router_pressure_refreshes")
        tick: Dict[str, dict] = {}
        for rep in self._replicas:
            try:
                rep.pressure = rep.sup.pressure()
            except Exception as e:  # a dying replica reads as empty
                rep.pressure = {"error": repr(e)}
            try:
                rep.health = rep.sup.health()
            except Exception as e:  # a dying replica reads as drained
                rep.health = {"ready": False, "reason": repr(e)}
            was = rep.drained
            rep.drained = not rep.health.get("ready")
            if rep.drained != was:
                if rep.drained:
                    monitor.stat_add("STAT_router_drains")
                self._audit.audit(
                    "ROUTE_DRAIN", replica=rep.name,
                    drained=rep.drained,
                    verdict=rep.health.get("reason"),
                    breaker_open=bool(rep.health.get("breaker_open")))
            p = rep.pressure
            tick[rep.name] = {
                "ready": not rep.drained,
                "queue_depth": p.get("queue_depth", 0),
                "oldest_age_ms": p.get("oldest_age_ms", 0.0),
                "free_pages": p.get("free_pages", 0),
                "slots_free": p.get("slots_free", 0),
                "live": p.get("live", 0),
                # how much of the replica's prefix traffic the host
                # tier absorbs; replicas without a tier read 0
                "tier_hit_rate": (p.get("tier") or {}).get("hit_rate",
                                                           0.0),
            }
        self._timeline.append({"t_ms": round(now_ms, 1),
                               "replicas": tick})

    @staticmethod
    def _headroom_at(pressure: dict, total_tokens: int) -> int:
        """Admittable-request count at the smallest snapshot shape
        covering this request's worst-case total; falls back to the
        tightest shape when nothing covers it."""
        head = pressure.get("headroom") or {}
        shapes = sorted((int(t), int(n)) for t, n in head.items())
        for t, n in shapes:
            if t >= total_tokens:
                return n
        return shapes[-1][1] if shapes else 0

    def _least_pressure_locked(self, cands: List[_Replica],
                               total_tokens: int) -> _Replica:
        offset = next(self._rr)

        def key(j: int):
            p = cands[j].pressure
            return (-self._headroom_at(p, total_tokens),
                    p.get("queue_depth", 0),
                    p.get("oldest_age_ms", 0.0),
                    (j - offset) % len(cands))  # rotate exact ties

        return cands[min(range(len(cands)), key=key)]

    def _pick_locked(self, digests: List[bytes], total_tokens: int,
                     exclude: set, trace: dict) -> Optional[_Replica]:
        cands = [r for r in self._replicas
                 if r.name not in exclude and not r.drained
                 and r.sup.leads]
        if not cands:
            return None
        if self._affinity and digests:
            matched = []
            for r in cands:
                depth = 0
                for i in range(len(digests) - 1, -1, -1):
                    if digests[i] in r.sketch:
                        depth = i + 1
                        break
                matched.append(depth)
            best = max(matched)
            if best > 0:
                top = [r for r, m in zip(cands, matched) if m == best]
                rep = (top[0] if len(top) == 1
                       else self._least_pressure_locked(top, total_tokens))
                monitor.stat_add("STAT_router_affinity_hits")
                monitor.stat_add("STAT_router_affinity_pages", best)
                self._audit.audit(
                    "ROUTE_AFFINITY", replica=rep.name,
                    matched_pages=best, chain_pages=len(digests),
                    **trace)
                return rep
        if self._affinity:
            rep = self._least_pressure_locked(cands, total_tokens)
            policy = "least_pressure"
        else:
            rep = cands[next(self._rr) % len(cands)]
            policy = "round_robin"
        monitor.stat_add("STAT_router_least_pressure")
        self._audit.audit("ROUTE_LEAST_PRESSURE", replica=rep.name,
                          policy=policy,
                          queue_depth=rep.pressure.get("queue_depth", 0),
                          **trace)
        return rep

    def _note_placed_locked(self, rep: _Replica,
                            digests: List[bytes]) -> None:
        rep.placements += 1
        sk = rep.sketch
        for d in digests:
            if d in sk:
                sk.move_to_end(d)
            else:
                sk[d] = None
        while len(sk) > self._sketch_cap:
            sk.popitem(last=False)

    def _place(self, method: str, prompt_ids, kw: dict):
        """Pick a replica, call `method` on its supervisor, learn the
        placement. Placement-time typed failures (breaker open,
        shutdown, queue-full backpressure) re-route to the next-best
        replica — nothing was delivered yet, so exactly-once holds;
        anything the replica raises AFTER accepting the request
        propagates on the future/stream under its own supervisor's
        replay + retry-budget semantics."""
        if self._closed:
            raise UnavailableError(f"{self.name}: router shut down")
        if not any(rep.sup.leads for rep in self._replicas):
            # a follower rank of every replica's lane
            self._replicas[0].sup.engine._refuse_on_follower()
        monitor.stat_add("STAT_router_requests")
        # fleet trace context: the router is the request's
        # FIRST hop, so it mints the trace id and opens the fleet flow
        # chain — the id rides the placement audits (`trace=`), the
        # supervisor delegation, and every downstream incarnation's
        # span, so the merged fleet timeline links this decision to the
        # replica's prefill/decode and any post-restart replay
        tid = None
        if "trace_id" not in kw and trace_context.enabled():
            kw["trace_id"] = tid = trace_context.new_trace_id()
            tracer.flow("fleet_request", "s", trace_context.flow_id(tid))
        trace = {"trace": tid} if tid else {}
        digests = (chain_digests(prompt_ids, self._page_size)
                   if self._affinity else [])
        max_new = int(kw.get("max_new_tokens") or self._default_max_new)
        total = int(np.asarray(prompt_ids).size) + max_new
        tried: set = set()
        last_err: Optional[BaseException] = None
        for _ in range(len(self._replicas)):
            with self._lock:
                self._refresh_locked()
                rep = self._pick_locked(digests, total, tried, trace)
            if rep is None:
                break
            try:
                out = getattr(rep.sup, method)(prompt_ids, **kw)
            except (UnavailableError, ResourceExhaustedError) as e:
                # EngineOverloaded is the ResourceExhausted arm worth
                # rerouting (another replica has queue room); a
                # pool-can-never-fit ResourceExhausted repeats on every
                # identical replica but costs only one cheap re-raise
                # per survivor before the typed failure propagates
                last_err = e
                tried.add(rep.name)
                monitor.stat_add("STAT_router_reroutes")
                self._audit.audit("ROUTE_REROUTE", replica=rep.name,
                                  error=type(e).__name__, **trace)
                continue
            with self._lock:
                self._note_placed_locked(rep, digests)
            self._audit.flush_sink()
            return out
        self._audit.flush_sink()
        if last_err is not None:
            raise last_err
        raise UnavailableError(
            f"{self.name}: no replica placeable (all drained: SLO "
            "burn / breaker / not-ready)")

    # -- the engine surface -------------------------------------------------

    def submit(self, prompt_ids, **kw):
        """Same contract as GenerationEngine.submit, fleet-wide."""
        return self._place("submit", prompt_ids, kw)

    def submit_stream(self, prompt_ids, **kw) -> TokenStream:
        """Same contract as GenerationEngine.submit_stream; the stream
        is wired straight to the placed replica, so replay exactly-once
        semantics are the replica supervisor's own."""
        return self._place("submit_stream", prompt_ids, kw)

    def generate(self, prompt_ids, **kw) -> np.ndarray:
        return self._place("generate", prompt_ids, kw)

    # -- observability ------------------------------------------------------

    def pressure_timeline(self) -> List[dict]:
        with self._lock:
            return list(self._timeline)

    def stats(self) -> dict:
        """Router-level snapshot for `/stats`. Per-replica ENGINE stats
        stay under each supervisor's own exporter registration — this
        payload carries what only the router knows: placements,
        sketches, drain verdicts, the pressure timeline, and the
        placement audit tail."""
        with self._lock:
            reps = {
                rep.name: {
                    "placements": rep.placements,
                    "sketch_digests": len(rep.sketch),
                    "drained": rep.drained,
                    "pressure": dict(rep.pressure),
                    "supervisor": rep.sup.supervisor_stats(),
                } for rep in self._replicas}
            timeline = list(self._timeline)
        return {
            "router": {
                "affinity": self._affinity,
                "page_size": self._page_size,
                "sketch_capacity": self._sketch_cap,
                "pressure_ttl_ms": self._ttl_ms,
                "replicas": reps,
                "placements_total": sum(r["placements"]
                                        for r in reps.values()),
                "pressure_timeline": timeline,
                "audit_tail": self._audit.tail(256),
            }
        }

    def health(self) -> dict:
        """`/readyz` verdict: ready while >= 1 replica is placeable.
        Per-replica detail rides along so an operator can tell WHICH
        replica is burning/restarting from the router's own page."""
        with self._lock:
            self._refresh_locked()
            detail = {rep.name: {"ready": not rep.drained,
                                 "reason": rep.health.get("reason"),
                                 "breaker_open": bool(
                                     rep.health.get("breaker_open"))}
                      for rep in self._replicas}
        placeable = sum(1 for d in detail.values() if d["ready"])
        reason = ("ok" if placeable else
                  "no replica placeable (all drained/unready)")
        if self._closed:
            reason = "router shut down"
        return {"ready": placeable > 0 and not self._closed,
                "reason": reason, "placeable": placeable,
                "replicas": detail}

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        err = None
        for rep in self._replicas:
            try:
                rep.sup.shutdown(drain=drain, timeout_s=timeout_s)
            except Exception as e:  # noqa: BLE001 — a follower's lane
                #                     fault; the other replicas still end
                err = err or e
        exporter.unregister_engine(self)
        self._audit.close()
        if self._owns_metrics_server and self.metrics_server is not None:
            self.metrics_server.close()
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
