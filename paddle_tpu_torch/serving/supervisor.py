"""Engine resurrection: supervised restart with request replay.

Port of `paddle_tpu.serving.supervisor`. `GenerationEngine` treats any
decode or prefill exception as engine-fatal; without a supervisor that
verdict fails every queued and live request with `UnavailableError`.
The engine's design makes a restart cheap:

- **Iteration-level scheduling** means a mid-decode sequence is fully
  described by `prompt + generated-so-far`: replay is a re-submit whose
  prompt is the continuation and whose budget is the remainder. Greedy
  decode is deterministic given the prefix, so survivors finish
  token-identical to a fault-free run.
- **No kernel build in a recovery.** The kernels load once a process
  (`ops/_build.py`), and the rebuilt engine shares the dead one's
  program ledger, so its warmup re-runs known program shapes and adds
  no key: recovery is a pool rebuild, a warmup and the replay prefills.
- **The prefix cache** makes replay prefill cheap for shared-prefix
  traffic: the first replayed prompt re-registers its chain and later
  replays walk it.

`EngineSupervisor` wraps one engine. On death it receives the
`CrashManifest` the engine's `_die` builds (queued requests verbatim,
live slots as continuations, each entry's caller-held future and stream
kept), by then the dead engine has released its pools; it waits out an
exponential backoff (`FLAGS_gen_restart_backoff_ms` base), rebuilds an
engine with the same config (same name, next `incarnation`, the same
ledger and step and audit rings, the degraded verdict carried over) and
replays every entry in admission order under a per-request retry budget
(`FLAGS_gen_retry_limit`; past it a typed `UnavailableError`, audit
`RETRY_EXHAUSTED`).

**Exactly-once streams.** `_die` flushes staged tokens before the
manifest is taken, so for a streaming request `delivered ==
len(generated)`. A continuation replay moves those tokens into the
prompt, and the new engine streams only new tokens: no duplicate, no
gap. When a continuation no longer fits the prefill buckets, a greedy
stream replays from scratch with the first `delivered` tokens
suppressed (greedy re-derivation gives the same tokens); a sampled
stream there fails typed (`REPLAY_IMPOSSIBLE`), since new samples would
differ from the tokens already delivered.

**Crash-storm breaker.** `FLAGS_gen_breaker_threshold` deaths inside
`FLAGS_gen_breaker_window_s` open the breaker (audit `BREAKER_OPEN`,
`STAT_gen_breaker_open`): the supervisor stays down, pending work fails
typed, and `health()` (the supervisor, not the engine, is the registered
`/readyz` entity) reports 503 with the breaker reason until an operator
intervenes. A rebuild that raises counts as another death and trips the
breaker after `threshold` attempts at most: after a real device fault
(an illegal address) the CUDA context is lost and every rebuild fails,
so the supervisor fails the entries typed and never loops holding the
gate. Nothing falls back to the CPU.

Recovery runs on the dying engine's step thread, after its inference
mode has ended; the rebuilt engine starts its own step thread, which
sets the device as every step thread does.

**A supervised tp lane** (`tp` > 1: one supervisor on every rank of the
lane, as one engine is). The leader's supervisor restarts as above; its
rebuilt engine reuses the lane and the sharded weights and sends the
rebuild descriptor before its warmup, and each follower's supervisor
builds its next engine on that descriptor (`_follow_rebuild`: same lane,
same groups, the incarnation the leader chose), so no group is made by
a rebuild. The lane ends at the supervisor's shutdown. A lane that ends
on a fault inside a program (`tp_lane.LaneFault`) is not rebuilt: its
entries fail with that error, which names the rank at fault, and the
supervisor stays down as with an open breaker.
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Optional

import numpy as np

from ..framework import monitor
from ..framework.errors import InvalidArgumentError, UnavailableError
from ..framework.flags import flag
from ..profiler import exporter, slo
from .generation import (CrashManifest, GenerationConfig, GenerationEngine,
                         ReplayEntry, TokenStream)
from .restart import CrashBreaker, RestartBackoff

__all__ = ["EngineSupervisor"]


class EngineSupervisor:
    """Self-healing wrapper around one `GenerationEngine`: the same
    submit surface (`submit` / `submit_stream` / `generate`), plus
    restart, replay, breaker and degraded-mode supervision. Register THIS
    with the router tier: its `health()` spans engine generations.
    `device` passes through to every incarnation (default: the CUDA
    card)."""

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 name: str = "generation", device=None,
                 metrics_port: Optional[int] = None,
                 retry_limit: Optional[int] = None,
                 restart_backoff_ms: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_window_s: Optional[float] = None,
                 **overrides):
        if config is None:
            config = GenerationConfig(**overrides)
        elif overrides:
            raise InvalidArgumentError(
                "pass either a GenerationConfig or keyword overrides, "
                "not both")
        self.name = name
        self._model = model
        self._cfg = config
        self._device = device
        self._retry_limit = int(flag("FLAGS_gen_retry_limit")
                                if retry_limit is None else retry_limit)
        self._backoff = RestartBackoff(
            float(flag("FLAGS_gen_restart_backoff_ms"))
            if restart_backoff_ms is None else float(restart_backoff_ms))
        self._breaker = CrashBreaker(
            int(flag("FLAGS_gen_breaker_threshold"))
            if breaker_threshold is None else int(breaker_threshold),
            float(flag("FLAGS_gen_breaker_window_s"))
            if breaker_window_s is None else float(breaker_window_s))
        # the gate serializes restarts against submits: a submit that
        # races a death blocks briefly and lands on the new engine;
        # _swap_cv wakes submitters parked in _await_recovery once a
        # restart (or a final breaker/shutdown verdict) lands
        self._gate = threading.RLock()
        self._swap_cv = threading.Condition()
        self._closed = False
        self._restarting = False
        self._breaker_reason: Optional[str] = None
        self.incarnation = 0
        self.restarts = 0
        self.replayed = 0
        self.retry_exhausted = 0
        self.replay_impossible = 0
        # entries whose replay target died before they could land on
        # it: they ride the NEXT crash manifest with their retry budget
        # untouched (gate-serialized: only the death handler touches it)
        self._pending_replays = []
        self._last_recovery_ms: Optional[float] = None
        self._replay_ms_total = 0.0
        self._engine = self._build_engine(incarnation=0, carry=None)
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

    # -- engine lifecycle ---------------------------------------------------

    def _build_engine(self, incarnation: int,
                      carry: Optional[dict]) -> GenerationEngine:
        return GenerationEngine(
            self._model, copy.copy(self._cfg), name=self.name,
            device=self._device, incarnation=incarnation,
            on_death=self._on_engine_death,
            _carryover=dict(carry or {}, rebuild=self._follow_rebuild))

    def _follow_rebuild(self, incarnation: int,
                        carry: dict) -> GenerationEngine:
        """A follower rank's restart, on its leader's rebuild descriptor
        (the lane's follow thread): the next engine on the same lane, at
        the leader's incarnation. The leader's supervisor kept the
        breaker and the backoff; a follower has no request to replay."""
        with self._gate:
            self.incarnation = int(incarnation)
            self._engine = self._build_engine(self.incarnation, carry)
            self.restarts += 1
            return self._engine

    @property
    def leads(self) -> bool:
        """False on a follower rank of a tp lane, which takes no
        request."""
        lane = self._engine._lane
        return lane is None or lane.leader

    def _on_engine_death(self, manifest: CrashManifest) -> None:
        """The dead engine's `_die` hands over here (still on the dying
        step thread): breaker check, backoff, rebuild (the same ledger,
        no new program shape), replay in admission order. Runs under the
        gate, so submits block until the new engine serves."""
        t0 = time.perf_counter()
        try:
            self._handle_death(manifest)
        finally:
            # wake submitters parked in _await_recovery on EVERY exit
            # path (restart done, breaker open, shutdown race)
            with self._swap_cv:
                self._swap_cv.notify_all()
        dt = (time.perf_counter() - t0) * 1000.0
        self._last_recovery_ms = dt
        self._replay_ms_total += dt
        monitor.stat_add("STAT_gen_replay_ms", int(round(dt)))

    def _handle_death(self, manifest: CrashManifest) -> None:
        with self._gate:
            self._restarting = True
            try:
                dead = self._engine
                # quiet-window policy (restart.py): an engine that
                # survived a full breaker window earned the base backoff
                # again; only CONSECUTIVE deaths escalate
                self._backoff.note_death(self._breaker.window_s)
                # entries deferred by a death DURING the previous replay
                # pass come first: they were admitted before anything in
                # this manifest
                entries = self._pending_replays + list(manifest.entries)
                self._pending_replays = []
                lane = dead._lane
                if lane is not None and lane.error is not None:
                    # a fault inside a program ended the lane: nothing to
                    # rebuild on; fail typed, naming the rank at fault
                    self._breaker_reason = f"tp lane ended: {lane.error}"
                    self._fail_entries(entries, lane.error)
                    lane.stop()
                    return
                if self._closed:
                    self._fail_entries(
                        entries,
                        f"{self.name}: supervisor shut down during "
                        f"restart")
                    return
                if self._breaker.record():
                    if self._breaker_reason is None:
                        st = self._breaker.state()
                        self._breaker_reason = (
                            f"crash-storm breaker open: "
                            f">={st['threshold']} engine deaths in "
                            f"{st['window_s']}s (last: "
                            f"{manifest.error!r})")
                        monitor.stat_add("STAT_gen_breaker_open")
                        dead._audit.audit(
                            "BREAKER_OPEN", threshold=st["threshold"],
                            window_s=st["window_s"],
                            error=repr(manifest.error))
                        dead._audit.flush_sink()
                    self._fail_entries(entries,
                                       f"{self.name}: "
                                       f"{self._breaker_reason}")
                    return
                carry = {"ledger": dead._ledger,
                         "execs": dead._execs, "loaded": dead._loaded,
                         "step_log": dead._step_log,
                         "audit": dead._audit, "W": dead._W,
                         "degraded_spec_off": manifest.degraded_spec_off}
                if lane is not None:
                    carry["lane"] = lane
                eng = None
                build_failures = 0
                while eng is None:
                    delay = self._backoff.next_delay_ms()
                    if delay:
                        time.sleep(delay / 1000.0)
                    self.incarnation += 1
                    try:
                        eng = self._build_engine(self.incarnation, carry)
                    except Exception as build_e:  # noqa: BLE001
                        # a rebuild that fails (out of memory in warmup,
                        # a lost CUDA context) is another death for the
                        # breaker, ALSO capped by a consecutive count:
                        # failures slower than the rolling window would
                        # otherwise spin here with the submit gate held
                        build_failures += 1
                        if (self._breaker.record()
                                or build_failures
                                >= self._breaker.threshold):
                            self._breaker.trip()
                            self._breaker_reason = (
                                f"crash-storm breaker open: rebuild "
                                f"keeps failing ({build_e!r})")
                            monitor.stat_add("STAT_gen_breaker_open")
                            self._fail_entries(
                                entries,
                                f"{self.name}: {self._breaker_reason}")
                            return
                self._engine = eng
                self.restarts += 1
                monitor.stat_add("STAT_gen_restarts")
                eng._audit.audit(
                    "ENGINE_RESTART", incarnation=self.incarnation,
                    backoff_ms=round(delay, 1),
                    error=repr(manifest.error), entries=len(entries))
                for entry in entries:
                    self._replay_entry(eng, entry)
                eng._audit.flush_sink()
            finally:
                self._restarting = False

    def _replay_entry(self, eng: GenerationEngine,
                      entry: ReplayEntry) -> None:
        if entry.retries >= self._retry_limit:
            self.retry_exhausted += 1
            eng._audit.audit("RETRY_EXHAUSTED", rid=entry.rid,
                             retries=entry.retries,
                             limit=self._retry_limit,
                             **({"trace": entry.trace_id}
                                if entry.trace_id else {}))
            self._fail_entry(entry, (
                f"{self.name}: request failed permanently: replay "
                f"budget exhausted after {entry.retries} engine "
                f"restart(s) (FLAGS_gen_retry_limit="
                f"{self._retry_limit})"))
            return
        k = len(entry.toks)
        S = int(entry.prompt.size)
        bmax = eng._cfg.prefill_buckets[-1]
        if k and S + k <= bmax:
            # continuation: the generated prefix becomes prompt, the
            # remaining budget becomes max_new; the full sequence the
            # future resolves with is unchanged, and a stream emits only
            # tokens it has not delivered yet. `delivered` can exceed k
            # when THIS entry is itself an interrupted from-scratch
            # replay (tokens past k were delivered by an even earlier
            # incarnation): keep suppressing those
            prompt = np.concatenate(
                [entry.prompt, np.asarray(entry.toks, np.int32)])
            max_new = entry.max_new - k
            skip = max(0, entry.delivered - k)
        elif k == 0:
            # nothing generated THIS incarnation, but an interrupted
            # from-scratch replay may still owe suppressions for tokens
            # an earlier incarnation delivered
            prompt, max_new = entry.prompt, entry.max_new
            skip = entry.delivered
        elif entry.stream is not None and entry.do_sample:
            # a sampled stream whose continuation exceeds the prefill
            # buckets cannot be replayed exactly-once: regenerating
            # would sample other tokens than the ones delivered. Its own
            # audit code: no retry budget can fix it
            self.replay_impossible += 1
            eng._audit.audit("REPLAY_IMPOSSIBLE", rid=entry.rid,
                             generated=k, prompt_tokens=S,
                             bucket_max=bmax,
                             **({"trace": entry.trace_id}
                                if entry.trace_id else {}))
            self._fail_entry(entry, (
                f"{self.name}: sampled stream cannot be replayed "
                f"exactly-once (continuation of {S + k} tokens exceeds "
                f"the largest prefill bucket {bmax})"))
            return
        else:
            # from scratch: greedy decode re-derives the same tokens, so
            # a stream suppresses the first `delivered` ones
            prompt, max_new = entry.prompt, entry.max_new
            skip = entry.delivered
        try:
            eng.replay_submit(entry, prompt, max_new, skip_stream=skip)
            self.replayed += 1
        except UnavailableError:
            # the rebuilt engine ALREADY died (its death handler waits on
            # the gate we hold) and this entry never landed on it: defer
            # to the next manifest with the retry budget untouched
            self._pending_replays.append(entry)
        except Exception as e:  # noqa: BLE001 — replay must fail typed,
            #                     never strand the caller
            self._fail_entry(entry, f"{self.name}: replay failed: {e!r}")

    def _fail_entries(self, entries, msg) -> None:
        for entry in entries:
            self._fail_entry(entry, msg)

    def _fail_entry(self, entry: ReplayEntry, msg) -> None:
        """Fail one entry with UnavailableError(msg), or with `msg`
        itself where it is an error already (a LaneFault)."""
        err = msg if isinstance(msg, BaseException) else \
            UnavailableError(msg)
        if entry.stream is not None:
            entry.stream._put(err)
        try:
            entry.future.set_exception(err)
        except Exception:  # noqa: BLE001 — a racing caller-side cancel
            pass
        slo.observe_request(self.name, ok=False)

    # -- submit surface -----------------------------------------------------

    def _current(self) -> GenerationEngine:
        with self._gate:
            if self._breaker_reason is not None:
                raise UnavailableError(
                    f"{self.name}: {self._breaker_reason}")
            if self._closed:
                raise UnavailableError(
                    f"{self.name}: supervisor is shut down")
            return self._engine

    def _await_recovery(self, eng: GenerationEngine) -> None:
        """Park until `eng` has been replaced or a final verdict (breaker
        open, shutdown) landed. A dying engine marks itself closed on its
        step thread BEFORE its death handler reaches the gate: a racing
        submit waits for the swap here instead of burning its retries on
        the corpse. The bound scales with the backoff ceiling, so a slow
        legitimate recovery does not outlast its waiters."""
        deadline = (time.monotonic() + 60.0
                    + self._backoff.max_delay_ms / 1000.0)
        with self._swap_cv:
            while (self._engine is eng and not self._closed
                   and self._breaker_reason is None
                   and time.monotonic() < deadline):
                self._swap_cv.wait(0.05)

    def _delegate(self, method: str, *args, **kw):
        # a submit can race a death: the engine raises "shut down",
        # _await_recovery parks until the restart lands, and the retry
        # goes to the new incarnation (bounded, not a loop)
        for attempt in range(3):
            eng = self._current()
            try:
                return getattr(eng, method)(*args, **kw)
            except UnavailableError:
                if attempt == 2:
                    raise
                self._await_recovery(eng)

    def submit(self, prompt_ids, **kw):
        """`GenerationEngine.submit` across restarts: the future survives
        engine deaths (replayed under the retry budget) and fails only
        typed."""
        return self._delegate("submit", prompt_ids, **kw)

    def submit_stream(self, prompt_ids, **kw) -> TokenStream:
        """`GenerationEngine.submit_stream` across restarts: each token is
        delivered exactly once, also when the engine dies and the
        sequence is replayed on the next incarnation."""
        return self._delegate("submit_stream", prompt_ids, **kw)

    def generate(self, prompt_ids, **kw) -> np.ndarray:
        return self.submit(prompt_ids, **kw).result()

    # -- introspection / lifecycle ------------------------------------------

    def supervisor_stats(self) -> dict:
        return {
            "incarnation": self.incarnation,
            "restarts": self.restarts,
            "replayed_requests": self.replayed,
            "retry_exhausted": self.retry_exhausted,
            "replay_impossible": self.replay_impossible,
            "retry_limit": self._retry_limit,
            "restarting": self._restarting,
            "last_recovery_ms": (round(self._last_recovery_ms, 3)
                                 if self._last_recovery_ms is not None
                                 else None),
            "replay_ms_total": round(self._replay_ms_total, 3),
            "breaker": self._breaker.state(),
            # where a rebuild finds its programs when the dead engine's
            # are not handed over: the on-disk store (None = off)
            "program_store": self._cfg.program_store,
        }

    def stats(self) -> dict:
        # gate NOT taken: a /stats scrape must not block behind a restart
        # (the dead engine's snapshot stays readable)
        s = self._engine.stats()
        s["supervisor"] = self.supervisor_stats()
        return s

    def pressure(self) -> dict:
        """The live engine's `pressure()` snapshot, gate NOT taken, as in
        stats(): a router poll never blocks behind a restart. Mid-restart
        the dead incarnation's last snapshot comes back; health() reports
        not-ready then, so the router drains the replica."""
        return self._engine.pressure()

    def health(self) -> dict:
        """`/readyz` verdict across engine generations: breaker open ->
        503 with the breaker reason; restarting -> 503 "restarting";
        otherwise the live engine's own verdict."""
        if self._breaker_reason is not None:
            return {"ready": False, "reason": self._breaker_reason,
                    "breaker_open": True,
                    "incarnation": self.incarnation,
                    "restarts": self.restarts}
        if self._restarting:
            return {"ready": False,
                    "reason": "restarting (engine resurrection in "
                              "progress)",
                    "breaker_open": False,
                    "incarnation": self.incarnation,
                    "restarts": self.restarts}
        h = self._engine.health()
        h["incarnation"] = self.incarnation
        h["restarts"] = self.restarts
        h["breaker_open"] = False
        return h

    @property
    def engine(self) -> GenerationEngine:
        """The CURRENT engine incarnation (the object changes across
        restarts: don't keep it)."""
        return self._engine

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None):
        with self._gate:
            self._closed = True
            eng = self._engine
            pend, self._pending_replays = self._pending_replays, []
        # deferred replays whose next manifest never came (the engine
        # died mid-replay and we shut down before another death) must
        # not strand their callers
        self._fail_entries(pend, f"{self.name}: supervisor shut down")
        try:
            # a follower's shutdown waits for its leader to end the lane
            # and raises the lane's fault where it ended on one
            eng.shutdown(drain=drain, timeout_s=timeout_s)
        finally:
            if eng._lane is not None:
                # the lane outlived each incarnation: it ends here (an
                # engine whose loop ended already sent this; once)
                eng._lane.stop()
            exporter.unregister_engine(self)
            if self._owns_metrics_server \
                    and self.metrics_server is not None:
                self.metrics_server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
