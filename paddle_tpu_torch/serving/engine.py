"""Pipelined multi-device micro-batching inference engine (port of
`paddle_tpu.serving.engine`).

Submitters only validate + enqueue numpy; ONE shared **collector** thread
owns batching: it coalesces queued requests into a batch, then routes it
to one of N per-device **dispatch lanes** (round-robin with a
least-inflight tiebreak). Each lane is a Predictor replica pinned to one
device plus two threads:

- a *dispatcher* pads the batch up to a bucket shape, stages it in pinned
  host memory, copies it to the card with `non_blocking=True` on the
  lane's own `torch.cuda.Stream`, runs the program on that stream,
  queues the outputs' copies into pinned host buffers on the same
  stream, and records an event: nothing waits for the card;
- a *completer* waits on that event alone, then reads the outputs on the
  host, slices them back per request, and resolves futures.

Nothing is issued on the default stream: a copy to the host there waits
for every kernel queued on the card. No tensor crosses streams but the
weights, which a lane's stream waits for once when the lane starts.
Because dispatch and completion are decoupled, lane K admits batch N+1
while batch N is still on the card, and with multiple lanes every card
serves traffic concurrently. In-flight batches per lane are bounded by
`FLAGS_serving_max_inflight`, so backpressure still reaches
`EngineOverloaded` at the front door instead of piling work on the
device queue. `jit.save` exports a symbolic batch dim, so a single saved
artifact serves every (device, bucket) pair, each run first once at
warmup, observable through the per-replica `Predictor.compile_count` /
`STAT_predictor_compiles`. On a CPU lane (`devices="cpu"`, the tests)
the dispatcher runs the program and the completer reads its outputs.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..framework import monitor
from ..framework.errors import (ExecutionTimeoutError, InvalidArgumentError,
                                UnavailableError)
from ..framework.flags import flag
from ..profiler import (RecordEvent, device_telemetry, exporter,
                        flight_recorder, spans)
from .generation import EngineOverloaded
from .restart import RestartBackoff

__all__ = ["EngineConfig", "InferenceEngine"]

# intake depth moves both ways: Prometheus gauge, but its stat_add/
# stat_sub deltas still relay across processes (monitor is the single
# registry of gauge names)
monitor.register_gauge("STAT_serving_queue_depth", updown=True)


def _now_ms() -> float:
    return time.perf_counter() * 1000.0


def _leaves(out) -> list:
    """A model's outputs as a flat list (a tensor or array is one)."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _host_array(x) -> np.ndarray:
    """One output on the host as a numpy array: a pinned staging buffer
    is copied out (so the result does not hold pinned memory), bfloat16
    widened to float32."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    if x.is_pinned():
        return x.numpy().copy()
    return x.cpu().numpy()


class EngineConfig:
    """Micro-batcher knobs; every default comes from the FLAGS_serving_*
    registry so deployments tune engines without code changes."""

    def __init__(self, max_batch_size: Optional[int] = None,
                 max_batch_delay_ms: Optional[float] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_queue_depth: Optional[int] = None,
                 request_timeout_ms: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 warmup: bool = True):
        self.max_batch_size = int(
            flag("FLAGS_serving_max_batch_size")
            if max_batch_size is None else max_batch_size)
        if self.max_batch_size < 1:
            raise InvalidArgumentError("max_batch_size must be >= 1")
        self.max_batch_delay_ms = float(
            flag("FLAGS_serving_max_batch_delay_ms")
            if max_batch_delay_ms is None else max_batch_delay_ms)
        explicit = batch_buckets is not None
        if batch_buckets is None:
            raw = str(flag("FLAGS_serving_batch_buckets"))
            batch_buckets = [int(x) for x in raw.split(",") if x.strip()]
        if explicit and any(int(b) < 1 or int(b) > self.max_batch_size
                            for b in batch_buckets):
            # flag-default buckets clip silently (a global default against
            # a local max), but an explicitly-passed bucket the engine
            # could never fill is a config error worth surfacing
            raise InvalidArgumentError(
                f"batch_buckets {tuple(batch_buckets)} contains buckets "
                f"outside [1, max_batch_size={self.max_batch_size}]")
        buckets = sorted({int(b) for b in batch_buckets
                          if 1 <= int(b) <= self.max_batch_size})
        if not buckets or buckets[-1] < self.max_batch_size:
            buckets.append(self.max_batch_size)  # every batch must fit
        self.batch_buckets = tuple(buckets)
        self.max_queue_depth = int(
            flag("FLAGS_serving_max_queue_depth")
            if max_queue_depth is None else max_queue_depth)
        self.request_timeout_ms = float(
            flag("FLAGS_serving_request_timeout_ms")
            if request_timeout_ms is None else request_timeout_ms)
        self.max_inflight = int(
            flag("FLAGS_serving_max_inflight")
            if max_inflight is None else max_inflight)
        if self.max_inflight < 1:
            raise InvalidArgumentError("max_inflight must be >= 1")
        self.warmup = bool(warmup)


class _Request:
    __slots__ = ("arrays", "rows", "future", "deadline_ms", "t_enqueue_ms",
                 "span")

    def __init__(self, arrays, rows, future, deadline_ms, t_enqueue_ms,
                 span=None):
        self.arrays = arrays
        self.rows = rows
        self.future = future
        self.deadline_ms = deadline_ms
        self.t_enqueue_ms = t_enqueue_ms
        self.span = span  # per-request phase clock (None when spans off)


class _Lane:
    """One per-device dispatch lane: a Predictor replica (or callable)
    plus a dispatcher thread (pads + enqueues the device call, no host
    sync) and a completer thread (blocks on results, slices, resolves
    futures). A lane that dies — a BaseException escaping either thread —
    fails only its OWN in-flight work and is taken out of rotation; the
    other lanes keep serving.
    """

    def __init__(self, engine: "InferenceEngine", index: int, runner,
                 predictor, device):
        self.engine = engine
        self.index = index
        self.runner = runner
        self.predictor = predictor
        self.device = device
        self.alive = True
        self.death_cause: Optional[BaseException] = None
        self.restarts = 0           # times this lane slot was rebuilt
        self.will_restart = False   # restart RESERVED in _die's locked
        #                             section, so the collector never
        #                             sees all-dead with a rebuild
        #                             still unannounced
        self.quiet_death = False    # previous death was > a quiet
        #                             window ago: budget+backoff reset
        self.inflight = 0           # routed batches not yet resolved (engine._cv)
        self.batches = 0            # completed device batches (engine._stats_lock)
        self.rows = 0
        self.bucket_compiles = {}   # bucket -> first runs on THIS replica
        self.inbox: "queue.Queue" = queue.Queue()    # collector -> dispatcher
        self.pending: "queue.Queue" = queue.Queue()  # dispatcher -> completer
        # serializes runner calls + first-run accounting: the completer's
        # poison/unsliceable reruns share this replica with the
        # dispatcher, and overlapping compile_count windows would
        # double-count a first run (it also keeps a single-lane callable
        # single-threaded, as the engine docstring promises). Held only
        # across dispatch — never the wait for the card — so pipelining
        # survives.
        self._run_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"{engine.name}-lane{index}-dispatch")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name=f"{engine.name}-lane{index}-complete")
        # a CUDA lane issues all its work on its own stream, which first
        # waits for the default stream (the weights were placed there)
        self.stream = None
        if device is not None and device.type == "cuda":
            self.stream = torch.cuda.Stream(device=device)
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def start(self):
        self._dispatcher.start()
        self._completer.start()

    def join(self, deadline):
        """deadline: time.monotonic() instant (None = wait forever)."""
        for t in (self._dispatcher, self._completer):
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))

    # -- execution ---------------------------------------------------------

    def _dispatch(self, arrays):
        """Run the lane's model on one padded batch without waiting for
        the card; returns (event, outputs). On a CUDA lane: the inputs
        staged in pinned host memory and copied on the lane's stream, the
        program run there, its tensor outputs copied into pinned host
        buffers on the same stream, and the event recorded after them. A
        callable lane gets the host arrays themselves. On a CPU lane the
        event is None."""
        if self.stream is None:
            return None, _leaves(self.runner(list(arrays)))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            xs = list(arrays)
            if self.predictor is not None:
                xs = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                      .to(self.device, non_blocking=True) for a in arrays]
            outs = []
            for leaf in _leaves(self.runner(xs)):
                if torch.is_tensor(leaf) and leaf.is_cuda:
                    host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                       pin_memory=True)
                    host.copy_(leaf, non_blocking=True)
                    leaf = host
                outs.append(leaf)
            event = torch.cuda.Event()
            event.record(self.stream)
        return event, outs

    @staticmethod
    def _outputs(handle):
        """Wait on a dispatch's event alone, then the outputs as numpy
        arrays (bfloat16 widened to float32: numpy has no bfloat16)."""
        event, outs = handle
        if event is not None:
            event.synchronize()
        return [_host_array(o) for o in outs]

    def _execute_async(self, arrays, rows: int, bucket: int, reqs=None):
        """Pad to the bucket and dispatch (`_dispatch`); returns the
        dispatch handle WITHOUT waiting for the card (the completer
        waits). Accounting is exact per replica: a first run of a bucket
        shows in the replica's `compile_count` delta under the run lock.
        `reqs` (live requests riding this dispatch, None during warmup)
        get their span phase stamps and flow-step events here."""
        if rows < bucket:
            arrays = [np.concatenate(
                [a, np.zeros((bucket - rows,) + a.shape[1:], a.dtype)])
                for a in arrays]
        if reqs:
            t_pad = time.perf_counter()
            for r in reqs:
                if r.span is not None:
                    r.span.lane = self.index
                    r.span.bucket = bucket
                    r.span.stamp("padded", t_pad)
        with self._run_lock:
            c0 = (self.predictor.compile_count
                  if self.predictor is not None else None)
            t_run0 = time.perf_counter()
            with RecordEvent(
                    f"serving::lane{self.index}::dispatch[b={bucket}]"):
                handle = self._dispatch(arrays)
                if reqs:
                    # flow steps INSIDE the dispatch scope so the arrows
                    # attach to this lane's dispatch slice
                    for r in reqs:
                        if r.span is not None:
                            r.span.flow("t")
            t_run1 = time.perf_counter()
            d = (self.predictor.compile_count - c0
                 if c0 is not None else None)
        if reqs:
            for r in reqs:
                if r.span is not None:
                    r.span.stamp("dispatched", t_run1)
        eng = self.engine
        with eng._stats_lock:
            # setdefault: unsliceable models run ad-hoc exact-size "buckets"
            st = eng._bucket_stats.setdefault(
                bucket, {"compiles": 0, "batches": 0, "rows": 0})
            lane_c = self.bucket_compiles.setdefault(bucket, 0)
            if d is None:
                # callable-backed runner: no first-run counter, mark the
                # first dispatch of each (lane, bucket); predictor lanes got
                # the exact per-replica delta under the run lock above
                d = 1 if lane_c == 0 else 0
            if d:
                self.bucket_compiles[bucket] = lane_c + d
                st["compiles"] += d
        if d:
            monitor.stat_add("STAT_serving_bucket_compiles", d)
            # feed the cumulative per-(device, bucket) first-run ledger
            dev_key = (self.device.index if self.device is not None
                       and self.device.type == "cuda" else None)
            device_telemetry.note_compile(
                f"d{dev_key}" if dev_key is not None else f"lane{self.index}",
                bucket, t_run1 - t_run0)
        return handle

    def _units_for(self, batch: List[_Request]):
        """Dispatch a claimed batch; returns completion units
        (reqs, rows, bucket, leaves, err). A dispatch-time failure of a
        multi-request batch is retried per request so the error lands
        only on the offending future (poison isolation, per lane)."""
        eng = self.engine
        if eng._unsliceable and len(batch) > 1:
            return [u for req in batch for u in self._units_for([req])]
        rows = sum(r.rows for r in batch)
        # an unsliceable model's outputs may aggregate over batch rows, so
        # zero padding would contaminate them — run exact-size (one
        # compile per observed size is the price of such models)
        bucket = rows if eng._unsliceable else eng._bucket_for(rows)
        nin = len(batch[0].arrays)
        try:
            # concat inside the try: on a spec-less engine, requests with
            # inconsistent trailing dims must poison only themselves, not
            # kill the lane
            concat = [batch[0].arrays[i] if len(batch) == 1 else
                      np.concatenate([r.arrays[i] for r in batch])
                      for i in range(nin)]
            handle = self._execute_async(concat, rows, bucket, reqs=batch)
            return [(batch, rows, bucket, handle, None)]
        except Exception as e:  # noqa: BLE001
            if len(batch) == 1:
                return [(batch, rows, bucket, None, e)]
            monitor.stat_add("STAT_serving_batch_retries")
            flight_recorder.dump("serving_poisoned_batch", {
                "engine": eng.name, "lane": self.index, "stage": "dispatch",
                "bucket": bucket, "rows": rows, "requests": len(batch),
                "error": repr(e)})
            return [u for req in batch for u in self._units_for([req])]

    def warm(self, shapes):
        """Run every bucket once on THIS lane's device, waiting on each."""
        for b in self.engine._cfg.batch_buckets:
            arrays = [np.zeros((b,) + rest, dtype) for rest, dtype in shapes]
            self._outputs(self._execute_async(arrays, b, b))

    # -- dispatcher --------------------------------------------------------

    def _dispatch_loop(self):
        batch = None
        try:
            while True:
                batch = self.inbox.get()
                if batch is None:
                    self.pending.put(None)
                    return
                if not self.alive:  # completer died while we were idle
                    self._fail_reqs(batch, self.death_cause)
                    self._dec_inflight(1)
                    batch = None
                    continue
                self.pending.put(self._units_for(batch))
                if not self.alive:
                    # completer died racing the put above: it may have
                    # drained `pending` already, so drain again ourselves
                    # — one side is guaranteed to see the entry
                    dropped = self._drain_pending()
                    if dropped:
                        self._dec_inflight(dropped)
                batch = None
        except BaseException as e:  # noqa: BLE001 — lane death, not engine death
            self._die(e, batch)
            self.pending.put(None)  # completer finishes dispatched work, exits
            raise

    # -- completer ---------------------------------------------------------

    def _expired(self, req: _Request, t_ms: float) -> bool:
        """Completion-time deadline: a request whose deadline lapsed while
        its batch was on-device gets ExecutionTimeoutError, not a late
        result the caller already gave up on."""
        if req.deadline_ms is None or t_ms <= req.deadline_ms:
            return False
        monitor.stat_add("STAT_serving_timeouts")
        try:
            req.future.set_exception(ExecutionTimeoutError(
                f"{self.engine.name}: request expired after "
                f"{t_ms - req.t_enqueue_ms:.1f}ms (deadline passed while "
                f"the batch was in flight)"))
        except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled, the timeout has nowhere to land
            pass
        return True

    def _complete_unit(self, reqs, rows, bucket, handle, err):
        eng = self.engine
        outs = None
        if err is None:
            try:
                with RecordEvent(
                        f"serving::lane{self.index}::complete[b={bucket}]"):
                    # THE wait for the card: a fault in the lane's kernels
                    # surfaces here, not at dispatch
                    outs = self._outputs(handle)
                    t_sync = time.perf_counter()
                    for req in reqs:
                        if req.span is not None:
                            req.span.stamp("device_done", t_sync)
                            req.span.flow("f")  # arrow ends in this scope
            except Exception as e:  # noqa: BLE001
                err = e
        if err is not None:
            if len(reqs) == 1:
                monitor.stat_add("STAT_serving_request_errors")
                try:
                    reqs[0].future.set_exception(err)
                except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled
                    pass
                return
            # poisoned batch: isolate — each request reruns alone so the
            # error lands only on the offending future and the lane
            # keeps serving everyone else
            monitor.stat_add("STAT_serving_batch_retries")
            flight_recorder.dump("serving_poisoned_batch", {
                "engine": eng.name, "lane": self.index,
                "stage": "complete", "bucket": bucket, "rows": rows,
                "requests": len(reqs), "error": repr(err)})
            for req in reqs:
                if not self._expired(req, _now_ms()):
                    for u in self._units_for([req]):
                        self._complete_unit(*u)
            return
        if (not eng._unsliceable
                and (len(reqs) > 1 or rows < bucket)
                and any(getattr(o, "ndim", 0) < 1 or o.shape[0] != bucket
                        for o in outs)):
            # an output without the batch dim leading can't be sliced back
            # per request, and if the batch was padded it may even be
            # computed over the padding rows — never deliver co-mingled or
            # padding-contaminated data; rerun each request alone and
            # UNPADDED (the _unsliceable verdict makes the reruns use
            # bucket == rows), and remember the verdict so future batches
            # skip the wasted bucketed execution
            eng._unsliceable = True
            monitor.stat_add("STAT_serving_unsliceable_batches")
            for req in reqs:
                if not self._expired(req, _now_ms()):
                    for u in self._units_for([req]):
                        self._complete_unit(*u)
            return
        with eng._stats_lock:
            st = eng._bucket_stats[bucket]
            st["batches"] += 1
            st["rows"] += rows
            self.batches += 1
            self.rows += rows
        monitor.stat_add("STAT_serving_batches")
        monitor.stat_add("STAT_serving_batch_rows", rows)
        monitor.stat_add("STAT_serving_batch_slots", bucket)
        monitor.stat_add(f"STAT_serving_lane{self.index}_batches")
        monitor.stat_add(f"STAT_serving_lane{self.index}_rows", rows)
        t_done = _now_ms()
        off = 0
        for req in reqs:
            # multi-request batches are guaranteed batch-major by the guard
            # above; for a lone request, a non-batch-major output (e.g. a
            # per-batch aggregate) is its own result and passes through whole
            res = [o[off:off + req.rows]
                   if (getattr(o, "ndim", 0) >= 1 and o.shape[0] == bucket)
                   else o for o in outs]
            off += req.rows
            if req.span is not None:
                req.span.stamp("sliced")
            eng._hist.observe(t_done - req.t_enqueue_ms)
            if self._expired(req, t_done):
                continue  # abandoned span: phase hists mean DELIVERED work
            try:
                req.future.set_result(res)
            except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled, the result has nowhere to land
                pass
            else:
                if req.span is not None:
                    req.span.stamp("resolved")
                    req.span.finish()

    def _complete_loop(self):
        units = None
        try:
            while True:
                units = self.pending.get()
                if units is None:
                    return
                for u in units:
                    self._complete_unit(*u)
                units = None
                self._dec_inflight(1)
        except BaseException as e:  # noqa: BLE001
            self._die(e, None,
                      current_reqs=[r for u in (units or []) for r in u[0]])
            raise

    # -- death / accounting ------------------------------------------------

    def _dec_inflight(self, n: int):
        eng = self.engine
        with eng._cv:
            self.inflight -= n
            eng._cv.notify_all()  # collector may be waiting for capacity

    def _fail_reqs(self, reqs, exc):
        err = UnavailableError(
            f"{self.engine.name} lane{self.index} "
            f"(device={self.device}): died: {exc!r}")
        for req in reqs:
            try:
                req.future.set_exception(err)
            except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled
                pass

    def _drain_pending(self, span_sink=None) -> int:
        """Fail every dispatched-but-uncompleted unit; returns how many
        routed batches were dropped (for in-flight accounting).
        `span_sink` collects the failed requests for the postmortem's
        in-flight span list."""
        dropped = 0
        while True:
            try:
                units = self.pending.get_nowait()
            except queue.Empty:
                return dropped
            if units is None:
                continue
            dropped += 1
            for u in units:
                self._fail_reqs(u[0], self.death_cause)
                if span_sink is not None:
                    span_sink.extend(u[0])

    def _die(self, exc: BaseException, current_batch,
             current_reqs: Optional[list] = None):
        """Take this lane out of rotation and fail ONLY its own in-flight
        work: the current batch/units, everything routed to its inbox,
        and (on completer death) everything awaiting completion."""
        eng = self.engine
        stranded_batches = []
        saw_sentinel = False
        with eng._cv:
            first = self.alive
            self.alive = False
            if self.death_cause is None:
                self.death_cause = exc
            if first:
                # reserve the restart UNDER the same lock that marks
                # this lane dead: a collector waking on the notify
                # below must never observe all-dead with zero pending
                # rebuilds and wrongly close the engine
                limit = int(flag("FLAGS_serving_lane_restarts"))
                if (limit > 0 and not eng._closed
                        and eng._lanes[self.index] is self):
                    backoff = eng._lane_backoffs.setdefault(
                        self.index, RestartBackoff(
                            float(flag("FLAGS_gen_restart_backoff_ms"))))
                    # shared quiet-window policy (restart.py): a slot
                    # that survived a full quiet window earns its base
                    # backoff AND its restart budget back — the budget
                    # check must see that verdict, or a long-lived
                    # lane's occasional transients exhaust it forever
                    self.quiet_death = backoff.note_death(
                        float(flag("FLAGS_gen_breaker_window_s")))
                    used = 0 if self.quiet_death else self.restarts
                    if used < limit:
                        self.will_restart = True
                        eng._restarting += 1
            while True:  # puts happen under _cv, so this drain is consistent
                try:
                    item = self.inbox.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    saw_sentinel = True  # shutdown's drain sentinel
                else:
                    stranded_batches.append(item)
            if saw_sentinel:
                # restore it — a completer-side death must not strand the
                # dispatcher in inbox.get() forever and hang shutdown()
                self.inbox.put(None)
            eng._cv.notify_all()
        if first:
            monitor.stat_add("STAT_serving_lane_deaths")
            monitor.stat_add(f"STAT_serving_lane{self.index}_deaths")
        dropped = 0
        died_reqs = []  # everything this death failed, for span postmortem
        if current_batch is not None:
            self._fail_reqs(current_batch, exc)
            died_reqs.extend(current_batch)
            dropped += 1
        if current_reqs:
            self._fail_reqs(current_reqs, exc)
            died_reqs.extend(current_reqs)
            dropped += 1
        for b in stranded_batches:
            self._fail_reqs(b, exc)
            died_reqs.extend(b)
            dropped += 1
        if current_reqs is not None:
            # completer is the dying thread: nobody will consume `pending`
            dropped += self._drain_pending(span_sink=died_reqs)
        if dropped:
            self._dec_inflight(dropped)
        if first:
            # postmortem artifact AFTER every stranded future is failed:
            # the dump is file IO and must never delay a waiting caller.
            # Its event tail carries this lane's last dispatch/complete
            # scopes — the context the raised UnavailableError lacks —
            # and the in-flight spans say exactly which phase each
            # stranded request died in.
            flight_recorder.dump("serving_lane_death", {
                "engine": eng.name, "lane": self.index,
                "device": str(self.device) if self.device is not None
                else None, "thread": threading.current_thread().name,
                "error": repr(exc), "dropped_batches": dropped,
                "lane_batches_completed": self.batches,
                "lane_rows_completed": self.rows,
                "lane_restarts": self.restarts,
                "inflight_spans": [r.span.to_dict() for r in died_reqs
                                   if r.span is not None][:64]})
            # per-lane resurrection: with
            # FLAGS_serving_lane_restarts > 0, rebuild this lane slot
            # in place (fresh threads, same replica/device) so a
            # transient fault no longer permanently shrinks capacity —
            # runs on the dying thread, AFTER its own work is failed
            eng._maybe_restart_lane(self)


class InferenceEngine:
    """Thread-safe batched serving front-end over a saved artifact,
    pipelined across every local device.

    `model` may be an artifact path prefix (as written by `jit.save`),
    an `inference.Config`, an existing
    `inference.Predictor`, any callable `fn(list_of_batched_arrays) ->
    outputs`, or a list of such callables (one dispatch lane each — the
    test/bench seam). `submit()` returns a `concurrent.futures.Future`
    resolving to the per-request output list.

    `devices` picks the dispatch lanes: None defaults from
    `FLAGS_serving_devices` — for a path/Config model the default is
    EVERY CUDA device (one Predictor replica per card; raises where
    there is none), or the CPU for a Config after `disable_gpu()`; a
    user-built Predictor or callable stays single-lane unless `devices`
    says otherwise. Accepts 'all', 'cpu', an int count, or a list of CUDA
    device indices / torch devices. A callable model with multi-lane
    `devices` must be thread-safe — lanes dispatch concurrently.

    Observability is process-global (the same contract as every other
    STAT counter): multiple engines share the STAT_serving_* counters,
    and the latency/in-flight histograms are registered as
    "<name>_request_ms" / "<name>_inflight_depth" — give each engine a
    unique `name` when per-engine attribution matters.

    Model contract (the requirement of every dynamic batcher, cf. TF
    Serving's batching): output row i must depend only on input row i.
    Inference-mode networks satisfy this; anything that mixes rows
    (train-mode batchnorm, cross-batch attention, pairwise x @ x.T
    outputs) must not be served through a batching engine. The engine
    detects the common violation class — outputs without a leading batch
    dim — and falls back to unpadded per-request execution, but
    row-mixing inside a batch-major output is semantically invisible and
    stays the caller's responsibility.

    Numerics: results are bit-identical within one (device, bucket) —
    padding and co-riders never change a request's rows — but different
    buckets may pick other GEMM tilings whose float reductions are
    ordered differently. Callers that need bit-stable replies across
    repeats must pin a single device and bucket. bfloat16 outputs come
    back as float32 numpy arrays (numpy has no bfloat16; the widening is
    exact).
    """

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 input_spec=None, name: str = "serving", devices=None,
                 metrics_port: Optional[int] = None, **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            raise InvalidArgumentError(
                "pass either an EngineConfig or keyword overrides, not both")
        import copy
        self._cfg = copy.copy(config)  # never mutate a shared caller config
        self.name = name
        self._stats_lock = threading.Lock()
        self._queue = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._rr = 0
        # lane resurrection: lanes mid-rebuild count here so
        # the collector WAITS through an all-dead-but-restarting window
        # instead of declaring the engine dead; one backoff policy per
        # lane slot (a flapping lane escalates, its neighbors don't)
        self._restarting = 0
        self._lane_backoffs = {}
        # set once a multi-request batch proves the model's outputs can't
        # be sliced per request; later batches then skip the wasted
        # batched execution and go straight to per-request dispatch
        self._unsliceable = False
        self._build_lanes(model, input_spec, devices)
        # a fixed-batch artifact (pre-polymorphism save) admits exactly one
        # device shape: collapse bucketing to it rather than failing later
        fixed = self._fixed_batch()
        if fixed is not None:
            self._cfg.max_batch_size = fixed
            self._cfg.batch_buckets = (fixed,)
        self._bucket_stats = {b: {"compiles": 0, "batches": 0, "rows": 0}
                              for b in self._cfg.batch_buckets}
        self._hist = monitor.histogram(f"{name}_request_ms")
        self._inflight_hist = monitor.histogram(f"{name}_inflight_depth")
        # observability surfaces BEFORE warmup: registering early means
        # /readyz reports this engine as warming up (ready:false with
        # warmup_complete:false) instead of not existing — the signal a
        # router needs to hold traffic during a rolling restart
        self._warmed = False
        flight_recorder.touch()
        device_telemetry.touch()
        exporter.register_engine(self)
        if self._cfg.warmup:
            self._warmup()
        self._warmed = True
        for lane in self._lanes:
            lane.start()
        self._collector = threading.Thread(target=self._collector_loop,
                                           name=f"{name}-collector",
                                           daemon=True)
        self._collector.start()
        # an explicit port 0 binds an ephemeral, never-shared server —
        # this engine owns it and must close it on shutdown
        self._owns_metrics_server = (metrics_port is not None
                                     and int(metrics_port) == 0)
        self.metrics_server = None
        try:
            self.metrics_server = exporter.start_metrics_server(
                metrics_port)
        except Exception:
            # the lanes + collector are already running; a port-bind
            # failure must not leak them with no handle to stop them
            self.shutdown(drain=False, timeout_s=5)
            raise

    # -- model / lane plumbing ---------------------------------------------

    def _build_lanes(self, model, input_spec, devices):
        from .. import inference
        if isinstance(model, (list, tuple)) and model and all(
                callable(m) and not isinstance(m, (str, inference.Config,
                                                   inference.Predictor))
                for m in model):
            # one lane per callable — the deterministic failover seam
            if devices is not None:
                raise InvalidArgumentError(
                    "a list-of-callables model already fixes the lane "
                    "count; don't pass devices too")
            self._signature = self._spec_signature(input_spec)
            self._set_expect()
            self._lanes = [_Lane(self, i, m, None, None)
                           for i, m in enumerate(model)]
            return
        predictor = None
        if isinstance(model, str):
            model = inference.Config(model)
        if isinstance(model, inference.Config):
            cfg_model = model
        elif isinstance(model, inference.Predictor):
            predictor = model
            cfg_model = None
        elif callable(model):
            cfg_model = None
        else:
            raise InvalidArgumentError(
                f"InferenceEngine: model must be a path, inference.Config, "
                f"Predictor, callable(s), got {type(model).__name__}")
        if devices is None:
            # the flag is a fleet-wide default for ARTIFACT engines only:
            # a user-built Predictor or callable stays single-lane unless
            # the caller passes devices= explicitly (replicating it behind
            # the caller's back would be a surprise, and a callable may
            # not be thread-safe)
            if cfg_model is not None and not cfg_model.use_gpu():
                devices = "cpu"
            elif cfg_model is not None:
                devices = str(flag("FLAGS_serving_devices")).strip() or "all"
        devs = (inference.resolve_devices(devices)
                if devices is not None else [None])
        if cfg_model is not None:
            predictor = inference.create_predictor(cfg_model,
                                                   device=devs[0])
            lane0 = predictor
        elif predictor is not None and devs[0] is not None:
            # same policy as the config copy above: never mutate the
            # caller's Predictor — pin a clone, leave theirs untouched
            lane0 = predictor.clone_for_device(devs[0])
        else:
            lane0 = predictor
        if predictor is not None:
            self._signature = predictor.input_signature()
            replicas = [lane0] + [predictor.clone_for_device(d)
                                  for d in devs[1:]]
            self._set_expect()
            self._lanes = [_Lane(self, i, p.run_device, p, p.device)
                           for i, p in enumerate(replicas)]
        else:
            self._signature = self._spec_signature(input_spec)
            self._set_expect()
            self._lanes = [_Lane(self, i, model, None, d)
                           for i, d in enumerate(devs)]

    def _set_expect(self):
        from ..inference import format_input_sig
        self._expect = (", ".join(format_input_sig(*s)
                                  for s in self._signature)
                        if self._signature else "")

    @staticmethod
    def _spec_signature(input_spec):
        """Optional signature for callable-backed engines: a list of
        InputSpec or (shape, dtype) pairs; None disables deep validation
        (and warmup, which needs concrete trailing dims)."""
        if input_spec is None:
            return None
        sig = []
        for i, spec in enumerate(input_spec):
            shape = getattr(spec, "shape", None)
            dtype = getattr(spec, "dtype", None)
            if shape is None:
                shape, dtype = spec
            dims = tuple(None if (d is None or d == -1) else int(d)
                         for d in shape)
            sig.append((getattr(spec, "name", None) or f"input_{i}",
                        dims, np.dtype(dtype) if dtype is not None
                        else np.dtype("float32")))
        return sig

    def _fixed_batch(self) -> Optional[int]:
        if not self._signature:
            return None
        dims0 = [d for _, dims, _ in self._signature if dims
                 for d in [dims[0]]]
        fixed = [d for d in dims0 if d is not None]
        return fixed[0] if fixed else None

    # -- request intake ----------------------------------------------------

    def _validate(self, inputs) -> tuple:
        from ..inference import check_fed_input
        sig = self._signature
        nin = len(sig) if sig else None
        if isinstance(inputs, np.ndarray) or not isinstance(
                inputs, (list, tuple)):
            inputs = [inputs]
        arrays = [np.asarray(a) for a in inputs]
        if nin is not None:
            expect = self._expect
            if len(arrays) != nin:
                raise InvalidArgumentError(
                    f"{self.name}: model expects {nin} input(s) "
                    f"[{expect}] but {len(arrays)} were submitted")
            try:
                # shared checker (same one Predictor.run uses), with the
                # batch axis exempt — the engine owns that dimension
                arrays = [check_fed_input(arr, n, dims, dtype,
                                          skip_batch_dim=True,
                                          ctx=self.name, expect=expect)
                          for arr, (n, dims, dtype) in zip(arrays, sig)]
            except ValueError as e:
                raise InvalidArgumentError(str(e)) from None
        rows = {int(a.shape[0]) for a in arrays if a.ndim >= 1}
        if len(rows) != 1:
            raise InvalidArgumentError(
                f"{self.name}: all inputs must share the leading batch "
                f"dim, got {[tuple(a.shape) for a in arrays]}")
        n = rows.pop()
        if n < 1:
            raise InvalidArgumentError(f"{self.name}: empty request")
        if n > self._cfg.max_batch_size:
            raise InvalidArgumentError(
                f"{self.name}: request batch {n} exceeds max_batch_size "
                f"{self._cfg.max_batch_size}; split the request")
        return arrays, n

    def submit(self, inputs, timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one request (arrays with a leading batch dim); returns a
        Future of the per-request output list. Raises `EngineOverloaded`
        when the queue is at max_queue_depth."""
        with RecordEvent("serving::submit"):
            arrays, rows = self._validate(inputs)
            t = _now_ms()
            tmo = (self._cfg.request_timeout_ms if timeout_ms is None
                   else float(timeout_ms))
            # 0/None disables the deadline; a negative budget (caller's
            # remaining time already spent) expires immediately at pop
            req = _Request(arrays, rows, Future(),
                           None if not tmo else t + tmo, t)
            with self._cv:
                if self._closed:
                    raise UnavailableError(
                        f"{self.name}: engine is shut down")
                if len(self._queue) >= self._cfg.max_queue_depth:
                    monitor.stat_add("STAT_serving_rejected")
                    raise EngineOverloaded(
                        f"{self.name}: queue depth "
                        f"{self._cfg.max_queue_depth} reached "
                        f"({len(self._queue)} pending); shed load or "
                        f"raise FLAGS_serving_max_queue_depth")
                # span AFTER the admission checks: a rejected submit must
                # not leave an orphan flow-start polluting the bounded
                # trace ring. "queued" stamps here — queue time starts at
                # admission — and the flow arrow leaves this submit scope
                req.span = spans.start(self.name)
                self._queue.append(req)
                monitor.stat_add("STAT_serving_queue_depth")
                self._cv.notify_all()
            monitor.stat_add("STAT_serving_requests")
            return req.future

    def run(self, inputs, timeout_ms: Optional[float] = None) -> List:
        """Synchronous submit: blocks for this request's result."""
        return self.submit(inputs, timeout_ms=timeout_ms).result()

    # -- collector ---------------------------------------------------------

    def _peek_live(self) -> Optional[_Request]:
        """Drop expired/cancelled requests from the queue head and return
        the first live one WITHOUT popping it (so the caller can size-check
        before claiming). Caller holds the lock."""
        while self._queue:
            req = self._queue[0]
            if req.deadline_ms is not None and _now_ms() > req.deadline_ms:
                self._queue.popleft()
                monitor.stat_sub("STAT_serving_queue_depth")
                monitor.stat_add("STAT_serving_timeouts")
                try:
                    req.future.set_exception(ExecutionTimeoutError(
                        f"{self.name}: request expired after "
                        f"{_now_ms() - req.t_enqueue_ms:.1f}ms in queue"))
                except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled
                    pass
                continue
            if req.future.cancelled():
                self._queue.popleft()
                monitor.stat_sub("STAT_serving_queue_depth")
                continue
            return req
        return None

    def _take(self) -> Optional[_Request]:
        """Pop + claim the queue head; None if a racing cancel won.
        Caller holds the lock and has peeked the head."""
        req = self._queue.popleft()
        monitor.stat_sub("STAT_serving_queue_depth")
        if not req.future.set_running_or_notify_cancel():
            return None
        if req.span is not None:
            req.span.stamp("claimed")
        return req

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the next batch: first live request opens the window,
        co-riders join until max_batch_size or max_batch_delay_ms. A
        request that would overflow the batch stays queued (peek before
        take), so rows never exceed the largest bucket."""
        cfg = self._cfg
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue and self._closed:
                return None
            first = None
            while first is None:
                if self._peek_live() is None:
                    return []  # nothing live; outer loop re-waits
                first = self._take()
            batch = [first]
            rows = first.rows
            window_end = _now_ms() + cfg.max_batch_delay_ms
            while rows < cfg.max_batch_size:
                head = self._peek_live() if self._queue else None
                if head is not None:
                    if rows + head.rows > cfg.max_batch_size:
                        break
                    got = self._take()
                    if got is None:
                        continue
                    batch.append(got)
                    rows += got.rows
                else:
                    remain = window_end - _now_ms()
                    if remain <= 0 or self._closed:
                        break
                    self._cv.wait(remain / 1000.0)
                    if not self._queue and _now_ms() >= window_end:
                        break
            return batch

    def _maybe_restart_lane(self, lane: _Lane) -> None:
        """Rebuild one dead lane slot in place: fresh
        dispatcher/completer threads around the SAME replica/device —
        the replica keeps its loaded program and its first-run ledger, so
        a restarted lane re-serves without a single new warm. Gated by
        FLAGS_serving_lane_restarts (0 = legacy permanent death), with
        per-slot exponential backoff (FLAGS_gen_restart_backoff_ms
        base, the shared restart primitive); a lane that exhausts its
        budget stays down, and all-lanes-down still closes the engine.
        Runs on the dying lane's own thread, after `_die` failed that
        lane's in-flight work."""
        if not lane.will_restart:  # reservation made in _die's locked
            return                 # section (or none: legacy death)
        try:
            # unblock the dead lane's surviving twin thread (the
            # dispatcher when the completer died, and vice versa): a
            # replaced lane's threads must exit, not leak blocked on
            # queues nobody will ever drain
            lane.inbox.put(None)
            # the death (and its quiet-window verdict) was already
            # noted on this slot's shared backoff in _die's reservation
            delay = self._lane_backoffs[lane.index].next_delay_ms()
            if delay:
                time.sleep(delay / 1000.0)
            fresh = _Lane(self, lane.index, lane.runner, lane.predictor,
                          lane.device)
            fresh.restarts = 1 if lane.quiet_death else lane.restarts + 1
            # accounting continuity: the slot's compile ledger and
            # throughput totals describe the (device, bucket) history,
            # not one thread generation — carrying them forward keeps
            # the exactly-once ledger exact (a callable lane's
            # first-dispatch compile marker must not re-fire)
            fresh.bucket_compiles = dict(lane.bucket_compiles)
            fresh.batches = lane.batches
            fresh.rows = lane.rows
            # start BEFORE the swap: once the lane is visible in
            # self._lanes, a racing shutdown() may Thread.join() it —
            # joining a never-started thread raises out of shutdown
            fresh.start()
            with self._cv:
                if self._closed:
                    fresh.inbox.put(None)  # drain sentinel: the threads
                    return                 # we just started exit clean
                self._lanes[lane.index] = fresh
            monitor.stat_add("STAT_serving_lane_restarts")
        except BaseException as e:  # noqa: BLE001
            # a failed rebuild (e.g. thread-start refusal under the
            # very resource exhaustion that killed the lane) degrades
            # to legacy permanent lane death — it must NOT propagate
            # into the dying thread's death path, which still has its
            # own exit sentinels to post
            flight_recorder.dump("serving_lane_restart_failed", {
                "engine": self.name, "lane": lane.index,
                "error": repr(e)})
        finally:
            with self._cv:
                self._restarting -= 1
                self._cv.notify_all()

    def _wait_capacity(self) -> bool:
        """Block until some alive lane has a free in-flight slot — BEFORE
        claiming requests from the queue, so backpressure stays at the
        front door (submit sees true depth → EngineOverloaded) instead of
        leaking into lane inboxes. False = every lane is dead (and none
        is mid-restart)."""
        with self._cv:
            while True:
                alive = [l for l in self._lanes if l.alive]
                if not alive and self._restarting == 0:
                    return False
                if any(l.inflight < self._cfg.max_inflight for l in alive):
                    return True
                self._cv.wait()

    def _route(self, batch: List[_Request]) -> None:
        """Hand a claimed batch to the best lane: least in-flight, ties
        broken round-robin so equal lanes share warm-cache traffic."""
        with self._cv:
            while True:
                alive = [l for l in self._lanes if l.alive]
                if not alive:
                    if self._restarting:
                        self._cv.wait()  # a lane is mid-rebuild: hold
                        continue         # the batch for it
                    raise UnavailableError(
                        f"{self.name}: all {len(self._lanes)} dispatch "
                        f"lanes dead")
                ready = [l for l in alive
                         if l.inflight < self._cfg.max_inflight]
                if ready:
                    n = len(self._lanes)
                    lane = min(ready, key=lambda l: (
                        l.inflight, (l.index - self._rr) % n))
                    lane.inflight += 1
                    self._rr = (lane.index + 1) % n
                    self._inflight_hist.observe(lane.inflight)
                    # put under _cv: lane death drains its inbox under the
                    # same lock, so a batch can never land in a dead inbox
                    lane.inbox.put(batch)
                    return
                self._cv.wait()

    def _collector_loop(self):
        batch = None
        try:
            while True:
                if not self._wait_capacity():
                    raise UnavailableError(
                        f"{self.name}: all {len(self._lanes)} dispatch "
                        f"lanes dead")
                batch = self._collect()
                if batch is None:
                    return  # closed + drained
                if batch:
                    # the collector's own trace track: scope spans the
                    # routing decision INCLUDING any wait for lane
                    # capacity (visible backpressure in the timeline)
                    with RecordEvent(
                            f"serving::route[n={len(batch)}]"):
                        self._route(batch)
                batch = None
        except BaseException as e:  # noqa: BLE001 — never hang submitters
            # fail BOTH the already-claimed batch and everything still
            # queued, or their submitters block on result() forever
            stranded = list(batch or [])
            with self._cv:
                self._closed = True
                while self._queue:
                    stranded.append(self._queue.popleft())
                    monitor.stat_sub("STAT_serving_queue_depth")
                self._cv.notify_all()
            for req in stranded:
                try:
                    req.future.set_exception(UnavailableError(
                        f"{self.name}: collector died: {e!r}"))
                except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled
                    pass
            flight_recorder.dump("serving_collector_death", {
                "engine": self.name, "error": repr(e),
                "stranded_requests": len(stranded)})
            if not isinstance(e, UnavailableError):
                raise
        finally:
            for lane in self._lanes:
                lane.inbox.put(None)  # drain sentinel: lanes finish + exit

    # -- execution helpers -------------------------------------------------

    def _bucket_for(self, rows: int) -> int:
        for b in self._cfg.batch_buckets:
            if b >= rows:
                return b
        return self._cfg.batch_buckets[-1]

    def _warmup(self):
        """Run every (device, bucket) pair once up front, so no live
        request pays a first run (allocations, cuBLAS heuristics) on any
        lane. Needs concrete trailing dims; silently skipped otherwise."""
        if not self._signature:
            return
        shapes = []
        for _, dims, dtype in self._signature:
            if dims is None or any(d is None for d in dims[1:]):
                return
            shapes.append((tuple(dims[1:]), dtype or np.dtype("float32")))
        with RecordEvent("serving::warmup"):
            if len(self._lanes) == 1:
                self._lanes[0].warm(shapes)
                return
            # lanes are independent replicas (own program + run lock):
            # warm them concurrently or constructor latency scales with
            # the device count (N lanes x buckets sequential first runs)
            errs = []

            def _warm(lane):
                try:
                    lane.warm(shapes)
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            threads = [threading.Thread(target=_warm, args=(lane,),
                                        name=f"{self.name}-warm{lane.index}")
                       for lane in self._lanes]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errs:
                raise errs[0]

    # -- lifecycle / introspection -----------------------------------------

    def stats(self) -> dict:
        """Engine-local snapshot: per-bucket compile/batch/occupancy, live
        queue depth, per-lane state, and latency/in-flight histograms."""
        with self._cv:
            depth = len(self._queue)
            lanes = [{"index": l.index,
                      "device": str(l.device) if l.device is not None
                      else None,
                      "alive": l.alive,
                      "restarts": l.restarts,
                      "inflight": l.inflight} for l in self._lanes]
        with self._stats_lock:
            buckets = {b: dict(s) for b, s in self._bucket_stats.items()}
            for snap, l in zip(lanes, self._lanes):
                snap["batches"] = l.batches
                snap["rows"] = l.rows
                snap["bucket_compiles"] = dict(l.bucket_compiles)
        slots = sum(b * s["batches"] for b, s in buckets.items())
        served = sum(s["rows"] for s in buckets.values())
        # weight-only-quantized artifact? (Predictor read the .pdmeta
        # manifest and keeps int8/int4 weights device-resident) — the
        # capacity-planning signal next to the per-lane ledger
        qinfo = None
        for lane in self._lanes:
            getq = getattr(lane.predictor, "quant_info", None)
            if getq is not None:
                qinfo = getq()
                break
        return {
            "buckets": buckets,
            "lanes": lanes,
            "quantized_weights": qinfo,
            "queue_depth": depth,
            "rows_served": served,
            "mean_occupancy": round(served / slots, 4) if slots else 0.0,
            "latency_ms": self._hist.snapshot(),
            "inflight_depth": self._inflight_hist.snapshot(),
            # per-phase attribution (process-global across engines, like
            # every STAT counter; per-engine e2e is latency_ms above)
            "phases": spans.phase_snapshot(),
        }

    def health(self) -> dict:
        """Readiness verdict for `/readyz`: can this engine take traffic
        RIGHT NOW? Ready = warmup done, not draining/closed, ≥1 live
        lane, intake queue below the rejection threshold. Always carries
        per-lane detail so a router can drain or route around a sick
        replica instead of just dropping it."""
        with self._cv:
            depth = len(self._queue)
            draining = self._closed
            lanes = [{"index": l.index, "alive": l.alive,
                      "inflight": l.inflight} for l in self._lanes]
        live = sum(1 for l in lanes if l["alive"])
        limit = self._cfg.max_queue_depth
        warmed = self._warmed
        if draining:
            reason = "draining"
        elif not warmed:
            reason = "warming up"
        elif live == 0:
            reason = "no live lanes"
        elif depth >= limit:
            reason = "queue at rejection threshold"
        else:
            reason = "ok"
        return {"ready": reason == "ok", "reason": reason,
                "warmup_complete": warmed, "draining": draining,
                "live_lanes": live, "queue_depth": depth,
                "queue_limit": limit, "lanes": lanes}

    def shutdown(self, drain: bool = True, timeout_s: Optional[float] = None):
        """Stop intake; by default the collector routes every queued
        request and the lanes finish them before exiting. With
        drain=False pending futures fail fast (in-flight device batches
        still complete)."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    monitor.stat_sub("STAT_serving_queue_depth")
                    try:
                        req.future.set_exception(UnavailableError(
                            f"{self.name}: engine shut down"))
                    except Exception:  # lint: allow(except-pass): racing caller-side cancel — the future is already settled
                        pass
            self._cv.notify_all()
        # one deadline for the WHOLE shutdown: timeout_s bounds the caller's
        # wait, not each of the 1 + 2*lanes joins separately
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        self._collector.join(None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
        for lane in self._lanes:
            lane.join(deadline)
        # a flag/fixed-port HTTP server is shared across engines and
        # stays up; an ephemeral one (explicit metrics_port=0) is this
        # engine's own and would otherwise leak its socket + thread
        exporter.unregister_engine(self)
        if self._owns_metrics_server and self.metrics_server is not None:
            self.metrics_server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
