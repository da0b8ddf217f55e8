"""Elastic training / failure detection (port of
`paddle_tpu.distributed.fleet.elastic`; reference
`python/paddle/distributed/fleet/elastic/manager.py`: ElasticManager with
etcd-backed node heartbeats, `launch_utils.py:526 watch_local_trainers`).

Heartbeats ride the fleet KV http server (`http_server.KVServer`): every
rank PUTs `beat/<rank>` on a cadence (`distributed.init_parallel_env`
starts one when the launcher's `--elastic` set PADDLE_ELASTIC_KV); the
launcher's manager scans staleness and flips the job state to FAULT when
a rank misses `timeout` seconds (or never beats within `grace`), and the
launcher then terminates the job. Plain Python, as in the JAX
package."""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional
from urllib import request as _rq

__all__ = ["ElasticManager", "HeartbeatClient", "ElasticStatus"]


class ElasticStatus:
    OK = "ok"
    FAULT = "fault"
    EXIT = "exit"


def _http(method, url, data=b""):
    req = _rq.Request(url, data=data if method == "PUT" else None,
                      method=method)
    with _rq.urlopen(req, timeout=5) as r:
        return r.read()


class HeartbeatClient:
    """Runs inside each rank: PUT beat/<rank> every `interval` seconds.

    Liveness granularity: the beat runs on a background thread, so it
    proves the PROCESS is alive (crash, OOM-kill, lost host, failed
    init), not that the training loop is making progress — an in-process
    deadlock keeps beating. For loop-level liveness pass `manual=True`
    and call `touch()` from the train loop; beats then stop the moment
    the loop stops. A clean exit writes `exit/<rank>` (atexit) so the
    master can tell completion from death."""

    def __init__(self, kv_endpoint: str, rank: int, interval: float = 2.0,
                 manual: bool = False):
        self.kv = kv_endpoint
        self.url = f"http://{kv_endpoint}/beat/{rank}"
        self.rank = rank
        self.interval = interval
        self.manual = manual
        self._touched = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat_once(self):
        _http("PUT", self.url, str(time.time()).encode())

    def touch(self):
        """Mark loop progress (manual mode): the next tick beats only if
        touched since the last one."""
        self._touched.set()

    def mark_exited(self):
        try:
            _http("PUT", f"http://{self.kv}/exit/{self.rank}", b"0")
        except Exception:
            pass

    def start(self):
        try:
            self.beat_once()   # synchronous first beat: no startup race
        except Exception:
            pass
        import atexit
        atexit.register(self.mark_exited)

        def loop():
            while not self._stop.is_set():
                self._stop.wait(self.interval)
                if self.manual and not self._touched.is_set():
                    continue   # loop made no progress → no beat
                self._touched.clear()
                try:
                    self.beat_once()
                except Exception:
                    pass  # the MASTER decides liveness, not the worker
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, exited: bool = False):
        self._stop.set()
        if exited:
            self.mark_exited()
        if self._thread:
            self._thread.join(timeout=5)


class ElasticManager:
    """Runs on the master: watches rank heartbeats in the KV store and
    exposes the job state (reference ElasticManager._monitor)."""

    def __init__(self, kv_endpoint: str, world_size: int = None,
                 timeout: float = 10.0, grace: Optional[float] = None,
                 ranks=None):
        self.kv = kv_endpoint
        # watch only `ranks` when given: a loopback KV can only ever see
        # the LOCAL ranks' beats (multi-node launchers each watch theirs)
        self.ranks = list(ranks) if ranks is not None else \
            list(range(world_size or 1))
        self.world = len(self.ranks)
        self.timeout = timeout
        # ranks that never beat yet are given `grace` seconds from manager
        # start (jax/backend init can take tens of seconds)
        self.grace = timeout if grace is None else grace
        self._t0 = time.time()
        self._last: Dict[int, float] = {}
        self._status = ElasticStatus.OK
        self._dead: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _read(self, path) -> Optional[bytes]:
        try:
            return _http("GET", f"http://{self.kv}/{path}")
        except Exception:
            return None

    def _read_beat(self, rank) -> Optional[float]:
        raw = self._read(f"beat/{rank}")
        try:
            return float(raw.decode()) if raw is not None else None
        except Exception:
            return None

    def scan(self, now: Optional[float] = None) -> str:
        """One liveness sweep; returns the job status."""
        now = now if now is not None else time.time()
        dead, exited = [], []
        for r in self.ranks:
            if self._read(f"exit/{r}") is not None:
                exited.append(r)    # clean completion, not a fault
                continue
            beat = self._read_beat(r)
            if beat is not None:
                self._last[r] = beat
            seen = self._last.get(r)
            if seen is None:
                if now - self._t0 > self.grace:
                    dead.append(r)
            elif now - seen > self.timeout:
                dead.append(r)
        self._dead = dead
        if dead:
            self._status = ElasticStatus.FAULT
        elif len(exited) == len(self.ranks):
            self._status = ElasticStatus.EXIT
        else:
            self._status = ElasticStatus.OK
        return self._status

    @property
    def status(self):
        return self._status

    @property
    def dead_ranks(self):
        return list(self._dead)

    def watch(self, interval: float = 2.0, on_fault=None):
        """Background monitor; on_fault(dead_ranks) fires on transition
        to FAULT (reference: triggers job restart from checkpoint)."""
        def loop():
            was_ok = True
            while not self._stop.is_set():
                st = self.scan()
                if st == ElasticStatus.EXIT:
                    return          # whole job completed cleanly
                if st == ElasticStatus.FAULT and was_ok:
                    was_ok = False
                    if on_fault:
                        try:
                            on_fault(self.dead_ranks)
                        except Exception:
                            pass
                elif st == ElasticStatus.OK:
                    was_ok = True
                self._stop.wait(interval)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
