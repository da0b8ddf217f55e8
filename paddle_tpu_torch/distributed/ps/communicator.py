"""Async and Geo communicators (port of
`paddle_tpu.distributed.ps.communicator`; reference
`paddle/fluid/distributed/service/communicator.h:197/346/495`): a
background thread merges the queued sparse gradients by id and pushes
them; pulls are synchronous. `flush()` returns once every push queued
before it has reached the servers.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from .service import PsClient

__all__ = ["AsyncCommunicator", "GeoCommunicator"]


class AsyncCommunicator:
    """Batches pushes in a background thread; pulls are synchronous.
    reference AsyncCommunicator: send_queue + merge by id."""

    def __init__(self, client: PsClient, send_interval_s: float = 0.01,
                 merge_size: int = 16):
        self._client = client
        self._interval = send_interval_s
        self._merge_size = merge_size
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._errors: list = []

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            batch = []
            try:
                batch.append(self._q.get(timeout=self._interval))
            except queue.Empty:
                continue
            while len(batch) < self._merge_size:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._flush_done(batch)
        rest = []
        while True:
            try:
                rest.append(self._q.get_nowait())
            except queue.Empty:
                break
        if rest:
            self._flush_done(rest)

    def _flush_done(self, batch):
        try:
            self._flush(batch)
        except Exception as e:  # noqa: BLE001 — raised by flush()
            self._errors.append(e)
        finally:
            for _ in batch:
                self._q.task_done()

    def _flush(self, batch):
        # merge sparse grads by (table, id); sum dense grads per table
        sparse: Dict[int, Dict[int, np.ndarray]] = {}
        dense: Dict[int, np.ndarray] = {}
        for kind, table_id, a, b in batch:
            if kind == "sparse":
                d = sparse.setdefault(table_id, {})
                for i, g in zip(a.tolist(), b):
                    if i in d:
                        d[i] = d[i] + g
                    else:
                        d[i] = g.copy()
            else:
                dense[table_id] = (dense[table_id] + a
                                   if table_id in dense else a.copy())
        for tid, d in sparse.items():
            ids = np.fromiter(d.keys(), dtype=np.int64)
            grads = np.stack([d[i] for i in ids.tolist()])
            self._client.push_sparse(tid, ids, grads)
        for tid, g in dense.items():
            self._client.push_dense(tid, g)

    def push_sparse_async(self, table_id, ids, grads):
        self._q.put(("sparse", table_id, np.asarray(ids, np.int64),
                     np.asarray(grads, np.float32)))

    def push_dense_async(self, table_id, grad):
        self._q.put(("dense", table_id, np.asarray(grad, np.float32), None))

    def pull_sparse(self, table_id, ids, dim):
        return self._client.pull_sparse(table_id, ids, dim)

    def pull_dense(self, table_id):
        return self._client.pull_dense(table_id)

    def flush(self):
        if self._thread is not None and self._thread.is_alive():
            self._q.join()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError(f"async push failed: {err!r}") from err

    def stop(self):
        try:
            self.flush()
        finally:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=3)


class GeoCommunicator(AsyncCommunicator):
    """Geo-SGD (reference GeoCommunicator:495): workers train on local
    replicas; every k steps the DELTA vs the last synced snapshot is
    pushed (rule='sum') and the fresh global value pulled."""

    def __init__(self, client: PsClient, k_steps: int = 10):
        super().__init__(client)
        self._k = k_steps
        self._step = 0
        self._snapshots: Dict[int, np.ndarray] = {}

    def register_dense(self, table_id, initial: np.ndarray):
        self._snapshots[table_id] = initial.astype(np.float32).copy()
        self._client.set_dense(table_id, initial)

    def maybe_sync_dense(self, table_id, local: np.ndarray):
        """Returns possibly-updated local values."""
        self._step += 1
        if self._step % self._k:
            return local
        snap = self._snapshots[table_id]
        delta = local.astype(np.float32) - snap
        self._client.push_dense(table_id, delta)  # rule must be 'sum'
        fresh = self._client.pull_dense(table_id)
        self._snapshots[table_id] = fresh.copy()
        return fresh
