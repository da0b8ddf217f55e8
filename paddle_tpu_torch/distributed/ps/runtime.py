"""The parameter server's runtime (port of
`paddle_tpu.distributed.ps.runtime`; reference
`fleet/runtime/the_one_ps.py:399` TheOnePSRuntime: _init_server /
_init_worker / _run_server over the brpc service).

A server holds the native tables behind the TCP service; a worker gets a
client and an async (or, with `geo_k`, a geo) communicator. The topology
comes from the launcher's env: PADDLE_PSERVERS_IP_PORT_LIST (the servers'
endpoints), PADDLE_PSERVER_ID (this server's index, else POD_ID) and
PADDLE_TRAINERS_NUM (the workers a barrier waits for)."""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .communicator import AsyncCommunicator, GeoCommunicator
from .service import PsClient, PsServer, TableConfig

__all__ = ["TheOnePSRuntime", "the_one_ps", "DistributedEmbedding"]

_runtime: Optional["TheOnePSRuntime"] = None


def the_one_ps() -> "TheOnePSRuntime":
    global _runtime
    if _runtime is None:
        _runtime = TheOnePSRuntime()
    return _runtime


class TheOnePSRuntime:
    def __init__(self):
        self.server: Optional[PsServer] = None
        self.client: Optional[PsClient] = None
        self.communicator: Optional[AsyncCommunicator] = None
        self.tables: List[TableConfig] = []
        self._next_table_id = 0

    # -- configuration ------------------------------------------------------
    def register_sparse_table(self, dim, rule="sgd", lr=0.01,
                              init_range=0.05, name=""):
        cfg = TableConfig(self._next_table_id, "sparse", dim=dim, rule=rule,
                          lr=lr, init_range=init_range, name=name)
        self.tables.append(cfg)
        self._next_table_id += 1
        return cfg.table_id

    def register_dense_table(self, size, rule="sgd", lr=0.01, name=""):
        cfg = TableConfig(self._next_table_id, "dense", size=size, rule=rule,
                          lr=lr, name=name)
        self.tables.append(cfg)
        self._next_table_id += 1
        return cfg.table_id

    def _server_endpoints(self):
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        return [e for e in eps.split(",") if e] or ["127.0.0.1:0"]

    # -- lifecycle (fleet surface) -----------------------------------------
    def init_server(self, *args, **kwargs):
        idx = int(os.environ.get("PADDLE_PSERVER_ID",
                                 os.environ.get("POD_ID", "0")))
        eps = self._server_endpoints()
        n_workers = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.server = PsServer(eps[min(idx, len(eps) - 1)], self.tables,
                               n_workers)
        self.server.start(block=False)
        return self.server

    def run_server(self):
        if self.server is None:
            self.init_server()
        # block until stopped
        if self.server._thread is not None:
            self.server._thread.join()

    def init_worker(self, geo_k: int = 0):
        self.client = PsClient(self._server_endpoints())
        if geo_k > 0:
            self.communicator = GeoCommunicator(self.client, geo_k).start()
        else:
            self.communicator = AsyncCommunicator(self.client).start()
        return self.client

    def stop_worker(self):
        if self.communicator is not None:
            self.communicator.stop()
        if self.client is not None:
            self.client.stop_server()
            self.client.close()


class DistributedEmbedding:
    """Worker-side sparse embedding over the servers (reference
    `operators/pscore/distributed_lookup_table_op` + CommonSparseTable):
    pull the rows of the batch's ids, compute on the worker's device,
    push their gradients."""

    def __init__(self, runtime: TheOnePSRuntime, table_id: int, dim: int):
        self.rt = runtime
        self.table_id = table_id
        self.dim = dim
        self._last_ids = None

    def pull(self, ids: np.ndarray) -> np.ndarray:
        self._last_ids = np.asarray(ids, np.int64).reshape(-1)
        return self.rt.client.pull_sparse(self.table_id, self._last_ids,
                                          self.dim).reshape(
            *np.asarray(ids).shape, self.dim)

    def push_grad(self, grads: np.ndarray, async_=True):
        g = np.asarray(grads, np.float32).reshape(-1, self.dim)
        if async_ and self.rt.communicator is not None:
            self.rt.communicator.push_sparse_async(self.table_id,
                                                   self._last_ids, g)
        else:
            self.rt.client.push_sparse(self.table_id, self._last_ids, g)
