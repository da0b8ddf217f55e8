"""FleetWrapper, the PSLib bridge (port of
`paddle_tpu.distributed.fleet.fleet_wrapper`; reference
`paddle/fluid/framework/fleet/fleet_wrapper.h`: PullSparseVarsSync /
PushSparseVarsWithLabelAsync / PullDenseVarsSync / PushDenseVarsAsync /
InitServer / InitWorker / StopServer / SaveModel, the API the Downpour
device workers program against).

PSLib is this package's own parameter server (`distributed/ps/`: the
native tables behind the TCP service), so the wrapper maps the
reference's method names onto PsServer / PsClient. Asynchronous pushes
go through ONE background queue thread (the client serialises its
requests anyway) and copy their buffers (the trainer may reuse its
gradient buffer at once); an error of that thread is raised at
client_flush() / save_model(), as the reference's queue drain does."""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["FleetWrapper"]


class FleetWrapper:
    _instance = None

    @classmethod
    def instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self._server = None
        self._client = None
        self._dims: Dict[int, int] = {}
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []

    # -- lifecycle (reference InitServer/InitWorker/StopServer) ------------
    def init_server(self, endpoint: str, table_configs, n_workers=1):
        from ..ps.service import PsServer
        self._server = PsServer(endpoint, table_configs,
                                n_workers=n_workers).start()
        for cfg in table_configs:
            if cfg.kind == "sparse":
                self._dims[cfg.table_id] = cfg.dim
        host = endpoint.rsplit(":", 1)[0]
        return f"{host}:{self._server.port}"

    def init_worker(self, endpoints: List[str],
                    sparse_dims: Optional[Dict[int, int]] = None):
        """sparse_dims: table_id → embedding dim. Required on worker-only
        processes (the reference passes fea_dim per call instead)."""
        from ..ps.service import PsClient
        self._client = PsClient(endpoints)
        if sparse_dims:
            self._dims.update(sparse_dims)

        def drain():
            while True:
                item = self._q.get()
                if item is None:
                    return
                fn, args = item
                try:
                    fn(*args)
                except BaseException as e:  # surfaced at flush time
                    self._errors.append(e)
                finally:
                    self._q.task_done()
        self._worker = threading.Thread(target=drain, daemon=True)
        self._worker.start()

    def stop_server(self):
        if self._client:
            self.client_flush()
            self._q.put(None)
            try:
                self._client.stop_server()
            except Exception:
                pass
            self._client.close()
        if self._server:
            self._server.stop()

    # -- sparse (reference PullSparseVarsSync / PushSparseVarsAsync) -------
    def pull_sparse_vars_sync(self, table_id: int, ids,
                              fea_dim: Optional[int] = None) -> np.ndarray:
        dim = fea_dim if fea_dim is not None else self._dims.get(table_id)
        if dim is None:
            raise ValueError(
                f"unknown dim for sparse table {table_id}; pass fea_dim "
                f"or init_worker(..., sparse_dims={{...}})")
        ids = np.asarray(ids, np.int64).reshape(-1)
        return self._client.pull_sparse(table_id, ids, dim)

    def push_sparse_vars_async(self, table_id: int, ids, grads):
        ids = np.array(ids, np.int64, copy=True).reshape(-1)
        g = np.array(grads, np.float32, copy=True).reshape(ids.size, -1)
        self._q.put((self._client.push_sparse, (table_id, ids, g)))

    def push_sparse_vars_with_label_async(self, table_id, ids, grads,
                                          labels=None):
        """reference PushSparseVarsWithLabelAsync: labels feed PSLib's
        show/click accumulators, which our tables don't keep — accepted
        and ignored."""
        self.push_sparse_vars_async(table_id, ids, grads)

    # -- dense (reference PullDenseVarsSync / PushDenseVarsAsync) ----------
    def pull_dense_vars_sync(self, table_id: int, server=0) -> np.ndarray:
        return self._client.pull_dense(table_id, server=server)

    def push_dense_vars_async(self, table_id: int, grad, server=0):
        g = np.array(grad, np.float32, copy=True).reshape(-1)
        self._q.put((lambda t, gg, s: self._client.push_dense(
            t, gg, server=s), (table_id, g, server)))

    def client_flush(self, timeout: float = 60.0):
        """reference ClientFlush: drain the async push queue; raises the
        first worker error so a later save_model can't silently persist a
        state with pushes missing."""
        deadline = time.time() + timeout
        while not self._q.empty() and time.time() < deadline:
            time.sleep(0.01)
        self._q.join()
        if self._errors:
            err = self._errors[0]
            self._errors = []
            raise RuntimeError(f"async push failed: {err!r}") from err

    def barrier(self):
        self._client.barrier()

    # -- persistence (reference SaveModel/LoadModel/ShrinkSparseTable) -----
    def save_model(self, path: str, mode=0):
        self.client_flush()
        return self._client.save(path)

    def load_model(self, path: str, mode=0):
        return self._client.load(path)
