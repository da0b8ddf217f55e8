"""Parameter server and client over a length-prefixed TCP frame (port of
`paddle_tpu.distributed.ps.service`; reference
`paddle/fluid/distributed/service/brpc_ps_server.cc` /
`brpc_ps_client.cc`).

The table math is the native core (`tables.py`); the transport is a
threaded socket server speaking the JAX package's binary frame, byte for
byte, so either package's client talks to either package's server:

    request  [op:u8][table:u32][n_ids:u64][payload_len:u64][ids][payload]
    reply    [status:u8][payload_len:u64][payload]

Ops 1-9: pull/push dense, pull/push sparse, barrier, save, load, stop,
set dense. A server bound to port 0 takes a free port and reports it
(`PsServer.port`). A request that fails on the server is answered with
status 1 and the error's text, which the client raises.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Dict, List, Optional

import numpy as np

from .tables import DenseTable, SparseTable

__all__ = ["PsServer", "PsClient", "TableConfig"]

OP_PULL_DENSE = 1
OP_PUSH_DENSE = 2
OP_PULL_SPARSE = 3
OP_PUSH_SPARSE = 4
OP_BARRIER = 5
OP_SAVE = 6
OP_LOAD = 7
OP_STOP = 8
OP_SET_DENSE = 9

_HDR = struct.Struct("<BIQQ")
_REP = struct.Struct("<BQ")


class TableConfig:
    def __init__(self, table_id, kind, size=0, dim=0, rule="sgd", lr=0.01,
                 init_range=0.05, name=""):
        self.table_id = table_id
        self.kind = kind  # "dense" | "sparse"
        self.size = size
        self.dim = dim
        self.rule = rule
        self.lr = lr
        self.init_range = init_range
        self.name = name or f"table_{table_id}"


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class PsServer:
    """reference BrpcPsServer: one thread a connection; the barrier counts
    workers (reference `table/barrier_table.cc`)."""

    def __init__(self, endpoint: str, tables: List[TableConfig],
                 n_workers: int = 1):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._tables: Dict[int, object] = {}
        self._cfgs: Dict[int, TableConfig] = {}
        self.add_tables(tables)
        self._n_workers = n_workers
        self._barrier_lock = threading.Condition()
        self._barrier_count = 0
        self._barrier_gen = 0
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def add_tables(self, tables: List[TableConfig]):
        """Create `tables` on this server. A server started on port 0
        takes its tables once its endpoint is known (the transpiler
        places tables by endpoint); add them before a client uses them."""
        for cfg in tables:
            if cfg.kind == "dense":
                self._tables[cfg.table_id] = DenseTable(cfg.size, cfg.rule,
                                                        cfg.lr)
            else:
                self._tables[cfg.table_id] = SparseTable(
                    cfg.dim, cfg.rule, cfg.lr, cfg.init_range)
            self._cfgs[cfg.table_id] = cfg
        return self

    @property
    def port(self):
        return self._addr[1]

    @property
    def endpoint(self) -> str:
        """host:port as bound (the port taken when 0 was asked)."""
        return f"{self._addr[0]}:{self._addr[1]}"

    def start(self, block=False):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._addr)
        self._addr = self._sock.getsockname()
        self._sock.listen(128)
        if block:
            self._serve()
        else:
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        return self

    def _serve(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        self._sock.close()

    def _handle(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                hdr = _recv_exact(conn, _HDR.size)
                op, table_id, n_ids, plen = _HDR.unpack(hdr)
                ids = np.frombuffer(_recv_exact(conn, n_ids * 8),
                                    dtype=np.int64) if n_ids else None
                payload = _recv_exact(conn, plen) if plen else b""
                try:
                    status, reply = 0, self._dispatch(op, table_id, ids,
                                                      payload)
                except Exception as e:  # noqa: BLE001 — sent to the client
                    status, reply = 1, repr(e).encode()
                conn.sendall(_REP.pack(status, len(reply)) + reply)
                if op == OP_STOP:
                    self._stop.set()
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _dispatch(self, op, table_id, ids, payload) -> bytes:
        t = self._tables.get(table_id)
        if op == OP_PULL_DENSE:
            return t.pull().tobytes()
        if op == OP_PUSH_DENSE:
            t.push(np.frombuffer(payload, dtype=np.float32))
            return b""
        if op == OP_SET_DENSE:
            t.set(np.frombuffer(payload, dtype=np.float32))
            return b""
        if op == OP_PULL_SPARSE:
            return t.pull(ids).tobytes()
        if op == OP_PUSH_SPARSE:
            t.push(ids, np.frombuffer(payload, dtype=np.float32))
            return b""
        if op == OP_BARRIER:
            with self._barrier_lock:
                gen = self._barrier_gen
                self._barrier_count += 1
                if self._barrier_count >= self._n_workers:
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._barrier_lock.notify_all()
                else:
                    while gen == self._barrier_gen and not \
                            self._stop.is_set():
                        self._barrier_lock.wait(timeout=1.0)
            return b""
        if op == OP_SAVE:
            path = payload.decode()
            for tid, tab in self._tables.items():
                if isinstance(tab, SparseTable):
                    tab.save(f"{path}.table{tid}")
                else:
                    np.save(f"{path}.table{tid}.npy", tab.pull())
            return b""
        if op == OP_LOAD:
            path = payload.decode()
            for tid, tab in self._tables.items():
                if isinstance(tab, SparseTable):
                    if os.path.exists(f"{path}.table{tid}"):
                        tab.load(f"{path}.table{tid}")
                elif os.path.exists(f"{path}.table{tid}.npy"):
                    tab.set(np.load(f"{path}.table{tid}.npy"))
            return b""
        if op == OP_STOP:
            return b""
        raise ValueError(f"unknown op {op}")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)


class PsClient:
    """reference BrpcPsClient: synchronous pull / push (the asynchronous
    batching is `communicator.py`'s)."""

    def __init__(self, endpoints: List[str]):
        self._endpoints = endpoints
        self._socks: Dict[str, socket.socket] = {}
        self._lock = threading.Lock()

    def _sock(self, ep):
        if ep not in self._socks:
            host, port = ep.rsplit(":", 1)
            s = socket.create_connection((host, int(port)), timeout=30)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[ep] = s
        return self._socks[ep]

    def _call(self, ep, op, table_id, ids=None, payload=b""):
        with self._lock:
            s = self._sock(ep)
            n_ids = 0 if ids is None else ids.size
            s.sendall(_HDR.pack(op, table_id, n_ids, len(payload)))
            if ids is not None and ids.size:
                s.sendall(np.ascontiguousarray(ids, np.int64).tobytes())
            if payload:
                s.sendall(payload)
            status, plen = _REP.unpack(_recv_exact(s, _REP.size))
            data = _recv_exact(s, plen) if plen else b""
            if status != 0:
                raise RuntimeError(f"PS call failed on {ep} (op {op}): "
                                   f"{data.decode(errors='replace')}")
            return data

    def _shard_ep(self, ids):
        """A sparse id lives on server |id| mod the server count."""
        n = len(self._endpoints)
        return (np.abs(ids) % n).astype(np.int64)

    def pull_dense(self, table_id, server=0):
        return np.frombuffer(
            self._call(self._endpoints[server], OP_PULL_DENSE, table_id),
            dtype=np.float32).copy()

    def push_dense(self, table_id, grad, server=0):
        self._call(self._endpoints[server], OP_PUSH_DENSE, table_id,
                   payload=np.ascontiguousarray(grad,
                                                np.float32).tobytes())

    def set_dense(self, table_id, vals, server=0):
        self._call(self._endpoints[server], OP_SET_DENSE, table_id,
                   payload=np.ascontiguousarray(vals,
                                                np.float32).tobytes())

    def pull_sparse(self, table_id, ids, dim):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = np.empty((ids.size, dim), dtype=np.float32)
        shard = self._shard_ep(ids)
        for s, ep in enumerate(self._endpoints):
            m = shard == s
            if not m.any():
                continue
            data = self._call(ep, OP_PULL_SPARSE, table_id, ids[m])
            out[m] = np.frombuffer(data, np.float32).reshape(-1, dim)
        return out

    def push_sparse(self, table_id, ids, grads):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, np.float32).reshape(ids.size, -1)
        shard = self._shard_ep(ids)
        for s, ep in enumerate(self._endpoints):
            m = shard == s
            if not m.any():
                continue
            self._call(ep, OP_PUSH_SPARSE, table_id, ids[m],
                       grads[m].tobytes())

    def barrier(self):
        for ep in self._endpoints:
            self._call(ep, OP_BARRIER, 0)

    def _server_path(self, path, i):
        # every server writes `{path}.table{tid}`: over several servers
        # each gets a path of its own, or the last writer's shard would be
        # the only one kept (ROADMAP C41)
        return path if len(self._endpoints) == 1 else f"{path}.server{i}"

    def save(self, path):
        for i, ep in enumerate(self._endpoints):
            self._call(ep, OP_SAVE, 0,
                       payload=self._server_path(path, i).encode())

    def load(self, path):
        for i, ep in enumerate(self._endpoints):
            self._call(ep, OP_LOAD, 0,
                       payload=self._server_path(path, i).encode())

    def stop_server(self):
        for ep in self._endpoints:
            try:
                self._call(ep, OP_STOP, 0)
            except Exception:
                pass

    def close(self):
        for s in self._socks.values():
            try:
                s.close()
            except Exception:
                pass
        self._socks.clear()
