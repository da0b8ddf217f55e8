"""ctypes bindings for the parameter server's native table core (port of
`paddle_tpu.distributed.ps.tables`; reference
`paddle/fluid/distributed/table/common_{dense,sparse}_table.cc`).

The core is the JAX package's C++ source, copied to
`paddle_tpu_torch/csrc/ps_core.cc` and built here at first use
(`framework/native.py`), so a table of either package with the same
seed and the same pushes holds the same bits, and a sparse table saved
by one loads in the other."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ...framework import native

__all__ = ["DenseTable", "SparseTable", "native_available"]

_LIB: Optional[ctypes.CDLL] = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = native.load("ps_core.cc")
    lib.dense_table_create.restype = ctypes.c_void_p
    lib.dense_table_create.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                       ctypes.c_float]
    lib.dense_table_destroy.argtypes = [ctypes.c_void_p]
    lib.dense_table_pull.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int64]
    lib.dense_table_push.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int64]
    lib.dense_table_set.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int64]
    lib.sparse_table_create.restype = ctypes.c_void_p
    lib.sparse_table_create.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                        ctypes.c_float, ctypes.c_float,
                                        ctypes.c_uint32]
    lib.sparse_table_destroy.argtypes = [ctypes.c_void_p]
    lib.sparse_table_pull.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_float)]
    lib.sparse_table_push.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_float)]
    lib.sparse_table_size.restype = ctypes.c_int64
    lib.sparse_table_size.argtypes = [ctypes.c_void_p]
    lib.sparse_table_save.restype = ctypes.c_int64
    lib.sparse_table_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sparse_table_load.restype = ctypes.c_int64
    lib.sparse_table_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the table core builds and loads here."""
    try:
        _load()
        return True
    except Exception:  # noqa: BLE001 — the answer is the question
        return False


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class DenseTable:
    def __init__(self, size: int, rule: str = "sgd", lr: float = 0.01):
        self.size = int(size)
        self._lib = _load()
        self._h = self._lib.dense_table_create(self.size, rule.encode(),
                                               float(lr))

    def pull(self) -> np.ndarray:
        out = np.empty(self.size, dtype=np.float32)
        self._lib.dense_table_pull(self._h, _fp(out), self.size)
        return out

    def push(self, grad: np.ndarray):
        g = np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)
        self._lib.dense_table_push(self._h, _fp(g), g.size)

    def set(self, vals: np.ndarray):
        v = np.ascontiguousarray(vals, dtype=np.float32).reshape(-1)
        self._lib.dense_table_set(self._h, _fp(v), v.size)

    def __del__(self):
        try:
            self._lib.dense_table_destroy(self._h)
        except Exception:
            pass


class SparseTable:
    def __init__(self, dim: int, rule: str = "sgd", lr: float = 0.01,
                 init_range: float = 0.05, seed: int = 0):
        self.dim = int(dim)
        self._lib = _load()
        self._h = self._lib.sparse_table_create(self.dim, rule.encode(),
                                                float(lr), float(init_range),
                                                int(seed))

    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.int64).reshape(-1)
        out = np.empty((ids.size, self.dim), dtype=np.float32)
        self._lib.sparse_table_pull(self._h, _ip(ids), ids.size, _fp(out))
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray):
        ids = np.ascontiguousarray(ids, dtype=np.int64).reshape(-1)
        g = np.ascontiguousarray(grads, dtype=np.float32).reshape(
            ids.size, self.dim)
        self._lib.sparse_table_push(self._h, _ip(ids), ids.size, _fp(g))

    def __len__(self):
        return int(self._lib.sparse_table_size(self._h))

    def save(self, path: str) -> int:
        return int(self._lib.sparse_table_save(self._h, path.encode()))

    def load(self, path: str) -> int:
        return int(self._lib.sparse_table_load(self._h, path.encode()))

    def __del__(self):
        try:
            self._lib.sparse_table_destroy(self._h)
        except Exception:
            pass
