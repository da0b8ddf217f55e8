"""The slot-file dataset pipeline (port of
`paddle_tpu.distributed.fleet.dataset`; reference
`fleet/dataset/dataset.py` InMemoryDataset / QueueDataset over the C++
`framework/data_feed.cc` MultiSlotDataFeed:664 and `data_set.cc`
DatasetImpl LoadIntoMemory / LocalShuffle / GlobalShuffle; the user's
ETL through `fleet/data_generator/data_generator.py`
MultiSlotDataGenerator).

Slot files are parsed by the native parser (`csrc/data_feed.cc`, built
at first use by `framework/native.py`), held in memory as one tuple of
per-slot arrays a record, shuffled with Python's `random` (unseeded
here: seed it with `random.seed` for a replayable order;
`global_shuffle` is the local shuffle, as in the JAX package), and
batched into padded numpy arrays, [B, the batch's longest record] a
slot, int64 or float32. The per-record loops run in Python, as the JAX
package's do.
"""
from __future__ import annotations

import ctypes
import random
import sys
from typing import List, Optional, Sequence

import numpy as np

from ...framework import native

__all__ = ["InMemoryDataset", "QueueDataset", "MultiSlotDataGenerator"]

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = native.load("data_feed.cc")
    lib.data_feed_parse.restype = ctypes.c_void_p
    lib.data_feed_parse.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int]
    lib.data_feed_n_lines.restype = ctypes.c_int64
    lib.data_feed_n_lines.argtypes = [ctypes.c_void_p]
    lib.data_feed_slot_size.restype = ctypes.c_int64
    lib.data_feed_slot_size.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    for name, ptr in (("data_feed_copy_int", ctypes.c_int64),
                      ("data_feed_copy_float", ctypes.c_float),
                      ("data_feed_copy_lengths", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ptr)]
    lib.data_feed_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class _Slot:
    def __init__(self, name, dtype):
        self.name = name
        self.dtype = dtype  # "int64" | "float32"


class InMemoryDataset:
    """reference InMemoryDataset: set_use_var/set_batch_size/
    load_into_memory/local_shuffle → iterate batches."""

    def __init__(self):
        self._slots: List[_Slot] = []
        self._batch_size = 1
        self._files: List[str] = []
        self._records: Optional[list] = None
        self._thread_num = 1

    def init(self, batch_size=1, use_var=None, thread_num=1, **kwargs):
        self._batch_size = batch_size
        self._thread_num = thread_num
        if use_var:
            self.set_use_var(use_var)

    def set_use_var(self, slots):
        self._slots = []
        for s in slots:
            if hasattr(s, "dtype"):
                dt = "float32" if "float" in str(s.dtype) else "int64"
                self._slots.append(_Slot(getattr(s, "name", "slot"), dt))
            elif isinstance(s, tuple):
                self._slots.append(_Slot(s[0], s[1]))
            else:
                self._slots.append(_Slot(str(s), "int64"))

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, n):
        self._thread_num = n

    def set_filelist(self, files):
        self._files = list(files)

    def load_into_memory(self):
        lib = _load()
        schema = (ctypes.c_int * len(self._slots))(
            *[0 if s.dtype == "int64" else 1 for s in self._slots])
        self._records = []
        for path in self._files:
            h = lib.data_feed_parse(path.encode(), schema, len(self._slots))
            if not h:
                raise FileNotFoundError(path)
            n = lib.data_feed_n_lines(h)
            per_slot = []
            for si, s in enumerate(self._slots):
                is_f = 1 if s.dtype == "float32" else 0
                total = lib.data_feed_slot_size(h, si, is_f)
                lens = np.empty(n, np.int64)
                lib.data_feed_copy_lengths(
                    h, si, lens.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int64)))
                if is_f:
                    vals = np.empty(total, np.float32)
                    lib.data_feed_copy_float(
                        h, si, vals.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_float)))
                else:
                    vals = np.empty(total, np.int64)
                    lib.data_feed_copy_int(
                        h, si, vals.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int64)))
                offs = np.concatenate([[0], np.cumsum(lens)])
                per_slot.append((vals, offs))
            lib.data_feed_destroy(h)
            for i in range(n):
                rec = tuple(vals[offs[i]:offs[i + 1]]
                            for vals, offs in per_slot)
                self._records.append(rec)

    def local_shuffle(self):
        random.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=None):
        """The local shuffle: records are not exchanged between workers
        (the JAX package's `dataset.py:138-141`; ROADMAP C40)."""
        self.local_shuffle()

    def release_memory(self):
        self._records = None

    def get_memory_data_size(self, fleet=None):
        return len(self._records or [])

    def __iter__(self):
        """Yield padded dense batches: per slot [B, max_len] (int64) or
        [B, max_len] float32 plus a length array."""
        recs = self._records or []
        for i in range(0, len(recs), self._batch_size):
            chunk = recs[i:i + self._batch_size]
            batch = []
            for si, s in enumerate(self._slots):
                rows = [r[si] for r in chunk]
                ml = max((len(r) for r in rows), default=1) or 1
                dt = np.int64 if s.dtype == "int64" else np.float32
                arr = np.zeros((len(rows), ml), dt)
                for j, r in enumerate(rows):
                    arr[j, :len(r)] = r
                batch.append(arr)
            yield tuple(batch)


class QueueDataset(InMemoryDataset):
    """Streaming variant: parses per-file lazily."""

    def load_into_memory(self):
        pass

    def __iter__(self):
        for f in self._files:
            self._records = None
            files, self._files = self._files, [f]
            try:
                InMemoryDataset.load_into_memory(self)
                yield from InMemoryDataset.__iter__(self)
            finally:
                self._files = files


class MultiSlotDataGenerator:
    """reference `data_generator.py:278`: user overrides generate_sample;
    run_from_stdin/_from_files writes the slot text format the C++ parser
    reads."""

    def generate_sample(self, line):
        raise NotImplementedError

    def _format(self, sample) -> str:
        parts = []
        for _name, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def run_from_files(self, in_files: Sequence[str], out_file: str):
        with open(out_file, "w") as out:
            for path in in_files:
                with open(path) as f:
                    for line in f:
                        gen = self.generate_sample(line)
                        for sample in (gen() if callable(gen) else gen):
                            out.write(self._format(sample) + "\n")

    def run_from_stdin(self):
        for line in sys.stdin:
            gen = self.generate_sample(line)
            for sample in (gen() if callable(gen) else gen):
                sys.stdout.write(self._format(sample) + "\n")
