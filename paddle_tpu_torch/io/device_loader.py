"""DeviceFeeder: host-to-device copies overlapped with compute (port of
`paddle_tpu.io.device_loader`; reference `fluid/reader.py`
use_buffer_reader and the GPU `buffered_reader.py` double buffer).

While the consumer's stream works on batch N, a producer thread fetches
batch N+1, copies every array leaf into pinned host memory and issues
its host-to-device copy `non_blocking` on a side CUDA stream, then
records an event after the copies. At hand-out the consumer's current
stream waits on that event (the host does not), and every device leaf
gets `record_stream` of the consumer's stream, so the caching allocator
does not hand its memory to another tensor while the consumer's queued
work still reads it. The pinned buffers rotate over `depth + 1` sets; a
set is overwritten only after the event of the copies that read it has
completed. A worker batch of `io.DataLoader` arrives as views of its
shared-memory ring slot (`DataLoader._iter_borrowed`): the producer
copies it once, straight into the pinned buffer, then hands the slot
back.

`device=None` resolves to the card through `framework.place.
resolve_device` (UnavailableError where there is none); the CPU must be
asked for, and there the feeder only prefetches on its thread, the
leaves copied into fresh CPU tensors.

The feeder keeps the batch's order and structure; `__len__` delegates
to the source; an exception in the source reaches the consumer; the
source iterator is closed from the producer thread (a worker loader's
shutdown must not run in a finalizer). `depth` bounds the staged batches
waiting for the consumer.

Counters (`framework.monitor`): `STAT_device_feeder_batches` (batches
handed out) and `STAT_device_feeder_overlap` (hand-outs whose staging
hid behind the consumer's work: the consumer waited for less than 25 %
of the wall time since the previous hand-out; the first hand-out never
counts). Spans `feeder::fetch` and `feeder::stage` time the producer's
two parts.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..framework import monitor
from ..framework.place import resolve_device
from ..profiler import RecordEvent
from .dataloader import Borrowed, DataLoader, _to_tensors

__all__ = ["DeviceFeeder"]

_DONE = object()


def _leaf_dtype(x):
    """The torch dtype a host leaf stages as (float64 narrowed to
    float32, as the loader narrows it), or None for a leaf that is not
    an array torch holds."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.float64:
            return torch.float32
        try:
            return torch.from_numpy(np.empty(0, x.dtype)).dtype
        except TypeError:
            return None
    if torch.is_tensor(x) and x.device.type == "cpu":
        return x.dtype
    return None


class _Stager:
    """The producer's pinned buffers and side stream for one iteration."""

    def __init__(self, device, sets):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.sets = [{"bufs": [], "event": None} for _ in range(sets)]
        self.turn = 0

    def _pinned(self, bufs, i, nbytes):
        if i == len(bufs):
            bufs.append(None)
        b = bufs[i]
        if b is None or b.numel() < nbytes:
            b = bufs[i] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                      pin_memory=True)
        return b

    def stage(self, batch):
        """The batch with every array leaf copied to the device on the
        side stream, and the event recorded after those copies."""
        cur = self.sets[self.turn]
        self.turn = (self.turn + 1) % len(self.sets)
        if cur["event"] is not None:
            cur["event"].synchronize()   # its pinned bytes are read
        bufs, n = cur["bufs"], [0]

        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(put(v) for v in x)
            if torch.is_tensor(x) and x.device == self.device:
                return x
            dt = _leaf_dtype(x)
            if dt is None:
                return x
            shape = tuple(x.shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            host = self._pinned(bufs, n[0], nbytes)[:nbytes].view(dt) \
                .view(shape)
            n[0] += 1
            if torch.is_tensor(x):
                host.copy_(x)
            else:
                np.copyto(host.numpy(), x)
            with torch.cuda.stream(self.stream):
                dev = torch.empty(shape, dtype=dt, device=self.device)
                dev.copy_(host, non_blocking=True)
            return dev

        out = put(batch)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        cur["event"] = ev
        return out, ev


def _handed(tree, stream):
    """Mark every device leaf of `tree` as used by `stream`."""
    if torch.is_tensor(tree):
        if tree.device.type == "cuda":
            tree.record_stream(stream)
    elif isinstance(tree, dict):
        for v in tree.values():
            _handed(v, stream)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _handed(v, stream)


class DeviceFeeder:
    """Double-buffered device feed over any batch iterator (see the
    module docstring)."""

    def __init__(self, loader, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"DeviceFeeder depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def __len__(self):
        # a generator has no __len__ and a DataLoader over an
        # IterableDataset raises TypeError from its own: both surface as
        # TypeError, so callers probing with try/except go countless
        n = getattr(self.loader, "__len__", None)
        if n is None:
            raise TypeError(
                f"{type(self.loader).__name__} loader has no __len__; "
                "iterate the feeder instead of sizing it")
        return n()

    def _source(self):
        if isinstance(self.loader, DataLoader):
            return self.loader._iter_borrowed()
        return iter(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        it = self._source()
        dev = self.device
        cuda = dev.type == "cuda"
        stager = _Stager(dev, self.depth + 1) if cuda else None

        def stage(batch):
            if isinstance(batch, Borrowed):
                try:
                    if cuda:
                        return stager.stage(batch.batch)
                    return _to_tensors(batch.batch, copy=True), None
                finally:
                    batch.release()
            if cuda:
                return stager.stage(batch)
            return _to_tensors(batch), None

        def offer(item):
            # a bounded put that stays responsive to the consumer's exit
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if cuda:
                    torch.cuda.set_device(dev)
                while not stop.is_set():
                    try:
                        with RecordEvent("feeder::fetch"):
                            batch = next(it)
                    except StopIteration:
                        break
                    with RecordEvent("feeder::stage"):
                        item = stage(batch)
                    del batch
                    if not offer(item):
                        return
            except BaseException as e:  # noqa: BLE001 — to the consumer
                offer(e)
                return
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
            offer(_DONE)

        t = threading.Thread(target=produce, daemon=True,
                             name="paddle_tpu_torch-device-feeder")
        t.start()
        try:
            last = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                item = q.get()
                now = time.perf_counter()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, ev = item
                if ev is not None:
                    s = torch.cuda.current_stream(dev)
                    s.wait_event(ev)
                    _handed(batch, s)
                wait, elapsed = now - t0, now - last
                if wait < 0.25 * elapsed:
                    monitor.stat_add("STAT_device_feeder_overlap")
                monitor.stat_add("STAT_device_feeder_batches")
                last = now
                yield batch
        finally:
            stop.set()
            while True:   # unblock a producer parked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # a producer inside next(it) on a slow batch sees `stop` only
            # when that batch lands: do not stall the caller for it
            t.join(timeout=1)
