"""DataLoader (port of `paddle_tpu.io.dataloader`; reference
`fluid/reader.py:149` + `fluid/dataloader/dataloader_iter.py:265/469`).

Batches are collated on the host into CPU tensors (float64 narrowed to
float32, as the JAX package does). Four ways to produce them:

- `num_workers=0`: in the calling thread;
- an `IterableDataset`: its stream, cut into batches in the calling
  thread (workers are not used for a stream, as in the JAX package);
- `use_thread_workers=True`: an ordered pool of `num_workers` threads;
- `num_workers > 0`: worker PROCESSES (forked where the platform can)
  that fetch and collate to numpy and ship each batch through a POSIX
  shared-memory ring of `num_workers * prefetch_factor` reusable slots.
  A worker claims a free slot, writes the batch's arrays into its
  segment and sends the layout on a small queue; the parent copies the
  arrays out once and hands the slot back. A slot's segment is made
  again only when a batch outgrows it, so after the first lap no segment
  is created, mapped or unlinked. Batches are handed out in order. A
  worker's exception reaches the parent with its traceback; a dead
  worker or `timeout` (seconds without a batch; 0 waits forever) raises
  RuntimeError and writes a flight-recorder dump. Shutdown sweeps
  exactly the ring's slot names.

Worker processes run the dataset and the collate function only: they
never touch the card (the parent may have CUDA initialised when it
forks), and they run torch with one intra-op thread, since a forked
OpenMP pool can deadlock. No worker is given a seed, as in the JAX
package (ROADMAP C26): each inherits the parent's numpy state, so the
workers repeat each other's numpy draws, and Python reseeds `random`
from the OS in a forked child, so their `random` draws follow no seed.

A `torch.from_numpy` view of a slot would alias memory the next batch
overwrites, so every array is copied out of its slot exactly once:
into a fresh array here, or, when `io.DeviceFeeder` drives the loader,
straight into the feeder's pinned staging buffer (`_iter_borrowed`).

Counters (`framework.monitor`, parent side): `STAT_dataloader_batches`
(batches handed out), `STAT_shm_slot_segments` (ring segments the parent
mapped: the ring's size plus regrows, however long the epoch) and
`STAT_shm_slots_reused` (batches read from an already mapped segment).
Each worker zeroes its copy of the registry when it starts and ships
`monitor.drain_deltas()` with every result, which the parent merges, so
any counter or histogram a dataset or collate_fn bumps in a worker
counts in the parent exactly once.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
import traceback as _traceback
import uuid

import numpy as np
import torch

from ..framework import monitor
from ..profiler import flight_recorder
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "WorkerInfo"]

_worker_info = threading.local()


def get_worker_info():
    """The `WorkerInfo` of the calling worker (process or thread), None
    outside a worker."""
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def default_collate_fn(batch):
    """Stack a list of samples (reference
    `fluid/dataloader/collate.py:default_collate_fn`)."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if torch.is_tensor(sample):
        return torch.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items))
                     for items in zip(*batch))
    return batch


def _to_tensors(collated, copy=False):
    """numpy leaves to CPU tensors (float64 narrowed to float32); with
    `copy`, leaves that view memory the caller will reuse are copied."""
    if isinstance(collated, np.ndarray):
        if collated.dtype == np.float64:
            collated = collated.astype(np.float32)
        elif copy:
            collated = collated.copy()
        return torch.from_numpy(np.ascontiguousarray(collated))
    if isinstance(collated, dict):
        return {k: _to_tensors(v, copy) for k, v in collated.items()}
    if isinstance(collated, (list, tuple)):
        return type(collated)(_to_tensors(v, copy) for v in collated)
    return collated


class Borrowed:
    """A worker batch whose array leaves are numpy views of a ring slot.
    The holder copies the leaves out and then calls `release()`, which
    hands the slot back to the workers; `DataLoader._iter_borrowed`
    yields these, and `io.DeviceFeeder` stages them."""
    __slots__ = ("batch", "_release")

    def __init__(self, batch, release):
        self.batch = batch
        self._release = release

    def release(self):
        r, self._release = self._release, None
        self.batch = None
        if r is not None:
            r()


# ---------------------------------------------------------------------------
# worker processes over a reusable shared-memory slot ring
# ---------------------------------------------------------------------------

class _ArrRef:
    """Placeholder for an ndarray leaf stripped out of a collated batch."""
    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = idx


# shutdown token pushed onto the free-slot queue so a worker blocked on a
# slot claim wakes up, drops its task and reaches the task sentinel
_RING_ABORT = -1


def _untrack(shm):
    """The parent owns every ring segment's lifetime (it unlinks them at
    shutdown): take the segment off this process's resource_tracker, so
    neither a worker's exit nor a second unregister frees a live slot."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _slot_name(uid, slot):
    return f"{uid}r{slot}"


def _close(shm):
    try:
        shm.close()
    except Exception:   # a live view keeps the mapping; unlink still works
        pass


def _ring_claim(slot_q, cache, uid, needed):
    """Claim a free ring slot with capacity >= `needed` bytes.

    Returns (slot, gen, size, shm), or None on shutdown. The (gen, size)
    pair from the free queue is authoritative: gen moves each time the
    slot's segment is made again, so every process's handle cache can
    tell a stale mapping from a live one."""
    from multiprocessing import shared_memory
    slot, gen, size = slot_q.get()
    if slot == _RING_ABORT:
        return None
    cached = cache.pop(slot, None)
    if cached is not None and cached[0] != gen:
        _close(cached[1])
        cached = None
    if size < needed:
        # regrow: drop the segment and make the same name larger. The
        # unlink goes through a fresh attach, whose tracker registration
        # pairs with unlink's unregister (cached handles were untracked)
        if cached is not None:
            _close(cached[1])
            cached = None
        if size > 0:
            try:
                old = shared_memory.SharedMemory(name=_slot_name(uid, slot))
                old.unlink()
                old.close()
            except Exception:
                pass
        shm = shared_memory.SharedMemory(name=_slot_name(uid, slot),
                                         create=True, size=needed)
        _untrack(shm)
        gen += 1
        size = needed
    elif cached is None:
        shm = shared_memory.SharedMemory(name=_slot_name(uid, slot))
        _untrack(shm)
    else:
        shm = cached[1]
    cache[slot] = (gen, shm)
    return slot, gen, size, shm


def _shm_encode_ring(obj, slot_q, cache, uid):
    """Strip the array leaves of a collated batch into a claimed slot.

    Returns (tree, slot, gen, size, specs), slot None when the batch
    holds no arrays, or None when shutdown raced the claim. A failure
    after the claim hands the slot back before it propagates."""
    arrays = []

    def strip(x):
        if torch.is_tensor(x):
            x = x.detach().numpy()
        if isinstance(x, np.ndarray):
            arrays.append(np.ascontiguousarray(x))
            return _ArrRef(len(arrays) - 1)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x

    tree = strip(obj)
    if not arrays:
        return tree, None, 0, 0, []
    total = sum(a.nbytes for a in arrays) or 1
    claim = _ring_claim(slot_q, cache, uid, total)
    if claim is None:
        return None
    slot, gen, size, shm = claim
    try:
        specs, off = [], 0
        for a in arrays:
            if a.nbytes:
                dst = np.ndarray(a.shape, a.dtype, buffer=shm.buf,
                                 offset=off)
                np.copyto(dst, a)
            specs.append((off, a.shape, a.dtype.str))
            off += a.nbytes
    except BaseException:
        slot_q.put((slot, gen, size))
        raise
    return tree, slot, gen, size, specs


def _rebuild(tree, arrays):
    if isinstance(tree, _ArrRef):
        return arrays[tree.idx]
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, arrays) for v in tree)
    return tree


def _shm_decode_ring(payload, slot_q, cache, uid, borrow):
    """The batch of a ring payload. Without `borrow` its arrays are
    copied out of the slot and the slot is handed back at once; with
    `borrow` the arrays are views of the slot, returned as a `Borrowed`
    whose `release()` hands the slot back."""
    tree, slot, gen, size, specs = payload
    if slot is None:
        return Borrowed(tree, None) if borrow else tree
    from multiprocessing import shared_memory
    cached = cache.get(slot)
    if cached is None or cached[0] != gen:
        if cached is not None:
            _close(cached[1])
        shm = shared_memory.SharedMemory(name=_slot_name(uid, slot))
        _untrack(shm)   # the iterator's shutdown sweep owns the unlink
        cache[slot] = (gen, shm)
        monitor.stat_add("STAT_shm_slot_segments")
    else:
        shm = cached[1]
        monitor.stat_add("STAT_shm_slots_reused")

    def give_back():
        slot_q.put((slot, gen, size))

    try:
        views = [np.ndarray(shape, np.dtype(dt), buffer=shm.buf, offset=off)
                 for off, shape, dt in specs]
        if borrow:
            return Borrowed(_rebuild(tree, views), give_back)
        arrays = [v.copy() for v in views]
    except BaseException:
        give_back()
        raise
    del views
    give_back()
    return _rebuild(tree, arrays)


def _mp_worker_loop(dataset, collate_fn, worker_init_fn, wid, nw,
                    task_q, result_q, slot_q, use_shm, uid):
    """Target of one worker process: the dataset and the collate function
    only, never the card."""
    torch.set_num_threads(1)
    _worker_info.info = WorkerInfo(wid, nw, dataset)
    # the fork inherited the parent's counts: zero this process's copy so
    # every shipped delta is work done here
    monitor.reset_all_stats()
    ring_cache = {}   # slot -> (gen, SharedMemory): this worker's mappings
    rc = 0
    if worker_init_fn:
        try:
            worker_init_fn(wid)
        except Exception:
            result_q.put((-1, "err", _traceback.format_exc(), None))
            rc = 1
    while not rc:
        item = task_q.get()
        if item is None:
            break
        seq, indices = item
        try:
            out = collate_fn([dataset[i] for i in indices])
            if use_shm:
                payload = _shm_encode_ring(out, slot_q, ring_cache, uid)
                if payload is None:   # shutdown raced the slot claim
                    continue
            else:
                payload = (out, None, 0, 0, [])
            result_q.put((seq, "ok", payload, monitor.drain_deltas()))
        except Exception:
            result_q.put((seq, "err", _traceback.format_exc(),
                          monitor.drain_deltas()))
    for _, shm in ring_cache.values():
        _close(shm)
    result_q.close()
    result_q.join_thread()   # flush the queue's feeder thread first
    os._exit(rc)             # skip atexit: the fork inherited CUDA state


class DataLoader:
    """Batches of `dataset` (see the module docstring). The signature is
    the JAX package's (`paddle_tpu/io/dataloader.py:333-338`):
    `feed_list`, `places` and `return_list` are accepted and not read;
    `use_buffer_reader` tells `hapi.Model` to feed the batches through an
    `io.DeviceFeeder`; `persistent_workers` is accepted and not read
    (workers live for one epoch)."""

    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_thread_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.use_thread_workers = use_thread_workers
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        return self._iter(borrow=False)

    def _iter_borrowed(self):
        """Like `iter(self)`, but worker batches come as `Borrowed` views
        of their ring slots, for a consumer that copies them out once
        (`io.DeviceFeeder`); the other modes yield their batches as
        usual."""
        return self._iter(borrow=True)

    def _iter(self, borrow):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_single()
        if self.use_thread_workers:
            return self._iter_threaded()
        return self._iter_multiprocess(borrow)

    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        monitor.stat_add("STAT_dataloader_batches")
        return _to_tensors(self.collate_fn(samples))

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                monitor.stat_add("STAT_dataloader_batches")
                yield _to_tensors(self.collate_fn(batch))
                batch = []
        if batch and not self.drop_last:
            monitor.stat_add("STAT_dataloader_batches")
            yield _to_tensors(self.collate_fn(batch))

    def _iter_multiprocess(self, borrow=False):
        """Worker processes over the shared-memory ring (reference
        `_DataLoaderIterMultiProcess`, `dataloader_iter.py:469`). The ring
        holds `num_workers * prefetch_factor` slots, the prefetch window,
        so the set of segment names is fixed: shutdown sweeps those."""
        ctx = mp.get_context("fork" if "fork" in mp.get_all_start_methods()
                             else "spawn")
        flight_recorder.touch()   # crash context for worker-death raises
        nw = self.num_workers
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        slot_q = ctx.Queue()
        use_shm = self.use_shared_memory
        # deterministic slot names ("<uid>r<slot>") let shutdown sweep the
        # whole ring even when a killed worker never reported its claim
        uid = f"ptt{os.getpid()}x{uuid.uuid4().hex[:8]}"
        n_slots = max(1, nw * self.prefetch_factor)
        if use_shm:
            for slot in range(n_slots):
                slot_q.put((slot, 0, 0))   # gen 0, size 0: not made yet
        procs = [ctx.Process(
            target=_mp_worker_loop,
            args=(self.dataset, self.collate_fn, self.worker_init_fn,
                  wid, nw, task_q, result_q, slot_q, use_shm, uid),
            daemon=True) for wid in range(nw)]
        for p in procs:
            p.start()

        batches = list(self.batch_sampler)
        total = len(batches)
        sent = 0
        for seq in range(min(n_slots, total)):
            task_q.put((seq, batches[seq]))
            sent += 1
        pending = {}
        ring_cache = {}   # slot -> (gen, SharedMemory): the parent's maps

        def shutdown():
            # drop queued work so workers reach the sentinel quickly even
            # when the consumer left the epoch early
            while True:
                try:
                    task_q.get_nowait()
                except Exception:
                    break
            if use_shm:
                # wake workers parked on a slot claim
                for _ in procs:
                    try:
                        slot_q.put((_RING_ABORT, 0, 0))
                    except Exception:
                        pass
            for _ in procs:
                try:
                    task_q.put(None)
                except Exception:
                    pass
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
            for _, shm in ring_cache.values():
                _close(shm)
            ring_cache.clear()
            pending.clear()
            if use_shm:
                from multiprocessing import shared_memory
                for slot in range(n_slots):
                    try:
                        leak = shared_memory.SharedMemory(
                            name=_slot_name(uid, slot))
                    except FileNotFoundError:
                        continue
                    except Exception:
                        break
                    try:
                        # the attach registered the name; unlink's own
                        # unregister pairs with it
                        leak.unlink()
                        leak.close()
                    except Exception:
                        pass

        poll = min(5.0, float(self.timeout)) if self.timeout else 5.0
        try:
            deadline = (time.monotonic() + self.timeout
                        if self.timeout else None)
            for want in range(total):
                while want not in pending:
                    try:
                        seq, status, payload, deltas = result_q.get(
                            timeout=poll)
                        # a failed batch ships its deltas too: the work
                        # done before the failure stays counted
                        monitor.merge_deltas(deltas)
                    except queue.Empty:
                        dead = [p.pid for p in procs if not p.is_alive()]
                        if dead:
                            flight_recorder.dump(
                                "dataloader_worker_crash",
                                {"dead_pids": dead, "batch": want,
                                 "num_workers": nw, "sent": sent,
                                 "total": total})
                            raise RuntimeError(
                                f"DataLoader worker(s) {dead} died while "
                                f"batch {want} was outstanding") from None
                        if deadline and time.monotonic() > deadline:
                            flight_recorder.dump(
                                "dataloader_timeout",
                                {"timeout_s": self.timeout, "batch": want,
                                 "num_workers": nw})
                            raise RuntimeError(
                                f"DataLoader timed out after "
                                f"{self.timeout}s waiting for batch "
                                f"{want}") from None
                        continue
                    if status == "err":
                        flight_recorder.dump(
                            "dataloader_worker_error",
                            {"batch": int(seq), "num_workers": nw,
                             "error": payload.splitlines()[-1]
                             if payload else ""})
                        raise RuntimeError(
                            "DataLoader worker raised:\n" + payload)
                    pending[seq] = payload
                if sent < total:
                    task_q.put((sent, batches[sent]))
                    sent += 1
                deadline = (time.monotonic() + self.timeout
                            if self.timeout else None)
                monitor.stat_add("STAT_dataloader_batches")
                out = _shm_decode_ring(pending.pop(want), slot_q,
                                       ring_cache, uid, borrow)
                yield out if borrow else _to_tensors(out)
        finally:
            shutdown()

    def _iter_threaded(self):
        """Ordered prefetch over `num_workers` threads, at most
        `num_workers * prefetch_factor` batches ahead."""
        nw = self.num_workers
        task_q: "queue.Queue" = queue.Queue(nw * self.prefetch_factor)
        done = object()
        results = {}
        results_lock = threading.Condition()
        stop = threading.Event()

        def worker(wid):
            _worker_info.info = WorkerInfo(wid, nw, self.dataset)
            if self.worker_init_fn:
                self.worker_init_fn(wid)
            while not stop.is_set():
                item = task_q.get()
                if item is done:
                    task_q.put(done)
                    return
                seq, indices = item
                try:
                    out = self._fetch(indices)
                except Exception as e:   # handed to the consumer
                    out = e
                with results_lock:
                    results[seq] = out
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                    name=f"paddle_tpu_torch-loader-w{i}")
                   for i in range(nw)]
        for t in threads:
            t.start()

        def feeder():
            for seq, indices in enumerate(self.batch_sampler):
                if stop.is_set():
                    return
                task_q.put((seq, indices))
            task_q.put(done)

        threading.Thread(target=feeder, daemon=True).start()
        total = len(self.batch_sampler)
        try:
            for seq in range(total):
                with results_lock:
                    while seq not in results:
                        results_lock.wait(timeout=self.timeout or None)
                    out = results.pop(seq)
                if isinstance(out, Exception):
                    raise out
                yield out
        finally:
            stop.set()
            try:
                task_q.put_nowait(done)
            except queue.Full:
                pass
