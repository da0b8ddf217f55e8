"""paddle_tpu_torch.io, the rest, held to paddle_tpu.io on the same numpy
data: the dataset combinators and `random_split`, the samplers, the
thread workers, the iterable mode, and the worker processes over the
shared-memory ring.

- `ComposeDataset`, `ChainDataset`, `ConcatDataset`, `Subset` give the
  JAX package's items; `random_split`, `RandomSampler(replacement=True)`
  and `WeightedRandomSampler` draw from numpy's global generator in both
  packages, so one `np.random.seed` gives the same indices. Without
  replacement `RandomSampler` keeps the port's own permutation (a torch
  generator from `framework.random`, PR 2's order), so `num_samples`
  truncates that: held to distinct in-range indices and, over many
  epochs, to every index being drawn about equally often;
- the thread loader and the iterable mode yield the JAX package's
  batches in order;
- worker processes (`num_workers=2`, small batches): the batches, their
  order and bytes equal the in-process loader's and the JAX loader's;
  `get_worker_info` inside a worker; a counter the dataset bumps in the
  workers reaches the parent once a sample; the ring's segment counters;
  a worker's exception arrives with its traceback; a killed worker and
  a `timeout` raise RuntimeError within 10 s; no ring name is left in
  /dev/shm after an epoch, an early exit or a failure.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import monitor


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, (list, tuple)) else [g]
        w = w if isinstance(w, (list, tuple)) else [w]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = _np(a), _np(b)
            if a.dtype == np.int64 and b.dtype == np.int32:
                b = b.astype(np.int64)   # JAX runs without 64-bit ints
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _ring_names():
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("ptt")}
    except FileNotFoundError:
        return set()


def _arrays(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 3)),
            rng.randint(0, 9, size=(n,)).astype(np.int64))


# -- datasets ---------------------------------------------------------------

def test_dataset_combinators_match_jax():
    x, y = _arrays()
    tx, ty = tio.TensorDataset([x]), tio.TensorDataset([y])
    jx, jy = jio.TensorDataset([x]), jio.TensorDataset([y])
    pairs = [(tio.ComposeDataset([tx, ty]), jio.ComposeDataset([jx, jy])),
             (tio.ConcatDataset([tx, ty]), jio.ConcatDataset([jx, jy])),
             (tio.Subset(tx, [3, 1, 4]), jio.Subset(jx, [3, 1, 4]))]
    for t, j in pairs:
        assert len(t) == len(j)
        for i in list(range(len(j))) + [-1]:
            _same_batches([t[i]], [j[i]])

    class TS(tio.IterableDataset):
        def __init__(self, k):
            self.k = k

        def __iter__(self):
            return iter(range(self.k))

    class JS(jio.IterableDataset):
        __init__ = TS.__init__
        __iter__ = TS.__iter__

    # iterated, not list()ed: list() asks __len__ for a hint, which an
    # iterable dataset refuses with RuntimeError in both packages
    assert [v for v in tio.ChainDataset([TS(2), TS(3)])] == \
        [v for v in jio.ChainDataset([JS(2), JS(3)])] == [0, 1, 0, 1, 2]
    with pytest.raises(RuntimeError):
        len(TS(2))


def test_random_split_matches_jax():
    data_t, data_j = tio.TensorDataset([np.arange(20)]), \
        jio.TensorDataset([np.arange(20)])
    np.random.seed(5)
    j = jio.random_split(data_j, [12, 5, 3])
    np.random.seed(5)
    t = tio.random_split(data_t, [12, 5, 3])
    assert [s.indices for s in t] == [s.indices for s in j]
    assert sorted(i for s in t for i in s.indices) == list(range(20))
    with pytest.raises(ValueError):
        tio.random_split(data_t, [3, 3])


# -- samplers ---------------------------------------------------------------

def test_samplers_drawn_from_numpy_match_jax():
    data = list(range(10))
    np.random.seed(1)
    jr = list(jio.RandomSampler(data, replacement=True, num_samples=7))
    jw = list(jio.WeightedRandomSampler([0.1, 0.0, 0.5, 0.4], 6))
    jwn = list(jio.WeightedRandomSampler([1, 2, 3, 4], 3,
                                         replacement=False))
    np.random.seed(1)
    tr = tio.RandomSampler(data, replacement=True, num_samples=7)
    assert len(tr) == 7
    assert list(tr) == jr
    tw = tio.WeightedRandomSampler([0.1, 0.0, 0.5, 0.4], 6)
    assert len(tw) == 6 and list(tw) == jw
    assert 1 not in jw
    assert list(tio.WeightedRandomSampler([1, 2, 3, 4], 3,
                                          replacement=False)) == jwn


def test_random_sampler_num_samples_in_distribution():
    """The port's permutation is its own (framework.random's torch
    generator; PR 2's order is kept), so `num_samples` is held to the
    contract, not to the JAX indices: each epoch draws `num_samples`
    distinct in-range indices, and over 3000 epochs every index is
    drawn 900 times in expectation (binomial sd 25; limit 6 sd)."""
    data = list(range(10))
    s = tio.RandomSampler(data, num_samples=3)
    assert len(s) == 3
    counts = np.zeros(10)
    for e in range(3000):
        s.set_epoch(e)
        got = list(s)
        assert len(got) == len(set(got)) == 3
        assert all(0 <= i < 10 for i in got)
        counts[got] += 1
    assert np.abs(counts - 900).max() < 6 * 25.1
    whole = tio.RandomSampler(data)
    assert sorted(whole) == data


# -- loaders in the process -------------------------------------------------

def test_thread_workers_and_iterable_mode_match_jax():
    x, y = _arrays(11)
    want = list(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=3))
    got = list(tio.DataLoader(tio.TensorDataset([x, y]), batch_size=3,
                              num_workers=3, use_thread_workers=True,
                              prefetch_factor=1))
    _same_batches(got, want)
    seen = []

    class TS(tio.IterableDataset):
        def __iter__(self):
            return iter([(x[i], y[i]) for i in range(11)])

    class JS(jio.IterableDataset):
        __iter__ = TS.__iter__

    for drop_last in (False, True):
        t = tio.DataLoader(TS(), batch_size=4, drop_last=drop_last)
        with pytest.raises(TypeError):
            len(t)
        got = list(t)
        seen.append(len(got))
        _same_batches(got, list(jio.DataLoader(JS(), batch_size=4,
                                               drop_last=drop_last)))
    assert seen == [3, 2]


def test_dataloader_takes_the_reference_signature():
    x, y = _arrays(5)
    calls = []
    dl = tio.DataLoader(tio.TensorDataset([x, y]), feed_list=None,
                        places=None, return_list=True, batch_size=2,
                        use_buffer_reader=False, prefetch_factor=3,
                        use_shared_memory=True, timeout=0,
                        worker_init_fn=calls.append,
                        persistent_workers=False, num_workers=2,
                        use_thread_workers=True)
    assert dl.use_buffer_reader is False and dl.prefetch_factor == 3
    _same_batches(list(dl), list(jio.DataLoader(jio.TensorDataset([x, y]),
                                                batch_size=2)))
    assert sorted(calls) == [0, 1]


# -- worker processes -------------------------------------------------------

def test_stat_relay_drains_counters_and_histograms_not_gauges():
    """`drain_deltas` reads and zeroes counters and histogram buckets and
    leaves gauges (level and updown) where they are; `merge_deltas`
    adds them in, as the JAX package's relay."""
    from paddle_tpu.framework import monitor as jmon
    for mon in (monitor, jmon):
        mon.drain_deltas()
        mon.stat_add("STAT_test_relay_count", 3)
        mon.stat_set("STAT_test_relay_level", 7)
        mon.histogram("test_relay_ms").observe(2.0)
        h0 = mon.histogram("test_relay_ms").count
        blob = mon.drain_deltas()
        assert blob["stats"] == {"STAT_test_relay_count": 3}
        assert set(blob["hists"]) == {"test_relay_ms"}
        assert mon.stat_get("STAT_test_relay_count") == 0
        assert mon.stat_get("STAT_test_relay_level") == 7
        assert mon.histogram("test_relay_ms").count == 0
        assert mon.drain_deltas() is None
        mon.merge_deltas(blob)
        mon.merge_deltas(None)
        assert mon.stat_get("STAT_test_relay_count") == 3
        assert mon.histogram("test_relay_ms").count == h0
        assert mon.stat_reset("STAT_test_relay_count") == 0
        assert mon.stat_get("STAT_test_relay_count") == 0


class _Counted(tio.Dataset):
    """Rows of (x, y, worker id); bumps a counter and a histogram a
    sample, in whichever process fetches it."""

    def __init__(self, n):
        self.x, self.y = _arrays(n, seed=2)

    def __getitem__(self, i):
        monitor.stat_add("STAT_test_io_rest_samples")
        monitor.histogram("test_io_rest_ms").observe(1.0)
        info = tio.get_worker_info()
        wid = -1 if info is None else info.id * 10 + info.num_workers
        return self.x[i], self.y[i], np.int64(wid)

    def __len__(self):
        return len(self.y)


def test_worker_processes_match_in_process_and_jax():
    ds = _Counted(23)
    before = _ring_names()
    s0 = monitor.stat_get("STAT_test_io_rest_samples")
    h0 = monitor.histogram("test_io_rest_ms").count
    seg0, reu0, b0 = (monitor.stat_get("STAT_shm_slot_segments"),
                      monitor.stat_get("STAT_shm_slots_reused"),
                      monitor.stat_get("STAT_dataloader_batches"))
    got = list(tio.DataLoader(ds, batch_size=3, num_workers=2))
    segs = monitor.stat_get("STAT_shm_slot_segments") - seg0
    reused = monitor.stat_get("STAT_shm_slots_reused") - reu0
    assert monitor.stat_get("STAT_dataloader_batches") - b0 == 8
    # the relay: every sample counted once, in the parent
    assert monitor.stat_get("STAT_test_io_rest_samples") - s0 == 23
    assert monitor.histogram("test_io_rest_ms").count - h0 == 23
    # ring of 2 x 2 slots; a tail batch fits its slot, so no regrow
    assert segs == 4 and reused == 8 - segs
    assert {int(w) for b in got for w in b[2]} <= {2, 12}
    assert _ring_names() == before
    ref = list(tio.DataLoader(ds, batch_size=3))
    assert {int(w) for b in ref for w in b[2]} == {-1}
    _same_batches([b[:2] for b in got], [b[:2] for b in ref])
    jref = list(jio.DataLoader(jio.TensorDataset([ds.x, ds.y]),
                               batch_size=3))
    _same_batches([b[:2] for b in got], jref)
    assert got[0][0].dtype == torch.float32


class _Raises(tio.Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad sample 5")
        return np.full(2, i, np.float32)

    def __len__(self):
        return 8


def test_worker_exception_carries_its_traceback():
    before = _ring_names()
    with pytest.raises(RuntimeError) as e:
        list(tio.DataLoader(_Raises(), batch_size=2, num_workers=2))
    msg = str(e.value)
    assert "ValueError: bad sample 5" in msg and "__getitem__" in msg
    assert _ring_names() == before


class _Slow(tio.Dataset):
    def __init__(self, slow_from, seconds):
        self.slow_from, self.seconds = slow_from, seconds

    def __getitem__(self, i):
        if i >= self.slow_from:
            time.sleep(self.seconds)
        return np.full(2, i, np.float32)

    def __len__(self):
        return 8


def test_killed_worker_raises_within_10s():
    before = _ring_names()
    it = iter(tio.DataLoader(_Slow(2, 30.0), batch_size=2, num_workers=2))
    first = next(it)
    assert _np(first).tolist() == [[0, 0], [1, 1]]
    import multiprocessing as mp
    kids = mp.active_children()
    assert kids
    t0 = time.monotonic()
    for p in kids:
        os.kill(p.pid, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="died"):
        next(it)
    assert time.monotonic() - t0 < 10
    assert _ring_names() == before


def test_timeout_and_early_exit_leave_no_ring_name():
    before = _ring_names()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        list(tio.DataLoader(_Slow(4, 2.0), batch_size=2, num_workers=2,
                            timeout=1))
    assert time.monotonic() - t0 < 10
    assert _ring_names() == before
    it = iter(tio.DataLoader(_Counted(12), batch_size=2, num_workers=2))
    next(it)
    it.close()   # an epoch left early
    assert _ring_names() == before
