"""paddle_tpu_torch.io.DeviceFeeder, on the CPU when asked for, and on
the card (a `chip` test that skips without one).

- `device="cpu"`: batches in order and in their structure (tuples,
  dicts, numpy leaves become tensors), `__len__` delegated (TypeError
  for a source without one), the source's exception raised in the
  consumer, the source iterator closed from the producer thread when the
  consumer leaves early, `STAT_device_feeder_batches` a hand-out; over a
  worker loader, the batches of the in-process loader, bit for bit, and
  no slot left borrowed (the loader's ring names all gone).
- `device=None` resolves to the card: UnavailableError where there is
  none, and a `DeviceFeeder` with no device is built on the card where
  there is one.
- On the card: every leaf handed out lies on the card, equals the host
  batch bit for bit, and the consumer's stream waited on the event of
  the feeder's side-stream copy once a batch.

This file imports no JAX, so the chip test runs on the GPU machine with
`python -m pytest --noconftest -m chip tests/test_torch_device_feeder.py`.
"""
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch import io
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import UnavailableError


def _data(n=10):
    rng = np.random.RandomState(0)
    return io.TensorDataset([rng.standard_normal((n, 3)).astype(np.float32),
                             rng.randint(0, 5, size=(n,)).astype(np.int64)])


def test_cpu_feeder_keeps_order_structure_and_counts():
    src = [({"a": np.arange(3) + i, "b": np.float32(i)}, [np.ones(2) * i])
           for i in range(5)]
    b0 = monitor.stat_get("STAT_device_feeder_batches")
    f = io.DeviceFeeder(src, device="cpu")
    assert len(f) == 5
    got = list(f)
    assert monitor.stat_get("STAT_device_feeder_batches") - b0 == 5
    for i, (d, lst) in enumerate(got):
        assert torch.equal(d["a"], torch.arange(3) + i)
        assert isinstance(lst, list) and lst[0].dtype == torch.float32
        assert torch.equal(lst[0], torch.ones(2) * i)
    with pytest.raises(TypeError):
        len(io.DeviceFeeder((x for x in src), device="cpu"))
    with pytest.raises(ValueError):
        io.DeviceFeeder(src, depth=0, device="cpu")


def test_cpu_feeder_forwards_errors_and_closes_the_source():
    def bad():
        yield np.zeros(2)
        raise KeyError("source failed")
    it = iter(io.DeviceFeeder(bad(), device="cpu"))
    next(it)
    with pytest.raises(KeyError, match="source failed"):
        next(it)
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield np.full(2, i)
                i += 1
        finally:
            closed.set()
    it = iter(io.DeviceFeeder(endless(), depth=2, device="cpu"))
    assert next(it)[0] == 0
    it.close()
    assert closed.wait(5)


def test_cpu_feeder_over_worker_loader_matches_in_process():
    data = _data(11)
    before = {n for n in os.listdir("/dev/shm") if n.startswith("ptt")}
    got = list(io.DeviceFeeder(io.DataLoader(data, batch_size=4,
                                             num_workers=2), device="cpu"))
    want = list(io.DataLoader(data, batch_size=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    after = {n for n in os.listdir("/dev/shm") if n.startswith("ptt")}
    assert after == before


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        f = io.DeviceFeeder([np.zeros(2)])
        assert f.device.type == "cuda"
    else:
        with pytest.raises(UnavailableError):
            io.DeviceFeeder([np.zeros(2)])


@pytest.mark.chip
def test_side_stream_copy_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream copy runs only "
                    "on the card")
    data = _data(40)
    host = list(io.DataLoader(data, batch_size=8))
    consumer = torch.cuda.Stream()
    seen_streams = []
    orig = torch.cuda.Stream.wait_event

    def spy(self, ev):
        seen_streams.append(self)
        return orig(self, ev)
    torch.cuda.Stream.wait_event = spy
    try:
        with torch.cuda.stream(consumer):
            out = []
            for x, y in io.DeviceFeeder(io.DataLoader(data, batch_size=8,
                                                      num_workers=2)):
                assert x.device.type == "cuda" and y.device.type == "cuda"
                # queued work on the consumer stream reads the batch
                out.append((x * 1, y + 0))
        torch.cuda.synchronize()
    finally:
        torch.cuda.Stream.wait_event = orig
    assert len(out) == len(host) == 5
    assert all(s == consumer for s in seen_streams) and len(seen_streams) == 5
    for (x, y), (hx, hy) in zip(out, host):
        assert torch.equal(x.cpu(), hx) and torch.equal(y.cpu(), hy)
