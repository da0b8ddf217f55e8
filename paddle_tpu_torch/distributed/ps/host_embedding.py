"""Host-resident sparse embedding with the dense step on the card (port of
`paddle_tpu.distributed.ps.host_embedding`; reference
`paddle/fluid/framework/fleet/heter_ps/heter_comm.h:50` and
`PSGPUTrainer`, `framework/trainer.h:283`).

The embedding table lives in host RAM (the native sparse table of
`tables.py`); the card runs the dense model. A step of
`make_host_embedding_step` is:

1. pull the batch's distinct ids from the table, on the host;
2. one H2D copy, from a pinned staging buffer, of the pulled rows, the
   inverse index and the batch's other arrays;
3. on the card: `rows[inverse]` (`index_select`), the dense layer's
   forward and backward, and `optimizer.step()`; the backward of
   `index_select` sums the gradients of duplicate ids into their row
   (an atomic `index_add` on CUDA, so in no fixed order there);
4. one D2H copy of the loss and the row gradients into pinned memory;
5. the push of the row gradients to the table, whose rule (sgd, adam,
   sum) applies them, one update a touched row a step.

Rows are not padded: eager PyTorch does not retrace on a new unique
count (the JAX package pads to a power of two for XLA, and drops the
pad rows' gradients at the push; a table view that pads still works,
since the push takes the first `uniq.size` rows).

`step.timings` keeps each step's split in ms (`pull`, `h2d`, `device`,
`d2h`, `push`, `wall`); on the card `h2d`, `device` and `d2h` are CUDA
event spans, the rest host clock.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Tuple

import numpy as np
import torch

from ...framework.place import resolve_device

__all__ = ["HostEmbedding", "make_host_embedding_step"]


class HostEmbedding:
    """A host-RAM embedding table with deduplicated pull and push.

    dim: embedding width; rule: 'sgd' | 'adam' | 'sum' (applied by the
    C++ core on push); lr / init_range / seed as in SparseTable.
    """

    def __init__(self, dim: int, rule: str = "sgd", lr: float = 0.01,
                 init_range: float = 0.05, seed: int = 0):
        from .tables import SparseTable
        self.dim = int(dim)
        self.table = SparseTable(dim, rule=rule, lr=lr,
                                 init_range=init_range, seed=seed)

    def pull_dedup(self, ids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ids (any shape) -> (rows [uniq.size, dim], inverse [ids.size],
        uniq), uniq ascending."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64)).reshape(-1)
        uniq, inverse = np.unique(ids, return_inverse=True)
        return self.table.pull(uniq), inverse.reshape(-1), uniq

    def push(self, uniq_ids: np.ndarray, grads) -> None:
        self.table.push(np.asarray(uniq_ids, np.int64),
                        np.asarray(grads, np.float32))

    def __len__(self):
        return len(self.table)

    def save(self, path):
        return self.table.save(path)

    def load(self, path):
        return self.table.load(path)


def _align8(n: int) -> int:
    return (n + 7) & ~7


class _Staging:
    """Pinned host buffers for the step's one H2D and one D2H copy, grown
    to the largest step seen."""

    def __init__(self, device: torch.device):
        self.device = device
        self._up = torch.empty(0, dtype=torch.uint8)
        self._down = torch.empty(0, dtype=torch.float32)

    def _grow(self, buf, n, dtype):
        if buf.numel() >= n:
            return buf
        return torch.empty(max(n, 2 * buf.numel()), dtype=dtype,
                           pin_memory=True)

    def upload(self, arrays):
        """numpy arrays -> tensors on the card through one copy."""
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += _align8(a.nbytes)
        self._up = self._grow(self._up, total, torch.uint8)
        host = self._up.numpy()
        for a, o in zip(arrays, offs):
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = self._up[:total].to(self.device, non_blocking=True)
        out = []
        for a, o in zip(arrays, offs):
            dt = torch.from_numpy(np.empty(0, a.dtype)).dtype
            out.append(dev[o:o + a.nbytes].view(dt).reshape(a.shape))
        return out

    def download(self, t):
        """A flat float32 tensor on the card -> a pinned host view, the
        copy queued (wait on the current stream before reading it)."""
        self._down = self._grow(self._down, t.numel(), torch.float32)
        host = self._down[:t.numel()]
        host.copy_(t, non_blocking=True)
        return host


def make_host_embedding_step(dense_layer, optimizer, loss_fn: Callable,
                             emb, device=None):
    """Build `step(ids, *data) -> loss` for a dense model over a host
    table (see the module docstring).

    dense_layer(emb_batch, *data) -> outputs, emb_batch [ids.size, dim];
    loss_fn(outputs, [data tensors]) -> a loss tensor (its mean is the
    step's loss). The dense parameters train on `device` (the card unless
    the caller names the CPU) through `optimizer`; the embedding rows
    train through the table's rule on the host. `emb` is anything with
    `pull_dedup(ids) -> (rows, inverse, uniq)` and `push(uniq, grads)`.
    """
    dev = resolve_device(device)
    dense_layer.to(dev)
    on_card = dev.type == "cuda"
    stage = _Staging(dev) if on_card else None
    params = [p for p in (optimizer._parameter_list or [])
              if p.requires_grad]
    state = {"n": 0}
    timings = collections.deque(maxlen=4096)

    def step(ids, *data):
        t0 = time.perf_counter()
        rows, inverse, uniq = emb.pull_dedup(ids)
        n = int(np.asarray(uniq).size)
        arrays = [np.ascontiguousarray(rows, np.float32),
                  np.ascontiguousarray(inverse, np.int64).reshape(-1)]
        arrays += [np.ascontiguousarray(np.asarray(d)) for d in data]
        t1 = time.perf_counter()
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            up = stage.upload(arrays)
            ev[1].record()
        else:
            up = [torch.from_numpy(a) for a in arrays]
        rows_t = up[0].requires_grad_(True)
        inv_t, data_t = up[1], up[2:]
        with torch.enable_grad():
            emb_batch = rows_t.index_select(0, inv_t)
            out = dense_layer(emb_batch, *data_t)
            lv = loss_fn(out, list(data_t))
            lv = lv.float().mean()
        for p in params:
            p.grad = None
        lv.backward()
        for p in params:
            if p.grad is None:   # an unused parameter: a zero gradient,
                p.grad = torch.zeros_like(p)   # as the JAX step's
        optimizer.step()
        grows = rows_t.grad if rows_t.grad is not None else \
            torch.zeros_like(rows_t)   # a loss that reads no row
        flat = torch.cat([lv.detach().reshape(1), grows[:n].reshape(-1)])
        if on_card:
            ev[2].record()
            host = stage.download(flat)
            ev[3].record()
            ev[3].synchronize()
        else:
            host = flat
        t2 = time.perf_counter()
        loss = float(host[0])
        emb.push(uniq, host[1:].numpy().reshape(n, -1))
        t3 = time.perf_counter()
        state["n"] += 1
        rec = {"pull": (t1 - t0) * 1e3, "push": (t3 - t2) * 1e3,
               "wall": (t3 - t0) * 1e3, "uniq": n}
        if on_card:
            rec.update(h2d=ev[0].elapsed_time(ev[1]),
                       device=ev[1].elapsed_time(ev[2]),
                       d2h=ev[2].elapsed_time(ev[3]))
        else:
            rec.update(h2d=0.0, device=(t2 - t1) * 1e3, d2h=0.0)
        timings.append(rec)
        return loss

    step.state = state
    step.timings = timings
    step.device = dev
    return step
