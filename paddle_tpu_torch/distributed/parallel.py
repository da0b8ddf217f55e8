"""DataParallel (port of `paddle_tpu.distributed.parallel`; reference
`fluid/dygraph/parallel.py:322` DataParallel and the bucketed all-reduce
of `imperative/reducer.cc`).

The JAX package needs no reducer: GSPMD emits the gradient all-reduce of
a dp-sharded batch. The port runs one process a rank, so `DataParallel`
is the reducer:
- at construction it broadcasts the parameters and buffers from rank 0
  of its group, so every rank starts from one model;
- each parameter's gradient, once accumulated, joins a bucket (buckets
  of `comm_buffer_size` MB in reverse registration order, the first one
  `last_comm_buffer_size` MB, as the reference sizes them); a full
  bucket is flattened and all-reduced asynchronously while the backward
  goes on; at the end of the backward every bucket is waited for and
  its mean written back into the gradients;
- with `find_unused_parameters` a parameter that got no gradient is
  reduced as zeros at the end of the backward; without it that raises,
  as the reference's reducer does;
- `no_sync()` skips the reduction (gradient accumulation);
  `apply_collective_grads()` then reduces what was accumulated.
`scale_loss` returns the loss: the reduction averages. `state_dict` is
the wrapped layer's.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..nn.layer.layers import Layer
from .collective import process_group
from .env import ParallelEnv, init_parallel_env

__all__ = ["DataParallel", "ParallelEnv", "init_parallel_env"]


class _Bucket:
    def __init__(self, params):
        self.params = params
        self.ready = set()
        self.work = None
        self.flat = None


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._pg, ranks = process_group(group)
        self._src = ranks[0]
        self._n = len(ranks)
        self._sync = True
        self._pending = False
        params = [p for p in layers.parameters() if p.requires_grad]
        self._buckets = []
        if self._pg is None:
            return
        with torch.no_grad():
            for t in list(layers.parameters()) + list(layers.buffers()):
                dist.broadcast(t.data, src=self._src, group=self._pg)
        limit = last_comm_buffer_size * (1 << 20)
        cur, size = [], 0
        for p in reversed(params):
            cur.append(p)
            size += p.numel() * p.element_size()
            if size >= limit:
                self._buckets.append(_Bucket(cur))
                cur, size, limit = [], 0, comm_buffer_size * (1 << 20)
        if cur:
            self._buckets.append(_Bucket(cur))
        self._bucket_of = {id(p): b for b in self._buckets for p in b.params}
        for p in params:
            p.register_post_accumulate_grad_hook(self._on_grad)

    # -- reduction -----------------------------------------------------------

    def _on_grad(self, p):
        if not self._sync:
            return
        if not self._pending:
            self._pending = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        b = self._bucket_of[id(p)]
        b.ready.add(id(p))
        if len(b.ready) == len(b.params):
            self._launch(b)

    def _launch(self, b):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in b.params]
        b.flat = _flatten_dense_tensors(grads)
        b.work = dist.all_reduce(b.flat, group=self._pg, async_op=True)

    def _finish(self):
        self._pending = False
        for b in self._buckets:
            if b.work is None:
                if len(b.ready) < len(b.params) and \
                        not self.find_unused_parameters:
                    missing = len(b.params) - len(b.ready)
                    b.ready.clear()
                    raise RuntimeError(
                        f"DataParallel: {missing} parameters received no "
                        f"gradient in this backward; pass "
                        f"find_unused_parameters=True to reduce them as "
                        f"zeros")
                self._launch(b)
        for b in self._buckets:
            b.work.wait()
            grads = _unflatten_dense_tensors(b.flat.div_(self._n),
                                             b.params)
            for p, g in zip(b.params, grads):
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.copy_(g)
            b.ready.clear()
            b.work = b.flat = None

    @contextlib.contextmanager
    def no_sync(self):
        """Accumulate gradients without reducing them."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def apply_collective_grads(self):
        """Reduce the gradients accumulated under `no_sync` (a no-op after
        a synchronised backward, which reduced them already)."""
        if self._pg is None:
            return
        for b in self._buckets:
            if any(p.grad is not None for p in b.params):
                self._launch(b)
        self._finish()

    # -- the reference's surface ---------------------------------------------

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    load_dict = set_state_dict
    set_dict = set_state_dict
