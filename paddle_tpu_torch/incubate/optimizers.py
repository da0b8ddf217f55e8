"""Wrapper optimizers (port of `paddle_tpu.incubate.optimizers`; reference
`fluid/optimizer.py` LookaheadOptimizer:5230, GradientMergeOptimizer:5402,
RecomputeOptimizer:4549, and `incubate/optimizer/modelaverage.py`).

Each wraps an optimizer of `paddle_tpu_torch.optimizer` (or, for
ModelAverage, a parameter list) and works on the parameters' tensors in
place, on their device: the slow weights, the running sums and the
merged gradients are tensors beside the parameters, never host copies.
The rules are the JAX package's, step for step."""
from __future__ import annotations

import contextlib

import torch

from ..optimizer.optimizer import Optimizer

__all__ = ["LookAhead", "LookaheadOptimizer", "ModelAverage",
           "GradientMergeOptimizer", "RecomputeOptimizer"]


class LookAhead(Optimizer):
    """Every k inner steps the slow weights move alpha of the way to the
    fast ones, and the fast weights take their value. As in the JAX
    package, the slow weights start at the fast weights of the first
    k-th step (so that step leaves the parameters as they are)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = {}
        self._steps = 0

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @torch.no_grad()
    def step(self):
        self.inner.step()
        self._steps += 1
        if self._steps % self.k:
            return
        for p in (self.inner._parameter_list or []):
            slow = self._slow.get(id(p))
            if slow is None:
                slow = p.detach().clone()
            slow = slow + self.alpha * (p - slow)
            self._slow[id(p)] = slow
            p.copy_(slow)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self):
        self.inner.clear_grad()


LookaheadOptimizer = LookAhead


class ModelAverage(Optimizer):
    """The running average of the parameters over the steps taken (each
    `step()` adds their current values); `apply()` is a context in which
    the parameters hold the average, put back on exit (`need_restore`) or
    by `restore()`."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(0.0, parameters)
        self._sums = {}
        self._counts = {}
        self._backup = {}

    @torch.no_grad()
    def step(self):
        for p in (self._parameter_list or []):
            k = id(p)
            s = self._sums.get(k)
            self._sums[k] = p.detach().clone() if s is None else s + p
            self._counts[k] = self._counts.get(k, 0) + 1

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def ctx():
            with torch.no_grad():
                for p in (self._parameter_list or []):
                    k = id(p)
                    if k in self._sums and self._counts.get(k):
                        self._backup[k] = p.detach().clone()
                        p.copy_(self._sums[k] / self._counts[k])
            try:
                yield
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in (self._parameter_list or []):
            k = id(p)
            if k in self._backup:
                p.copy_(self._backup.pop(k))


class GradientMergeOptimizer:
    """Sum the gradients of k_steps calls of `step()` (their mean with
    `avg`), then take one inner step on them; the calls between only
    accumulate (and clear `.grad`)."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg
        self._acc = {}
        self._count = 0

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @torch.no_grad()
    def step(self):
        self._count += 1
        params = self.inner._parameter_list or []
        for p in params:
            if p.grad is None:
                continue
            k = id(p)
            a = self._acc.get(k)
            self._acc[k] = p.grad.clone() if a is None else a + p.grad
            p.grad = None
        if self._count < self.k_steps:
            return
        for p in params:
            g = self._acc.get(id(p))
            if g is not None:
                p.grad = g / self.k_steps if self.avg else g
        self.inner.step()
        self.inner.clear_grad()
        self._acc = {}
        self._count = 0

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self):
        self.inner.clear_grad()


class RecomputeOptimizer:
    """reference `fluid/optimizer.py:4549`: forwards to the inner
    optimizer. Recompute itself is the training step's choice here
    (`torch.utils.checkpoint`, as `parallel.spmd`'s `recompute` and the
    pipeline's use it); `_set_checkpoints` records the names, as the JAX
    package's wrapper does."""

    def __init__(self, optimizer):
        self.inner = optimizer

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def step(self):
        self.inner.step()

    def minimize(self, loss, **kw):
        return self.inner.minimize(loss, **kw)
