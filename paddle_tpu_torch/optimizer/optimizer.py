"""Optimizer base (port of `paddle_tpu.optimizer.optimizer`; reference
`python/paddle/optimizer/optimizer.py`).

Every optimizer is a per-parameter update rule
`_update(g, p, state, lr, step) -> (new_p, new_state)` on torch tensors,
written as the JAX package's rule (`paddle_tpu/optimizer/optimizers.py`)
so the two agree to float rounding. `step()` applies it under
`torch.no_grad` to every parameter whose `.grad` is set, after the
gradient clip, and writes the new values into the parameters in place
(`copy_`), so the model keeps its tensors. The learning rate and the
step count are host numbers: a step never waits for the card.

`parameters` is an iterable of tensors, or of (name, tensor) pairs such
as `module.named_parameters()`; the names key `state_dict()` as the JAX
package's parameter names do (`{name}_moment1`), and default to
`param_{i}`.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._names: List[str] = []
        self._parameter_list = None
        if parameters is not None:
            self._set_parameters(parameters)
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (float, int)):
            self._weight_decay = float(weight_decay)
        elif weight_decay is None:
            self._weight_decay = 0.0
        else:  # L2Decay-like object
            self._weight_decay = float(getattr(weight_decay, "_coeff",
                                               getattr(weight_decay,
                                                       "coeff", 0.0)))
        self._accumulators: Dict[int, dict] = {}
        self._global_step = 0

    def _set_parameters(self, parameters):
        params, names = [], []
        for i, item in enumerate(parameters):
            if isinstance(item, tuple):
                names.append(item[0])
                params.append(item[1])
            else:
                names.append(f"param_{i}")
                params.append(item)
        self._parameter_list, self._names = params, names

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the lr is an LRScheduler; call "
                "scheduler.step() instead")
        self._lr = float(value)

    # -- state --------------------------------------------------------------
    def _init_state(self, p) -> dict:
        """Per-parameter accumulator init. Override."""
        return {}

    def _update(self, g, p, state: dict, lr: float, step: int) -> tuple:
        """Per-parameter update: returns (new_p, new_state)."""
        raise NotImplementedError

    def _state_for(self, p) -> dict:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p)
        return st

    def _apply_weight_decay(self, g, p):
        if self._weight_decay:
            return g + self._weight_decay * p
        return g

    # -- step ---------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = [p for p in (self._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_grads(grads)
        lr = self.get_lr()
        step_no = self._global_step + 1
        for p, g in zip(params, grads):
            new_p, new_state = self._update(g, p, self._state_for(p), lr,
                                            step_no)
            p.copy_(new_p)
            self._accumulators[id(p)] = new_state
        self._global_step = step_no

    def clear_grad(self):
        for p in (self._parameter_list or []):
            p.grad = None

    clear_gradients = clear_grad

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self):
        out = {"global_step": self._global_step}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for name, p in zip(self._names, self._parameter_list or []):
            for k, v in self._accumulators.get(id(p), {}).items():
                out[f"{name}_{k}"] = v
        return out

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(dict(state_dict["LR_Scheduler"]))
        for name, p in zip(self._names, self._parameter_list or []):
            st = self._init_state(p)
            found = False
            for k in st:
                v = state_dict.get(f"{name}_{k}")
                if v is not None:
                    st[k] = torch.as_tensor(v).to(device=p.device,
                                                  dtype=st[k].dtype)
                    found = True
            if found:
                self._accumulators[id(p)] = st
