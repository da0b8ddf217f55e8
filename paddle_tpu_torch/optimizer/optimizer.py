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

    # set by `parallel.spmd` while `_update` runs on a block of a
    # parameter: sums a block's partial sum over the ranks holding the
    # other blocks
    _block_sum = None

    def _sum_sq(self, x):
        """sum(x * x) over the whole parameter `x` is a block of (a rule
        reading a whole-parameter norm, Lamb's and LarsMomentum's)."""
        s = torch.sum(x * x)
        return s if self._block_sum is None else self._block_sum(s)

    def _apply_weight_decay(self, g, p):
        if self._weight_decay:
            return g + self._weight_decay * p
        return g

    # -- step ---------------------------------------------------------------
    @torch.no_grad()
    def _apply(self, grads, params, states, step_no):
        """One update of `params` by `grads`, after the gradient clip;
        `states[i]` holds the i-th parameter's accumulators (None before
        its first update). Returns the new values and the new states.
        `step` applies it to the parameters' `.grad`, a static Program's
        `Executor.run` to the Program's replayed gradients."""
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_grads(grads)
        lr = self.get_lr()
        new_ps, new_states = [], []
        for p, g, st in zip(params, grads, states):
            new_p, new_st = self._update(
                g, p, self._init_state(p) if st is None else st, lr,
                step_no)
            new_ps.append(new_p)
            new_states.append(new_st)
        return new_ps, new_states

    @torch.no_grad()
    def step(self):
        params = [p for p in (self._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        step_no = self._global_step + 1
        new_ps, new_states = self._apply(
            [p.grad for p in params], params,
            [self._accumulators.get(id(p)) for p in params], step_no)
        for p, new_p, st in zip(params, new_ps, new_states):
            p.copy_(new_p)
            self._accumulators[id(p)] = st
        self._global_step = step_no

    # rules whose _update takes whole-tensor norms (trust ratios) cannot
    # be applied row-wise; they set this to False
    _rowwise_safe = True

    @torch.no_grad()
    def apply_selected_rows(self, param, srows, advance_step=True):
        """Sparse-row update over a SelectedRows gradient (reference
        sparse kernels in `operators/optimizers/*_op.cc` consuming
        `framework/selected_rows.h` gradients; the JAX package's
        `optimizer.py:115-150`): only the touched rows of the parameter
        and of its accumulators are read or written, in place on the
        parameter's device, and no vocabulary-sized dense gradient is
        made.

        When several sparse tables are updated in one optimization step,
        pass advance_step=False for all but the last call, so that the
        Adam family's bias correction sees one step an iteration, as
        `step()` does."""
        if not self._rowwise_safe:
            raise NotImplementedError(
                f"{type(self).__name__} computes whole-tensor trust-ratio "
                f"norms; a row-subset update would change its scale — use "
                f"a dense gradient")
        m = srows.merge()
        if m.height != param.shape[0]:
            raise ValueError(
                f"SelectedRows height {m.height} != param rows "
                f"{param.shape[0]}")
        rows = torch.as_tensor(m.rows, dtype=torch.int64,
                               device=param.device)
        st = self._accumulators.get(id(param))
        if st is None:
            st = self._accumulators[id(param)] = self._init_state(param)
        prow = param.index_select(0, rows)
        sliced, passthrough = {}, {}
        for k, v in st.items():
            if v.dim() >= 1 and v.shape[0] == param.shape[0]:
                sliced[k] = v.index_select(0, rows)
            else:
                passthrough[k] = v
        g = torch.as_tensor(m.value, device=param.device).reshape(
            prow.shape)
        if self._grad_clip is not None:
            g = self._grad_clip._clip_grads([g])[0]
        new_prow, new_state = self._update(
            g, prow, {**sliced, **passthrough}, self.get_lr(),
            self._global_step + 1)
        param.index_copy_(0, rows, new_prow.to(param.dtype))
        for k in st:
            if k in sliced:
                st[k].index_copy_(0, rows, new_state[k].to(st[k].dtype))
            else:
                st[k] = new_state[k]
        if advance_step:
            self._global_step += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """reference `optimizer.py` minimize (the JAX package's
        `optimizer.py:163-173`): in static mode, mark the default main
        program for the backward and register this optimizer on it
        (`Executor.run` then trains); in dygraph, `loss.backward()` then
        `step()`."""
        from ..static import program as _static
        if _static.in_static_mode():
            prog = _static.default_main_program()
            pg = _static.append_backward(loss, parameters)
            prog._opt_hooks.append(self)
            return [], pg
        loss.backward()
        self.step()
        return [], []

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
