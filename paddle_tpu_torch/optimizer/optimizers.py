"""Optimizer update rules (port of `paddle_tpu.optimizer.optimizers`,
`optimizers.py:16-91` there; reference `paddle/fluid/operators/
optimizers/*`): SGD, Momentum, Adam and AdamW, each the JAX package's
expression in the same order of operations. Adam-family moments are
float32 whatever the parameter's type. `torch.optim` is not used: its
AdamW orders the decay and the update differently."""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]


class SGD(Optimizer):
    def _update(self, g, p, state, lr, step):
        g = self._apply_weight_decay(g, p)
        return p - lr * g.to(p.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, g, p, state, lr, step):
        g = self._apply_weight_decay(g.to(p.dtype), p)
        vel = self._momentum * state["velocity"] + g
        if self._nesterov:
            new_p = p - lr * (g + self._momentum * vel)
        else:
            new_p = p - lr * vel
        return new_p, {"velocity": vel}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _adam_core(self, g, state, lr, step):
        g32 = g.float()
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * g32 * g32
        # the bias corrections in float32, as the JAX package computes
        # them (1 - beta2 ** t differs in the fifth digit from float64)
        t = np.float32(step)
        mhat = m / float(1 - np.float32(self._beta1) ** t)
        vhat = v / float(1 - np.float32(self._beta2) ** t)
        upd = lr * mhat / (torch.sqrt(vhat) + self._eps)
        return upd, {"moment1": m, "moment2": v}

    def _update(self, g, p, state, lr, step):
        g = self._apply_weight_decay(g.to(p.dtype), p)
        upd, new_state = self._adam_core(g, state, lr, step)
        return (p.float() - upd).to(p.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay (reference `paddle/optimizer/adamw.py`):
    p <- p - lr * coeff * p - upd."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name=name)
        self._coeff = float(getattr(weight_decay, "_coeff", weight_decay))

    def _update(self, g, p, state, lr, step):
        upd, new_state = self._adam_core(g, state, lr, step)
        p32 = p.float()
        p32 = p32 - lr * self._coeff * p32 - upd
        return p32.to(p.dtype), new_state
