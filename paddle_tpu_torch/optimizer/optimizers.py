"""Optimizer update rules (port of `paddle_tpu.optimizer.optimizers`;
reference `paddle/fluid/operators/optimizers/*`): SGD, Momentum, Adam,
AdamW, Adamax, Adagrad, Adadelta, RMSProp, Lamb and LarsMomentum, each
the JAX package's expression in the same order of operations, with its
state names (so a `.pdopt` opens in either package). Adam-family moments
and the other new rules' accumulators are float32 whatever the
parameter's type. `torch.optim` is not used: its AdamW orders the decay
and the update differently. Lamb and LarsMomentum take whole-tensor
norms; Lamb keeps `exclude_from_weight_decay_fn` and never calls it, as
the JAX package (ROADMAP C22)."""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "LarsMomentum"]


def _bias_correction(beta, step):
    """1 - beta ** step in float32, as the JAX package computes it."""
    return float(1 - np.float32(beta) ** np.float32(step))


def _zeros32(p):
    return torch.zeros_like(p, dtype=torch.float32)


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
        mhat = m / _bias_correction(self._beta1, step)
        vhat = v / _bias_correction(self._beta2, step)
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros32(p), "inf_norm": _zeros32(p)}

    def _update(self, g, p, state, lr, step):
        p32 = p.float()
        g = self._apply_weight_decay(g.float(), p32)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        rate = float(np.float32(lr) / np.float32(
            _bias_correction(self._beta1, step)))
        upd = rate * m / (u + self._eps)
        return (p32 - upd).to(p.dtype), {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _update(self, g, p, state, lr, step):
        p32 = p.float()
        g = self._apply_weight_decay(g.float(), p32)
        acc = state["moment"] + g * g
        new_p = p32 - lr * g / (torch.sqrt(acc) + self._eps)
        return new_p.to(p.dtype), {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros32(p),
                "avg_squared_update": _zeros32(p)}

    def _update(self, g, p, state, lr, step):
        p32 = p.float()
        g = self._apply_weight_decay(g.float(), p32)
        rho = self._rho
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = (torch.sqrt(state["avg_squared_update"] + self._eps)
               / torch.sqrt(asg + self._eps)) * g
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        return ((p32 - lr * upd).to(p.dtype),
                {"avg_squared_grad": asg, "avg_squared_update": asu})


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": _zeros32(p), "momentum_acc": _zeros32(p)}
        if self._centered:
            st["mean_grad"] = _zeros32(p)
        return st

    def _update(self, g, p, state, lr, step):
        p32 = p.float()
        g = self._apply_weight_decay(g.float(), p32)
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        st = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + self._eps)
            st["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * state["momentum_acc"] + lr * g / denom
        st["momentum_acc"] = mom
        return (p32 - mom).to(p.dtype), st


class Lamb(Optimizer):
    """reference `operators/optimizers/lamb_op.h`: Adam's direction plus
    decoupled decay, scaled by the trust ratio ||p|| / ||r|| (1 where
    either norm is 0). `exclude_from_weight_decay_fn` is stored and not
    called (C22)."""

    _rowwise_safe = False  # the trust ratio needs whole-tensor norms

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p)}

    def _update(self, g, p, state, lr, step):
        g32, p32 = g.float(), p.float()
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * g32 * g32
        mhat = m / _bias_correction(self._beta1, step)
        vhat = v / _bias_correction(self._beta2, step)
        r = mhat / (torch.sqrt(vhat) + self._eps) + self._lamb_wd * p32
        w_norm = torch.sqrt(self._sum_sq(p32))
        r_norm = torch.sqrt(self._sum_sq(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = (p32 - lr * trust * r).to(p.dtype)
        return new_p, {"moment1": m, "moment2": v}


class LarsMomentum(Optimizer):
    """reference `operators/optimizers/lars_momentum_op.*`: momentum with
    the layer-wise rate lars_coeff * ||p|| / (||g|| + wd * ||p|| + eps),
    1 where either norm is 0."""

    _rowwise_safe = False  # the local rate needs whole-tensor norms

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005, parameters=None,
                 grad_clip=None, epsilon=1e-9, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def _init_state(self, p):
        return {"velocity": _zeros32(p)}

    def _update(self, g, p, state, lr, step):
        g32, p32 = g.float(), p.float()
        p_norm = torch.sqrt(self._sum_sq(p32))
        g_norm = torch.sqrt(self._sum_sq(g32))
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lars_coeff * p_norm
            / (g_norm + self._lars_wd * p_norm + self._eps), 1.0)
        vel = (self._momentum * state["velocity"]
               + lr * local_lr * (g32 + self._lars_wd * p32))
        return (p32 - vel).to(p.dtype), {"velocity": vel}
