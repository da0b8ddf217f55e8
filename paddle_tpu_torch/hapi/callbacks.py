"""Callbacks (port of `paddle_tpu.hapi.callbacks`; reference
`python/paddle/hapi/callbacks.py`).

Loss values in `logs` may be device tensors: `Model.fit` forces host
floats only on the `log_freq` cadence and at epoch ends, so the loop
runs ahead of the card. A callback that needs a number calls
`_as_float(v)`, which waits for the card on a device tensor — do that
only where the value is printed or stored."""
from __future__ import annotations

import os
import time
from typing import List

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "config_callbacks"]


def _as_float(v):
    """Host float from a number or a one-element tensor; None if `v`
    isn't scalar-like."""
    if isinstance(v, bool):
        return None
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return None


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_end")(step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()

    @staticmethod
    def _items(logs):
        out = []
        for k, v in (logs or {}).items():
            if k in ("step", "batch_size"):
                continue
            f = _as_float(v)  # waits for a device loss; we're printing
            out.append(f"{k}: {f:.4f}" if f is not None else f"{k}: {v}")
        return out

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and step % self.log_freq == 0:
            print(f"Epoch {self.epoch + 1}/{self.epochs} "
                  f"step {step}/{self.steps} - " + " - ".join(
                      self._items(logs)))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose >= 1:
            dt = time.time() - self._epoch_t0
            print(f"Epoch {epoch + 1}/{self.epochs} done ({dt:.1f}s) - "
                  + " - ".join(self._items(logs)))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and (epoch + 1) % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LR scheduler after every train batch
    (`by_step`) and/or at every epoch end (`by_epoch`)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"batch_size": batch_size, "epochs": epochs,
                   "steps": steps, "verbose": verbose, "metrics":
                   metrics or ["loss"]})
    return cl
