"""Callbacks (port of `paddle_tpu.hapi.callbacks`; reference
`python/paddle/hapi/callbacks.py`).

Loss values in `logs` may be device tensors: `Model.fit` forces host
floats only on the `log_freq` cadence and at epoch ends, so the loop
runs ahead of the card. A callback that needs a number calls
`_as_float(v)`, which waits for the card on a device tensor — do that
only where the value is printed or stored. `VisualDL` keeps the device
values of its steps and brings them to the host in one stacked copy a
flush."""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "VisualDL", "config_callbacks"]


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


class EarlyStopping(Callback):
    """Stop `fit` when `monitor` (a key of the epoch's logs) has not
    improved by more than `min_delta` for `patience` epochs; `mode`
    "auto" maximises a name with "acc" in it and minimises any other.
    `baseline` and `save_best_model` are stored and not read, as in the
    JAX package (`paddle_tpu/hapi/callbacks.py:197-232`)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = _as_float(cur.reshape(-1)[0] if torch.is_tensor(cur)
                        else np.asarray(cur).reshape(-1)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


def _host_scalars(values):
    """Host floats of `values` (numbers, one-element tensors) with one
    wait for the card: the device scalars ride one stacked copy. An entry
    that is not scalar-like (a string, a list, a tensor of several
    elements) gives None. `VisualDL` and `Model.evaluate` read their
    losses through it."""
    def on_dev(v):
        return torch.is_tensor(v) and v.device.type != "cpu" and \
            v.numel() == 1
    dev = [v.detach().float().reshape(()) for v in values if on_dev(v)]
    got = iter(torch.stack(dev).tolist() if dev else ())
    return [next(got) if on_dev(v) else _as_float(v) for v in values]


class VisualDL(Callback):
    """Scalar logger over `utils.LogWriter` (reference
    `paddle.callbacks.VisualDL`; VisualDL itself is not a dependency: the
    JSONL scalar stream stands in). Every train batch's logs are kept as
    they come, device losses on the device; a flush (at 1024 entries, at
    each epoch's end and at the end of training) writes them as
    `train/<key>` records, the device values brought to the host in one
    stacked copy, so the loop never waits for the card a step. Each
    epoch's end also writes the STAT counters (`LogWriter.dump_stats`)."""

    _FLUSH_EVERY = 1024   # bounds the device scalars held between flushes

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._step = 0
        self._pending = []   # (step, key, value)

    def on_train_begin(self, logs=None):
        from ..utils.log_writer import LogWriter
        self._writer = LogWriter(self.log_dir)

    def on_train_batch_end(self, step, logs=None):
        if self._writer:
            self._step += 1
            for k, v in (logs or {}).items():
                self._pending.append((self._step, k, v))
            if len(self._pending) >= self._FLUSH_EVERY:
                self._flush()

    def _flush(self):
        pending, self._pending = self._pending, []
        if not pending:
            return
        for (step, k, _), f in zip(pending, _host_scalars(
                [v for _, _, v in pending])):
            if f is not None:
                self._writer.add_scalar(f"train/{k}", f, step)

    def on_epoch_end(self, epoch, logs=None):
        if self._writer:
            self._flush()
            self._writer.dump_stats(step=epoch)

    def on_train_end(self, logs=None):
        if self._writer:
            self._flush()
            self._writer.close()


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
