"""High-level Model API (port of `paddle_tpu.hapi.model`; reference
`python/paddle/hapi/model.py:810`: Model.fit:1299 / evaluate / save:1043).

The JAX package captures the network functionally and jits one
forward + `value_and_grad` + optimizer program over a donated carry.
PyTorch needs neither: `Model` works on the `nn.Module` directly, torch
autograd takes the place of `functionalize` + `jax.value_and_grad`, and
the optimizer updates the parameters in place, so there is no carry to
write back and the network's tensors are always current.

Training hot-loop contract, as in the JAX package:

* `train_batch` runs the forward, the loss (the float32 mean of what
  the prepared loss returns), `backward`, the gradient clip and
  `optimizer.step()`, then `clear_grad()`. It returns `([loss], [])`
  with the loss left on the device: nothing in it waits for the card.
* Batches are moved to the model's device (the device of its first
  parameter) through pinned host memory, without a synchronisation.
* `fit` forces a host float only every `log_freq` steps and at epoch
  ends (the JAX "deferred host sync", README "Training hot path"), so
  the Python loop runs ahead of the card. Each forced float counts in
  `STAT_train_host_syncs`; `STAT_train_steps` counts steps and
  `STAT_train_step_ns` their host wall time.

Not ported yet (ROADMAP): metrics, AMP (`amp_configs`), tail bucketing
and token masks (`loss_mask`), the fleet path, `DeviceFeeder`,
`predict`, and `save(training=False)` (export).
"""
from __future__ import annotations

import os
import time

import torch

from ..framework import monitor
from ..io import DataLoader, Dataset
from . import callbacks as cbks_mod

__all__ = ["Model"]


def _flatten_batch(data):
    if isinstance(data, dict):
        return list(data.values())
    if isinstance(data, (list, tuple)):
        return list(data)
    return [data]


def _steps_of(loader):
    """len(loader), or None for a loader without one (a generator)."""
    try:
        return len(loader)
    except TypeError:
        return None


def _host_float(v):
    """The one place fit waits for the card: a device loss to a float."""
    monitor.stat_add("STAT_train_host_syncs")
    return float(v)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self.stop_training = False

    # -- preparation --------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise NotImplementedError("Model.prepare: metrics are not "
                                      "ported yet")
        if amp_configs is not None:
            raise NotImplementedError("Model.prepare: AMP (amp_configs) is "
                                      "not ported yet; training runs in "
                                      "the parameters' type")
        self._optimizer = optimizer
        self._loss = loss
        if optimizer is not None and optimizer._parameter_list is None:
            optimizer._set_parameters(self.network.named_parameters())
        return self

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    # -- internals ----------------------------------------------------------
    def _place(self, leaves):
        """Batch leaves as tensors on the model's device. A host tensor
        bound for the card goes through pinned memory, so the copy is
        asynchronous and the host does not wait."""
        dev = self.device
        out = []
        for x in leaves:
            t = torch.as_tensor(x)
            if t.device != dev:
                if dev.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                t = t.to(dev, non_blocking=True)
            out.append(t)
        return out

    def _loss_value(self, outputs, labels):
        outs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        if self._loss is None:
            return outs[0]  # the network returns its loss
        return self._loss(*outs, *labels)

    def _split_batch(self, batch):
        data = _flatten_batch(batch)
        n_in = len(self._inputs) if self._inputs else 1
        if len(data) == 1:
            return data, []
        return data[:n_in], data[n_in:]

    def _as_loader(self, data, batch_size, shuffle, num_workers, drop_last):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data

    # -- steps --------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True, loss_mask=None):
        """One training step. `update=False` leaves the gradients in the
        parameters' `.grad` (they accumulate over calls) and skips the
        optimizer. Returns ([loss], []) with the loss a device tensor."""
        if loss_mask is not None:
            raise NotImplementedError("Model.train_batch: loss masks (tail "
                                      "bucketing, packing) are not ported "
                                      "yet")
        t0 = time.perf_counter_ns()
        ins = self._place(_flatten_batch(inputs))
        lbs = self._place(_flatten_batch(labels or []))
        self.network.train()
        lv = self._loss_value(self.network(*ins), lbs).float().mean()
        lv.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        monitor.stat_add("STAT_train_steps")
        monitor.stat_add("STAT_train_step_ns", time.perf_counter_ns() - t0)
        return [lv.detach()], []

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """Forward in eval mode; returns (loss, []) with the loss a device
        tensor (0 when no loss is prepared or no labels are given)."""
        ins = self._place(_flatten_batch(inputs))
        lbs = self._place(_flatten_batch(labels or []))
        self.network.eval()
        out = self.network(*ins)
        if self._loss is None or not lbs:
            return torch.zeros((), device=self.device), []
        return self._loss_value(out, lbs).float().mean(), []

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            num_iters=None):
        if self._optimizer is None:
            raise RuntimeError("Model.fit: call prepare() first")
        loader = self._as_loader(train_data, batch_size, shuffle, num_workers,
                                 drop_last)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers, False)
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=_steps_of(loader),
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=["loss"])
        cbks.on_begin("train")
        self.stop_training = False
        step_count = 0
        logs = {}  # stays bound for on_end even with epochs=0
        for epoch in range(epochs):
            sampler = getattr(loader, "batch_sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_batch_begin("train", step, logs)
                ins, lbs = self._split_batch(batch)
                (lv,), _ = self.train_batch(ins, lbs)
                # deferred host sync: the loss stays on the device except
                # on the log cadence
                if log_freq and step % log_freq == 0:
                    lv = _host_float(lv)
                logs = {"loss": lv, "step": step,
                        "batch_size": int(torch.as_tensor(ins[0]).shape[0])}
                cbks.on_batch_end("train", step, logs)
                step_count += 1
                if num_iters is not None and step_count >= num_iters:
                    self.stop_training = True
                    break
            if torch.is_tensor(logs.get("loss")):
                logs["loss"] = _host_float(logs["loss"])
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size, verbose=0)
            if self.stop_training:
                break
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        """Mean loss over `eval_data`, with one wait for the card at the
        end of the pass."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        losses = []
        for batch in loader:
            ins, lbs = self._split_batch(batch)
            losses.append(self.eval_batch(ins, lbs)[0])
        if not losses:
            return {"loss": 0.0}
        vals = torch.stack(losses).tolist()
        monitor.stat_add("STAT_train_host_syncs")
        return {"loss": sum(vals) / len(vals)}

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """`path.pdparams` (the network's state dict) and, with an
        optimizer, `path.pdopt` (its state dict), both `torch.save`."""
        if not training:
            raise NotImplementedError("Model.save(training=False): export is "
                                      "not ported yet")
        torch.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            torch.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = torch.load(path + ".pdparams", map_location=self.device)
        self.network.load_state_dict(state, strict=not skip_mismatch)
        opt = self._optimizer
        if opt is None:
            return self
        opt_path = path + ".pdopt"
        if not reset_optimizer and os.path.exists(opt_path):
            opt.set_state_dict(torch.load(opt_path, map_location=self.device))
        else:
            opt._accumulators.clear()
            opt._global_step = 0
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()
