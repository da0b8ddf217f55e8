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

Sequence packing, as in the JAX package: with `io.PackingCollator` as
the loader's `collate_fn` (anything with `emits_token_mask`), every
batch is a fixed-shape pack whose last leaf is a [rows, max_tokens]
token validity mask. `fit` and `evaluate` pop it and fold it into the
loss as a TOKEN mask: the loss must give per-token values (a loss with
a `reduction` attribute is called with "none"), pad tokens get zero
weight, and the mean divides by the number of real tokens. The network
masks attention per segment (`F.scaled_dot_product_attention(
segment_ids=...)`, splash attention). A 1-D mask passed to
`train_batch`/`eval_batch` is a ROW mask: padded rows get zero weight
and the mean divides by the real rows. The model must be built with
`inputs=` specs, so `_split_batch` knows how many leading pack leaves
feed the network.

AMP, as in the JAX package: `prepare(amp_configs=...)` takes a level
("O1"/"O2", or a dict's "level"), and `train_batch` runs the forward
and the loss (masked or not) under `amp.auto_cast(level=...)` in the
default bfloat16; the loss is then the float32 mean. `eval_batch` and
`predict_batch` run in the parameters' type, outside AMP.

Not ported yet (ROADMAP): metrics, tail bucketing
(row-padding the last partial batch: it saves the JAX package an XLA
compile, and eager PyTorch has none to save), the fleet path,
`DeviceFeeder`, and `save(training=False)` (export).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .. import amp
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


def _host_floats(values):
    """Host floats of `values` (numbers, or one-element tensors) with one
    wait for the card: the device tensors ride one stacked copy."""
    def on_dev(v):
        return torch.is_tensor(v) and v.device.type != "cpu"
    dev = [v.float().reshape(()) for v in values if on_dev(v)]
    got = iter(torch.stack(dev).tolist() if dev else ())
    return [next(got) if on_dev(v) else float(v) for v in values]


class _TailMaskError(TypeError):
    """The prepared loss gives no per-token (token mask) or per-row (row
    mask) values, so the mask cannot be folded into it."""


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._amp_level = None
        self.stop_training = False

    # -- preparation --------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise NotImplementedError("Model.prepare: metrics are not "
                                      "ported yet")
        self._amp_level = None
        if amp_configs is not None:
            self._amp_level = (amp_configs if isinstance(amp_configs, str)
                               else amp_configs.get("level", "O1"))
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

    def _masked_loss(self, outputs, labels, mask):
        """The prepared loss folded with a validity mask
        (`paddle_tpu/hapi/model.py:244-316`).

        A 2-D mask [rows, T] is a TOKEN mask (the packing collator's last
        leaf): the loss must give per-token values [rows, T(, ...)], pad
        tokens get zero weight and the mean divides by the real-token
        count. A 1-D mask [rows] is a ROW mask: padded rows get zero
        weight and the mean divides by the real-row count. A loss with a
        `reduction` attribute is called with reduction "none"; one that
        gives no such values raises _TailMaskError (a TypeError)."""
        red = getattr(self._loss, "reduction", None)
        if red in ("mean", "sum"):
            self._loss.reduction = "none"
            try:
                lv = self._loss_value(outputs, labels)
            finally:
                self._loss.reduction = red
        else:
            lv = self._loss_value(outputs, labels)
        lv = lv.float()
        rows = int(mask.shape[0])
        if self._is_token_mask(mask):
            T = int(mask.shape[1])
            if lv.dim() < 2 or tuple(lv.shape[:2]) != (rows, T):
                raise _TailMaskError(
                    f"loss produced shape {tuple(lv.shape)} — not per-token "
                    f"over the ({rows}, {T}) pack, so the token mask cannot "
                    "be folded in; packed training needs a per-token-"
                    "maskable loss (e.g. CrossEntropyLoss over [rows, T, C] "
                    "logits)")
            per = lv.reshape(rows, T, -1)
        else:
            if lv.dim() < 1 or lv.shape[0] != rows:
                raise _TailMaskError(
                    f"loss produced shape {tuple(lv.shape)} — not per-row "
                    f"over the {rows}-row batch, so the row mask cannot be "
                    "folded in; use a loss with a mean/sum `reduction`")
            per = lv.reshape(rows, 1, -1)
        per = per.sum(2) if red == "sum" else per.mean(2)
        # where, not multiply: a non-finite value at a pad position must
        # not poison the sum through NaN * 0
        per = torch.where(mask.reshape(per.shape) > 0, per, 0.0)
        if red == "sum":
            return per.sum()
        return per.sum() / torch.clamp(mask.float().sum(), min=1.0)

    @staticmethod
    def _is_token_mask(loss_mask):
        return loss_mask is not None and getattr(loss_mask, "ndim", 1) > 1

    @staticmethod
    def _token_masked(loader):
        """True when the loader's collator emits a token mask as every
        batch's last leaf (`io.PackingCollator`, `emits_token_mask`)."""
        cf = getattr(loader, "collate_fn", None)
        return bool(getattr(cf, "emits_token_mask", False))

    @staticmethod
    def _pop_token_mask(lbs):
        """Split the collator's token mask off the label leaves."""
        if not lbs:
            raise ValueError(
                "packing collator batches must carry at least the token "
                "mask after the input leaves — construct the Model with "
                "inputs= specs matching the pack layout")
        return lbs[:-1], lbs[-1]

    def _step_loss(self, outputs, labels, loss_mask):
        """The float32 scalar loss of one batch: the mean of what the
        prepared loss returns, or its masked fold."""
        if loss_mask is None:
            return self._loss_value(outputs, labels).float().mean()
        return self._masked_loss(outputs, labels,
                                 self._place([loss_mask])[0])

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
        """One training step (under `amp.auto_cast` when prepared with
        `amp_configs`). `update=False` leaves the gradients in the
        parameters' `.grad` (they accumulate over calls) and skips the
        optimizer. `loss_mask`: a token [rows, T] or row [rows] mask
        folded into the loss (`_masked_loss`). Returns ([loss], []) with
        the loss a device tensor."""
        t0 = time.perf_counter_ns()
        ins = self._place(_flatten_batch(inputs))
        lbs = self._place(_flatten_batch(labels or []))
        self.network.train()
        with (amp.auto_cast(level=self._amp_level) if self._amp_level
              else contextlib.nullcontext()):
            lv = self._step_loss(self.network(*ins), lbs, loss_mask)
        lv.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        monitor.stat_add("STAT_train_steps")
        monitor.stat_add("STAT_train_step_ns", time.perf_counter_ns() - t0)
        return [lv.detach()], []

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None, loss_mask=None):
        """Forward in eval mode; returns (loss, []) with the loss a device
        tensor (0 when no loss is prepared or no labels are given),
        `loss_mask` folded in as in `train_batch`."""
        ins = self._place(_flatten_batch(inputs))
        lbs = self._place(_flatten_batch(labels or []))
        self.network.eval()
        out = self.network(*ins)
        if self._loss is None or not lbs:
            return torch.zeros((), device=self.device), []
        return self._step_loss(out, lbs, loss_mask), []

    @torch.no_grad()
    def predict_batch(self, inputs):
        """Forward in eval mode; the outputs on the host as numpy arrays
        (a list when the network returns several)."""
        ins = self._place(_flatten_batch(inputs))
        self.network.eval()
        out = self.network(*ins)
        if isinstance(out, (list, tuple)):
            return [o.detach().cpu().numpy() for o in out]
        return out.detach().cpu().numpy()

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
        token_masked = self._token_masked(loader)
        for epoch in range(epochs):
            sampler = getattr(loader, "batch_sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_batch_begin("train", step, logs)
                ins, lbs = self._split_batch(batch)
                mask = None
                if token_masked:
                    lbs, mask = self._pop_token_mask(lbs)
                (lv,), _ = self.train_batch(ins, lbs, loss_mask=mask)
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
        end of the pass. Under a packing collator each pack's loss is
        already real-token-normalised, and the pass weights packs by
        their real-token counts, so the result is the true per-token
        mean (a near-empty last pack does not count like a full one)."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        token_masked = self._token_masked(loader)
        losses, weights = [], []
        for batch in loader:
            ins, lbs = self._split_batch(batch)
            mask = None
            if token_masked:
                lbs, mask = self._pop_token_mask(lbs)
                weights.append(torch.as_tensor(mask).float().sum())
            losses.append(self.eval_batch(ins, lbs, loss_mask=mask)[0])
        if not losses:
            return {"loss": 0.0}
        vals = _host_floats(losses + weights)
        monitor.stat_add("STAT_train_host_syncs")
        vals, weights = vals[:len(losses)], vals[len(losses):]
        if token_masked and sum(weights) > 0:
            return {"loss": float(np.average(vals, weights=weights))}
        return {"loss": sum(vals) / len(vals)}

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """`predict_batch` over `test_data`: a list with one output per
        batch, or, with `stack_outputs`, the outputs concatenated over
        batches. Packs go through as they are: the port never row-pads a
        batch (the JAX package must not pad packs either)."""
        loader = self._as_loader(test_data, batch_size, False, num_workers,
                                 False)
        outputs = [self.predict_batch(self._split_batch(batch)[0])
                   for batch in loader]
        if stack_outputs and outputs:
            if isinstance(outputs[0], list):
                return [np.concatenate([o[i] for o in outputs])
                        for i in range(len(outputs[0]))]
            return np.concatenate(outputs)
        return outputs

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
