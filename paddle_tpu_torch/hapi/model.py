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
  with the loss left on the device: nothing in it waits for the card,
  unless metrics are prepared (below).
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

Metrics, as in the JAX package: `prepare(metrics=)` takes one
`metric.Metric` or a list. Each step hands the network's first output
and the labels to every metric's `compute` and the result to its
`update`, on the host (the metric's numpy arithmetic; the one wait for
the card a metric step adds, as the JAX package's host-side update
does). `train_batch` then returns `(loss, metrics)`, the loss bare, and
`eval_batch` `(loss, metrics)`, one `update` result a metric. Rows that
a row mask drops never reach a metric; a token mask keeps whole rows.
`fit` logs each batch's metric values under the metrics' names, resets
them at each epoch's start and logs their `accumulate()` at its end;
`evaluate` resets them, runs the pass and returns their `accumulate()`
beside the loss.

Input feed, as in the JAX package: a `DataLoader` with
`use_buffer_reader` (the default) is wrapped in an `io.DeviceFeeder` on
the model's device, whose thread copies the next batch to the card on a
side stream while the current step runs; `_place` passes tensors that
are already on the device through untouched.

Tail bucketing, as in the JAX package (`FLAGS_train_tail_bucketing`,
default on): when a loader with `drop_last=False` can end an epoch on a
partial batch (its dataset's length is not a multiple of the batch size,
or it has none), `fit`, `evaluate` and `predict` pad that batch to the
batch size by repeating its last real row, and every batch of the epoch
carries a row mask folded into the loss (all ones on full batches). This
changes results, not only shapes: the padded rows enter every cross-row
statistic (a training-mode BatchNorm's batch mean and variance, and so
its running buffers), and the loss becomes the mean of per-row means,
which weights rows alike where a loss's own mean has a data-dependent
denominator (`CrossEntropyLoss(ignore_index=)`). The port pads as the
JAX package does so that both train to the same weights. A loss that
gives no per-row values raises `_TailMaskError`: the model warns once,
runs that batch and every later one unpadded (a failed training attempt
first restores the buffers its forward moved). `logs["batch_size"]` is
the real row count, metrics see only the real rows, `predict_batch(
nreal=)` slices the padded rows off, and `STAT_tail_pad_batches` counts
the padded batches.

The fleet path, as in the JAX package (`paddle_tpu/hapi/model.py:220-228,
639-702`): when `distributed.fleet.init` ran and its mesh spans more than
one rank, `prepare` routes training through the strategy's step
(`fleet.build_sharded_train_step`: the sharded, pipeline or LocalSGD step
the strategy picks), built at the first `train_batch`. Each call hands
the global batch to the step, which gives every rank its block; the loss
returned is the global batch's. A row or token mask rides as the last
label leaf and is folded over the global batch: each rank's masked sum is
divided by the GLOBAL count of real rows or tokens (times the ranks the
step averages over), so the padded tail's loss is the unpadded batch's,
as under GSPMD. Metrics are not updated on this path (as there). The
step trains the network's own parameters in place; a step that keeps its
own replicas or stages (LocalSGD, the pipeline) writes them back
(`step.write_back`: the replicas' mean, the gathered stages) at each
epoch's end in `fit` and after each standalone `train_batch`.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import torch

from .. import amp
from ..framework import io_state, monitor
from ..framework.flags import flag
from ..io import DataLoader, Dataset, DeviceFeeder
from ..metric import Metric
from ..profiler import RecordEvent
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


def _real_rows(mask):
    """(rows, the indices of the real rows) of a loss mask: a row mask
    [rows] counts a row when its entry is > 0, a token mask [rows, T]
    when any of its tokens is (metrics then see whole packed rows)."""
    m = mask.detach().cpu().numpy() if torch.is_tensor(mask) \
        else np.asarray(mask)
    if m.ndim > 1:
        m = m.reshape(m.shape[0], -1) > 0
        m = m.any(axis=1)
    return int(m.shape[0]), np.flatnonzero(m > 0)


def _select_rows(leaves, rows, idx):
    """The real rows `idx` of every leaf whose first dimension is `rows`
    (a slice when they are a prefix, as a padded tail's are); other
    leaves as they are."""
    n = len(idx)
    prefix = bool(np.array_equal(idx, np.arange(n)))
    out = []
    for x in leaves:
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == rows:
            if prefix:
                x = x[:n]
            elif torch.is_tensor(x):
                x = x[torch.as_tensor(idx, device=x.device)]
            else:
                x = x[idx]
        out.append(x)
    return out


def _batch_rows(leaves):
    """The first dimension of the first leaf that has one."""
    for x in leaves:
        if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1:
            return int(x.shape[0])
    return None


def _pad_leaf(x, rows, target):
    """A batch-major leaf grown to `target` rows by repeating its last
    real row (a real sample: in distribution and finite, where zeros can
    be invalid labels); other leaves as they are."""
    if not (hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1
            and x.shape[0] == rows):
        return x
    if torch.is_tensor(x):
        return torch.cat([x, x[-1:].expand(target - rows, *x.shape[1:])])
    v = np.asarray(x)
    return np.concatenate([v, np.repeat(v[-1:], target - rows, axis=0)])


def _metric_names(m):
    names = m.name()
    return names if isinstance(names, list) else [names]


def _log_metrics(logs, metrics, values):
    """Put each metric's value(s) into `logs` under its name(s)."""
    for m, v in zip(metrics, values):
        vals = v if isinstance(v, list) else [v]
        for n, x in zip(_metric_names(m), vals):
            logs[n] = x


class _TailMaskError(TypeError):
    """The prepared loss gives no per-token (token mask) or per-row (row
    mask) values, so the mask cannot be folded into it."""


def _restore(module, saved):
    """Copy saved buffer values back into `module`'s buffers."""
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name in saved:
                b.copy_(saved[name])


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = None
        self._tail_maskable = True   # cleared once the loss refuses a mask
        self._row_mask_ok = False    # a row-masked step has succeeded
        self._mask_cache = {}        # (mask bytes, device) -> placed mask
        self.stop_training = False
        self._dist_ctx = None        # fleet, when prepare routes through it
        self._sharded_step = None
        self._sharded_state = None
        self._sharded_norm = None    # (global mask count, ranks averaged)
        self._in_fit = False

    # -- preparation --------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        self._amp_level = None
        if amp_configs is not None:
            self._amp_level = (amp_configs if isinstance(amp_configs, str)
                               else amp_configs.get("level", "O1"))
        self._optimizer = optimizer
        self._loss = loss
        self._row_mask_ok = False
        if optimizer is not None and optimizer._parameter_list is None:
            optimizer._set_parameters(self.network.named_parameters())
        # fleet: train through the strategy's step over the mesh
        from ..distributed.fleet import fleet as _fleet
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
        self._dist_ctx = _fleet if (_fleet._inited and mesh is not None
                                    and mesh.devices.size > 1) else None
        self._sharded_step = self._sharded_state = None
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

    def _masked_loss(self, outputs, labels, mask, norm=None):
        """The prepared loss folded with a validity mask
        (`paddle_tpu/hapi/model.py:244-316`).

        A 2-D mask [rows, T] is a TOKEN mask (the packing collator's last
        leaf): the loss must give per-token values [rows, T(, ...)], pad
        tokens get zero weight and the mean divides by the real-token
        count. A 1-D mask [rows] is a ROW mask: padded rows get zero
        weight and the mean divides by the real-row count. A loss with a
        `reduction` attribute is called with reduction "none"; one that
        gives no such values raises _TailMaskError (a TypeError).
        `norm` (the fleet path): (the whole batch's mask count, the ranks
        the step averages over) replaces this batch's own count."""
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
        if norm is not None:
            count, parts = norm
            if red == "sum":
                return per.sum() * parts
            return per.sum() * parts / max(float(count), 1.0)
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
                                 self._placed_mask(loss_mask))

    def _placed_mask(self, mask):
        """The mask on the model's device; a host row mask (the tail
        bucketing's) is placed once per distinct value."""
        if not (isinstance(mask, np.ndarray) and mask.ndim == 1):
            return self._place([mask])[0]
        key = (mask.tobytes(), str(self.device))
        hit = self._mask_cache.get(key)
        if hit is None:
            hit = self._mask_cache[key] = self._place([mask])[0]
        return hit

    def _mask_fallback(self, inputs, labels, loss_mask):
        """A loss that cannot fold the row mask: warn once, pin the model
        to unpadded batches, and give this batch's real rows. A TOKEN
        mask (packing) has no unpadded shape to fall back to, so its
        _TailMaskError propagates instead."""
        if self._tail_maskable:
            self._tail_maskable = False
            warnings.warn(
                "FLAGS_train_tail_bucketing: the prepared loss does not "
                "expose per-row values; falling back to unpadded tail "
                "batches", stacklevel=3)
        rows, idx = _real_rows(loss_mask)
        return (_select_rows(inputs, rows, idx),
                _select_rows(labels, rows, idx))

    def _tail_target(self, loader, need_mask=True):
        """The loader's batch size when its epochs can end on a partial
        batch (a loader without a sized dataset counts as "can"), else
        None (`paddle_tpu/hapi/model.py:848-871`). `need_mask=False`
        (predict: no loss) pads even after the loss refused the mask."""
        if not flag("FLAGS_train_tail_bucketing"):
            return None
        if need_mask and not self._tail_maskable:
            return None
        bs = getattr(loader, "batch_size", None)
        if not bs:
            return None
        sampler = getattr(loader, "batch_sampler", None)
        if getattr(sampler, "drop_last", False):
            return None   # the sampler already drops the tail
        ds = getattr(loader, "dataset", None)
        if ds is not None and sampler is not None:
            try:
                if len(ds) % bs == 0:
                    return None   # every batch is full
            except TypeError:
                pass   # unsized dataset: a tail is possible
        return bs

    @staticmethod
    def _pad_tail(ins, lbs, target):
        """Grow a partial batch to `target` rows: (ins, lbs, row mask,
        real rows). A full batch passes through with an all-ones mask."""
        rows = _batch_rows(ins + lbs)
        if rows is None:
            return ins, lbs, None, None
        if rows >= target:
            return ins, lbs, np.ones((rows,), "float32"), rows
        mask = np.zeros((target,), "float32")
        mask[:rows] = 1.0
        ins = [_pad_leaf(x, rows, target) for x in ins]
        lbs = [_pad_leaf(x, rows, target) for x in lbs]
        monitor.stat_add("STAT_tail_pad_batches")
        return ins, lbs, mask, rows

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

    def _buffered(self, loader):
        """A `DataLoader` that opted into buffering (`use_buffer_reader`)
        wrapped in a `DeviceFeeder` on the model's device; anything else
        as it is."""
        if isinstance(loader, DataLoader) and \
                getattr(loader, "use_buffer_reader", False):
            return DeviceFeeder(loader, device=self.device)
        return loader

    def _update_metrics(self, outputs, labels, loss_mask):
        """Every prepared metric's `update(compute(first output, *labels))`
        on the rows the mask keeps; the list of what each returns."""
        if not self._metrics:
            return []
        outs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        outs = [o.detach() for o in outs]
        if loss_mask is not None and not self._is_token_mask(loss_mask):
            rows, idx = _real_rows(loss_mask)
            if len(idx) < rows:
                outs = _select_rows(outs, rows, idx)
                labels = _select_rows(labels, rows, idx)
        res = []
        for m in self._metrics:
            inp = m.compute(outs[0], *labels)
            res.append(m.update(inp[0] if isinstance(inp, tuple) else inp))
        return res

    # -- steps --------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True, loss_mask=None):
        """One training step (under `amp.auto_cast` when prepared with
        `amp_configs`). `update=False` leaves the gradients in the
        parameters' `.grad` (they accumulate over calls) and skips the
        optimizer. `loss_mask`: a token [rows, T] or row [rows] mask
        folded into the loss (`_masked_loss`). Returns ([loss], []) with
        the loss a device tensor, or, with metrics prepared, (loss,
        [each metric's update result])."""
        if self._dist_ctx is not None:
            return self._train_batch_sharded(inputs, labels, loss_mask)
        t0 = time.perf_counter_ns()
        ins = self._place(_flatten_batch(inputs))
        lbs = self._place(_flatten_batch(labels or []))
        self.network.train()
        row_mask = loss_mask is not None and \
            not self._is_token_mask(loss_mask)
        saved = None
        if row_mask and not self._row_mask_ok:
            # until a row-masked step has worked, keep the buffers the
            # forward moves (BatchNorm's), for the fallback below
            saved = {n: b.detach().clone()
                     for n, b in self.network.named_buffers()}
        try:
            with (amp.auto_cast(level=self._amp_level) if self._amp_level
                  else contextlib.nullcontext()):
                out = self.network(*ins)
                lv = self._step_loss(out, lbs, loss_mask)
        except _TailMaskError:
            if not row_mask:
                raise   # packing: no unpadded shape to fall back to
            _restore(self.network, saved)
            ins, lbs = self._mask_fallback(ins, lbs, loss_mask)
            return self.train_batch(ins, lbs, update=update)
        if row_mask:
            self._row_mask_ok = True
        lv.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        monitor.stat_add("STAT_train_steps")
        monitor.stat_add("STAT_train_step_ns", time.perf_counter_ns() - t0)
        metrics = self._update_metrics(out, lbs, loss_mask)
        loss = lv.detach()
        return (loss, metrics) if self._metrics else ([loss], metrics)

    def _train_batch_sharded(self, inputs, labels, loss_mask=None):
        """The fleet path (see the module docstring): one step of the
        strategy's train step on the global batch."""
        t0 = time.perf_counter_ns()
        if self._sharded_step is None:
            def loss_fn(out, lbs):
                if self._sharded_norm is not None:
                    return self._masked_loss(out, list(lbs[:-1]), lbs[-1],
                                             norm=self._sharded_norm)
                return self._loss_value(out, lbs)
            self._sharded_step, self._sharded_state = \
                self._dist_ctx.build_sharded_train_step(
                    self.network, self._optimizer, loss_fn)
        ins = _flatten_batch(inputs)
        lbs = _flatten_batch(labels or [])
        self._sharded_norm = None
        if loss_mask is not None:
            m = loss_mask
            count = float(m.float().sum()) if torch.is_tensor(m) \
                else float(np.asarray(m, "float64").sum())
            self._sharded_norm = (count, self._dist_parts())
            lbs = lbs + [m]
        try:
            with (amp.auto_cast(level=self._amp_level) if self._amp_level
                  else contextlib.nullcontext()):
                self._sharded_state, lv = self._sharded_step(
                    self._sharded_state, tuple(ins), tuple(lbs))
        finally:
            self._sharded_norm = None
        monitor.stat_add("STAT_train_steps")
        monitor.stat_add("STAT_train_step_ns", time.perf_counter_ns() - t0)
        if not self._in_fit:
            self._sync_sharded()
        loss = lv.detach()
        return (loss, []) if self._metrics else ([loss], [])

    def _dist_parts(self):
        """The ranks the strategy's step averages a loss over (dp, x sp
        under sequence parallelism)."""
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
        st = self._dist_ctx._strategy
        parts = mesh.axis_size("dp")
        if st is not None and st.sequence_parallel:
            parts *= mesh.axis_size("sp")
        return parts

    def _sync_sharded(self):
        """Write a step's own replicas or stages back into the network
        (LocalSGD's mean, the pipeline's gathered stages)."""
        wb = getattr(self._sharded_step, "write_back", None)
        if wb is not None and self._sharded_state is not None:
            wb(self._sharded_state)

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None, loss_mask=None):
        """Forward in eval mode; returns (loss, metrics) with the loss a
        device tensor (0 when no loss is prepared or no labels are given),
        `loss_mask` folded in as in `train_batch`, and each prepared
        metric's update result."""
        ins = self._place(_flatten_batch(inputs))
        lbs = self._place(_flatten_batch(labels or []))
        self.network.eval()
        out = self.network(*ins)
        if self._loss is None or not lbs:
            lv = torch.zeros((), device=self.device)
        else:
            try:
                lv = self._step_loss(out, lbs, loss_mask)
            except _TailMaskError:
                if self._is_token_mask(loss_mask):
                    raise   # packing: no unpadded shape to fall back to
                ins, lbs = self._mask_fallback(ins, lbs, loss_mask)
                return self.eval_batch(ins, lbs)
        return lv, self._update_metrics(out, lbs, loss_mask)

    @torch.no_grad()
    def predict_batch(self, inputs, nreal=None):
        """Forward in eval mode; the outputs on the host as numpy arrays
        (a list when the network returns several). `nreal` (tail
        bucketing): the batch was padded, and only the first `nreal`
        rows of each batch-major output are returned."""
        ins = self._place(_flatten_batch(inputs))
        rows = _batch_rows(ins)
        self.network.eval()
        out = self.network(*ins)

        def host(o):
            o = o.detach()
            if nreal is not None and rows is not None and nreal < rows \
                    and o.dim() >= 1 and o.shape[0] == rows:
                o = o[:nreal]
            return o.cpu().numpy()
        if isinstance(out, (list, tuple)):
            return [host(o) for o in out]
        return host(out)

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """`accumulate_grad_batches` is accepted and not read, as in the
        JAX package (`paddle_tpu/hapi/model.py:905`)."""
        if self._optimizer is None:
            raise RuntimeError("Model.fit: call prepare() first")
        loader = self._as_loader(train_data, batch_size, shuffle, num_workers,
                                 drop_last)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers, False)
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=_steps_of(loader),
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=["loss"] + [
                n for m in self._metrics for n in _metric_names(m)])
        cbks.on_begin("train")
        self.stop_training = False
        token_masked = self._token_masked(loader)
        feed = self._buffered(loader)
        self._in_fit = True
        try:
            self._fit_epochs(loader, feed, eval_loader, cbks, epochs,
                             eval_freq, log_freq, batch_size, num_iters,
                             token_masked)
        finally:
            self._in_fit = False
        return self

    def _fit_epochs(self, loader, feed, eval_loader, cbks, epochs,
                    eval_freq, log_freq, batch_size, num_iters,
                    token_masked):
        step_count = 0
        logs = {}  # stays bound for on_end even with epochs=0
        for epoch in range(epochs):
            sampler = getattr(loader, "batch_sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            # tail bucketing (module docstring); a packing collator's
            # packs are fixed-shape already and carry their own mask
            pad_to = None if token_masked else self._tail_target(loader)
            for step, batch in enumerate(feed):
                cbks.on_batch_begin("train", step, logs)
                ins, lbs = self._split_batch(batch)
                mask, nreal = None, None
                if token_masked:
                    lbs, mask = self._pop_token_mask(lbs)
                elif pad_to and self._tail_maskable:
                    # re-checked each batch: a fallback stops the padding
                    ins, lbs, mask, nreal = self._pad_tail(ins, lbs, pad_to)
                with RecordEvent("fit::train_step"):
                    loss, metrics = self.train_batch(ins, lbs,
                                                     loss_mask=mask)
                lv = loss[0] if isinstance(loss, list) else loss
                # deferred host sync: the loss stays on the device except
                # on the log cadence
                if log_freq and step % log_freq == 0:
                    lv = _host_float(lv)
                logs = {"loss": lv, "step": step, "batch_size": nreal
                        if nreal is not None else
                        (int(ins[0].shape[0]) if hasattr(ins[0], "shape")
                         else batch_size)}
                _log_metrics(logs, self._metrics, metrics)
                cbks.on_batch_end("train", step, logs)
                step_count += 1
                if num_iters is not None and step_count >= num_iters:
                    self.stop_training = True
                    break
            if self._dist_ctx is not None:
                self._sync_sharded()
            if torch.is_tensor(logs.get("loss")):
                logs["loss"] = _host_float(logs["loss"])
            _log_metrics(logs, self._metrics,
                         [m.accumulate() for m in self._metrics])
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size, verbose=0)
            if self.stop_training:
                break
        cbks.on_end("train", logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """Mean loss over `eval_data`, with one wait for the card at the
        end of the pass (and one a batch for prepared metrics, whose
        `accumulate()` the result carries under their names). Under a
        packing collator each pack's loss is already real-token-
        normalised, and the pass weights packs by their real-token
        counts, so the result is the true per-token mean (a near-empty
        last pack does not count like a full one). A partial last batch
        is padded (tail bucketing) and its mean covers its real rows.
        `num_samples` is accepted and not read, as in the JAX package
        (`paddle_tpu/hapi/model.py:1044`)."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        for m in self._metrics:
            m.reset()
        token_masked = self._token_masked(loader)
        pad_to = None if token_masked else self._tail_target(loader)
        losses, weights = [], []
        for batch in self._buffered(loader):
            ins, lbs = self._split_batch(batch)
            mask = None
            if token_masked:
                lbs, mask = self._pop_token_mask(lbs)
                weights.append(torch.as_tensor(mask).float().sum())
            elif pad_to and self._tail_maskable:
                ins, lbs, mask, _ = self._pad_tail(ins, lbs, pad_to)
            losses.append(self.eval_batch(ins, lbs, loss_mask=mask)[0])
        if not losses:
            logs = {"loss": 0.0}
        else:
            vals = cbks_mod._host_scalars(losses + weights)
            monitor.stat_add("STAT_train_host_syncs")
            vals, weights = vals[:len(losses)], vals[len(losses):]
            if token_masked and sum(weights) > 0:
                logs = {"loss": float(np.average(vals, weights=weights))}
            else:
                logs = {"loss": sum(vals) / len(vals)}
        _log_metrics(logs, self._metrics,
                     [m.accumulate() for m in self._metrics])
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """`predict_batch` over `test_data`: a list with one output per
        batch, or, with `stack_outputs`, the outputs concatenated over
        batches. A partial last batch is padded (tail bucketing) and its
        padded rows sliced off the outputs; packs go through as they are
        (their rows are not sequences)."""
        loader = self._as_loader(test_data, batch_size, False, num_workers,
                                 False)
        pad_to = None if self._token_masked(loader) else \
            self._tail_target(loader, need_mask=False)
        outputs = []
        for batch in self._buffered(loader):
            ins = self._split_batch(batch)[0]
            nreal = None
            if pad_to:
                rows = _batch_rows(ins)
                if rows is not None and rows < pad_to:
                    ins = [_pad_leaf(x, rows, pad_to) for x in ins]
                    nreal = rows
                    monitor.stat_add("STAT_tail_pad_batches")
            outputs.append(self.predict_batch(ins, nreal=nreal))
        if stack_outputs and outputs:
            if isinstance(outputs[0], list):
                return [np.concatenate([o[i] for o in outputs])
                        for i in range(len(outputs[0]))]
            return np.concatenate(outputs)
        return outputs

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """Training: `path.pdparams` (the network's state dict) and, with
        an optimizer, `path.pdopt` (its state dict), both through
        `framework.io_state.save`, the JAX package's format (pickled
        numpy). Not training: the network exported through `jit.save`
        with the model's `inputs` specs, as the JAX package does; where
        `torch.export` cannot keep a symbolic dim, its error propagates
        (ROADMAP C17)."""
        if not training:
            from .. import jit
            jit.save(self.network, path, input_spec=self._inputs)
            return
        io_state.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            io_state.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The network's state from `path.pdparams` (the port's own names
        and layouts; weights of the JAX package cross through
        `models.load_reference_state`) onto the model's device, and the
        optimizer's from `path.pdopt` unless `reset_optimizer` or absent
        (then its state starts afresh)."""
        io_state.set_state_dict(self.network,
                                io_state.load(path + ".pdparams"),
                                strict=not skip_mismatch)
        opt = self._optimizer
        if opt is None:
            return self
        opt_path = path + ".pdopt"
        if not reset_optimizer and os.path.exists(opt_path):
            opt.set_state_dict(io_state.to_tensor_state(
                io_state.load(opt_path), self.device))
        else:
            opt._accumulators.clear()
            opt._global_step = 0
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtype)
