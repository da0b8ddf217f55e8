"""Metrics (port of `paddle_tpu.metric`, `metric/__init__.py:15-170` there;
reference `python/paddle/metric/metrics.py`).

Metrics update on the host with the JAX package's numpy arithmetic
(`np.argsort` for top-k, so ties break as there): a torch tensor, on the
card or not, is brought to the host as a float32 (or integer) numpy
array first, which waits for the card."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()   # numpy has no bfloat16
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of `topk`: `compute(pred, label)` gives
    the [N, maxk] float32 hits of the top-maxk classes (numpy), `update`
    adds them up and returns the batch's accuracies."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        correct = (idx == label_np[..., None])
        return correct.astype("float32")

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim else 1
        accs = []
        for k in self.topk:
            num_corr = c[..., :k].sum()
            self.total[self.topk.index(k)] += num_corr
            self.count[self.topk.index(k)] += num
            accs.append(float(num_corr) / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of `preds > 0.5` against 0/1 `labels`."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(int).reshape(-1)
        lab = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of `preds > 0.5` against 0/1 `labels`."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(int).reshape(-1)
        lab = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over `num_thresholds` + 1 score bins (trapezoids from the
    highest threshold down); `preds` [N] or [N, 2] (column 1 scored)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lab = _np(labels).astype(int).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        # np.trapezoid is numpy 2's name of np.trapz
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(pos / tot_pos, neg / tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top-k of `input`, a
    float32 numpy scalar array (reference `fluid/layers/metric_op.py`)."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    idx = np.argsort(-pred, axis=-1)[:, :k]
    corr = (idx == lab[:, None]).any(axis=1).mean()
    return np.asarray(corr, dtype="float32")
