"""Fleet metrics (port of `paddle_tpu.distributed.fleet.metrics`;
reference `fleet/metrics/metric.py`): sum / max / min / mean / acc / mae
/ rmse / auc of values each rank holds, over the world's
`torch.distributed` group (each rank's value gathered, in float64; the
value alone without a process group)."""
from __future__ import annotations

import numpy as np

from .utils import gather_values as _gather

__all__ = ["sum", "max", "min", "mean", "auc", "mae", "rmse", "acc"]


def sum(input, scope=None, util=None):
    return _gather(input).sum(0)


def max(input, scope=None, util=None):
    return _gather(input).max(0)


def min(input, scope=None, util=None):
    return _gather(input).min(0)


def mean(input, scope=None, util=None):
    return _gather(input).mean(0)


def acc(correct, total, scope=None, util=None):
    c = _gather(correct).sum()
    t = _gather(total).sum()
    return float(c) / float(np.maximum(t, 1))


def mae(abserr, total_ins_num, scope=None, util=None):
    return float(_gather(abserr).sum() / np.maximum(
        _gather(total_ins_num).sum(), 1))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(_gather(sqrerr).sum() / np.maximum(
        _gather(total_ins_num).sum(), 1)))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from per-worker threshold histograms (reference
    fleet.metrics.auc)."""
    pos = _gather(stat_pos).sum(0)
    neg = _gather(stat_neg).sum(0)
    tot_pos, tot_neg = pos.sum(), neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return 0.0
    tpr = np.cumsum(pos[::-1]) / tot_pos
    fpr = np.cumsum(neg[::-1]) / tot_neg
    return float(np.trapezoid(tpr, fpr))
