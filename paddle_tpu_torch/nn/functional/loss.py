"""Cross-entropy (port of `paddle_tpu.nn.functional.loss.cross_entropy`,
`loss.py:26-56` there; reference `python/paddle/nn/functional/loss.py`,
`operators/softmax_with_cross_entropy_op.*`)."""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["cross_entropy"]


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross-entropy of logits `input` against `label`.

    Hard labels: integer class ids shaped like `input` without `axis`
    (or with a size-1 `axis`). Positions whose label is `ignore_index`
    count 0 and leave the mean's denominator; `weight` [C] weights each
    position by its class, and the mean then divides by the summed
    weights of the counted positions. Soft labels: a distribution shaped
    like `input`. `reduction` is "mean", "sum" or "none". AMP's black op
    "cross_entropy": under AMP autocast-type logits (and soft labels, and
    weight) are cast up to float32."""
    if weight is None:
        input, label = amp.cast_args("cross_entropy", input, label)
    else:
        input, label, weight = amp.cast_args("cross_entropy", input, label,
                                             weight)
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-12))
    if soft_label:
        return _reduce(-torch.sum(label * logp, dim=axis), reduction)
    lab = label
    if lab.dim() == logp.dim():
        lab = lab.squeeze(axis)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = (torch.sum(weight[safe] * valid) if weight is not None
                 else torch.sum(valid.to(loss.dtype)))
        return torch.sum(loss) / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)
