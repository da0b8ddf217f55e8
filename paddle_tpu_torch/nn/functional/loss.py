"""Loss functionals (port of `paddle_tpu.nn.functional.loss`; reference
`python/paddle/nn/functional/loss.py`, `operators/softmax_with_cross_
entropy_op.*`, `operators/warpctc_op`).

Each is the JAX package's expression, with its reductions, epsilons and
defaults (not torch's), cast through AMP by its JAX op name.
`ctc_loss` is the JAX package's log-alpha recursion over all T frames:
it never reads `input_lengths`, and "mean" divides each loss by its
clipped label length (ROADMAP C21), so it is not
`torch.nn.functional.ctc_loss`."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...ops._util import named
from ...framework.static_hook import named_op

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "nll_loss", "kl_div", "smooth_l1_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "dice_loss",
           "npair_loss", "ctc_loss"]


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


@named_op
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-position cross-entropy with the label's axis kept (size 1);
    with `return_softmax`, also the softmax of the logits."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


@named_op
def mse_loss(input, label, reduction="mean", name=None):
    a, b = named("mse_loss", input, label)
    return _reduce((a - b) ** 2, reduction)


@named_op
def square_error_cost(input, label):
    a, b = named("square_error_cost", input, label)
    return (a - b) ** 2


@named_op
def l1_loss(input, label, reduction="mean", name=None):
    a, b = named("l1_loss", input, label)
    return _reduce(torch.abs(a - b), reduction)


@named_op
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """-logp[label] of log-probabilities [N, C]; `ignore_index` positions
    count 0 and leave the mean's denominator; `weight` [C] as in
    `cross_entropy`."""
    args = (input, label) + ((weight,) if weight is not None else ())
    logp, lab, *w = named("nll_loss", *args)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -torch.gather(logp, 1, safe[:, None])[:, 0]
    if w:
        loss = loss * w[0][safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = (torch.sum(w[0][safe] * valid) if w
                 else torch.sum(valid.to(loss.dtype)))
        return torch.sum(loss) / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


@named_op
def kl_div(input, label, reduction="mean", name=None):
    """target * (log(target) - input) with log(target) clipped at 1e-12;
    "batchmean" divides the sum by the batch size."""
    logp, target = named("kl_div", input, label)
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - logp)
    if reduction == "batchmean":
        return torch.sum(loss) / logp.shape[0]
    return _reduce(loss, reduction)


@named_op
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    a, b = named("smooth_l1_loss", input, label)
    d = torch.abs(a - b)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@named_op
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """BCE of probabilities clipped into [1e-12, 1 - 1e-12]."""
    args = (input, label) + ((weight,) if weight is not None else ())
    p, y, *w = named("bce", *args)
    p = torch.clamp(p, 1e-12, 1 - 1e-12)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if w:
        loss = loss * w[0]
    return _reduce(loss, reduction)


@named_op
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """-(y * log_sigmoid(z) * pos_weight + (1 - y) * log_sigmoid(-z)),
    times `weight`."""
    args = [logit, label] + [a for a in (pos_weight, weight)
                             if a is not None]
    z, y, *rest = named("bce_with_logits", *args)
    pw = rest.pop(0) if pos_weight is not None else 1.0
    loss = -(y * TF.logsigmoid(z) * pw + (1 - y) * TF.logsigmoid(-z))
    if weight is not None:
        loss = loss * rest[0]
    return _reduce(loss, reduction)


@named_op
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    a, b, y = named("margin_ranking_loss", input, other, label)
    return _reduce(torch.clamp(-y * (a - b) + margin, min=0.0), reduction)


@named_op
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    a, y = named("hinge_embedding_loss", input, label)
    loss = torch.where(y == 1, a, torch.clamp(margin - a, min=0.0))
    return _reduce(loss, reduction)


@named_op
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = named("cosine_embedding_loss", input1, input2, label)
    cos = torch.sum(a * b, -1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


@named_op
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = named("triplet_margin_loss", input, positive, negative)

    def dist(u, v):
        return torch.sum(torch.abs(u - v + epsilon) ** p, -1) ** (1 / p)
    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


@named_op
def log_loss(input, label, epsilon=1e-4, name=None):
    p, y = named("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


@named_op
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    args = (logit, label) + ((normalizer,) if normalizer is not None else ())
    z, y, *n = named("sigmoid_focal_loss", *args)
    p = torch.sigmoid(z)
    ce = -(y * TF.logsigmoid(z) + (1 - y) * TF.logsigmoid(-z))
    pt = p * y + (1 - p) * (1 - y)
    at = alpha * y + (1 - alpha) * (1 - y)
    loss = at * (1 - pt) ** gamma * ce
    if n:
        loss = loss / n[0]
    return _reduce(loss, reduction)


@named_op
def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - the Dice overlap of probabilities [N, ..., C] with the one-hot
    of labels [N, ..., 1], averaged over the batch."""
    p, y = named("dice_loss", input, label)
    classes = torch.arange(p.shape[-1], device=p.device)
    y1 = (y.squeeze(-1)[..., None] == classes).to(p.dtype)
    red = tuple(range(1, p.dim()))
    inter = torch.sum(p * y1, dim=red)
    union = torch.sum(p, dim=red) + torch.sum(y1, dim=red)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


@named_op
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, pos, lab = named("npair_loss", anchor, positive, labels)
    sim = a @ pos.T
    lab = lab.reshape(-1)
    tgt = (lab[:, None] == lab[None, :]).to(sim.dtype)
    tgt = tgt / torch.sum(tgt, -1, keepdim=True)
    ce = -torch.sum(tgt * torch.log_softmax(sim, -1), -1)
    reg = l2_reg * (torch.mean(torch.sum(a * a, -1))
                    + torch.mean(torch.sum(pos * pos, -1))) * 0.25
    return torch.mean(ce) + reg


_NEG_INF = -1e30


@named_op
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", name=None):
    """CTC by the log-alpha recursion over all T frames of log_probs
    [T, B, C] for labels [B, S]: `input_lengths` is taken and not read,
    as in the JAX package; "mean" is the mean of each loss divided by
    max(label_length, 1)."""
    lp, lab, _, ll = named("ctc_loss", log_probs, labels, input_lengths,
                           label_lengths)
    T, B, C = lp.shape
    S = lab.shape[1]
    L = 2 * S + 1
    lab = lab.long()
    ext = torch.full((B, L), blank, dtype=torch.long, device=lp.device)
    ext[:, 1::2] = lab
    neg = torch.full((B, 1), _NEG_INF, dtype=lp.dtype, device=lp.device)
    alpha = torch.cat([lp[0, :, blank:blank + 1],
                       torch.gather(lp[0], 1, lab[:, :1]),
                       neg.expand(B, L - 2)], dim=1)
    same = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=lp.device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, T):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a2 = torch.where(same, _NEG_INF, a2)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m))
        alpha = new + torch.gather(lp[t], 1, ext)
    last = (2 * ll.long())[:, None]
    a_last = torch.gather(alpha, 1, last)[:, 0]
    a_prev = torch.gather(alpha, 1, last - 1)[:, 0]
    m = torch.maximum(a_last, a_prev)
    loss = -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))
    if reduction == "mean":
        return torch.mean(loss / torch.clamp(ll.to(loss.dtype), min=1))
    return _reduce(loss, reduction)
