"""Gradient compression: DGC, deep gradient compression (port of
`paddle_tpu.parallel.compression`; reference
`fleet/meta_optimizers/dgc_optimizer.py:19` and the `dgc_op` /
`dgc_momentum_op` pair).

DGC keeps two accumulators a parameter, a momentum velocity ``u`` and an
error-feedback buffer ``v``, and each step applies only the top-k share
of the accumulated velocity, leaving the rest in ``v`` (Lin et al. 2018):

    u <- m*u + g ;  v <- v + u ;  keep the top (1 - sparsity) of |v|
    emitted = v * mask ;  u, v <- u * (1 - mask), v * (1 - mask)

A tensor keeps k = max(1, round(size * (1 - sparsity))) entries, more
only where |v| ties the k-th largest (the mask is |v| >= kth). With
``rampup_step`` the sparsity ramps from 0.75 to the target over the first
``rampup_step`` steps and the threshold is the float32 quantile of |v|
(linear interpolation), as the JAX package computes it.

The state is a dict {name: {"u", "v"}} beside the parameters; the
transform is pure (new tensors out), as the JAX package's pytree
transform is. `parallel.spmd.make_sharded_train_step(dgc=True)` applies
it to the dp-averaged gradient (on a rank's blocks from ZeRO-2 on, with
the whole gradient's threshold), `parallel.localsgd.
make_local_train_step(dgc=True)` to each rank's own before the average.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["dgc_init", "dgc_compress"]


def dgc_init(params):
    """{name: {"u": zeros, "v": zeros}} shaped like `params` (a dict of
    tensors)."""
    return {n: {"u": torch.zeros_like(p), "v": torch.zeros_like(p)}
            for n, p in params.items()}


def _topk_mask(x, k, groups=()):
    """|x| >= its k-th largest |value| (ties kept, as `lax.top_k`'s k-th
    value compared with >=). With `groups` ([(group, size)]), x is a block
    of a whole tensor split over them: each rank's top-k candidates are
    all-gathered and the k-th largest of the union is the whole tensor's
    k-th largest."""
    a = x.abs()
    top = torch.topk(a.reshape(-1), min(k, a.numel())).values
    for g, n in groups:
        if top.numel() < k:   # a short block: pad with values below any
            top = torch.cat([top, top.new_full((k - top.numel(),), -1.0)])
        parts = [torch.empty_like(top) for _ in range(n)]
        dist.all_gather(parts, top.contiguous(), group=g)
        top = torch.topk(torch.cat(parts), k).values
    return a >= top[k - 1]


def _quantile(a, q):
    """`jnp.quantile(a, q)` of a flat float32 tensor, method "linear", in
    float32 as JAX computes it (`q * (n - 1)`, floor / ceil, weighted)."""
    s = torch.sort(a.reshape(-1)).values
    n = torch.tensor(float(s.numel()), dtype=torch.float32)
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo = int(torch.clamp(low, 0, n - 1))
    hi = int(torch.clamp(high, 0, n - 1))
    return s[lo] * lw.to(s.device) + s[hi] * hw.to(s.device)


def dgc_compress(grads, state, momentum=0.9, sparsity=0.999,
                 rampup_step=None, step_no=None, groups=None):
    """One DGC step over {name: gradient}; returns (sparse gradients,
    new state), both dicts (see the module docstring). `groups` ({name:
    [(group, size)]}, from `parallel.spmd`) names the gradients that are
    blocks of a whole one split over those groups (ZeRO-2/3, 'mp' / 'ep'
    slices): their k counts the whole gradient and their threshold is the
    whole gradient's (`_topk_mask`)."""
    eff = None
    if rampup_step is not None and step_no is not None:
        frac = torch.clamp(torch.tensor(float(step_no) / float(rampup_step),
                                        dtype=torch.float32), 0.0, 1.0)
        eff = 0.75 + frac * (sparsity - 0.75)
    out, new_state = {}, {}
    for n, g in grads.items():
        st = state[n]
        u = momentum * st["u"] + g
        v = st["v"] + u
        gs = (groups or {}).get(n) or ()
        if rampup_step is None:
            size = v.numel()
            for _, m in gs:
                size *= m
            k = max(1, int(round(size * (1.0 - sparsity))))
            mask = _topk_mask(v, k, gs)
        else:
            q = _quantile(v.abs().float(), eff)
            mask = v.abs() >= q.to(v.dtype)
        keep = mask.to(v.dtype)
        out[n] = v * keep
        new_state[n] = {"u": u * (1 - keep), "v": v * (1 - keep)}
    return out, new_state

