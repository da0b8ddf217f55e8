"""LocalSGD, adaptive LocalSGD and per-rank DGC (port of
`paddle_tpu.parallel.localsgd`; reference
`fleet/meta_optimizers/localsgd_optimizer.py:24` (plain), `:195`
(adaptive, next interval ``k = sqrt(lr_0 * avg_loss / (lr * loss_0) *
init_k)`` at `:422`) and `dgc_optimizer.py:19`).

Replicas that diverge between syncs: the JAX package gives every state
leaf a leading replica axis over 'dp' under `shard_map`; the port runs one
process a rank, so each rank keeps its own replica of the parameters,
buffers and optimizer state (`state["params"]`, copies of the layer's,
run through `torch.func.functional_call`) and trains it on its dp block of
the batch with its own dropout draws. Every `k` steps from `begin_step` on
the replicas are averaged with one all-reduce over dp; between syncs no
parameter collective runs. The loss returned is the dp ranks' mean.

`adaptive=True` rescales `k` at each sync after the first (which pins
loss0 and lr0), in float32 as the JAX package computes it, clipped to
[1, max_k_steps]. `dgc=True` instead syncs every step: each rank
compresses its own gradient with error feedback (`compression.
dgc_compress`) before the gradients' all-reduce, the per-worker DGC
dataflow.

`local_write_back(layer, state)` puts the replicas' mean into the layer
(integer buffers from dp coordinate 0); the replicas themselves go on.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import torch
import torch.distributed as dist

from ..framework import random as frandom
from .compression import dgc_compress, dgc_init
from .mesh import get_mesh
from .spmd import _as_tensor, _mean_over, local_rows

__all__ = ["make_local_train_step", "local_write_back"]


def make_local_train_step(layer, optimizer, loss_fn: Callable, mesh=None,
                          k_steps=4, begin_step=1, adaptive=False,
                          max_k_steps=16, dgc=False, dgc_momentum=0.9,
                          dgc_sparsity=0.999, dp_axis="dp"):
    """Returns (step, state):
      state = {params, buffers, opt_state, dgc?, step_no, since_sync, k,
               loss0, lr0}  (this rank's replica and the sync counters)
      step(state, inputs, labels, lr=None, rng=None) -> (state, loss)
    on the global batch (the rank trains on its dp rows); `loss` is the
    dp ranks' mean. `rng` (an int) seeds the step's dropout, the rank's
    dp coordinate folded in."""
    mesh = mesh or get_mesh()
    dp = mesh.axis_size(dp_axis) if mesh is not None else 1
    group = mesh.group(dp_axis) if mesh is not None else None
    widx = mesh.axis_rank(dp_axis) if mesh is not None else 0
    params = OrderedDict(
        (n, p.detach().clone().requires_grad_(p.requires_grad))
        for n, p in layer.named_parameters())
    buffers = OrderedDict((n, b.detach().clone())
                          for n, b in layer.named_buffers())
    state = {"params": params, "buffers": buffers,
             "opt_state": {n: optimizer._init_state(p.detach())
                           for n, p in params.items() if p.requires_grad},
             "step_no": 0, "since_sync": 0, "k": int(k_steps),
             "loss0": 0.0, "lr0": 0.0}
    if dgc:
        state["dgc"] = dgc_init({n: p.detach() for n, p in params.items()
                                 if p.requires_grad})
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731

    def step(state, inputs, labels, lr=None, rng=None):
        ps = state["params"]
        device = next(iter(ps.values())).device
        inputs = tuple(_as_tensor(local_rows(x, mesh, dp_axis), device)
                       for x in inputs)
        labels = tuple(_as_tensor(local_rows(x, mesh, dp_axis), device)
                       for x in labels)
        lr = float(optimizer.get_lr() if lr is None else lr)
        base = int(rng) if rng is not None else frandom.next_seed("cpu")
        layer.train()
        for p in ps.values():
            p.grad = None
        with frandom.rng_scope(frandom.fold_seed(base, widx)):
            out = torch.func.functional_call(
                layer, {**ps, **state["buffers"]}, inputs)
            lv = loss_fn(out, list(labels)).float().mean()
        lv.backward()
        trained = [n for n in state["opt_state"]]
        grads = OrderedDict((n, ps[n].grad if ps[n].grad is not None
                             else torch.zeros_like(ps[n]))
                            for n in trained)
        avg = lv.detach().clone()
        if group is not None:
            dist.all_reduce(avg, group=group)
            avg = avg / dp
        if dgc:
            grads, state["dgc"] = dgc_compress(grads, state["dgc"],
                                               dgc_momentum, dgc_sparsity)
            _mean_over(grads, group, dp)
        if optimizer._grad_clip is not None:
            grads = OrderedDict(zip(trained, optimizer._grad_clip._clip_grads(
                [grads[n] for n in trained])))
        step_no = state["step_no"] + 1
        with torch.no_grad():
            for n in trained:
                new_p, state["opt_state"][n] = optimizer._update(
                    grads[n], ps[n].detach(), state["opt_state"][n], lr,
                    step_no)
                ps[n].copy_(new_p)
                ps[n].grad = None
            if not dgc:
                since = state["since_sync"]
                do_sync = step_no >= begin_step and since + 1 >= state["k"]
                if do_sync:
                    _mean_over({n: ps[n] for n in trained}, group, dp)
                state["since_sync"] = 0 if do_sync else since + 1
                if adaptive and do_sync:
                    loss_v = f32(float(avg))
                    if state["loss0"] <= 0.0:
                        # the first sync pins (loss0, lr0)
                        state["loss0"] = float(loss_v)
                        state["lr0"] = float(f32(lr))
                    else:
                        nk = torch.ceil(torch.sqrt(
                            f32(state["lr0"]) * loss_v
                            / (f32(lr) * torch.clamp(f32(state["loss0"]),
                                                     min=1e-12))
                            * float(k_steps)))
                        state["k"] = int(torch.clamp(nk, 1, max_k_steps))
        state["step_no"] = step_no
        return state, avg

    step.write_back = lambda st: local_write_back(layer, st, mesh, dp_axis)
    return step, state


def local_write_back(layer, state, mesh=None, dp_axis="dp"):
    """The replicas' mean into `layer` (float buffers averaged, others
    from dp coordinate 0)."""
    mesh = mesh or get_mesh()
    dp = mesh.axis_size(dp_axis) if mesh is not None else 1
    group = mesh.group(dp_axis) if mesh is not None else None
    with torch.no_grad():
        mean = {n: v.detach().clone() for n, v in state["params"].items()}
        _mean_over(mean, group, dp)
        own = dict(layer.named_parameters())
        for n, v in mean.items():
            own[n].copy_(v)
        bufs = dict(layer.named_buffers())
        for n, v in state["buffers"].items():
            v = v.detach().clone()
            if group is not None and dp > 1:
                if v.is_floating_point():
                    _mean_over({n: v}, group, dp)
                else:
                    dist.broadcast(v, mesh.group_ranks(dp_axis)[0],
                                   group=group)
            bufs[n].copy_(v)
