"""The sharded train step (port of `paddle_tpu.parallel.spmd`).

The JAX package lays parameters, optimizer state and batch onto one mesh
with NamedShardings and lets GSPMD insert every collective of one jitted
step. The port runs one process a rank and writes the collectives:
- the batch: a rank trains on its `dp` block of rows (the step takes the
  global batch, as the JAX step does, unless `local_batch=True`);
- parameters follow their `partition_spec` (the tensor-parallel layers
  of `distributed.tensor_parallel` hold their 'mp' slice; ZeRO-3 marks
  a 'dp' axis), else replicated;
- gradients: ZeRO-0 and ZeRO-1 all-reduce them over `dp` in flattened
  buckets a type and average; ZeRO-2 and ZeRO-3 reduce-scatter each
  gradient over `dp` on its largest dp-divisible axis, as `zero_sharding`
  picks it;
- optimizer state (ZeRO-1 and up): each rank keeps and updates the block
  of its parameter on that axis, then the blocks are all-gathered into
  the parameter. A parameter with no divisible axis is updated whole on
  every rank. The update rule runs on blocks, so it must be elementwise
  (every optimizer but `Lamb` and `LarsMomentum`);
- `recompute` checkpoints the forward (`torch.utils.checkpoint`).

`sharded_splash_attention` is the packed-batch attention of a dp rank:
splash attention (K5 forward, K6/K7 backward on the card) on the rank's
own rows, with the rank's dp coordinate added to the dropout seed, as
the JAX package adds `axis_index('dp')` (`spmd.py:391-396`): the keep
mask hashes (seed, b*H+h, i, j) on local row indices
(`csrc/flash_common.cuh`), so one seed would give every rank one mask.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..framework import random as frandom
from ..framework.errors import InvalidArgumentError
from .mesh import Mesh, P, get_mesh

__all__ = ["param_sharding", "zero_sharding", "batch_sharding",
           "make_sharded_train_step", "shard_params",
           "sharded_splash_attention", "write_back", "tp_mesh",
           "local_rows"]

# rules that update each element from its own gradient and state only
_NOT_ELEMENTWISE = ("Lamb", "LarsMomentum")


def tp_mesh(tp, axis="tp"):
    """A 1-D mesh over the first `tp` ranks for tensor-parallel serving;
    raises where the world has fewer."""
    from ..distributed.env import get_world_size
    world = get_world_size()
    if world < tp:
        raise RuntimeError(
            f"tp={tp} needs {tp} ranks, the world has {world}: call "
            f"distributed.init_parallel_env() in each rank started by "
            f"python -m paddle_tpu_torch.distributed.launch "
            f"--nproc_per_node {tp}")
    return Mesh({axis: tp}, list(range(tp)))


def _spec_of(param) -> P:
    return getattr(param, "partition_spec", None) or P()


def _filter_spec(spec, mesh):
    """Axes absent from the mesh (or of size 1) dropped."""
    return P(*[s if isinstance(s, str) and mesh is not None
               and mesh.axis_size(s) > 1 else None for s in tuple(spec)])


def param_sharding(layer, mesh=None) -> Dict[str, P]:
    mesh = mesh or get_mesh()
    return {n: _filter_spec(_spec_of(p), mesh)
            for n, p in layer.named_parameters()}


def _zero_axis(shape, base, dp):
    """The largest dim not sharded by `base` that `dp` divides, else None
    (the JAX package's choice, ties to the lower dim)."""
    base = tuple(base) + (None,) * (len(shape) - len(base))
    for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if base[ax] is None and shape[ax] % dp == 0:
            return ax
    return None


def zero_sharding(layer, opt_state, mesh=None, zero_stage=1,
                  dp_axis="dp") -> Dict:
    """Spec pytree of the optimizer state: each leaf inherits its
    parameter's spec and, at ZeRO >= 1, `dp_axis` on its largest
    dp-divisible free axis."""
    mesh = mesh or get_mesh()
    dp = mesh.axis_size(dp_axis) if mesh is not None else 1
    specs = param_sharding(layer, mesh)
    out = {}
    for name, st in opt_state.items():
        base = tuple(specs[name])
        leaves = {}
        for k, leaf in st.items():
            if not torch.is_tensor(leaf) or leaf.ndim == 0:
                leaves[k] = P()
                continue
            spec = list(base[:leaf.ndim]) + [None] * (leaf.ndim - len(base))
            ax = (_zero_axis(tuple(leaf.shape), spec, dp)
                  if zero_stage >= 1 and dp > 1 else None)
            if ax is not None:
                spec[ax] = dp_axis
            leaves[k] = P(*spec)
        out[name] = leaves
    return out


def batch_sharding(ndim, mesh=None, dp_axis="dp", sp_axis=None,
                   seq_dim=1) -> P:
    mesh = mesh or get_mesh()
    spec = [None] * ndim
    if mesh is not None and mesh.axis_size(dp_axis) > 1:
        spec[0] = dp_axis
    if sp_axis and mesh is not None and mesh.axis_size(sp_axis) > 1 \
            and ndim > seq_dim:
        spec[seq_dim] = sp_axis
    return P(*spec)


def shard_params(layer, mesh=None):
    """The parameters' specs on the mesh: each rank holds its slice
    already (the tensor-parallel layers keep theirs)."""
    return param_sharding(layer, mesh)


def local_rows(x, mesh=None, dp_axis="dp"):
    """This rank's dp block of rows of a global batch leaf."""
    mesh = mesh or get_mesh()
    n = mesh.axis_size(dp_axis) if mesh is not None else 1
    if n == 1 or x is None or np.ndim(x) == 0:
        return x
    rows = x.shape[0]
    if rows % n:
        raise InvalidArgumentError(
            f"batch of {rows} rows does not split over dp={n}")
    r = mesh.axis_rank(dp_axis)
    return x[r * rows // n:(r + 1) * rows // n]


def _as_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _gather_dim(shard, dim, group, n):
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts, dim)


def make_sharded_train_step(layer, optimizer, loss_fn: Callable,
                            mesh=None, zero_stage=None, dp_axis="dp",
                            sp_axis=None, recompute=False,
                            donate=True, grad_dtype=None,
                            dgc=False, dgc_momentum=0.9,
                            dgc_sparsity=0.999, local_batch=False):
    """Returns (step, state):
      state = {params, buffers, opt_state, step_no}
      step(state, inputs, labels, lr=None, rng=None) -> (state, loss)
    `loss` is the mean over the global batch (the ranks' means averaged).
    `params` are the layer's own (local) parameters, updated in place;
    `opt_state[name]` holds the rank's ZeRO block of each state leaf.
    `rng` (an int) seeds the step's dropout draws as `framework.random.
    seed` would; the draws of a dp rank differ from the other ranks'
    (the attention kernels fold the rank in). `zero_stage` defaults to
    the optimizer's (set by `distributed.sharding.
    group_sharded_parallel`), else 1."""
    if dgc:
        raise InvalidArgumentError(
            "make_sharded_train_step(dgc=True) is not yet ported to "
            "paddle_tpu_torch (parallel/compression.py)")
    if sp_axis:
        raise InvalidArgumentError(
            "make_sharded_train_step(sp_axis=...) is not yet ported to "
            "paddle_tpu_torch (sequence-parallel attention, "
            "parallel/ring_attention.py)")
    mesh = mesh or get_mesh()
    if zero_stage is None:
        zero_stage = int(getattr(optimizer, "_zero_stage", 1))
    dp = mesh.axis_size(dp_axis) if mesh is not None else 1
    group = mesh.group(dp_axis) if mesh is not None else None
    r = mesh.axis_rank(dp_axis) if mesh is not None else 0
    if dp > 1 and zero_stage >= 1 and \
            type(optimizer).__name__ in _NOT_ELEMENTWISE:
        raise InvalidArgumentError(
            f"ZeRO stage {zero_stage} updates blocks of a parameter; "
            f"{type(optimizer).__name__}'s rule reads whole-parameter "
            f"norms (use zero_stage=0)")
    if dp > 1 and zero_stage >= 2 and optimizer._grad_clip is not None:
        raise InvalidArgumentError(
            "gradient clipping under ZeRO-2/3 is not yet ported to "
            "paddle_tpu_torch (the clip needs the global norm of the "
            "scattered blocks); use zero_stage <= 1")
    names = [n for n, p in layer.named_parameters() if p.requires_grad]
    params = OrderedDict((n, p) for n, p in layer.named_parameters()
                         if p.requires_grad)
    # a ZeRO-3 'dp' mark (`group_sharded_parallel`) names the axis the
    # update is split on; the layer keeps the gathered parameter
    specs = {n: P(*[None if ax == dp_axis else ax for ax in spec])
             for n, spec in param_sharding(layer, mesh).items()}
    # each parameter's ZeRO axis: its largest dp-divisible free axis
    zaxis = {n: (_zero_axis(tuple(p.shape), specs[n], dp)
                 if zero_stage >= 1 and dp > 1 else None)
             for n, p in params.items()}

    def block(t, n):
        ax = zaxis[n]
        if ax is None:
            return t
        size = t.shape[ax] // dp
        return t.narrow(ax, r * size, size)

    opt_state = {n: optimizer._init_state(block(p.detach(), n))
                 for n, p in params.items()}
    state = {"params": params,
             "buffers": OrderedDict(layer.named_buffers()),
             "opt_state": opt_state, "step_no": 0}

    def reduce_grads(grads):
        """Mean gradients over dp: (full or block gradient a name)."""
        if group is None and dp == 1:
            return grads
        out = dict(grads)
        if zero_stage >= 2:
            for n, g in grads.items():
                ax = zaxis[n]
                if ax is None:
                    continue
                gc = g if grad_dtype is None else g.to(grad_dtype)
                parts = [c.contiguous() for c in gc.chunk(dp, ax)]
                shard = torch.empty_like(parts[r])
                dist.reduce_scatter(shard, parts, group=group)
                out[n] = shard.to(g.dtype).div_(dp)
        flat_names = [n for n in grads
                      if zero_stage < 2 or zaxis[n] is None]
        by_type: Dict[torch.dtype, list] = {}
        for n in flat_names:
            by_type.setdefault(grads[n].dtype, []).append(n)
        for dtype, ns in by_type.items():
            gs = [grads[n] for n in ns]
            flat = _flatten_dense_tensors(gs)
            if grad_dtype is not None:
                flat = flat.to(grad_dtype)
            dist.all_reduce(flat, group=group)
            flat = flat.to(dtype).div_(dp)
            for n, g in zip(ns, _unflatten_dense_tensors(flat, gs)):
                out[n] = g
        return out

    def forward_loss(inputs, labels):
        if recompute:
            from torch.utils.checkpoint import checkpoint
            out = checkpoint(layer, *inputs, use_reentrant=False)
        else:
            out = layer(*inputs)
        lv = loss_fn(out, list(labels))
        return lv.float().mean()

    def step(state, inputs, labels, lr=None, rng=None):
        device = next(iter(params.values())).device
        if not local_batch:
            inputs = tuple(local_rows(x, mesh, dp_axis) for x in inputs)
            labels = tuple(local_rows(x, mesh, dp_axis) for x in labels)
        inputs = tuple(_as_tensor(x, device) for x in inputs)
        labels = tuple(_as_tensor(x, device) for x in labels)
        lr = float(optimizer.get_lr() if lr is None else lr)
        layer.train()
        for p in params.values():
            p.grad = None
        if rng is not None:
            with frandom.rng_scope(int(rng)):
                lv = forward_loss(inputs, labels)
        else:
            lv = forward_loss(inputs, labels)
        lv.backward()
        grads = OrderedDict((n, p.grad if p.grad is not None
                             else torch.zeros_like(p))
                            for n, p in params.items())
        grads = reduce_grads(grads)
        if optimizer._grad_clip is not None:
            clipped = optimizer._grad_clip._clip_grads(
                [grads[n] for n in names])
            grads = OrderedDict(zip(names, clipped))
        step_no = state["step_no"] + 1
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                full_g = g.shape == p.shape
                pb = block(p.detach(), n)
                gb = block(g, n) if full_g else g
                new_pb, state["opt_state"][n] = optimizer._update(
                    gb, pb, state["opt_state"][n], lr, step_no)
                if zaxis[n] is None:
                    p.copy_(new_pb)
                else:
                    p.copy_(_gather_dim(new_pb.to(p.dtype), zaxis[n],
                                        group, dp))
                p.grad = None
        state["step_no"] = step_no
        loss = lv.detach()
        if group is not None:
            dist.all_reduce(loss, group=group)
            loss = loss / dp
        return state, loss

    def leaf_spec(n, v):
        if not torch.is_tensor(v) or v.ndim == 0:
            return P()
        base = tuple(specs[n]) + (None,) * (v.ndim - len(specs[n]))
        return P(*[dp_axis if d == zaxis[n] else ax
                   for d, ax in enumerate(base)])

    step.state_sharding = {
        "params": specs, "buffers": {n: P() for n in state["buffers"]},
        "opt_state": {n: {k: leaf_spec(n, v) for k, v in st.items()}
                      for n, st in opt_state.items()},
        "step_no": P()}
    step.zero_axes = zaxis
    return step, state


def sharded_splash_attention(mesh=None, causal=False, scale=None,
                             dropout_p=0.0, dp_axis="dp"):
    """Packed-batch attention of a dp rank (see the module docstring).
    Returns f(q, k, v, q_seg, kv_seg, seed=None) on the rank's rows
    [B/dp, H, S, D] and segment ids [B/dp, S]. `scale` defaults to
    1/sqrt(D). With dropout a seed is drawn a call from the framework's
    stream (the same on every rank of a seeded run) unless given, and the
    rank's dp coordinate is added to it."""
    from ..ops.splash_ops import splash_attention
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("sharded_splash_attention needs a live mesh "
                           "(parallel.mesh.create_mesh / "
                           "distributed.init_parallel_env)")
    rank = mesh.axis_rank(dp_axis) if mesh.axis_size(dp_axis) > 1 else 0

    def f(q, k, v, q_seg, kv_seg, seed=None):
        if dropout_p > 0.0 and seed is None:
            seed = frandom.next_seed(q.device)
        return splash_attention(q, k, v, q_seg, kv_seg, causal=causal,
                                scale=scale, dropout_p=dropout_p,
                                seed=(int(seed or 0) + rank
                                      if dropout_p > 0.0 else 0))

    return f


def write_back(layer, state):
    """Copy a state's parameters and buffers into `layer` (the step keeps
    the layer's own tensors, so this copies only foreign values)."""
    with torch.no_grad():
        own = dict(layer.named_parameters())
        for n, v in state["params"].items():
            if own[n] is not v:
                own[n].copy_(v)
        bufs = dict(layer.named_buffers())
        for n, v in state["buffers"].items():
            if bufs[n] is not v:
                bufs[n].copy_(v)
