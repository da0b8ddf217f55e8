"""The sharded train step (port of `paddle_tpu.parallel.spmd`).

The JAX package lays parameters, optimizer state and batch onto one mesh
with NamedShardings and lets GSPMD insert every collective of one jitted
step. The port runs one process a rank and writes the collectives:
- the batch: a rank trains on its `dp` block of rows (the step takes the
  global batch, as the JAX step does, unless `local_batch=True`);
- parameters follow their `partition_spec` (the tensor-parallel layers
  of `distributed.tensor_parallel` hold their 'mp' slice, the MoE
  experts their 'ep' block; ZeRO-3 marks a 'dp' axis), else replicated;
- gradients: ZeRO-0 and ZeRO-1 all-reduce them over `dp` in flattened
  buckets a type and average; ZeRO-2 and ZeRO-3 reduce-scatter each
  gradient over `dp` on its largest dp-divisible axis, as `zero_sharding`
  picks it;
- optimizer state (ZeRO-1 and up): each rank keeps and updates the block
  of its parameter on that axis, then the blocks are all-gathered into
  the parameter. A parameter with no divisible axis is updated whole on
  every rank. A rule that reads a whole-parameter norm (`Lamb`,
  `LarsMomentum`) sums a block's squares over the ranks holding the
  other blocks (`Optimizer._sum_sq`), so it reads the whole norm;
- ZeRO-3 also keeps only the rank's block of each such parameter between
  steps: the layer's tensor gives up its storage, the step all-gathers
  the blocks before the forward and frees them after the update. The
  layer's `state_dict()` gathers them into what it returns (a collective:
  every rank of the dp group calls it, as every rank calls a full state
  dict of torch's FSDP), and `step.write_back(state)` (which hapi's
  `Model` calls at each epoch's end) gathers them into the layer;
- gradient clipping (`clip_sharded`) reads the norms of the whole
  gradients: the clip's own formula (`nn.clip`) with each gradient's
  sum of squares summed over the mesh axes its block or slice is split
  on (ZeRO-2/3's dp, 'mp', 'ep'), so a replicated gradient counts once;
- `recompute` checkpoints the forward (`torch.utils.checkpoint`);
- `sp_axis` (sequence parallel): each rank also takes its block of the
  sequence axis (dim 1) of every input and of every label of two or more
  dims, as `batch_sharding` lays inputs out on 'sp'; the forward runs
  under `ring_attention.sequence_sharded`, so a layer that attends the
  whole sequence on its shard raises (the model must attend with ring or
  Ulysses attention, GPT's `use_ring=True`); losses and gradients are
  averaged over dp x sp. Where the JAX package computes the global
  function under GSPMD whatever the model does, the port computes it
  only for a model whose attention is sequence-parallel;
- `dgc` (deep gradient compression, `compression.dgc_compress`) on the
  dp-averaged gradient, its (u, v) state under `state["dgc"]`, as the
  JAX package applies it to the GSPMD-reduced gradient; from ZeRO-2 on,
  the state and the top-k run on a rank's blocks, the k-th largest |v|
  taken over every rank's block (the whole gradient's).

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
           "local_rows", "local_seq", "batch_placement", "clip_sharded"]

def tp_mesh(tp, axis="tp", devices=None):
    """A 1-D mesh of `tp` ranks for a tensor-parallel serving lane, as the
    JAX package's `tp_mesh` lays one over `tp` devices: `devices` names
    the lane's ranks (the first `tp` of them are taken), by default the
    first `tp` ranks of the world; raises where fewer are named.

    The mesh's group is made with only its members
    (`Mesh(local=True)`: `new_group(..., use_local_synchronization=True)`),
    so building a lane never needs a rank outside it: a lane over ranks
    [2, 3] of a world of 4 comes up while ranks 0 and 1 serve a lane of
    their own, and a rank outside the lane that calls this gets a mesh it
    is not in (`mesh.coords is None`) and makes no group."""
    from ..distributed.env import get_world_size
    world = get_world_size()
    ranks = list(range(world)) if devices is None else \
        [int(r) for r in devices]
    if len(ranks) < tp:
        raise RuntimeError(
            f"tp={tp} needs {tp} ranks, {len(ranks)} are named (the world "
            f"has {world}): call distributed.init_parallel_env() in each "
            f"rank started by python -m paddle_tpu_torch.distributed.launch "
            f"--nproc_per_node {tp}")
    if any(not 0 <= r < world for r in ranks[:tp]) \
            or len(set(ranks[:tp])) != tp:
        raise RuntimeError(
            f"tp_mesh devices {ranks[:tp]} are not {tp} distinct ranks of "
            f"a world of {world}")
    return Mesh({axis: tp}, ranks[:tp], local=True)


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


def batch_placement(mesh=None, dp_axis="dp", sp_axis=None, seq_dim=1):
    """Per-leaf placement of a training batch on `mesh` (the JAX package's
    `batch_placement`): leaf -> its spec (dim 0 over `dp_axis`, dim
    `seq_dim` over `sp_axis`), a dim that does not divide its axis left
    whole, None for a leaf with no split dim. A rank takes its blocks by
    the spec (`local_rows`, `local_seq`)."""
    mesh = mesh or get_mesh()

    def place(x):
        spec = list(batch_sharding(np.ndim(x), mesh, dp_axis, sp_axis,
                                   seq_dim))
        shape = np.shape(x)
        spec = [a if a is not None and shape[d] % mesh.axis_size(a) == 0
                else None for d, a in enumerate(spec)]
        return P(*spec) if any(a is not None for a in spec) else None

    return place


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


class _ShardSlice(torch.autograd.Function):
    """A whole tensor (the same on the group's n ranks) -> this rank's
    block r of n along `dim`; the backward gathers the ranks' block
    gradients into the whole (`shard_map`'s transpose of an input split
    over an axis)."""

    @staticmethod
    def forward(ctx, x, dim, r, n, group):
        ctx.args = (dim, n, group)
        size = x.shape[dim] // n
        return x.narrow(dim, r * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, n, group = ctx.args
        return _gather_dim(g, dim, group, n), None, None, None, None


class _ShardGather(torch.autograd.Function):
    """The group's n blocks -> the whole along `dim` on every rank; the
    backward (a cotangent the same on every rank) takes this rank's
    block."""

    @staticmethod
    def forward(ctx, x, dim, r, n, group):
        ctx.args = (dim, r, n)
        return _gather_dim(x, dim, group, n) if n > 1 else x

    @staticmethod
    def backward(ctx, g):
        dim, r, n = ctx.args
        size = g.shape[dim] // n
        return g.narrow(dim, r * size, size).contiguous(), None, None, \
            None, None


def _mean_over(tensors, group, n):
    """All-reduce mean of a {name: tensor} dict over `group`, in place,
    one flat bucket a type (nothing without a group)."""
    if group is None or n == 1:
        return
    for ns in _by_type(tensors).values():
        ts = [tensors[k] for k in ns]
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


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
    `params` are the layer's own (local) parameters, updated in place,
    except at ZeRO-3, where a parameter with a ZeRO axis is this rank's
    block of it (the layer's tensor holds no storage between steps; the
    layer's `state_dict()` returns it gathered, and `write_back` /
    `step.write_back(state)` gather it into the layer). `opt_state[name]` holds the
    rank's ZeRO block of each state leaf. `rng` (an int) seeds the step's
    dropout draws as `framework.random.seed` would; the draws of a dp
    rank differ from the other ranks' (the attention kernels fold the
    rank in). `zero_stage` defaults to the optimizer's (set by
    `distributed.sharding.group_sharded_parallel`), else 1."""
    mesh = mesh or get_mesh()
    if zero_stage is None:
        zero_stage = int(getattr(optimizer, "_zero_stage", 1))
    if grad_dtype is not None:
        from ..framework.dtype import to_torch_dtype
        grad_dtype = to_torch_dtype(grad_dtype)
    dp = mesh.axis_size(dp_axis) if mesh is not None else 1
    group = mesh.group(dp_axis) if mesh is not None else None
    r = mesh.axis_rank(dp_axis) if mesh is not None else 0
    sp = mesh.axis_size(sp_axis) if mesh is not None and sp_axis else 1
    sp_group = mesh.group(sp_axis) if sp > 1 else None
    names = [n for n, p in layer.named_parameters() if p.requires_grad]
    params = OrderedDict((n, p) for n, p in layer.named_parameters()
                         if p.requires_grad)
    # a ZeRO-3 'dp' mark (`group_sharded_parallel`) names the axis the
    # update is split on
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

    # the mesh axes a parameter's tensor is split over ('mp', 'ep'), and
    # those of its block in the update and of its gradient (+ 'dp' where
    # a rank holds a ZeRO block: the update from ZeRO-1, the gradient
    # from ZeRO-2 on)
    split = {n: {ax for ax in specs[n] if ax is not None} for n in params}
    usplit = {n: split[n] | ({dp_axis} if zaxis[n] is not None else set())
              for n in params}
    gsplit = {n: usplit[n] if zero_stage >= 2 else split[n]
              for n in params}
    opt_state = {n: optimizer._init_state(block(p.detach(), n))
                 for n, p in params.items()}
    # ZeRO-3: a rank keeps only its block of each parameter with a ZeRO
    # axis between steps
    z3 = [n for n in params if zero_stage >= 3 and zaxis[n] is not None]
    owned = OrderedDict()
    for n in z3:
        owned[n] = block(params[n].detach(), n).clone()
        owned[n]._zero_gather = (zaxis[n], group, dp)
        params[n].data = params[n].data.new_empty(0)
    _hook_gathered_state_dict(layer, owned)
    state = {"params": OrderedDict((n, owned.get(n, p))
                                   for n, p in params.items()),
             "buffers": OrderedDict(layer.named_buffers()),
             "opt_state": opt_state, "step_no": 0}
    if dgc:
        from .compression import dgc_init
        state["dgc"] = dgc_init({
            n: (owned[n] if n in owned else
                block(p.detach(), n) if dp_axis in gsplit[n]
                else p.detach()) for n, p in params.items()})

    def reduce_grads(grads):
        """Mean gradients over sp and dp: (full or block gradient a
        name)."""
        _mean_over(grads, sp_group, sp)
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
        for dtype, ns in _by_type(grads, flat_names).items():
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
            run = lambda: checkpoint(layer, *inputs,  # noqa: E731
                                     use_reentrant=False)
        else:
            run = lambda: layer(*inputs)  # noqa: E731
        if sp > 1:
            from .ring_attention import sequence_sharded
            with sequence_sharded(layer):
                out = run()
        else:
            out = run()
        lv = loss_fn(out, list(labels))
        return lv.float().mean()

    def step(state, inputs, labels, lr=None, rng=None):
        device = next(iter(state["params"].values())).device
        if not local_batch:
            inputs = tuple(local_rows(x, mesh, dp_axis) for x in inputs)
            labels = tuple(local_rows(x, mesh, dp_axis) for x in labels)
            if sp > 1:
                inputs = tuple(local_seq(x, mesh, sp_axis) for x in inputs)
                labels = tuple(local_seq(x, mesh, sp_axis) for x in labels)
        inputs = tuple(_as_tensor(x, device) for x in inputs)
        labels = tuple(_as_tensor(x, device) for x in labels)
        lr = float(optimizer.get_lr() if lr is None else lr)
        layer.train()
        for n in z3:    # the whole parameters, for this step only
            params[n].data = _gather_dim(owned[n], zaxis[n], group, dp)
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
        if dgc:
            from . import compression
            grads, state["dgc"] = compression.dgc_compress(
                grads, state["dgc"], dgc_momentum, dgc_sparsity,
                groups={n: _split_groups(mesh, gsplit[n]) for n in grads})
        if optimizer._grad_clip is not None:
            grads = OrderedDict(zip(names, clip_sharded(
                optimizer._grad_clip, [grads[n] for n in names],
                [gsplit[n] for n in names], mesh)))
        step_no = state["step_no"] + 1
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                pb = owned[n] if n in owned else block(p.detach(), n)
                gb = g if dp_axis in gsplit[n] else block(g, n)
                groups = _split_groups(mesh, usplit[n])
                optimizer._block_sum = _summer(groups) if groups else None
                try:
                    new_pb, state["opt_state"][n] = optimizer._update(
                        gb, pb, state["opt_state"][n], lr, step_no)
                finally:
                    optimizer._block_sum = None
                if n in owned:
                    owned[n].copy_(new_pb)
                    p.data = p.data.new_empty(0)
                elif zaxis[n] is None:
                    p.copy_(new_pb)
                else:
                    p.copy_(_gather_dim(new_pb.to(p.dtype), zaxis[n],
                                        group, dp))
                p.grad = None
        state["step_no"] = step_no
        loss = lv.detach()
        for g, n in ((sp_group, sp), (group, dp)):
            if g is not None:
                dist.all_reduce(loss, group=g)
                loss = loss / n
        return state, loss

    def leaf_spec(n, v):
        if not torch.is_tensor(v) or v.ndim == 0:
            return P()
        base = tuple(specs[n]) + (None,) * (v.ndim - len(specs[n]))
        return P(*[dp_axis if d == zaxis[n] else ax
                   for d, ax in enumerate(base)])

    step.state_sharding = {
        "params": {n: leaf_spec(n, owned[n]) if n in owned else specs[n]
                   for n in params},
        "buffers": {n: P() for n in state["buffers"]},
        "opt_state": {n: {k: leaf_spec(n, v) for k, v in st.items()}
                      for n, st in opt_state.items()},
        "step_no": P()}
    if dgc:
        step.state_sharding["dgc"] = {
            n: {k: (leaf_spec(n, v) if dp_axis in gsplit[n]
                    else specs[n]) for k, v in st.items()}
            for n, st in state["dgc"].items()}
    step.zero_axes = zaxis
    step.write_back = lambda st: write_back(layer, st)
    return step, state


def _hook_gathered_state_dict(layer, owned):
    """Make `layer.state_dict()` return each ZeRO-3 parameter of `owned`
    (name -> this rank's block, tagged `_zero_gather`) whole while the
    layer's tensor is empty; the hook of an earlier step on the layer is
    replaced."""
    old = getattr(layer, "_zero3_state_dict_hook", None)
    if old is not None:
        old.remove()
        layer._zero3_state_dict_hook = None
    if not owned:
        return
    own = dict(layer.named_parameters())

    def hook(module, sd, prefix, local_metadata):
        for n, blk in owned.items():
            if own[n].numel() == 0:
                ax, group, dp = blk._zero_gather
                sd[prefix + n] = _gather_dim(blk, ax, group, dp)
    layer._zero3_state_dict_hook = layer.register_state_dict_post_hook(hook)


def _split_groups(mesh, axes):
    """[(group, size)] of the mesh axes in `axes` that have size > 1, in
    the mesh's order."""
    if mesh is None:
        return []
    return [(mesh.group(ax), mesh.axis_size(ax)) for ax in mesh.axis_names
            if ax in axes and mesh.axis_size(ax) > 1]


def _summer(groups):
    """x -> its sum over every group of `groups` (a block's partial sum
    summed into the whole parameter's)."""
    def f(x):
        x = x.clone()
        for g, _ in groups:
            dist.all_reduce(x, group=g)
        return x
    return f


def clip_sharded(clip, grads, splits, mesh=None):
    """`clip._clip_grads(grads)` where gradient i may be a block or slice
    of the whole one, split over the mesh axes in `splits[i]`: each
    gradient's sum of squares is summed over those axes, so every norm
    the clip reads is the whole gradients' (a replicated gradient counts
    once). The sums of the gradients split alike go in one all-reduce;
    the ranks of a group hold their gradients in one order."""
    mesh = mesh or get_mesh()

    def whole_sq(sq):
        by = OrderedDict()
        for i, sp in enumerate(splits):
            groups = _split_groups(mesh, sp)
            if groups:
                by.setdefault(tuple(ax for ax in mesh.axis_names
                                    if ax in sp), (groups, []))[1].append(i)
        out = list(sq)
        for groups, idx in by.values():
            v = _summer(groups)(torch.stack([sq[i].float() for i in idx]))
            for j, i in enumerate(idx):
                out[i] = v[j].to(sq[i].dtype)
        return out
    return clip._clip_grads(grads, whole_sq)


def _by_type(grads, names=None):
    """{dtype: [names]} of `grads` (all of them, or `names`), in order."""
    out: Dict[torch.dtype, list] = {}
    for n in (grads if names is None else names):
        out.setdefault(grads[n].dtype, []).append(n)
    return out


def local_seq(x, mesh=None, sp_axis="sp", seq_dim=1):
    """This rank's sp block of the sequence axis of a batch leaf with more
    than `seq_dim` dims (others as they are)."""
    mesh = mesh or get_mesh()
    n = mesh.axis_size(sp_axis) if mesh is not None else 1
    if n == 1 or x is None or np.ndim(x) <= seq_dim:
        return x
    S = x.shape[seq_dim]
    if S % n:
        raise InvalidArgumentError(
            f"sequence of {S} does not split over {sp_axis}={n}")
    r = mesh.axis_rank(sp_axis)
    idx = [slice(None)] * np.ndim(x)
    idx[seq_dim] = slice(r * S // n, (r + 1) * S // n)
    return x[tuple(idx)]


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
    the layer's own tensors, so this copies only foreign values, and
    gathers ZeRO-3 blocks: every rank calls it then)."""
    with torch.no_grad():
        own = dict(layer.named_parameters())
        for n, v in state["params"].items():
            gather = getattr(v, "_zero_gather", None)
            if gather is not None:
                # a ZeRO-3 block: the whole parameter, gathered (every
                # rank of the dp group calls this)
                ax, group, dp = gather
                own[n].data = (_gather_dim(v, ax, group, dp) if dp > 1
                               else v.clone())
            elif own[n] is not v:
                own[n].copy_(v)
        bufs = dict(layer.named_buffers())
        for n, v in state["buffers"].items():
            if bufs[n] is not v:
                bufs[n].copy_(v)
