"""Tensor-parallel layers (port of `paddle_tpu.distributed.tensor_parallel`;
reference `distributed/collective.py:566` split: the vocab-parallel
embedding and the row / column-parallel Linear).

The JAX package keeps full (logical) weights annotated with a partition
spec over the 'mp' axis and lets GSPMD partition the matmuls. The port
runs one process a rank, so each layer holds its rank's slice of the
weight (in the JAX package's [in, out] layout) and writes Megatron's
collectives as `torch.autograd.Function`s over the current mesh's 'mp'
subgroup:
- `_CopyToParallel`: identity forward, all-reduce of the gradient;
- `_ReduceFromParallel`: all-reduce forward, identity backward;
- `_GatherFromParallel`: all-gather of the last dim forward, the rank's
  slice of the gradient backward;
- `_ScatterToParallel`: the rank's slice forward, all-gather backward.
A layer initialises the full weight from the framework's generator and
keeps its slice, so every rank of a seeded run starts from one full
weight. Each parameter carries its `partition_spec` (one axis name or
None a dim of its local tensor) for `parallel.spmd` and the sharded
checkpoint. Without an 'mp' axis of size > 1 the layers are the plain
ones.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.layers import Layer
from ..parallel.mesh import P, get_mesh

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "mark_sharding", "constraint",
           "shard_tensor"]


def mark_sharding(param, *spec):
    """Attach a partition spec to a parameter (read by `parallel.spmd` and
    `framework.sharded_checkpoint`)."""
    param.partition_spec = P(*spec)
    return param


def constraint(x, *spec):
    """The JAX package's sharding constraint: a rank holds its slice
    already, so this is the identity."""
    return x


def _axis(axis="mp"):
    mesh = get_mesh()
    if mesh is None or mesh.axis_size(axis) <= 1:
        return None, 1, 0
    return mesh.group(axis), mesh.axis_size(axis), mesh.axis_rank(axis)


def shard_tensor(full, spec, mesh=None):
    """This rank's block of the full tensor `full` under `spec` (one axis
    name or None a dim)."""
    mesh = mesh or get_mesh()
    out = full
    for d, ax in enumerate(tuple(spec or ())):
        if ax is None or mesh is None or mesh.axis_size(ax) <= 1:
            continue
        n = mesh.axis_size(ax)
        size = out.shape[d] // n
        out = out.narrow(d, mesh.axis_rank(ax) * size, size)
    return out


def _all_reduce(x, group):
    import torch.distributed as dist
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather_last(x, group, n):
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, -1)


class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.n, ctx.r = n, r
        return _gather_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[-1] // ctx.n
        return g.narrow(-1, ctx.r * size, size).contiguous(), None, None, \
            None


class _ScatterToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.group, ctx.n = group, n
        size = x.shape[-1] // n
        return x.narrow(-1, r * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group, ctx.n), None, None, None


def _sliced_param(layer, full_shape, spec, attr, is_bias=False, init=None):
    """A parameter holding this rank's block under `spec` of a full
    parameter initialised as `create_parameter` would, marked with it."""
    full = layer.create_parameter(full_shape, attr=attr, is_bias=is_bias,
                                  default_initializer=init)
    p = torch.nn.Parameter(shard_tensor(full.detach(), spec).clone(),
                           requires_grad=full.requires_grad)
    return mark_sharding(p, *spec)


class ColumnParallelLinear(Layer):
    """weight [in, out] split on out over 'mp'; the output gathered on its
    last dim when `gather_output`, else left split."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, bias_attr=None, gather_output=True,
                 name=None):
        super().__init__()
        self.gather_output = gather_output
        self.weight = _sliced_param(self, [in_features, out_features],
                                    (None, "mp"), weight_attr,
                                    init=I.XavierUniform())
        if has_bias and bias_attr is not False:
            self.bias = _sliced_param(self, [out_features], ("mp",),
                                      bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        group, n, r = _axis()
        if n > 1:
            x = _CopyToParallel.apply(x, group)
        out = F.linear(x, self.weight, self.bias)
        if n > 1 and self.gather_output:
            out = _GatherFromParallel.apply(out, group, n, r)
        return out


class RowParallelLinear(Layer):
    """weight [in, out] split on in over 'mp'; the partial products are
    all-reduced and the (replicated) bias added once after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, bias_attr=None, input_is_parallel=False,
                 name=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self.weight = _sliced_param(self, [in_features, out_features],
                                    ("mp", None), weight_attr,
                                    init=I.XavierUniform())
        if has_bias and bias_attr is not False:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        group, n, r = _axis()
        if n == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _ScatterToParallel.apply(x, group, n, r)
        out = _ReduceFromParallel.apply(F.linear(x, self.weight), group)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(Layer):
    """weight [vocab, emb] split on vocab over 'mp': each rank looks up the
    ids in its block (zeros elsewhere) and the rows are all-reduced."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.weight = _sliced_param(self, [num_embeddings, embedding_dim],
                                    ("mp", None), weight_attr,
                                    init=I.XavierUniform())

    def forward(self, x):
        group, n, r = _axis()
        if n == 1:
            return F.embedding(x, self.weight)
        rows = self.weight.shape[0]
        lo = r * rows
        inside = (x >= lo) & (x < lo + rows)
        local = torch.where(inside, x - lo, torch.zeros_like(x))
        out = F.embedding(local, self.weight)
        out = out * inside.unsqueeze(-1).to(out.dtype)
        return _ReduceFromParallel.apply(out, group)
