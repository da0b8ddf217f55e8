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

`mark_megatron` / `shard_megatron` do the same to the port's own layers
(`nn.Linear` [out, in], `nn.Embedding`, `nn.MultiHeadAttention`) in
place, for `models.ernie.tp_annotate`: a marked module keeps its class's
names and becomes, on a mesh whose 'mp' axis is > 1, the rank's slice of
itself (column-parallel: rows of the weight and the bias, the input
entering by `_CopyToParallel`; row-parallel: columns of the weight, the
partial products reduced by `_ReduceFromParallel` and the replicated
bias added after; vocab-parallel: rows of the table), each parameter
keeping its object (an optimizer built before still holds it) and
carrying its `partition_spec` in the port's layout.
"""
from __future__ import annotations

import torch

from ..framework.errors import InvalidArgumentError
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Embedding as _Embedding
from ..nn.layer.common import Linear as _Linear
from ..nn.layer.common import _linear_out_in
from ..nn.layer.layers import Layer
from ..parallel.mesh import P, get_mesh

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "mark_sharding", "constraint",
           "shard_tensor", "mark_megatron", "shard_megatron"]


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
        return _vocab_lookup(x, self.weight, group, r)


def _vocab_lookup(x, weight, group, r, padding_idx=None):
    """The rows of ids `x` in a table split on its vocabulary, of which
    `weight` is block r: ids outside the block (and `padding_idx`) look up
    zeros, and the rows are all-reduced over the group."""
    rows = weight.shape[0]
    lo = r * rows
    inside = (x >= lo) & (x < lo + rows)
    if padding_idx is not None:
        inside = inside & (x != padding_idx)
    local = torch.where(inside, x - lo, torch.zeros_like(x))
    out = F.embedding(local, weight)
    out = out * inside.unsqueeze(-1).to(out.dtype)
    return _ReduceFromParallel.apply(out, group)


# -- the port's own layers, split in place (`models.ernie.tp_annotate`) -------

_SPECS = {"column": {"weight": ("mp", None), "bias": ("mp",)},
          "row": {"weight": (None, "mp")},
          "vocab": {"weight": ("mp", None)}}


def mark_megatron(module, role):
    """Mark a port `Linear` ("column" or "row") or `Embedding` ("vocab")
    for `shard_megatron`, its parameters with their specs."""
    module._mp_role = role
    for name, spec in _SPECS[role].items():
        p = getattr(module, name, None)
        if p is not None:
            mark_sharding(p, *spec)
    return module


def shard_megatron(layer, axis="mp"):
    """Cut every module of `layer` marked by `mark_megatron` to this
    rank's slice on the current mesh's `axis`, and let each
    `MultiHeadAttention` whose q/k/v are marked column-parallel and whose
    out_proj is marked row-parallel attend over its rank's heads (an
    unmarked one stays whole, replicated); nothing where the axis is
    absent or of size 1, or where a module was cut already. Raises
    `InvalidArgumentError`, before cutting anything, where a marked dim
    or an attention's heads do not split over the axis, where an
    attention is marked in part, or where a Transformer layer's
    activation dropout would run on a column slice of its `linear1` (each
    rank would draw the same mask for its slice, which tp 1 never does).
    Returns `layer`."""
    from ..nn.layer.transformer import (MultiHeadAttention,
                                        TransformerDecoderLayer,
                                        TransformerEncoderLayer)
    mesh = get_mesh()
    if mesh is None or mesh.axis_size(axis) <= 1:
        return layer
    n, r = mesh.axis_size(axis), mesh.axis_rank(axis)

    def refuse(msg):
        raise InvalidArgumentError(f"{msg} ({axis}={n})")
    cut, attn = [], []
    for name, mod in layer.named_modules():
        role = getattr(mod, "_mp_role", None)
        if role is not None and not getattr(mod, "_mp_split", False):
            for pname, spec in _SPECS[role].items():
                p = getattr(mod, pname, None)
                if p is not None and p.shape[spec.index("mp")] % n:
                    refuse(f"{name}.{pname} of shape {list(p.shape)} does "
                           f"not split on dim {spec.index('mp')}")
            cut.append(mod)
        if isinstance(mod, MultiHeadAttention) and mod.tp is None:
            roles = tuple(getattr(getattr(mod, k), "_mp_role", None)
                          for k in ("q_proj", "k_proj", "v_proj",
                                    "out_proj"))
            if roles == ("column",) * 3 + ("row",):
                if mod.num_heads % n:
                    refuse(f"{name}: {mod.num_heads} heads do not split")
                attn.append(mod)
            elif any(roles):
                refuse(f"{name}: q/k/v are column-parallel and out_proj "
                       f"row-parallel together or not at all, not {roles}")
        if (isinstance(mod, (TransformerEncoderLayer,
                             TransformerDecoderLayer))
                and getattr(mod.linear1, "_mp_role", None) == "column"
                and not getattr(mod.linear1, "_mp_split", False)
                and mod.dropout.p > 0):
            refuse(f"{name}: act_dropout {mod.dropout.p} would drop a "
                   f"column slice of linear1; tensor parallelism needs "
                   f"act_dropout=0")
    for mod in cut:
        role = mod._mp_role
        with torch.no_grad():
            for pname, spec in _SPECS[role].items():
                p = getattr(mod, pname, None)
                if p is not None:
                    p.data = shard_tensor(p.data, spec,
                                          mesh).contiguous().clone()
        mod.__class__ = {"column": _ColumnSlice, "row": _RowSlice,
                         "vocab": _VocabSlice}[role]
        if role == "column":
            mod.out_features //= n
        elif role == "row":
            mod.in_features //= n
        else:
            mod.num_embeddings //= n
        mod._mp_split = True
    for mod in attn:
        mod.tp = (axis, n, r)
    return layer


class _ColumnSlice(_Linear):
    """A port Linear holding rows [r*out/n, (r+1)*out/n) of its weight and
    bias: the input enters through `_CopyToParallel`, the output stays
    split on its last dim."""

    def forward(self, x):
        group, n, _ = _axis()
        if n > 1:
            x = _CopyToParallel.apply(x, group)
        return super().forward(x)


class _RowSlice(_Linear):
    """A port Linear holding columns [r*in/n, (r+1)*in/n) of its weight:
    the input is this rank's split, the partial products are all-reduced
    and the replicated bias added once after."""

    def forward(self, x):
        group, n, _ = _axis()
        if n == 1:
            return super().forward(x)
        out = _ReduceFromParallel.apply(
            _linear_out_in(x, self.weight, None, weight_layout="out_in"),
            group)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class _VocabSlice(_Embedding):
    """A port Embedding holding rows [r*V/n, (r+1)*V/n) of the table: ids
    outside them look up zeros and the rows are all-reduced."""

    def forward(self, x):
        group, n, r = _axis()
        if n == 1:
            return super().forward(x)
        return _vocab_lookup(x, self.weight, group, r, self.padding_idx)
