"""Collective communication API (port of
`paddle_tpu.distributed.collective`; reference
`python/paddle/distributed/collective.py:101-457`).

The JAX package lowers each call to an XLA collective over the mesh axis
of the enclosing `shard_ctx` (inside `shard_map`). The port runs one
process a rank, so each call is the `torch.distributed` collective over
a process group: an explicit `group`, else the subgroup of the innermost
`shard_ctx` axis of the current mesh, else the whole world. Without a
process group, or over a mesh axis of size 1, every call is the
identity, as the JAX package's eager calls are at world size 1; a
1-rank world runs the real collectives, which return their input.

Results are the JAX calls' inside `shard_map`:
- `all_reduce` reduces in place; `reduce` is `all_reduce` (every member
  gets the result, as `paddle_tpu`'s does);
- `all_gather` returns the members' tensors stacked on a new leading
  axis and appends each to `tensor_list`;
- `broadcast`, `scatter`'s `src` and `send`'s `dst` / `recv`'s `src` are
  indices into the group (its axis coordinate), which are global ranks
  for the world group;
- `scatter` gives member i `tensor_list[i]` of `src`;
- `reduce_scatter` concatenates a list on axis 0 and gives member i the
  i-th block of the reduced whole;
- `alltoall` stacks the list and returns [n, ...] whose row j is member
  j's row i, appending each row to `out_tensor_list`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from .env import get_rank, get_world_size, is_initialized

__all__ = ["ReduceOp", "Group", "all_reduce", "all_gather", "broadcast",
           "reduce", "scatter", "barrier", "split", "send", "recv",
           "alltoall", "reduce_scatter", "new_group", "wait", "shard_ctx",
           "current_axis", "get_group", "process_group"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_TORCH_OP = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
             ReduceOp.PROD: "PRODUCT"}


def _op(op):
    return getattr(dist.ReduceOp, _TORCH_OP[op])


class Group:
    """A communicator: its members' global `ranks`, this process' `rank`
    in it (-1 outside), the mesh `axis` it stands for, and the
    `torch.distributed` group (`process_group`)."""

    def __init__(self, rank, nranks, id=0, axis=None, ranks=None,
                 process_group=None):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.axis = axis
        self.ranks = list(ranks) if ranks else list(range(nranks))
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, axis={self.axis})"


_groups = {}


def new_group(ranks=None, backend=None, axis=None):
    """A group over `ranks` (all of the world by default). Every rank
    must call it, in the same order, as `torch.distributed.new_group`
    requires."""
    gid = len(_groups) + 1
    ranks = list(ranks) if ranks else list(range(get_world_size()))
    pg = None
    if is_initialized() and get_world_size() > 1:
        pg = dist.new_group(ranks, backend=backend)
    me = get_rank()
    g = Group(ranks.index(me) if me in ranks else -1, len(ranks), gid,
              axis=axis, ranks=ranks, process_group=pg)
    _groups[gid] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return Group(get_rank(), get_world_size(), 0,
                     process_group=dist.group.WORLD if is_initialized()
                     else None)
    return _groups.get(gid)


class _Ctx(threading.local):
    def __init__(self):
        self.axes: List[str] = []


_ctx = _Ctx()


@contextlib.contextmanager
def shard_ctx(*axes: str):
    """Marks a region whose collective calls bind to the innermost mesh
    axis (or an explicit group's)."""
    _ctx.axes.extend(axes)
    try:
        yield
    finally:
        for _ in axes:
            _ctx.axes.pop()


def current_axis(group=None) -> Optional[str]:
    if group is not None and getattr(group, "axis", None):
        return group.axis
    return _ctx.axes[-1] if _ctx.axes else None


def process_group(group=None):
    """(torch group, member global ranks) a call runs over, or (None,
    [rank]) where it is the identity."""
    if not is_initialized():
        return None, [get_rank()]
    if isinstance(group, Group) and group.process_group is not None:
        return group.process_group, group.ranks
    axis = current_axis(group)
    if axis is not None:
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
        if mesh is None or mesh.group(axis) is None:
            return None, [get_rank()]
        return mesh.group(axis), mesh.group_ranks(axis)
    if group is not None and not isinstance(group, Group):
        return group, dist.get_process_group_ranks(group)
    return dist.group.WORLD, list(range(get_world_size()))


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=True):
    pg, _ = process_group(group)
    if pg is not None:
        dist.all_reduce(tensor, op=_op(op), group=pg)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is None:
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor) for _ in ranks]
        dist.all_gather(parts, tensor.contiguous(), group=pg)
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
    return torch.stack(parts)


def broadcast(tensor, src=0, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is not None:
        dist.broadcast(tensor, src=ranks[src], group=pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[src])
        return tensor
    me = ranks.index(get_rank())
    parts = ([t.contiguous() for t in tensor_list] if me == src else None)
    dist.scatter(tensor, parts, src=ranks[src], group=pg)
    return tensor


def reduce_scatter(tensor, input_list_or_tensor, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    src = input_list_or_tensor
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), 0)
    pg, ranks = process_group(group)
    if pg is None:
        tensor.copy_(src.reshape(tensor.shape))
        return tensor
    parts = list(src.contiguous().chunk(len(ranks), 0))
    dist.reduce_scatter(tensor, parts, op=_op(op), group=pg)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    x = (torch.stack(list(in_tensor_list))
         if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list)
    pg, _ = process_group(group)
    if pg is None:
        out = x
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=pg)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(out.unbind(0))
    return out


def send(tensor, dst=0, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is not None:
        dist.send(tensor.contiguous(), dst=ranks[dst], group=pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is not None:
        dist.recv(tensor, src=ranks[src], group=pg)
    return tensor


def barrier(group=None):
    pg, _ = process_group(group)
    if pg is not None:
        dist.barrier(group=pg)


def wait(tensor, group=None, use_calc_stream=True):
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


# ---------------------------------------------------------------------------
# tensor-parallel `split` (reference `distributed/collective.py:566`)
# ---------------------------------------------------------------------------

def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Build a tensor-parallel layer (vocab-parallel embedding, row or
    column-parallel linear) over the 'mp' axis and apply it to `x`."""
    from .tensor_parallel import (ColumnParallelLinear, RowParallelLinear,
                                  VocabParallelEmbedding)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr)
    elif operation == "linear" and axis == 0:
        layer = RowParallelLinear(size[0], size[1], weight_attr=weight_attr,
                                  bias_attr=bias_attr)
    elif operation == "linear":
        layer = ColumnParallelLinear(size[0], size[1],
                                     weight_attr=weight_attr,
                                     bias_attr=bias_attr,
                                     gather_output=gather_out)
    else:
        raise ValueError(f"unsupported split operation {operation}")
    return layer.to(x.device)(x)
