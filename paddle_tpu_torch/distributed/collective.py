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

Gloo hands a tensor's data pointer to its socket, so a CUDA tensor on a
gloo group (ranks that share one card) would give it device memory as
host memory: `send` and `recv` stage such a tensor through a host copy,
as do `ppermute` and `all_to_all`.

`ppermute` and `all_to_all` are the differentiable ring hop and
re-shard of `lax.ppermute` / `lax.all_to_all(tiled=True)`, the two
collectives the sequence-parallel attention and the pipeline schedules
ride on: `torch.autograd.Function`s whose backward is the inverse hop
(the permutation reversed) or the inverse re-shard. Every member of the
group must call them in the same order, forward and backward alike.
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
           "current_axis", "get_group", "process_group", "ppermute",
           "all_to_all"]


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
    if isinstance(group, str):
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
        if mesh is None or mesh.group(group) is None:
            return None, [get_rank()]
        return mesh.group(group), mesh.group_ranks(group)
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


def _staged(t, pg):
    """True where `t` lies on the card and `pg` is a gloo group: gloo
    reads and writes host memory only."""
    return t.is_cuda and dist.get_backend(pg) == "gloo"


def send(tensor, dst=0, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is not None:
        t = tensor.detach().contiguous()
        dist.send(t.cpu() if _staged(t, pg) else t, dst=ranks[dst],
                  group=pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    pg, ranks = process_group(group)
    if pg is not None:
        if _staged(tensor, pg) or not tensor.is_contiguous():
            buf = torch.empty(tensor.shape, dtype=tensor.dtype,
                              device="cpu" if _staged(tensor, pg)
                              else tensor.device)
            dist.recv(buf, src=ranks[src], group=pg)
            tensor.copy_(buf)
        else:
            dist.recv(tensor, src=ranks[src], group=pg)
    return tensor


# ---------------------------------------------------------------------------
# differentiable ring hop and re-shard (`lax.ppermute`, `lax.all_to_all`)
# ---------------------------------------------------------------------------

def _hop(x, perm, pg, ranks):
    """One hop of `perm` [(src, dst), ...] (group coordinates): this
    member's `x` goes to its dst, the result is what its src sent (zeros
    where no member sends to it, as in `lax.ppermute`). Sends and
    receives are posted together (`batch_isend_irecv`), so a ring does
    not deadlock."""
    me = ranks.index(get_rank())
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if pg is None or len(ranks) == 1:
        return x.clone() if dst == [me] else torch.zeros_like(x)
    stage = _staged(x, pg)
    send_t = x.detach().contiguous()
    if stage:
        send_t = send_t.cpu()
    recv_t = torch.empty_like(send_t) if src else None
    ops = []
    if dst and dst[0] != me:
        ops.append(dist.P2POp(dist.isend, send_t, ranks[dst[0]], pg))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, recv_t, ranks[src[0]], pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if not src:
        return torch.zeros_like(x)
    if src[0] == me:
        return x.detach().clone()
    return recv_t.to(x.device) if stage else recv_t


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, pg, ranks):
        ctx.perm, ctx.pg, ctx.ranks = perm, pg, ranks
        return _hop(x, perm, pg, ranks)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _hop(g.contiguous(), inv, ctx.pg, ctx.ranks), None, None, None


def ppermute(x, perm, group=None):
    """`lax.ppermute` over `group` (a `Group`, a torch group, a mesh axis
    name, or the current `shard_ctx` axis): `perm` lists (src, dst) pairs
    of group coordinates; member dst gets member src's `x`, a member no
    pair sends to gets zeros. Differentiable: the gradient takes the
    reverse hop. On a group of one member it is the identity (or zeros),
    with no communication."""
    pg, ranks = process_group(group)
    perm = [(int(s), int(d)) for s, d in perm]
    return _PPermute.apply(x, perm, pg, ranks)


def _a2a(x, split_axis, concat_axis, pg, ranks):
    n = len(ranks)
    if pg is None or n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n}")
    stage = _staged(x, pg)
    inp = torch.stack(x.detach().chunk(n, split_axis)).contiguous()
    if stage:
        inp = inp.cpu()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=pg)
    if stage:
        out = out.to(x.device)
    return torch.cat(out.unbind(0), concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, pg, ranks):
        ctx.args = (split_axis, concat_axis, pg, ranks)
        return _a2a(x, split_axis, concat_axis, pg, ranks)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, pg, ranks = ctx.args
        return (_a2a(g.contiguous(), concat_axis, split_axis, pg, ranks),
                None, None, None, None)


def all_to_all(x, split_axis, concat_axis, group=None):
    """`lax.all_to_all(..., tiled=True)` over `group` (as `ppermute`):
    `x` is cut into n blocks along `split_axis`, block j goes to member
    j, and the n blocks a member receives are concatenated along
    `concat_axis` in member order. Differentiable: the gradient takes
    the inverse re-shard. The identity on a group of one member."""
    pg, ranks = process_group(group)
    return _AllToAll.apply(x, int(split_axis), int(concat_axis), pg, ranks)


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
