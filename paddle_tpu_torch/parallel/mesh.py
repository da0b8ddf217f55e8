"""Device mesh over the ranks of a `torch.distributed` world (port of
`paddle_tpu.parallel.mesh`).

The JAX package lays ONE `jax.sharding.Mesh` over the devices of one
process and names its axes (dp/mp/pp/sp/ep/tp); a collective is an XLA
op over an axis. The port runs one process a card, so a mesh here lays
the world's ranks out row-major in the axes' order and gives each axis
one `torch.distributed` subgroup a slice (the ranks that differ only in
that axis' coordinate). Every rank builds every subgroup, once, in the
same order, as `new_group` requires; a rank keeps the groups of its own
slices. A 1-rank world (or no process group at all) gives the trivial
mesh: every axis of size 1 and no group, so the collectives are the
identity.

Two ways to make the groups, because `new_group` is collective over the
whole default group unless told otherwise:
- `create_mesh` (the default, `local=False`) makes every group of every
  slice on EVERY rank of the world, in one order. A mesh over the whole
  world is built by every rank anyway, so this costs nothing, and it is
  what each torch release supports.
- `Mesh(..., local=True)` (what `spmd.tp_mesh` builds a serving lane
  on) makes each group with `use_local_synchronization=True`: only the
  members of a slice call `new_group` for it, and a rank outside the
  mesh makes nothing. A lane over ranks [2, 3] of a world of 4 is then
  built by ranks 2 and 3 alone, while ranks 0 and 1 are inside
  collectives of their own; the world-collective form would deadlock
  there, or pair the two lanes' groups under one name. Members name a
  local group from its ranks and their count of groups, so the members
  of one slice must have built the same number of groups before, as
  ranks that run one program in step have (`local_group`).
"""
from __future__ import annotations

import contextlib
import datetime
import math
import threading
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "create_mesh", "get_mesh", "set_mesh", "mesh_scope",
           "axis_size", "axis_rank", "named_sharding", "local_group",
           "replicated", "DEFAULT_AXES", "P"]

DEFAULT_AXES = ("dp", "mp", "pp", "sp", "ep")


class P(tuple):
    """A partition spec: one mesh-axis name (or None) a tensor dim, as
    `jax.sharding.PartitionSpec`."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_group(ranks, backend=None, timeout_s: Optional[float] = None):
    """A process group over `ranks` that only its members create
    (`use_local_synchronization=True`): the caller must be one of them.
    `timeout_s` bounds each of its collectives (gloo raises past it)."""
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    return dist.new_group(list(ranks), backend=backend,
                          use_local_synchronization=True, **kw)


class Mesh:
    """Named axes over ranks. `shape[axis]` is the axis' size,
    `devices` the rank grid, `axis_rank(axis)` this rank's coordinate and
    `group(axis)` the subgroup of this rank's slice (None where the axis
    has size 1 or no process group is live). `local=True` makes only the
    groups of this rank's own slices, with only their members (see the
    module docstring); a rank outside the mesh makes none."""

    def __init__(self, axes: Dict[str, int], ranks=None, local=False):
        rank, world = _world()
        self.axis_names = tuple(axes)
        self.shape = {k: int(v) for k, v in axes.items()}
        need = math.prod(self.shape.values())
        ranks = list(range(world) if ranks is None else ranks)
        if need > len(ranks):
            raise RuntimeError(
                f"mesh {self.shape} needs {need} ranks, the world has "
                f"{len(ranks)} (launch one process a card: python -m "
                f"paddle_tpu_torch.distributed.launch --nproc_per_node N)")
        self.devices = np.asarray(ranks[:need]).reshape(
            tuple(self.shape.values()))
        self.rank = rank
        where = np.argwhere(self.devices == rank)
        self.coords = (tuple(int(c) for c in where[0]) if len(where)
                       else None)
        self._groups: Dict[str, object] = {}
        if world > 1:
            for ax_i, ax in enumerate(self.axis_names):
                if self.shape[ax] == 1:
                    continue
                if local:
                    if self.coords is not None:
                        members = self.group_ranks(ax)
                        self._groups[ax] = (local_group(members), members)
                    continue
                # every slice of this axis, in one order on every rank
                moved = np.moveaxis(self.devices, ax_i, -1)
                for members in moved.reshape(-1, self.shape[ax]):
                    members = [int(r) for r in members]
                    g = dist.new_group(members)
                    if rank in members:
                        self._groups[ax] = (g, members)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        if axis not in self.shape or self.coords is None:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        entry = self._groups.get(axis)
        return entry[0] if entry else None

    def group_ranks(self, axis: str):
        """The global ranks of this rank's slice along `axis`, in axis
        order (read off the rank grid: no group needed)."""
        if axis not in self.shape or self.coords is None:
            return [self.rank]
        at = list(self.coords)
        at[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in np.atleast_1d(self.devices[tuple(at)])]

    def __repr__(self):
        return f"Mesh({self.shape})"


class _State(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None


_state = _State()
_global_mesh: Optional[Mesh] = None


def create_mesh(axes: Dict[str, int] = None, ranks=None) -> Mesh:
    """create_mesh({'dp': 2, 'tp': 2}) over the world's ranks; -1 (or
    None) means the rest of the ranks. Sets it as the current mesh."""
    global _global_mesh
    _, world = _world()
    n = len(ranks) if ranks is not None else world
    axes = dict(axes or {"dp": n})
    known = math.prod(v for v in axes.values() if v not in (-1, None))
    rest = [k for k, v in axes.items() if v in (-1, None)]
    if rest:
        assert len(rest) == 1, "only one -1 axis allowed"
        axes[rest[0]] = n // known
    mesh = Mesh(axes, ranks)
    _state.mesh = mesh
    _global_mesh = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    # a mesh made on one thread is the process' mesh: the engine's step
    # thread and a DataLoader's threads see the launcher thread's mesh
    return _state.mesh if _state.mesh is not None else _global_mesh


def set_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _state.mesh = mesh
    _global_mesh = mesh


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    prev = _state.mesh
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_size(axis: str) -> int:
    mesh = get_mesh()
    return 1 if mesh is None else mesh.axis_size(axis)


def axis_rank(axis: str) -> int:
    mesh = get_mesh()
    return 0 if mesh is None else mesh.axis_rank(axis)


def named_sharding(*spec) -> Optional[P]:
    """The spec itself on a live mesh (the port places no tensor: a rank
    holds its slice), None without one."""
    return None if get_mesh() is None else P(*spec)


def replicated() -> Optional[P]:
    return named_sharding()
