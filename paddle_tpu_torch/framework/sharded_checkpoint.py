"""Sharded checkpoints (port of `paddle_tpu.framework.sharded_checkpoint`).

The JAX package writes an orbax tree of its sharded arrays. The port has
its own format, with no orbax: a directory holding one file a rank,
`rank{r}.pdparams` (the port's `io_state` format: pickled numpy), with
the blocks that rank owns, and `index.json`, which gives every leaf's
key (its path in the state, '/'-joined), full shape, type, and the
blocks: which rank's file holds it, its offset and shape. Non-tensor
leaves (the step count) sit in the index.

`save_sharded(state, path, shardings=None)`: `shardings` is a pytree of
partition specs beside `state` (`step.state_sharding` of
`parallel.spmd.make_sharded_train_step`; a leaf without one is
replicated). A replicated block is written once, by the first rank that
holds it. Every rank of the world calls it.

`load_sharded(path, target=None, shardings=None)` reassembles each leaf
from the blocks and returns, under `shardings` on the current mesh, the
rank's block of it (the full leaf without `shardings`); `target` gives
the device and type of each leaf. A checkpoint saved at one world size
loads at another: the blocks are cut anew.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from . import io_state

__all__ = ["save_sharded", "load_sharded", "AsyncCheckpointer"]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat):
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _block(shape, spec, mesh):
    """(offsets, sizes, owner) of this rank's block of a leaf of full
    `shape` under `spec`; `owner` is False where a replica of the block
    is owned by a rank with a lower coordinate on an axis the spec does
    not use."""
    offs, sizes = [0] * len(shape), list(shape)
    used = set()
    for d, ax in enumerate(tuple(spec or ())[:len(shape)]):
        if ax is None or mesh is None or mesh.axis_size(ax) <= 1:
            continue
        used.add(ax)
        n = mesh.axis_size(ax)
        sizes[d] = shape[d] // n
        offs[d] = mesh.axis_rank(ax) * sizes[d]
    owner = mesh is None or all(mesh.axis_rank(ax) == 0
                                for ax in mesh.axis_names
                                if ax not in used)
    return offs, sizes, owner


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _full_shape(local, spec, mesh):
    shape = list(local.shape)
    for d, ax in enumerate(tuple(spec or ())[:len(shape)]):
        if ax is not None and mesh is not None and mesh.axis_size(ax) > 1:
            shape[d] *= mesh.axis_size(ax)
    return shape


def _prepare(state, shardings):
    """This rank's (blocks to write, index entries)."""
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    rank, _ = _world()
    flat = _flatten(state)
    specs = _flatten(shardings) if shardings is not None else {}
    blocks, entries = {}, {}
    for key, v in flat.items():
        if not torch.is_tensor(v):
            entries[key] = {"value": v if not isinstance(v, np.generic)
                            else v.item()}
            continue
        spec = specs.get(key)
        full = _full_shape(v, spec, mesh)
        offs, sizes, owner = _block(full, spec, mesh)
        entries[key] = {"shape": full,
                        "dtype": str(v.dtype).replace("torch.", ""),
                        "blocks": []}
        if owner:
            blocks[key] = v.detach().to("cpu", copy=True)
            entries[key]["blocks"].append(
                {"rank": rank, "offsets": offs, "sizes": sizes})
    return blocks, entries


def _merge_index(entries):
    import torch.distributed as dist
    rank, world = _world()
    if world == 1:
        return entries
    gathered = [None] * world
    dist.all_gather_object(gathered, entries)
    merged = {}
    for part in gathered:
        for key, e in part.items():
            if key not in merged:
                merged[key] = {k: v for k, v in e.items() if k != "blocks"}
                if "blocks" in e:
                    merged[key]["blocks"] = []
            if "blocks" in e:
                merged[key]["blocks"].extend(e["blocks"])
    return merged


def _write(path, blocks, index):
    rank, _ = _world()
    io_state.save({k: v.numpy() if v.dtype != torch.bfloat16
                   else v.float().numpy() for k, v in blocks.items()},
                  os.path.join(path, f"rank{rank}.pdparams"))
    if rank == 0:
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump(index, f)


def _barrier():
    import torch.distributed as dist
    if _world()[1] > 1:
        dist.barrier()


def save_sharded(state: Any, path: str, overwrite: bool = True,
                 shardings: Optional[Any] = None) -> str:
    """Write `state` (see the module docstring); returns the path."""
    path = os.path.abspath(path)
    rank, _ = _world()
    if rank == 0:
        if overwrite and os.path.exists(path):
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)
    _barrier()
    blocks, entries = _prepare(state, shardings)
    _write(path, blocks, _merge_index(entries))
    _barrier()
    return path


def load_sharded(path: str, target: Optional[Any] = None,
                 shardings: Optional[Any] = None) -> Any:
    """Read a checkpoint of `save_sharded` (see the module docstring)."""
    from ..parallel.mesh import get_mesh
    path = os.path.abspath(path)
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    mesh = get_mesh()
    files: dict = {}
    specs = _flatten(shardings) if shardings is not None else {}
    like = _flatten(target) if target is not None else {}
    flat = {}
    for key, e in index.items():
        if "value" in e:
            flat[key] = e["value"]
            continue
        full = np.zeros(e["shape"], np.float32 if e["dtype"] == "bfloat16"
                        else np.dtype(e["dtype"]))
        for b in e["blocks"]:
            r = b["rank"]
            if r not in files:
                files[r] = io_state.load(os.path.join(path,
                                                      f"rank{r}.pdparams"))
            sl = tuple(slice(o, o + s) for o, s in zip(b["offsets"],
                                                       b["sizes"]))
            full[sl] = files[r][key]
        t = torch.from_numpy(full)
        if e["dtype"] == "bfloat16":
            t = t.to(torch.bfloat16)
        spec = specs.get(key)
        if spec is not None:
            offs, sizes, _ = _block(list(t.shape), spec, mesh)
            for d, (o, s) in enumerate(zip(offs, sizes)):
                t = t.narrow(d, o, s)
            t = t.contiguous()
        ref = like.get(key)
        if torch.is_tensor(ref):
            t = t.to(device=ref.device, dtype=ref.dtype)
        flat[key] = t
    return _unflatten(flat)


class AsyncCheckpointer:
    """`save_sharded` whose file writes run on a background thread: the
    blocks are copied to the host and the index agreed on the caller's
    thread (the collectives), so the caller may go on training while
    the files are written. `wait()` joins the last save."""

    def __init__(self):
        self._thread = None

    def save(self, path, state, shardings=None):
        self.wait()
        path = os.path.abspath(path)
        rank, _ = _world()
        if rank == 0:
            if os.path.exists(path):
                shutil.rmtree(path, ignore_errors=True)
            os.makedirs(path, exist_ok=True)
        _barrier()
        blocks, entries = _prepare(state, shardings)
        index = _merge_index(entries)
        self._thread = threading.Thread(target=_write,
                                        args=(path, blocks, index),
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

    def close(self):
        self.wait()
