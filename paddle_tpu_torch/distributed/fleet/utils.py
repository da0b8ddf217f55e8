"""Fleet utils (port of `paddle_tpu.distributed.fleet.utils`; reference
`fleet/base/util_factory.py` UtilBase, `fleet/utils/fs.py` HDFSClient /
LocalFS).

`UtilBase`'s collectives run over the world's `torch.distributed` group
(identity without one): `all_reduce` (sum / max / min), `all_gather`
(the ranks' values in rank order), `barrier`; the JAX package gathers
over its processes the same way (`process_allgather`).
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

__all__ = ["UtilBase", "LocalFS", "HDFSClient"]


def gather_values(value):
    """[world, ...] float64: every rank's `value` in rank order (the
    value alone, [1, ...], without a process group)."""
    import torch
    import torch.distributed as dist
    arr = np.asarray(value, dtype=np.float64)
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return arr[None]
    dev = "cpu"
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.as_tensor(arr, device=dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


class UtilBase:
    def all_reduce(self, input, mode="sum", comm_world="worker"):
        out = gather_values(input)
        if mode == "sum":
            return out.sum(0)
        if mode == "max":
            return out.max(0)
        return out.min(0)

    def barrier(self, comm_world="worker"):
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.barrier()

    def all_gather(self, input, comm_world="worker"):
        return list(gather_values(input))

    def get_file_shard(self, files):
        from ..env import get_rank, get_world_size
        n, r = get_world_size(), get_rank()
        return sorted(files)[r::n]

    def print_on_rank(self, message, rank_id=0):
        from ..env import get_rank
        if get_rank() == rank_id:
            print(message)


class LocalFS:
    """reference `fleet/utils/fs.py` LocalFS."""

    def ls_dir(self, path):
        if not os.path.exists(path):
            return [], []
        dirs, files = [], []
        for e in os.listdir(path):
            (dirs if os.path.isdir(os.path.join(path, e)) else files).append(e)
        return dirs, files

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst):
        os.rename(src, dst)

    def mv(self, src, dst, overwrite=False):
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        shutil.move(src, dst)

    def upload(self, local, remote):
        shutil.copy(local, remote)

    def download(self, remote, local):
        shutil.copy(remote, local)

    def touch(self, path, exist_ok=True):
        open(path, "a").close()

    def cat(self, path):
        with open(path) as f:
            return f.read()

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient:
    """Shell-out HDFS client (reference `fs.py` HDFSClient). Degrades to
    LocalFS when the hadoop binary is unavailable (this offline image)."""

    def __init__(self, hadoop_home=None, configs=None):
        self._hadoop = None
        if hadoop_home:
            cand = os.path.join(hadoop_home, "bin", "hadoop")
            if os.path.exists(cand):
                self._hadoop = cand
        self._local = LocalFS()

    def _run(self, *args):
        cmd = [self._hadoop, "fs"] + list(args)
        return subprocess.run(cmd, capture_output=True, text=True)

    def is_exist(self, path):
        if self._hadoop is None:
            return self._local.is_exist(path)
        return self._run("-test", "-e", path).returncode == 0

    def makedirs(self, path):
        if self._hadoop is None:
            return self._local.mkdirs(path)
        self._run("-mkdir", "-p", path)

    mkdirs = makedirs

    def delete(self, path):
        if self._hadoop is None:
            return self._local.delete(path)
        self._run("-rm", "-r", path)

    def upload(self, local, remote):
        if self._hadoop is None:
            return self._local.upload(local, remote)
        self._run("-put", local, remote)

    def download(self, remote, local):
        if self._hadoop is None:
            return self._local.download(remote, local)
        self._run("-get", remote, local)

    def ls_dir(self, path):
        if self._hadoop is None:
            return self._local.ls_dir(path)
        out = self._run("-ls", path).stdout.splitlines()
        files = [l.split()[-1] for l in out if l.startswith("-")]
        dirs = [l.split()[-1] for l in out if l.startswith("d")]
        return dirs, files
