"""Process-level distributed env (port of `paddle_tpu.distributed.env`;
reference `python/paddle/distributed/parallel.py:57` init_parallel_env
and `fleet/base/role_maker.py:528`'s env parsing).

The JAX package runs one process a host and spans its chips by SPMD;
the port runs one process a card. `init_parallel_env` reads the
launcher's env contract (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_MASTER as host:port, PADDLE_LOCAL_RANK), binds the rank to
`cuda:{local_rank}` and calls `torch.distributed.init_process_group`:
NCCL when the rank runs on the card, gloo when the caller asked for the
CPU (`set_device("cpu")` or `device="cpu"`). `backend=` (or
PADDLE_DISTRI_BACKEND) overrides the choice: gloo carries CUDA tensors
too. `init_method=` (e.g. a `file://` store) replaces PADDLE_MASTER. A
1-rank world with no master gets a fresh localhost port. It then builds
the default `dp` mesh over the world, as the JAX package's does over
its devices. Under the launcher's `--elastic` (PADDLE_ELASTIC_KV set)
it starts the rank's heartbeat first (`fleet.elastic.HeartbeatClient`).
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "local_device", "backend"]

_device: Optional[torch.device] = None


class ParallelEnv:
    def __init__(self):
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.local_rank = int(os.environ.get("PADDLE_LOCAL_RANK",
                                             self.rank))
        self.device_id = self.local_rank
        self.current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")
        self.trainer_endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", self.current_endpoint).split(",")

    @property
    def nranks(self):
        return self.world_size


def get_rank(group=None) -> int:
    if not is_initialized():
        return int(os.environ.get("PADDLE_TRAINER_ID", 0))
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    if not is_initialized():
        return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    return dist.get_world_size(group)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device() -> torch.device:
    """The device this rank runs on (its card, or the CPU)."""
    if _device is not None:
        return _device
    from ..framework.place import resolve_device
    return resolve_device(None)


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_parallel_env(strategy=None, backend: Optional[str] = None,
                      init_method: Optional[str] = None,
                      device=None, timeout_s: float = 300.0) -> ParallelEnv:
    """Join the launcher's world (see the module docstring). Idempotent."""
    global _device
    if is_initialized():
        return ParallelEnv()
    from ..framework.place import resolve_device, set_device
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    local = int(os.environ.get("PADDLE_LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        # ranks beyond the cards share them (a correctness run of two
        # ranks on one card); NCCL refuses that, gloo does not
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_device(f"gpu:{dev.index}")
    elif device is not None:
        set_device("cpu")
    _device = dev
    backend = (backend or os.environ.get("PADDLE_DISTRI_BACKEND")
               or ("nccl" if dev.type == "cuda" else "gloo"))
    if init_method is None:
        master = os.environ.get("PADDLE_MASTER")
        if master:
            init_method = f"tcp://{master}"
        elif world == 1:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise RuntimeError(
                "init_parallel_env: PADDLE_TRAINERS_NUM > 1 but no "
                "PADDLE_MASTER; start the ranks with python -m "
                "paddle_tpu_torch.distributed.launch")
    # elastic mode: this rank's heartbeat against the launcher's KV
    # server, started before the rendezvous so that a rank waiting there
    # for a hung peer still beats (fleet/elastic.py)
    kv_ep = os.environ.get("PADDLE_ELASTIC_KV")
    if kv_ep:
        from .fleet.elastic import HeartbeatClient
        HeartbeatClient(kv_ep, rank=rank).start()
    import datetime
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    from ..parallel.mesh import create_mesh, get_mesh
    if get_mesh() is None:
        create_mesh({"dp": world})
    return ParallelEnv()


def destroy_process_group():
    """Leave the world and drop the mesh (the reverse of
    `init_parallel_env`)."""
    global _device
    from ..parallel.mesh import set_mesh
    set_mesh(None)
    if is_initialized():
        dist.destroy_process_group()
    _device = None
