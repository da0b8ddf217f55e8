"""paddle.distributed (port of `paddle_tpu.distributed`; reference
`python/paddle/distributed/`): one process a card over
`torch.distributed` (NCCL on the card, gloo on the CPU), the mesh of
`parallel.mesh`, the collectives (with the differentiable `ppermute` and
`all_to_all`), `DataParallel`, the tensor-parallel layers, ZeRO through
`sharding`, fleet (`fleet`), the launcher (`launch`, `spawn`,
`--elastic`), the parameter server (`ps`) and the legacy
`DistributeTranspiler` over it."""
from . import collective, fleet, ps, sharding  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         all_to_all, alltoall, barrier, broadcast,
                         get_group, new_group, ppermute, recv, reduce,
                         reduce_scatter, scatter, send, shard_ctx, split,
                         wait)
from .env import (ParallelEnv, destroy_process_group,  # noqa: F401
                  get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .parallel import DataParallel  # noqa: F401
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model)
from .tensor_parallel import (ColumnParallelLinear,  # noqa: F401
                              RowParallelLinear, VocabParallelEmbedding)
from .transpiler import (DistributeTranspiler,  # noqa: F401
                         DistributeTranspilerConfig)


def _spawn_target(func, args, env):
    import os
    os.environ.update(env)
    func(*args)


class SpawnContext:
    """The processes of a `spawn(join=False)`; `join(timeout)` waits for
    them with the launcher's watchdog."""

    def __init__(self, procs):
        self.processes = procs

    def join(self, timeout=None):
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        procs = list(self.processes)
        while procs:
            for p in list(procs):
                if p.exitcode is None:
                    continue
                procs.remove(p)
                if p.exitcode != 0:
                    self._stop()
                    raise RuntimeError(
                        f"spawn: process {self.processes.index(p)} exited "
                        f"with code {p.exitcode}; the others were stopped")
            if deadline is not None and time.monotonic() > deadline:
                self._stop()
                raise TimeoutError(f"spawn: ranks still running after "
                                   f"{timeout} s; stopped")
            time.sleep(0.05)
        return True

    def _stop(self):
        for p in self.processes:
            if p.exitcode is None:
                p.terminate()
        for p in self.processes:
            p.join(10)
            if p.exitcode is None:
                p.kill()
                p.join()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference `distributed/spawn.py:276`: start `nprocs` processes (the
    CUDA cards when -1, at least 1), each running `func(*args)` with the
    PADDLE_* env of its rank and a fresh localhost rendezvous, so
    `init_parallel_env()` inside `func` joins them. `func` must be
    importable by name (a module-level function). Option: `timeout`
    (seconds, for `join`). A rank that fails stops the others and
    raises."""
    import multiprocessing as mp
    import socket
    if nprocs in (-1, 0):
        import torch
        nprocs = max(torch.cuda.device_count(), 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_LOCAL_RANK": str(rank),
               "PADDLE_MASTER": f"127.0.0.1:{port}"}
        p = ctx.Process(target=_spawn_target, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs)
    if join:
        context.join(options.get("timeout"))
    return context
