"""paddle.distributed.sharding (port of `paddle_tpu.distributed.sharding`;
reference `python/paddle/distributed/sharding/group_sharded.py`
group_sharded_parallel: dygraph ZeRO stages 1-3).

`group_sharded_parallel` marks the ZeRO stage on the optimizer
(`_zero_stage`), which `parallel.spmd.make_sharded_train_step` reads:
'os' shards the optimizer state over 'dp' (ZeRO-1), 'os_g' the
gradients too (reduce-scatter, ZeRO-2), 'p_g_os' also marks each
parameter without a partition spec 'dp' on its largest dp-divisible
axis, as the JAX package's `:25-38` does (ZeRO-3: the update and the
state run on that block, and a rank keeps only that block of the
parameter between steps; the layer's `state_dict()` and
`parallel.spmd.write_back` gather it).
"""
from __future__ import annotations

import os

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_STAGES = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """level: 'os' (ZeRO-1) | 'os_g' (ZeRO-2) | 'p_g_os' (ZeRO-3)."""
    stage = _STAGES.get(level, 1)
    from ..parallel.mesh import P, get_mesh
    mesh = get_mesh()
    if stage >= 3 and mesh is not None:
        dp = mesh.axis_size("dp")
        if dp > 1:
            for _, p in model.named_parameters():
                if getattr(p, "partition_spec", None):
                    continue
                shape = tuple(p.shape)
                for ax, d in sorted(enumerate(shape), key=lambda t: -t[1]):
                    if d % dp == 0:
                        spec = [None] * len(shape)
                        spec[ax] = "dp"
                        p.partition_spec = P(*spec)
                        break
    optimizer._zero_stage = stage
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """The gathered model (and the optimizer's state) through the port's
    `io_state`, as `model.pdparams` / `model.pdopt` under `output`."""
    from ..framework.io_state import save
    os.makedirs(output, exist_ok=True)
    save(model.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None and hasattr(optimizer, "state_dict"):
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
