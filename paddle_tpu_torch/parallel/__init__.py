"""Meshes over ranks and the sharded train step (port of
`paddle_tpu.parallel`: `mesh`, `spmd`). The pipeline, sequence-parallel
attention, LocalSGD and DGC are not ported yet (ROADMAP A6)."""
from .mesh import (DEFAULT_AXES, Mesh, P, axis_rank,  # noqa: F401
                   axis_size, create_mesh, get_mesh, mesh_scope,
                   named_sharding, replicated, set_mesh)
from .spmd import (batch_sharding, local_rows,  # noqa: F401
                   make_sharded_train_step, param_sharding, shard_params,
                   sharded_splash_attention, tp_mesh, write_back,
                   zero_sharding)
