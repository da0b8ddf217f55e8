"""Meshes over ranks and the train steps over them (port of
`paddle_tpu.parallel`): `mesh`, `spmd` (data, tensor and sequence
parallel, ZeRO, DGC), `ring_attention`, `pipeline` (GPipe, 1F1B),
`localsgd` and `compression`."""
from .compression import dgc_compress, dgc_init  # noqa: F401
from .localsgd import local_write_back, make_local_train_step  # noqa: F401
from .mesh import (DEFAULT_AXES, Mesh, P, axis_rank,  # noqa: F401
                   axis_size, create_mesh, get_mesh, mesh_scope,
                   named_sharding, replicated, set_mesh)
from .pipeline import (gpipe_spmd, make_pipeline_train_step,  # noqa: F401
                       partition_blocks, pipeline_forward,
                       pipeline_write_back)
from .ring_attention import (ring_attention,  # noqa: F401
                             shard_map_ring_attention, ulysses_attention)
from .spmd import (batch_placement, batch_sharding,  # noqa: F401
                   local_rows, local_seq, make_sharded_train_step,
                   param_sharding, shard_params, sharded_splash_attention,
                   tp_mesh, write_back, zero_sharding)
