"""paddle.distributed.fleet (port of `paddle_tpu.distributed.fleet`): the
collective side — `DistributedStrategy`, the role makers, `UtilBase` and
the file systems, the fleet metrics, `Fleet` / `fleet` (whose
`build_sharded_train_step` picks the strategy's step), the elastic
heartbeat and manager over the KV server, the launcher, and the
parameter server's side: `FleetWrapper`, `DownpourWorker` and the slot
datasets (`InMemoryDataset`, `QueueDataset`, `MultiSlotDataGenerator`)."""
from . import dataset, elastic, launch, metrics  # noqa: F401
from .dataset import (InMemoryDataset, MultiSlotDataGenerator,  # noqa: F401
                      QueueDataset)
from .device_worker import DownpourWorker  # noqa: F401
from .elastic import ElasticManager, ElasticStatus, HeartbeatClient  # noqa: F401
from .fleet_base import Fleet, fleet  # noqa: F401
from .fleet_wrapper import FleetWrapper  # noqa: F401
from .http_server import KVClient, KVServer  # noqa: F401
from .role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                         RoleMakerBase, UserDefinedRoleMaker)
from .strategy import DistributedStrategy  # noqa: F401
from .utils import HDFSClient, LocalFS, UtilBase  # noqa: F401

# module-level facade functions (reference: `fleet` is used as a module)
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
build_sharded_train_step = fleet.build_sharded_train_step
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
is_worker = fleet.is_worker
is_server = fleet.is_server
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
barrier_worker = fleet.barrier_worker
save_persistables = fleet.save_persistables


def worker_index():
    return fleet.worker_index
