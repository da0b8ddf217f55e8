"""The parameter server (port of `paddle_tpu.distributed.ps`; reference
Fleet's brpc parameter server, `paddle/fluid/distributed/`): the native
dense and sparse tables, the TCP service, the async and geo
communicators, the runtime behind `fleet.init_server` / `init_worker`,
and `HostEmbedding` with its step on the card."""
from .communicator import AsyncCommunicator, GeoCommunicator  # noqa: F401
from .host_embedding import (HostEmbedding,  # noqa: F401
                             make_host_embedding_step)
from .runtime import (DistributedEmbedding, TheOnePSRuntime,  # noqa: F401
                      the_one_ps)
from .service import PsClient, PsServer, TableConfig  # noqa: F401
from .tables import DenseTable, SparseTable, native_available  # noqa: F401
