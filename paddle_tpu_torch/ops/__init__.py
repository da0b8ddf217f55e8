"""Ops. The kernel-backed ones (`flash_ops`, `paged_ops`, `splash_ops`)
build nothing at import: each CUDA kernel is compiled from
`paddle_tpu_torch/csrc` at its first launch. The dense op families
(`creation`, `manipulation`, `logic`, `reduction`, `search`,
`random_ops`, `linalg`, `math`) are plain PyTorch, re-exported here and
at the package's top level (`paddle_tpu_torch.concat`, ...);
`tensor_methods` maps the reference's Tensor methods onto torch's;
`legacy` holds the fluid-era names (re-exported last, so its axis-aware
`elementwise_*` are the top-level ones, as in the JAX package)."""
from . import flash_ops, paged_ops, splash_ops  # noqa: F401
from . import (creation, linalg, logic, manipulation, math,  # noqa: F401
               random_ops, reduction, search)
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from . import legacy  # noqa: F401,E402
from .legacy import *  # noqa: F401,F403,E402  (last: axis-aware elementwise_*)
from . import tensor_methods  # noqa: F401,E402
