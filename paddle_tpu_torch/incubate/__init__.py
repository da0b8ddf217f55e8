"""paddle.incubate (port of `paddle_tpu.incubate`; reference
`python/paddle/incubate/`): the wrapper optimizers LookAhead,
ModelAverage, GradientMerge and Recompute, the auto-checkpoint epoch
range, `autotune.set_config`, and the `segment_*` ops."""
from . import autotune  # noqa: F401
from .checkpoint import (AutoCheckpointChecker, TrainEpochRange,  # noqa: F401
                         train_epoch_range)
from .optimizers import (GradientMergeOptimizer, LookAhead,  # noqa: F401
                         LookaheadOptimizer, ModelAverage, RecomputeOptimizer)
from ..ops.extra_ops import (segment_max, segment_mean,  # noqa: F401
                             segment_min, segment_sum)

__all__ = ["LookAhead", "LookaheadOptimizer", "ModelAverage",
           "GradientMergeOptimizer", "RecomputeOptimizer",
           "TrainEpochRange", "train_epoch_range", "AutoCheckpointChecker",
           "segment_sum", "segment_mean", "segment_max", "segment_min"]
