"""Vision (port of `paddle_tpu.vision`; reference `python/paddle/vision`):
the models (YOLOv3 among them), the detection `ops`, `transforms` and
`datasets`."""
from . import datasets, models, ops, transforms  # noqa: F401
from .models import *  # noqa: F401,F403
