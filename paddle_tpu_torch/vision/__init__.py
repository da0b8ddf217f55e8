"""Vision (port of `paddle_tpu.vision`; reference `python/paddle/vision`):
the models, `transforms` and `datasets`. `ops` and `models.yolov3` wait
for ROADMAP A8."""
from . import datasets, models, transforms  # noqa: F401
from .models import *  # noqa: F401,F403
