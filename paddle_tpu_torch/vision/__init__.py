"""Vision (port of `paddle_tpu.vision`; reference `python/paddle/vision`):
the models. `datasets`, `ops`, `transforms` and `models.yolov3` wait for
ROADMAP A item 21."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
