"""paddle.incubate.autotune (port of `paddle_tpu.incubate.autotune`):
`set_config` keeps the reference's call working and records the config.
It tunes nothing: the port's kernels have fixed tiles, and cuDNN's own
search is `torch.backends.cudnn.benchmark`'s."""
from __future__ import annotations

__all__ = ["set_config"]

_config = {}


def set_config(config=None):
    if config:
        _config.update(config)
    return dict(_config)
