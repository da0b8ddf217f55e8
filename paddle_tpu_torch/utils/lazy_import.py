"""try_import (port of `paddle_tpu.utils.lazy_import`; reference
`python/paddle/utils/lazy_import.py`)."""
from __future__ import annotations

import importlib

__all__ = ["try_import"]


def try_import(module_name: str, err_msg: str = None):
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed "
            "(this environment is offline; vendored deps only)") from e
