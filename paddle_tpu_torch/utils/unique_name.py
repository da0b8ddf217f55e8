"""Unique name generator (port of `paddle_tpu.utils.unique_name`;
reference `fluid/unique_name.py`)."""
from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]

_counters = defaultdict(int)


def generate(key: str) -> str:
    _counters[key] += 1
    return f"{key}_{_counters[key] - 1}"


def switch(new_generator=None):
    global _counters
    old = _counters
    _counters = defaultdict(int)
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    global _counters
    old = switch()
    try:
        yield
    finally:
        _counters = old
