"""The static-graph recording hook of the port's named ops.

The JAX package records a static Program at its one dispatch point,
`apply_op(name, ...)` (`paddle_tpu/framework/tensor.py:270-293`): every
op it runs while static mode is on becomes one entry of the Program,
under the op's name. PyTorch has no such point. The port's named ops
(the ones that call `amp.cast_args(name, ...)`, as `linear`, `sdpa`,
`layer_norm`, `embedding`, `cross_entropy`) are marked with the
`named_op` decorator instead: while a Program is being recorded, a call
of such a function becomes ONE op named after the first name the
function announces through `amp.cast_args`, and nothing inside it is
recorded again. Every other torch call is recorded by `static.program`'s
TorchFunctionMode.

`depth` is above 0 inside a named op being recorded and while a Program
replays: torch calls made then are not recorded. `_installed` counts the
threads with a recorder installed; while it is 0 (dygraph, the common
case) a named op's wrapper and `announce` test that one module global
and nothing else. This module imports only the standard library, so `nn`
and `ops` import it freely.
"""
from __future__ import annotations

import contextlib
import functools
import threading

__all__ = ["named_op", "announce", "recording", "suppressed", "install",
           "uninstall"]


class _HookState(threading.local):
    def __init__(self):
        # callable(fn, args, kwargs, name) -> outputs, installed by
        # static.program while static mode is on in this thread
        self.recorder = None
        self.depth = 0
        self.announced = None


_state = _HookState()
_installed = 0   # threads with a recorder installed


def install(recorder) -> None:
    """Record this thread's named-op calls through `recorder`."""
    global _installed
    if _state.recorder is None:
        _installed += 1
    _state.recorder = recorder


def uninstall() -> None:
    global _installed
    if _state.recorder is not None:
        _installed -= 1
    _state.recorder = None


def recording() -> bool:
    """True where a call made now is recorded into a Program."""
    return bool(_installed) and _state.recorder is not None \
        and _state.depth == 0


def announce(name) -> None:
    """`amp.cast_args`'s note of the op name it casts for: the first name
    announced inside a named op being recorded names the op."""
    if _installed and _state.depth and _state.announced is None and name:
        _state.announced = name


@contextlib.contextmanager
def suppressed():
    """Torch calls made inside are not recorded (a named op's body being
    recorded, a Program's replay)."""
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1


def named_op(fn):
    """Mark `fn` as one named op of a static Program: while a Program is
    recorded, the call is recorded whole, under the first name the
    function announces."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _installed or _state.recorder is None or _state.depth:
            return fn(*args, **kwargs)
        return _state.recorder(fn, args, kwargs, None)
    wrapper.__wrapped_op__ = fn
    return wrapper
