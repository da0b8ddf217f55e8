"""Typed framework errors raised by the serving slice.

A copy of the part of `paddle_tpu.framework.errors` this package needs
(reference `paddle/fluid/platform/enforce.h:410` + `platform/errors.h`).
Each type subclasses the closest Python builtin, so callers that catch
ValueError/MemoryError/TimeoutError keep working, while new code can
catch the typed family (all are EnforceNotMet)."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "ResourceExhaustedError",
           "ExecutionTimeoutError", "UnavailableError", "FatalError"]


class EnforceNotMet(Exception):
    """Base of every typed framework error. `code` mirrors
    platform/error_codes.proto."""
    code = "LEGACY"
    __str__ = Exception.__str__


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnavailableError(EnforceNotMet, RuntimeError):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"
