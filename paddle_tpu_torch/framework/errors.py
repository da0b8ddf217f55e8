"""Typed framework errors (port of `paddle_tpu.framework.errors`;
reference `paddle/fluid/platform/enforce.h:410` + `platform/errors.h`:
one class an error code, raised through `enforce`, PADDLE_ENFORCE).
Each type subclasses the closest Python builtin, so callers that catch
ValueError/MemoryError/TimeoutError keep working, while new code can
catch the typed family (all are EnforceNotMet)."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError",
           "ResourceExhaustedError", "PreconditionNotMetError",
           "PermissionDeniedError", "ExecutionTimeoutError",
           "UnimplementedError", "UnavailableError", "FatalError",
           "ExternalError", "enforce"]


class EnforceNotMet(Exception):
    """Base of every typed framework error. `code` mirrors
    platform/error_codes.proto."""
    code = "LEGACY"
    __str__ = Exception.__str__


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet, RuntimeError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet, PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnavailableError(EnforceNotMet, RuntimeError):
    code = "UNAVAILABLE"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class NotFoundError(EnforceNotMet, KeyError):
    code = "NOT_FOUND"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet, OSError):
    code = "EXTERNAL"


def enforce(condition, message="", error_cls=PreconditionNotMetError):
    """PADDLE_ENFORCE: raise `error_cls(message)` unless condition holds."""
    if not condition:
        raise error_cls(message)
