"""Fleet-wide trace-context propagation.

One request = one 16-hex trace id, minted ONCE at the outermost entry
point that sees the request (the Router when placement is involved, the
engine itself for direct submits) and threaded *explicitly* through
every hop — placement audit details (``trace=``), supervisor delegation,
engine admission, per-incarnation GenSpans, replay entries, and stream
delivery. No contextvars, no thread-locals: the id rides the request
objects so it survives thread handoffs, supervisor restarts, and (soon)
process boundaries unchanged.

The id doubles as a chrome flow id: :func:`flow_id` folds the 16 hex
chars into a positive int64 that is stable across processes, so N
replicas' ``/trace`` exports merged by ``tools/fleet_trace.py`` draw one
arrow chain per request (``fleet_request`` flow events) even though each
process allocated its own local rids.
"""

import os
import re

from ..framework.flags import flag

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{16}$")


def enabled() -> bool:
    """Trace propagation on? Read per-request so tests and bench can
    flip FLAGS_trace_propagation at runtime."""
    return bool(flag("FLAGS_trace_propagation"))


def new_trace_id() -> str:
    """A fresh 16-hex (64-bit) trace id."""
    return os.urandom(8).hex()


def is_trace_id(s) -> bool:
    """True iff *s* is a well-formed 16-hex trace id."""
    return isinstance(s, str) and bool(_TRACE_ID_RE.match(s))


def flow_id(trace_id: str) -> int:
    """Chrome flow-event id for a trace id: the hex value masked to a
    positive int64. Deterministic across processes — every replica that
    saw the same trace id emits flow events under the same id, which is
    what lets the merged timeline link them."""
    return int(trace_id, 16) & 0x7FFFFFFFFFFFFFFF
