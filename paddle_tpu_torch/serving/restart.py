"""Restart primitives of the fault-tolerance layer.

Port of `paddle_tpu.serving.restart`, as it is. Two small, thread-safe
building blocks, which `serving.supervisor.EngineSupervisor` uses for
whole-engine restarts and `serving.engine.InferenceEngine` for its
per-lane restarts, as in the JAX package:

- `RestartBackoff`: exponential delay between consecutive failures
  (base * 2^(n-1), capped at 32x the base), reset explicitly once the
  restarted unit has proven stable. The *caller* sleeps — the policy
  object only computes, so tests can assert the schedule without
  waiting it out.
- `CrashBreaker`: a rolling-window event counter that OPENS (latches)
  once `threshold` failures land inside `window_s`. Open is terminal
  by design: a crash storm means restarts are not fixing the cause,
  and flapping — down, up for one request, down again — burns more
  than staying down and reporting `/readyz` 503 with a reason until an
  operator (or a fresh process) intervenes.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

__all__ = ["RestartBackoff", "CrashBreaker"]

_BACKOFF_CAP_FACTOR = 32


class RestartBackoff:
    """Exponential restart delay: base_ms, 2*base_ms, 4*base_ms, ...
    capped at 32x base; `reset()` returns to the base once the
    restarted unit survives long enough to be trusted again."""

    def __init__(self, base_ms: float):
        self.base_ms = max(0.0, float(base_ms))
        self._lock = threading.Lock()
        self._consecutive = 0
        self._last_death: Optional[float] = None

    def note_death(self, quiet_after_s: float,
                   now: Optional[float] = None) -> bool:
        """Record one failure instant. A gap longer than
        `quiet_after_s` since the PREVIOUS failure means the restarted
        unit proved stable: the escalation resets and True is returned
        (callers restore the unit's restart budget on it too) — only
        CONSECUTIVE failures escalate. This is THE quiet-window policy,
        shared by the engine supervisor and the per-lane restarts so
        the two cannot drift."""
        t = time.monotonic() if now is None else now
        with self._lock:
            last, self._last_death = self._last_death, t
            if last is not None and t - last > quiet_after_s:
                self._consecutive = 0
                return True
            return False

    def next_delay_ms(self) -> float:
        """Delay to wait before the NEXT restart attempt; each call
        counts one failure."""
        with self._lock:
            n = self._consecutive
            self._consecutive += 1
        return min(self.base_ms * (2 ** n),
                   self.base_ms * _BACKOFF_CAP_FACTOR)

    @property
    def max_delay_ms(self) -> float:
        """The escalation ceiling — callers sizing a wait-for-restart
        deadline derive it from THIS, not a constant, so a flag-scaled
        backoff can't outlive the waiter."""
        return self.base_ms * _BACKOFF_CAP_FACTOR

    @property
    def consecutive(self) -> int:
        with self._lock:
            return self._consecutive

    def reset(self) -> None:
        with self._lock:
            self._consecutive = 0


class CrashBreaker:
    """N failures in a rolling window opens the breaker — permanently,
    until `reset()` (operator action / process restart)."""

    def __init__(self, threshold: int, window_s: float):
        self.threshold = max(1, int(threshold))
        self.window_s = max(0.0, float(window_s))
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._open = False
        self._opened_at: Optional[float] = None

    def record(self, now: Optional[float] = None) -> bool:
        """Count one failure; returns True the moment the breaker
        opens (and on every later record while open)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            if self._open:
                return True
            self._events.append(t)
            while self._events and t - self._events[0] > self.window_s:
                self._events.popleft()
            if len(self._events) >= self.threshold:
                self._open = True
                self._opened_at = t
            return self._open

    def trip(self, now: Optional[float] = None) -> None:
        """Latch the breaker open directly — for failure modes the
        rolling window cannot count reliably (e.g. rebuild attempts
        that each fail SLOWER than the window accumulates events)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            if not self._open:
                self._open = True
                self._opened_at = t

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def state(self) -> dict:
        with self._lock:
            return {"open": self._open,
                    "threshold": self.threshold,
                    "window_s": self.window_s,
                    "recent_events": len(self._events),
                    "open_for_s": (round(time.monotonic()
                                         - self._opened_at, 3)
                                   if self._open else None)}

    def reset(self) -> None:
        with self._lock:
            self._open = False
            self._opened_at = None
            self._events.clear()
