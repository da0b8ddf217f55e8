"""Deterministic, flag-gated fault injection for the serving stack.

Port of `paddle_tpu.serving.failpoints`. Every hardened failure path in
the generation engine (decode-step exceptions, prefill exceptions,
poisoned (non-finite) logits, allocator exhaustion, slow steps, the host
tier's upload and gather) is named as a **failpoint** and armed from one
flag, so a test or a smoke run injects the exact fault class it
exercises, deterministically, with no code change:

    FLAGS_failpoints = "decode_step_raise@3"            # 3rd hit only
    FLAGS_failpoints = "decode_poison_nan@every:5"      # every 5th hit
    FLAGS_failpoints = "slow_step_ms@every:2:40"        # arg = 40 ms
    FLAGS_failpoints = "prefill_raise@1;alloc_exhaust@every:3"

Grammar: ';'-separated `site@trigger[:arg]` terms. `trigger` is either
a plain integer `N` — fire on the Nth hit of that site ONLY (one-shot;
hit counters are process-wide, so a restarted engine does NOT re-fire
an already-spent one-shot — exactly the semantics a supervised-restart
test needs) — or `every:K` — fire on every Kth hit. `arg` is one
optional float the site interprets (today only `slow_step_ms` reads
it: the sleep in milliseconds).

Sites (`SITES`):

- `decode_step_raise` — raise `InjectedFault` before the decode/verify
  call (engine-fatal, as a failing kernel launch there is).
- `prefill_raise`    — raise `InjectedFault` before a prefill call
  (engine-fatal, the same contract).
- `decode_poison_nan` — mark one live slot's logits non-finite after
  the step (exercises poison isolation, NOT engine death).
- `alloc_exhaust`    — force the admission pass to treat the page pool
  as exhausted (DEFER_PAGES without actually draining it).
- `slow_step_ms`     — sleep `arg` ms at the top of the step (SLO /
  burn-rate exercises).
- `kv_tier.promote_upload` — abandon a host-tier promotion before the
  next upload chunk's scatter: the admission zeroes the target pages
  written so far and falls back to cold prefill.
- `kv_tier.demote_gather` — fail the off-device page gather at
  demotion time: the eviction proceeds plain (content discarded), as
  with no tier — no leak on either tier.

Cost discipline: with `FLAGS_failpoints` unset (the default, and every
production deployment), `fire()` is one flag read + one emptiness check
— no lock, no parsing, no counters. Hit counting starts only while a
spec is armed. `reset()` zeroes the counters and the parse cache
(tests, smoke arms).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..framework import monitor
from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag

__all__ = ["SITES", "InjectedFault", "fire", "maybe_raise", "reset",
           "snapshot"]

SITES = ("decode_step_raise", "prefill_raise", "decode_poison_nan",
         "alloc_exhaust", "slow_step_ms", "kv_tier.promote_upload",
         "kv_tier.demote_gather")


class InjectedFault(RuntimeError):
    """The exception an armed *_raise failpoint throws — a distinct
    type so tests and postmortems can tell an injected fault from a
    real one at a glance."""


def _parse(spec: str) -> Dict[str, Tuple[str, int, Optional[float]]]:
    """{site: (mode, n, arg)} — mode "nth" (one-shot on hit n) or
    "every" (every nth hit). A malformed spec raises immediately: a
    typo'd failpoint that silently never fires would invalidate the
    very test that armed it."""
    out: Dict[str, Tuple[str, int, Optional[float]]] = {}
    for term in spec.split(";"):
        term = term.strip()
        if not term:
            continue
        if "@" not in term:
            raise InvalidArgumentError(
                f"FLAGS_failpoints term {term!r} lacks '@trigger' "
                f"(spell it site@N, site@N:arg, site@every:K or "
                f"site@every:K:arg)")
        site, trig = term.split("@", 1)
        site = site.strip()
        if site not in SITES:
            raise InvalidArgumentError(
                f"unknown failpoint site {site!r}; known: {SITES}")
        if site in out:
            raise InvalidArgumentError(
                f"failpoint site {site!r} appears twice in "
                f"FLAGS_failpoints — one trigger per site")
        parts = [p.strip() for p in trig.split(":")]
        arg: Optional[float] = None
        try:
            if parts[0] == "every":
                if len(parts) < 2:
                    raise ValueError("every needs a K")
                mode, n = "every", int(parts[1])
                if len(parts) > 2:
                    arg = float(parts[2])
            else:
                mode, n = "nth", int(parts[0])
                if len(parts) > 1:
                    arg = float(parts[1])
        except ValueError as e:
            raise InvalidArgumentError(
                f"FLAGS_failpoints term {term!r}: bad trigger "
                f"({e})") from None
        if n < 1:
            raise InvalidArgumentError(
                f"FLAGS_failpoints term {term!r}: trigger count must "
                f"be >= 1")
        out[site] = (mode, n, arg)
    return out


class _Registry:
    """Process-wide armed-spec cache + per-site hit/fired counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._src: Optional[str] = None   # raw spec last parsed
        self._armed: Dict[str, Tuple[str, int, Optional[float]]] = {}
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}

    def fire(self, site: str) -> Optional[float]:
        """One hit at `site`; returns the trigger's arg (or 0.0 when
        it has none) if this hit fires, else None. The fast path —
        flag unset — is a dict read + strip, nothing else."""
        spec = str(flag("FLAGS_failpoints"))
        if not spec.strip():
            return None
        with self._lock:
            if spec != self._src:
                # re-arming does NOT reset hit counters: a one-shot
                # spent before a flag rewrite stays spent (reset() is
                # the explicit way to start a fresh schedule)
                self._armed = _parse(spec)
                self._src = spec
            trig = self._armed.get(site)
            if trig is None:
                return None
            self._hits[site] = hit = self._hits.get(site, 0) + 1
            mode, n, arg = trig
            hits_now = (hit == n) if mode == "nth" else (hit % n == 0)
            if not hits_now:
                return None
            self._fired[site] = self._fired.get(site, 0) + 1
        monitor.stat_add("STAT_failpoints_fired")
        return 0.0 if arg is None else arg

    def reset(self) -> None:
        with self._lock:
            self._src = None
            self._armed = {}
            self._hits = {}
            self._fired = {}

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": dict(self._armed),
                    "hits": dict(self._hits),
                    "fired": dict(self._fired)}


_REG = _Registry()


def fire(site: str) -> Optional[float]:
    """Count one hit at `site`; non-None (the trigger arg) iff this
    hit fires. Never raises on the hot path when the flag is unset."""
    return _REG.fire(site)


def maybe_raise(site: str) -> None:
    """`fire()` + raise `InjectedFault` when triggered — the helper
    the *_raise sites use so every injected exception carries the
    site name."""
    if _REG.fire(site) is not None:
        raise InjectedFault(f"failpoint {site} fired "
                            f"(FLAGS_failpoints="
                            f"{str(flag('FLAGS_failpoints')).strip()!r})")


def reset() -> None:
    """Zero every hit/fired counter and drop the parse cache (tests /
    bench arms start a fresh schedule)."""
    _REG.reset()


def snapshot() -> dict:
    """{armed, hits, fired} — the registry's current accounting."""
    return _REG.snapshot()
