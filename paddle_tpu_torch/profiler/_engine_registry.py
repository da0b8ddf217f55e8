"""Engine-name-keyed weakref registry shared by the step-log and
decision-audit surfaces (`/steps`, flight dumps).

Entries hold weakrefs so a registry can never keep a dead engine's log
alive, and dead refs are pruned on every read instead of leaking one
map entry per engine name forever. `unregister` only removes the entry
if it still points at the caller's object (or is already dead) — a
newer engine reusing the name must not be evicted by the old one's
shutdown.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict


class EngineRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._refs: Dict[str, weakref.ref] = {}

    def register(self, name: str, obj) -> None:
        with self._lock:
            self._refs[name] = weakref.ref(obj)

    def unregister(self, name: str, obj) -> None:
        with self._lock:
            ref = self._refs.get(name)
            if ref is not None and ref() in (obj, None):
                del self._refs[name]

    def get(self, name: str):
        """The live object registered under `name`, pruning a dead ref."""
        with self._lock:
            ref = self._refs.get(name)
            if ref is not None and ref() is None:
                del self._refs[name]
                ref = None
        return ref() if ref is not None else None

    def live(self) -> Dict[str, object]:
        """{name: obj} of every live entry, pruning dead refs."""
        with self._lock:
            items = list(self._refs.items())
        out = {}
        for name, ref in items:
            obj = ref()
            if obj is None:
                with self._lock:
                    if self._refs.get(name) is ref:
                        del self._refs[name]
                continue
            out[name] = obj
        return out
