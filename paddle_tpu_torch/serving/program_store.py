"""Keyed on-disk program store for the generation engine: the engine's
programs survive a process (port of `paddle_tpu.serving.program_store`).

A new process pays, at warmup, the trace of every (bucket, program) it
runs. This store keeps every covered program (per-bucket `prefill[b=S]`
/ `prefill_tail[b=S]`, `decode[m=M]`, `verify[k=K]`, `cow_copy`) as a
`torch.export` program under a CONTENT KEY, so a cold process whose key
matches loads them instead of tracing them. Weights and KV pools are
inputs of every program: no artifact holds a parameter, and the pools
it is handed are the engine's own, written in place.

Layout (one directory per key under the configured root):

    <root>/<key>/manifest.json       key material + per-program index
    <root>/<key>/<program>.bin       torch.export.save of the program

The key is `jit.key_material_digest` over everything that shapes the
traced programs: model config, the decode-weight pytree spec (shapes,
types and paths: int8 / int4 leaves and their scale rows land there),
the engine knobs that shape traces (slots, page geometry, buckets,
spec_k, top_k, tail/prefix wiring), torch and CUDA versions, backend and
device kind, the kernel-selection FLAGS the programs bake in and the
hash of every kernel source a program can launch. Anything off by one
bit gives another key: a clean miss, never a wrong program.

Trust model: a loaded program is usable only if it still writes the
pools in place (a functionalized program writes copies, and the engine
would read stale pools). Where `device.serialization_unsafe_backend()`
is True the store refuses to engage unless forced, which warns once;
forced or not, the ENGINE checks each loaded program's in-place spec
against the manifest's recorded one and runs a numeric smoke probe
before it serves (`GenerationEngine._warm_one`); a failure dumps a
flight record and falls back to an export. Counters:
STAT_pack_store_hits / _misses / _writes, STAT_pack_selfcheck_failures,
and the `pack_load_ms` histogram.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from ..framework import monitor

__all__ = ["ProgramStore", "read_manifest"]

_MANIFEST = "manifest.json"


def _safe_name(program: str) -> str:
    """`prefill[b=8]` -> `prefill_b_8`: a file-system-safe name (the
    manifest keeps the exact program name)."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", program).strip("_")


def read_manifest(key_dir: str) -> Optional[dict]:
    """The key directory's manifest dict, or None when absent or
    unreadable (an unreadable manifest is a miss, never an error)."""
    try:
        with open(os.path.join(key_dir, _MANIFEST), "r",
                  encoding="utf-8") as f:
            return json.load(f)
    except Exception:  # noqa: BLE001 — any I/O or parse fault is a miss
        return None


class ProgramStore:
    """One engine's view of the store: a resolved content key and
    load / store over that key's directory.

    All I/O is best-effort: a corrupt payload, a half-written file or a
    permissions error is a MISS (the engine exports, exactly the
    store-off trace), so the store can make a start faster, never
    wrong and never failed."""

    def __init__(self, root: str, key_material: dict, force: bool = False):
        from .. import device as _device
        from ..jit import key_material_digest
        self.root = os.path.expanduser(str(root))
        self.key = key_material_digest(key_material)
        self.key_dir = os.path.join(self.root, self.key)
        self._material = key_material
        unsafe = _device.serialization_unsafe_backend()
        self.refused = unsafe and not force
        if unsafe and force:
            _device.warn_forced_serialization("ProgramStore(force=True)")
        self._hist = monitor.histogram("pack_load_ms")

    # -- read path ---------------------------------------------------------

    def load(self, program: str):
        """Load `program` from this key's directory. Returns (program,
        recorded in-place spec) on a hit, None on a miss or refusal. The
        caller (the engine's warmup) owns the self-check and the smoke
        probe: a returned program is NOT yet trusted."""
        if self.refused:
            return None
        entry = ((read_manifest(self.key_dir) or {}).get("programs", {})
                 .get(program))
        if entry is None:
            monitor.stat_add("STAT_pack_store_misses")
            return None
        t0 = time.perf_counter()
        try:
            from ..jit import deserialize_compiled
            with open(os.path.join(self.key_dir, entry["file"]), "rb") as f:
                blob = f.read()
            loaded = deserialize_compiled(blob)
        except Exception:  # noqa: BLE001 — corrupt payload: a miss
            monitor.stat_add("STAT_pack_store_misses")
            return None
        self._hist.observe((time.perf_counter() - t0) * 1000.0)
        monitor.stat_add("STAT_pack_store_hits")
        return loaded, str(entry.get("alias", ""))

    # -- write path --------------------------------------------------------

    def store(self, program: str, exported) -> bool:
        """Save an exported program under `program`, recording its
        in-place spec (what the next process self-checks against).
        Atomic a file (tmp + rename); the manifest is rewritten last, so
        a reader never sees an indexed but absent payload. Returns True
        on success."""
        if self.refused:
            return False
        try:
            from ..jit import compiled_alias_spec, serialize_compiled
            alias = compiled_alias_spec(exported)
            blob = serialize_compiled(exported)
            os.makedirs(self.key_dir, exist_ok=True)
            fname = _safe_name(program) + ".bin"
            tmp = os.path.join(self.key_dir, f".{fname}.tmp.{os.getpid()}")
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(self.key_dir, fname))
            mf = read_manifest(self.key_dir) or self._fresh_manifest()
            mf.setdefault("programs", {})[program] = {
                "file": fname, "bytes": len(blob), "alias": alias}
            tmp = os.path.join(self.key_dir,
                               f".{_MANIFEST}.tmp.{os.getpid()}")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(mf, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(self.key_dir, _MANIFEST))
        except Exception:  # noqa: BLE001 — a failed write: a later miss
            return False
        monitor.stat_add("STAT_pack_store_writes")
        return True

    def _fresh_manifest(self) -> dict:
        """The manifest's header: the key, its material, and the torch and
        CUDA versions, backend and device kind the programs were traced
        with (the engine's device where the key material names it)."""
        import torch
        backend = self._material.get("backend")
        kind = self._material.get("device_kind")
        if backend is None:
            backend = "cuda" if torch.cuda.is_available() else "cpu"
        if kind is None:
            kind = (torch.cuda.get_device_name() if backend == "cuda"
                    else "cpu")
        return {
            "key": self.key,
            "key_material": self._material,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": backend,
            "device_kind": kind,
            "programs": {},
        }

    # -- introspection -----------------------------------------------------

    def entries(self) -> dict:
        """{program: {file, bytes, alias}} for this key (may be {})."""
        return dict((read_manifest(self.key_dir) or {}).get("programs", {}))
