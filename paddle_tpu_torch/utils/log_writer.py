"""Scalar logging (port of `paddle_tpu.utils.log_writer`; reference
ecosystem: VisualDL's `LogWriter` and the `paddle.callbacks.VisualDL`
callback).

One append-only JSONL file a run (`{"tag", "step", "value",
"wall_time"}` records) that any plotting stack reads, and `dump_stats()`,
which writes the STAT counters of `framework.monitor` into the same
stream."""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogWriter"]


class LogWriter:
    def __init__(self, logdir: str, file_name: str = "scalars.jsonl",
                 display_name: str = ""):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, file_name)
        self._f = open(self._path, "a", buffering=1)
        self.display_name = display_name

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps({
            "tag": tag, "step": int(step), "value": float(value),
            "wall_time": time.time()}) + "\n")

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._f.write(json.dumps({
            "tag": tag, "step": int(step), "text": str(text),
            "wall_time": time.time()}) + "\n")

    def dump_stats(self, step: int = 0, prefix: str = "stat/") -> None:
        """Every STAT counter of `framework.monitor` as a scalar."""
        from ..framework.monitor import all_stats
        for name, v in all_stats().items():
            self.add_scalar(prefix + name, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
