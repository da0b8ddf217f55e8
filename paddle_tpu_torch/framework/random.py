"""Seeds and generators (port of `paddle_tpu.framework.random`).

The reference keeps stateful per-device generators (`paddle.seed`,
`framework/generator.cc`); the JAX package bridges them to functional
keys. Here torch's own generators are the state:

- `seed(s)` seeds torch's default generators on every device (what
  `nn.Dropout` and `torch.rand` draw from) and resets the registry below.
- The registry holds, per device, a host-side `torch.Generator` seeded
  from `s` and the device's name. `next_seed(device)` draws from it the
  int32 seed of a flash kernel's dropout mask, as the JAX package draws
  one from `get_rng_key()` (`pallas_ops.py:516-520`). The generator lives
  on the host, so drawing a seed never waits for the card.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict

import torch

__all__ = ["seed", "default_seed", "generator", "next_seed"]

default_seed = 0

_lock = threading.Lock()
_seed = default_seed
_generators: Dict[str, torch.Generator] = {}


def seed(s: int) -> int:
    """paddle.seed: seed torch's default generators and restart every
    device's seed stream."""
    global _seed
    with _lock:
        _seed = int(s)
        _generators.clear()
    torch.manual_seed(_seed)
    return _seed


def generator(device) -> torch.Generator:
    """The registry's host generator for `device` (created on first use)."""
    key = str(torch.device(device))
    with _lock:
        g = _generators.get(key)
        if g is None:
            # the CPU generator (mt19937) keeps only the low 32 bits of its
            # seed, so the user's seed and the device are hashed into them
            g = _generators[key] = torch.Generator().manual_seed(
                zlib.crc32(f"{_seed}:{key}".encode()))
        return g


def next_seed(device) -> int:
    """A fresh int32 in [0, 2^31 - 1) from `device`'s seed stream."""
    g = generator(device)
    with _lock:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g).item())
