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
- `get_rng_state()` snapshots all of it (torch's CPU generator, every
  card's generator, the seed and the registry) and `set_rng_state`
  restores it, so a random op and a flash kernel's dropout seed drawn
  after `set_rng_state(get_rng_state())` replay the same values.
  `get_cuda_rng_state` / `set_cuda_rng_state` cover the cards'
  generators alone (one state a card), as the reference's do.
- `rng_scope(s)` runs a block as if `seed(s)` had been called, and puts
  the state back after it (the JAX package pushes a key scope).
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Dict

import torch

__all__ = ["seed", "default_seed", "generator", "next_seed",
           "get_rng_state", "set_rng_state", "get_cuda_rng_state",
           "set_cuda_rng_state", "rng_scope"]

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
        # on the host explicitly: a caller may be building under a
        # `torch.device("cuda")` context (the vision models are)
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g,
                                 device="cpu").item())


def get_cuda_rng_state():
    """One state a CUDA card (its default generator); [] without one."""
    if not torch.cuda.is_available():
        return []
    return [torch.cuda.get_rng_state(i)
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(states):
    for i, st in enumerate(states):
        torch.cuda.set_rng_state(st, i)


def get_rng_state():
    """[state]: torch's CPU generator, the cards' generators, the seed and
    the registry's generators, for `set_rng_state`."""
    with _lock:
        reg = {k: g.get_state() for k, g in _generators.items()}
        s = _seed
    return [{"cpu": torch.get_rng_state(), "cuda": get_cuda_rng_state(),
             "seed": s, "registry": reg}]


def set_rng_state(states):
    """Restore a `get_rng_state()` snapshot (the list, or its entry)."""
    global _seed
    st = states[0] if isinstance(states, (list, tuple)) else states
    torch.set_rng_state(st["cpu"])
    set_cuda_rng_state(st["cuda"])
    with _lock:
        _seed = st["seed"]
        _generators.clear()
        for k, g_state in st["registry"].items():
            g = _generators[k] = torch.Generator()
            g.set_state(g_state)


def fold_seed(seed: int, *xs) -> int:
    """A 31-bit seed from `seed` and the integers `xs`, one per
    distinct tuple (`jax.random.fold_in`'s role: the pipeline folds
    (pp rank, microbatch, block) into a step's seed, LocalSGD a dp
    rank)."""
    return zlib.crc32(":".join(str(int(x)) for x in (seed,) + xs)
                      .encode()) & 0x7FFFFFFF


@contextlib.contextmanager
def rng_scope(s: int):
    """Run a block as after `seed(s)`; the state before it comes back
    after it."""
    saved = get_rng_state()
    seed(s)
    try:
        yield s
    finally:
        set_rng_state(saved)
