"""Paged KV cache: block allocator + preallocated per-layer K/V pools.

Port of `paddle_tpu.serving.kv_cache.PagedKVCache` without the prefix-
cache references (`alloc_shared`, `cow_split`, `pin`, `cache_hold`), the
tp mesh and the int8 scale pools, which come with later slices.

- Pools `[L, H, num_pages, page_size, D]` live on the device; the
  engine updates them in place.
- **Page 0 is reserved scratch ("trash")**: inactive decode slots and
  padded prefill tails write there, and page-table padding points there.
  It is never allocated.
- **Worst-case admission**: `can_admit(tokens)` is exact page arithmetic
  over prompt + max-new, so a running sequence is never starved.
- **Zero-on-free**: freed pages are zeroed by the engine before reuse
  (`zero_rows` builds the row), so a poisoned sequence's NaNs never
  reach the next owner. The decode kernel reads only positions up to a
  sequence's length; the plain path masks the rest to an exact 0, which
  is only safe when stale never means NaN.

`alloc()`/`free()` are not thread-safe: the engine calls them from its
single step thread.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..framework import monitor
from ..framework.errors import InvalidArgumentError, ResourceExhaustedError
from ..framework.place import resolve_device

__all__ = ["PagedKVCache", "TRASH_PAGE"]

TRASH_PAGE = 0

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PagedKVCache:
    """Block allocator over per-layer paged K/V pools."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 page_size: int, num_pages: int, pages_per_seq: int,
                 dtype="float32", device=None):
        if page_size < 1 or num_pages < 2 or pages_per_seq < 1:
            raise InvalidArgumentError(
                f"PagedKVCache needs page_size>=1, num_pages>=2 (page 0 "
                f"is reserved scratch), pages_per_seq>=1; got "
                f"{page_size}/{num_pages}/{pages_per_seq}")
        if str(dtype) not in _TORCH_DTYPES:
            raise InvalidArgumentError(
                f"PagedKVCache dtype {dtype!r} is not yet ported "
                f"(float32/bfloat16)")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_seq = int(pages_per_seq)
        self.dtype = str(dtype)
        shape = (self.num_layers, self.num_heads, self.num_pages,
                 self.page_size, self.head_dim)
        tdt = _TORCH_DTYPES[self.dtype]
        device = resolve_device(device)
        self.k_pages = torch.zeros(shape, dtype=tdt, device=device)
        self.v_pages = torch.zeros(shape, dtype=tdt, device=device)
        # LIFO free list: the page freed last is reallocated first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}  # seq id -> pages
        self._free_low_water = len(self._free)
        self._free_high_water = len(self._free)
        monitor.stat_set("STAT_kv_pages_inuse", 0)

    # -- capacity arithmetic ----------------------------------------------

    def hbm_bytes(self) -> int:
        return (self.k_pages.numel() * self.k_pages.element_size()
                + self.v_pages.numel() * self.v_pages.element_size())

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1  # minus the trash page

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)  # ceil

    def fits(self, tokens: int) -> bool:
        """Could `tokens` EVER be admitted (table width + pool size)?"""
        need = self.pages_needed(tokens)
        return need <= self.pages_per_seq and need <= self.usable_pages

    def can_admit(self, tokens: int) -> bool:
        """Admission check: worst-case pages free RIGHT NOW."""
        need = self.pages_needed(tokens)
        return need <= self.pages_per_seq and need <= len(self._free)

    # -- alloc / free ------------------------------------------------------

    def alloc(self, seq_id: int, tokens: int) -> np.ndarray:
        """Reserve worst-case pages for `tokens`; returns the sequence's
        fixed-width page-table row (trash-padded int32 [pages_per_seq]).
        Raises ResourceExhaustedError when the pool is short — callers
        gate on `can_admit`, so this raising means an accounting bug."""
        if seq_id in self._owned:
            raise InvalidArgumentError(
                f"sequence {seq_id} already holds pages")
        need = self.pages_needed(tokens)
        if need > self.pages_per_seq:
            raise InvalidArgumentError(
                f"{tokens} tokens need {need} pages > pages_per_seq="
                f"{self.pages_per_seq} (page_size={self.page_size})")
        if need > len(self._free):
            raise ResourceExhaustedError(
                f"KV page pool exhausted: need {need} pages, "
                f"{len(self._free)} free of {self.usable_pages}")
        pages = [self._free.pop() for _ in range(need)]
        self._owned[seq_id] = pages
        self._free_low_water = min(self._free_low_water, len(self._free))
        monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        row = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        row[:need] = pages
        return row

    def free(self, seq_id: int) -> List[int]:
        """Release a sequence's pages and return them (the engine zeroes
        them on device before reuse). Idempotent — a double free (evict
        racing natural EOS) is a no-op."""
        pages = self._owned.pop(seq_id, [])
        self._free.extend(pages)
        self._free_high_water = max(self._free_high_water, len(self._free))
        monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        return pages

    def owned(self, seq_id: int):
        pages = self._owned.get(seq_id)
        return list(pages) if pages is not None else None

    def owners(self) -> Dict[int, List[int]]:
        """Page-ownership map `{seq_id: [page, ...]}` (snapshot)."""
        out = {}
        for sid in list(self._owned):
            pages = self._owned.get(sid)
            if pages is not None:
                out[sid] = list(pages)
        return out

    def zero_rows(self, pages: List[int]) -> np.ndarray:
        """Fixed-width page-id row for the engine's zeroing scatter
        (trash-padded)."""
        row = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        row[:len(pages)] = pages[:self.pages_per_seq]
        return row

    def stats(self) -> dict:
        return {
            "dtype": self.dtype,
            "hbm_bytes": self.hbm_bytes(),
            "page_size": self.page_size,
            "usable_pages": self.usable_pages,
            "pages_in_use": self.pages_in_use,
            "free_pages": self.free_pages,
            "pages_per_seq": self.pages_per_seq,
            "sequences": len(self._owned),
            "occupancy": round(self.pages_in_use
                               / max(1, self.usable_pages), 4),
            "free_low_water": self._free_low_water,
            "free_high_water": self._free_high_water,
        }
