"""Paged KV cache: block allocator + preallocated per-layer K/V pools.

Port of `paddle_tpu.serving.kv_cache.PagedKVCache` with its refcount
layer (the prefix cache's substrate), its int8 page mode and the host
tier's page sizing (`page_host_bytes`); the tp mesh comes with a later
slice.

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
- **Refcounted sharing (prefix cache)**: every allocated page carries a
  refcount. `alloc_shared` maps an already-filled prefix chain read-only
  into a new sequence's page table (incref), the prefix index holds a
  reference on registered pages (`cache_hold`), and `cow_split` swaps one
  shared page for a private copy. Zero-on-free keys on refcounts:
  `free()` returns ONLY the pages whose count hit 0, so a page another
  sequence (or the prefix index) still reads is never zeroed under it.
  Pages held only by the index (refcount 1, cache-held) are *evictable*:
  `can_admit`/`headroom` count them as reclaimable, and the engine
  evicts them (LRU, through the prefix index) before allocating.
- **Pool types**: float32, bfloat16 and float16 pools hold K/V as they
  are (the decode kernel K1 reads all three). **int8 page mode**
  (`dtype="int8"`): the pools store int8 with parallel per-(layer, head,
  page) float32 scale pools (`k_scales`/`v_scales` [L, H, N]);
  `ops.paged_ops.paged_write_quantized` quantizes on append and the
  attention path dequantizes on gather. One page costs about 4x fewer
  device bytes than float32 (`page_hbm_bytes`/`pages_for_budget` do the
  arithmetic, scale pools included), so the same pool budget admits
  about 4x the concurrent sequences. Zero-on-free covers the scale pools:
  a freed page's scale returns to 0 ("empty") with its content.

- **Residency gauge**: each live cache adds its pool (and scale-pool)
  bytes to `STAT_kv_cache_hbm_bytes` at construction and subtracts them
  when it is collected (`weakref.finalize`) or when a dead engine's
  pools are released (`release_pools`), so a process with several
  engines exports what exists.

`alloc()`/`free()` are not thread-safe: the engine calls them from its
single step thread.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import numpy as np
import torch

from ..framework import monitor
from ..framework.errors import InvalidArgumentError, ResourceExhaustedError
from ..framework.place import resolve_device

__all__ = ["PagedKVCache", "TRASH_PAGE"]

TRASH_PAGE = 0


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8}


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
                f"PagedKVCache dtype {dtype!r} is not one of "
                f"{sorted(_TORCH_DTYPES)}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_seq = int(pages_per_seq)
        self.dtype = str(dtype)
        self.quantized = self.dtype == "int8"
        shape = (self.num_layers, self.num_heads, self.num_pages,
                 self.page_size, self.head_dim)
        tdt = _TORCH_DTYPES[self.dtype]
        device = resolve_device(device)
        self.k_pages = torch.zeros(shape, dtype=tdt, device=device)
        self.v_pages = torch.zeros(shape, dtype=tdt, device=device)
        # int8 page mode: per-(layer, head, page) symmetric abs-max scales
        # in parallel pools (dequant = q * scale; scale 0 = page empty)
        if self.quantized:
            sshape = (self.num_layers, self.num_heads, self.num_pages)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
            self.v_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
        else:
            self.k_scales = self.v_scales = None
        # LIFO free list: the page freed last is reallocated first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}  # seq id -> pages
        self._ref: Dict[int, int] = {}          # page -> refcount
        # pages the prefix index holds a reference on (cache_hold);
        # evictable = cache-held AND refcount 1 (no live sequence reads)
        self._cache_held: set = set()
        self._free_low_water = len(self._free)
        self._free_high_water = len(self._free)
        monitor.stat_set("STAT_kv_pages_inuse", 0)
        b = self.hbm_bytes()
        monitor.stat_gauge_add("STAT_kv_cache_hbm_bytes", b)
        self._gauge_finalizer = weakref.finalize(
            self, monitor.stat_gauge_add_later, "STAT_kv_cache_hbm_bytes",
            -b)

    # -- capacity arithmetic ----------------------------------------------

    @staticmethod
    def page_hbm_bytes(num_layers: int, num_heads: int, head_dim: int,
                       page_size: int, dtype="float32") -> int:
        """Device bytes ONE page costs across both pools (K and V, every
        layer), its slice of the int8 scale pools included: the unit of
        the capacity arithmetic."""
        item = torch.empty((), dtype=_TORCH_DTYPES[str(dtype)]) \
            .element_size()
        b = 2 * num_layers * num_heads * page_size * head_dim * item
        if str(dtype) == "int8":
            b += 2 * num_layers * num_heads * 4  # fp32 scale per (L, H)
        return b

    def page_host_bytes(self) -> int:
        """Host bytes ONE page costs demoted into the host KV tier: the
        raw K/V page blocks in the pool type plus (int8 mode) the fp32
        scale rows, the same arithmetic as `page_hbm_bytes`, because the
        tier stores the bytes as they are (a promotion re-uploads
        identical bytes)."""
        return self.page_hbm_bytes(self.num_layers, self.num_heads,
                                   self.head_dim, self.page_size,
                                   self.dtype)

    @classmethod
    def pages_for_budget(cls, budget_bytes: int, *, num_layers: int,
                         num_heads: int, head_dim: int, page_size: int,
                         dtype="float32") -> int:
        """Most pages (the reserved scratch page included) a device
        budget admits: int8 pages are about 4x denser than float32, the
        serving-capacity multiplier the quantized KV mode exists for."""
        per = cls.page_hbm_bytes(num_layers, num_heads, head_dim,
                                 page_size, dtype)
        return max(2, int(budget_bytes) // per)

    def hbm_bytes(self) -> int:
        """Live device bytes of the K/V pools and the scale pools."""
        b = (self.k_pages.numel() * self.k_pages.element_size()
             + self.v_pages.numel() * self.v_pages.element_size())
        if self.quantized:
            b += (self.k_scales.numel() * self.k_scales.element_size()
                  + self.v_scales.numel() * self.v_scales.element_size())
        return b

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

    @property
    def evictable_pages(self) -> int:
        """Pages the prefix index alone holds (refcount 1, cache-held):
        reclaimable on demand by an LRU eviction before alloc."""
        return sum(1 for p in list(self._cache_held)
                   if self._ref.get(p) == 1)

    @property
    def reclaimable_pages(self) -> int:
        """Free-list pages plus evictable cached pages: the admission
        capacity (the caller evicts before alloc)."""
        return len(self._free) + self.evictable_pages

    def can_admit(self, tokens: int) -> bool:
        """Admission check: worst-case pages available RIGHT NOW (free
        list + evictable cached pages)."""
        need = self.pages_needed(tokens)
        return need <= self.pages_per_seq and need <= self.reclaimable_pages

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
        for p in pages:
            self._ref[p] = 1
        self._owned[seq_id] = pages
        self._free_low_water = min(self._free_low_water, len(self._free))
        monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        row = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        row[:need] = pages
        return row

    def alloc_shared(self, seq_id: int, tokens: int,
                     shared_pages: List[int]) -> np.ndarray:
        """Like `alloc`, but the leading pages of the page-table row map
        an already-filled prefix chain READ-ONLY (each shared page's
        refcount is incremented; the sequence never writes them — its
        first write lies past the shared prefix, or behind a
        `cow_split`). Only the tail pages come off the free list."""
        if seq_id in self._owned:
            raise InvalidArgumentError(
                f"sequence {seq_id} already holds pages")
        need = self.pages_needed(tokens)
        fresh = need - len(shared_pages)
        if fresh < 0 or need > self.pages_per_seq:
            raise InvalidArgumentError(
                f"{tokens} tokens need {need} pages "
                f"(pages_per_seq={self.pages_per_seq}, "
                f"{len(shared_pages)} shared)")
        for p in shared_pages:
            if self._ref.get(p, 0) < 1:
                raise InvalidArgumentError(
                    f"shared page {p} is not allocated")
        if fresh > len(self._free):
            raise ResourceExhaustedError(
                f"KV page pool exhausted: need {fresh} fresh pages, "
                f"{len(self._free)} free of {self.usable_pages}")
        for p in shared_pages:
            self._ref[p] += 1
        pages = [self._free.pop() for _ in range(fresh)]
        for p in pages:
            self._ref[p] = 1
        self._owned[seq_id] = list(shared_pages) + pages
        self._free_low_water = min(self._free_low_water, len(self._free))
        monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        row = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        row[:need] = self._owned[seq_id]
        return row

    def _decref(self, page: int) -> bool:
        """Drop one reference; True when the page returned to the free
        list (refcount hit 0): zero-on-free applies to exactly these
        pages and defers while any sharer remains."""
        n = self._ref.get(page, 0) - 1
        if n > 0:
            self._ref[page] = n
            return False
        self._ref.pop(page, None)
        self._cache_held.discard(page)
        self._free.append(page)
        return True

    def free(self, seq_id: int) -> List[int]:
        """Release a sequence's references; returns ONLY the pages whose
        refcount hit 0 (the engine zeroes those on device before reuse;
        pages another sequence or the prefix index still reads are not
        returned and must not be zeroed). Idempotent — a double free
        (evict racing natural EOS) is a no-op."""
        pages = self._owned.pop(seq_id, [])
        freed = [p for p in pages if self._decref(p)]
        self._free_high_water = max(self._free_high_water, len(self._free))
        monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        return freed

    # -- prefix-cache references -------------------------------------------

    def pin(self, pages: List[int]) -> None:
        """Temporarily incref pages (an admission holding its matched
        chain across an eviction pass); pair with `unpin`."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise InvalidArgumentError(f"page {p} is not allocated")
            self._ref[p] += 1

    def unpin(self, pages: List[int]) -> List[int]:
        """Drop a `pin`; returns any pages freed (refcount hit 0)."""
        freed = [p for p in pages if self._decref(p)]
        if freed:
            self._free_high_water = max(self._free_high_water,
                                        len(self._free))
            monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        return freed

    def cache_hold(self, pages: List[int]) -> None:
        """The prefix index takes a reference on registered chain pages:
        they survive their producer sequence's free (content kept for
        later hits) and become evictable once no live sequence shares
        them."""
        self.pin(pages)
        self._cache_held.update(pages)

    def cache_release(self, pages: List[int]) -> List[int]:
        """Drop the prefix index's reference (chain eviction); returns
        the pages freed NOW (refcount 0: the caller zeroes them). Pages
        a live sequence still shares stay allocated and zero later, when
        that sequence frees."""
        for p in pages:
            self._cache_held.discard(p)
        return self.unpin(pages)

    def cow_split(self, seq_id: int, old_page: int) -> int:
        """Copy-on-write split: swap one SHARED page in `seq_id`'s
        ownership for a fresh private page (the caller copies the
        content on device, then writes through the private copy).
        Returns the new page id; the shared original keeps its other
        readers."""
        pages = self._owned.get(seq_id)
        if pages is None or old_page not in pages:
            raise InvalidArgumentError(
                f"sequence {seq_id} does not hold page {old_page}")
        if self._ref.get(old_page, 0) < 2:
            raise InvalidArgumentError(
                f"page {old_page} is not shared (refcount "
                f"{self._ref.get(old_page, 0)}); split is pointless")
        if not self._free:
            raise ResourceExhaustedError(
                "KV page pool exhausted: no free page for CoW split")
        new = self._free.pop()
        self._ref[new] = 1
        self._ref[old_page] -= 1
        pages[pages.index(old_page)] = new
        self._free_low_water = min(self._free_low_water, len(self._free))
        monitor.stat_set("STAT_kv_pages_inuse", self.pages_in_use)
        return new

    def refcounts(self) -> Dict[int, int]:
        """{page: refcount} snapshot."""
        out = {}
        for p in list(self._ref):
            n = self._ref.get(p)
            if n is not None:
                out[p] = n
        return out

    def cached_pages(self) -> List[int]:
        """Pages the prefix index currently holds (snapshot)."""
        return list(self._cache_held)

    def headroom(self, token_counts) -> Dict[int, int]:
        """For each request size (total tokens = prompt + max_new), how
        many MORE such requests `can_admit` would accept RIGHT NOW from
        the free list plus the evictable cached pages (0 when the shape
        can never fit the page table)."""
        out = {}
        free = self.reclaimable_pages
        for tokens in token_counts:
            need = self.pages_needed(tokens)
            if need > self.pages_per_seq or need <= 0:
                out[int(tokens)] = 0
            else:
                out[int(tokens)] = free // need
        return out

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

    def release_pools(self) -> None:
        """Drop the device pools of a dead engine's cache, at once and not
        at its collection: the JAX engine donates its pools into the call
        that failed, so a restart never holds two sets, and this is the
        port's counterpart. The pools become empty tensors of the same
        type and device, the residency gauge gives their bytes back now,
        and the bookkeeping (owners, refcounts, `stats()`) stays readable
        for the crash record."""
        if not self._gauge_finalizer.alive:
            return
        b = self.hbm_bytes()
        self._gauge_finalizer.detach()
        empty = self.k_pages.new_empty((0,))
        self.k_pages = self.v_pages = empty
        if self.quantized:
            self.k_scales = self.v_scales = \
                self.k_scales.new_empty((0,))
        monitor.stat_gauge_add("STAT_kv_cache_hbm_bytes", -b)

    def manifest(self) -> dict:
        """Crash-manifest snapshot: pool stats plus the ownership and
        refcount maps, taken at engine death so the flight dump records
        which sequences held which pages when the pools were lost; the
        rebuilt engine starts from a fresh pool, so this is the only
        record of the dead layout."""
        return {"stats": self.stats(), "owners": self.owners(),
                "refcounts": self.refcounts()}

    def stats(self) -> dict:
        return {
            "dtype": self.dtype,
            "quantized": self.quantized,
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
            # prefix-cache occupancy: cached = held by the prefix index
            # at all; evictable = held ONLY by it
            "cached_pages": len(self._cache_held),
            "evictable_pages": self.evictable_pages,
            "reclaimable_pages": self.reclaimable_pages,
        }
