"""Host-memory demotion tier under the prefix cache.

Port of `paddle_tpu.serving.kv_tier`. Without this tier a prefix-cache
page is binary: resident on the device or zeroed and gone, so every
eviction turns a future TTFT win back into a full prefill. With it, when
`PrefixCache` eviction would free a cold chain's pages, the engine
*demotes* them instead: the page's raw blocks (and, in int8 mode, the
per-(layer, head) fp32 scale rows) are copied off the device into this
bounded host store, keyed by the chain's blake2b digests, and the device
pages are zeroed and freed as before. A later lookup that misses the
device but hits here *promotes*: the pages re-upload in fixed-size
chunks on a side CUDA stream, chunk i+1's upload overlapping chunk i's
scatter into the pools, ahead of the tail prefill of the uncovered
suffix, so a revisit costs about one tail prefill instead of a full
prefill.

On a CUDA engine the entries are **pinned** CPU memory carved from the
engine's slab (`HostSlab`): fixed-size slots in pinned segments of
`HostSlab.SEGMENT_BYTES`, the first pinned with the engine and the
rest as demotions fill them, up to the budget. A demotion copies into a
free slot, and the tier returns an entry's slot wherever it drops the
entry, so no page ever pins memory of its own and the uploads are true
asynchronous DMA. On the CPU the slab is plain CPU memory. Contents are
stored as they are: int8 pages keep their integer bytes and their fp32
scale rows side by side, so a promotion re-uploads identical bytes with
no requantization, and a promoted chain decodes exactly like a
never-evicted one.

Under a tp lane each rank's slab holds its heads of every page, with as
many slots as the leader's: the leader's tier is the only allocator (it
takes the slots and names them in the programs' descriptors,
`serving.tp_lane`), and a follower's slab keeps no free list of its own.
An entry counts the lane's bytes of its page (`HostEntry.nbytes`), so
the budget holds as many pages at any tp, and the evictions match tp =
1's and the JAX lane's, whose host pages are whole.

Budget: the tier owns its own byte budget (`FLAGS_kv_tier_host_bytes`)
with LRU eviction; demote-of-demoted is the final eviction (audit code
KV_TIER_EVICT). `put` returns the evicted digests so the `PrefixCache`
can drop the corresponding host-state chain nodes in the same step; an
entry that alone exceeds the budget is refused (stored nowhere, plain
eviction applies upstream).

Threading: single writer like the allocator and the prefix index. The
engine's step thread owns every mutation (demote at eviction, pop at
promotion, LRU eviction inside put); scraper and submit threads read the
plain-int counters and `host_bytes` through `stats()`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..framework import monitor
from ..framework.errors import ResourceExhaustedError

__all__ = ["HostEntry", "HostSlab", "HostTier"]


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class HostEntry:
    """One demoted page's host copy: raw K/V page blocks
    `[L, H, page_size, D]` plus (int8 mode) the per-(layer, head) fp32
    scale rows `[L, H]`, as CPU tensors (pinned on a CUDA engine): raw
    bytes in, raw bytes out, so the round trip is exact. `slot` is the
    `HostSlab` slot the tensors live in (None when they are not a
    slab's), returned by the tier when it drops the entry. `nbytes`, what
    the budget counts, defaults to the tensors' bytes; a tp rank's entry
    holds its heads and counts the whole page's."""

    __slots__ = ("k", "v", "ks", "vs", "nbytes", "slot")

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 ks: Optional[torch.Tensor] = None,
                 vs: Optional[torch.Tensor] = None,
                 slot: Optional[int] = None,
                 nbytes: Optional[int] = None):
        self.k, self.v, self.ks, self.vs = k, v, ks, vs
        self.nbytes = (_nbytes(k) + _nbytes(v) + _nbytes(ks) + _nbytes(vs)
                       if nbytes is None else int(nbytes))
        self.slot = slot


class HostSlab:
    """Fixed-size host slots for demoted pages, carved from segments of
    at most SEGMENT_BYTES (pinned when `pin`): slot i holds one page's
    parts (K, V and, int8, the two scale rows) back to back. The first
    segment is allocated here, so a host that cannot pin fails at
    construction; another is added when `take()` finds no free slot, up
    to `slots` in all. `take()` hands out a free slot's views and
    `release(slot)` returns it (the step thread is the only caller). The
    owner sizes `slots` to the most entries the tier can hold at once,
    so taking a slot never fails in use; it raises when it would."""

    SEGMENT_BYTES = 64 << 20

    def __init__(self, parts: Sequence[Tuple[tuple, torch.dtype]],
                 slots: int, pin: bool):
        self._parts = [(tuple(shape), dtype) for shape, dtype in parts]
        self._sizes = [torch.Size(shape).numel()
                       * torch.empty((), dtype=dtype).element_size()
                       for shape, dtype in self._parts]
        # every part starts on an 8-byte boundary of its slot
        self._offs, off = [], 0
        for n in self._sizes:
            self._offs.append(off)
            off += -(-n // 8) * 8
        self.slot_bytes = off
        self.slots = int(slots)
        self._pin = pin
        self._per_seg = max(1, min(self.slots,
                                   self.SEGMENT_BYTES // self.slot_bytes))
        self._segs: List[torch.Tensor] = []
        self._free: List[int] = []
        self._held = 0
        self._grow()

    def _grow(self) -> None:
        """Allocate the next segment and free its slots."""
        first = len(self._segs) * self._per_seg
        n = min(self._per_seg, self.slots - first)
        if n <= 0:
            raise ResourceExhaustedError(
                f"host tier slab: all {self.slots} slots hold entries")
        self._segs.append(torch.empty(n * self.slot_bytes,
                                      dtype=torch.uint8,
                                      pin_memory=self._pin))
        self._free.extend(range(first + n - 1, first - 1, -1))

    def take(self) -> Tuple[int, List[torch.Tensor]]:
        """A free slot and its part views."""
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self._held += 1
        return slot, [v[0] for v in self.part_views(self.raw(slot)[None])]

    def raw(self, slot: int) -> torch.Tensor:
        """Slot `slot`'s bytes, uint8 [slot_bytes]: its parts at
        `part_views(...)`' offsets, back to back. A tp follower reads
        the slots its leader took, so the segments grow to hold any
        slot named."""
        seg, i = divmod(slot, self._per_seg)
        while seg >= len(self._segs):
            self._grow()
        base = i * self.slot_bytes
        return self._segs[seg][base:base + self.slot_bytes]

    def part_views(self, rows: torch.Tensor) -> List[torch.Tensor]:
        """The parts of slot-shaped byte rows (uint8 [n, slot_bytes], on
        any device): one [n, *shape] view of its dtype a part."""
        n = rows.shape[0]
        return [rows[:, off:off + size].view(dtype).view((n,) + shape)
                for (shape, dtype), off, size in zip(
                    self._parts, self._offs, self._sizes)]

    def release(self, slot: int) -> None:
        """Return `slot` to the free list: its views may be handed out
        again by the next `take()`."""
        self._free.append(slot)
        self._held -= 1

    @property
    def held(self) -> int:
        """Slots that hold an entry."""
        return self._held

    @property
    def segments(self) -> int:
        return len(self._segs)

    @property
    def reserved_bytes(self) -> int:
        """Host bytes the segments allocated so far hold."""
        return sum(t.numel() for t in self._segs)


class HostTier:
    """Bounded, LRU-evicting host store of demoted prefix-cache pages
    for ONE engine, keyed by chain digest. The engine's step thread is
    the only writer (see module docstring)."""

    def __init__(self, max_bytes: int, engine: str = "generation",
                 slab: Optional[HostSlab] = None):
        self.engine = engine
        self.max_bytes = int(max_bytes)
        # where entries' slots return when the tier drops them
        self._slab = slab
        self._entries: "OrderedDict[bytes, HostEntry]" = OrderedDict()
        self._bytes = 0
        # plain-int counters: step thread writes, scrapers read
        # GIL-atomically (stats() below)
        self.demotions = 0    # entries ever stored
        self.promotions = 0   # pages re-uploaded to the device
        self.evictions = 0    # entries finally dropped (LRU / cascade)
        self.hits = 0         # admissions that matched >= 1 host page
        self.abandons = 0     # promotions abandoned mid-upload
        self.rejects = 0      # puts refused (entry alone over budget)

    # -- store mutation (step thread only) ---------------------------------

    def _release(self, entry: HostEntry) -> None:
        """Return a dropped entry's slab slot."""
        if self._slab is not None and entry.slot is not None:
            self._slab.release(entry.slot)

    def put(self, digest: bytes, entry: HostEntry,
            protect: Iterable[bytes] = ()) -> Tuple[bool, List[bytes]]:
        """Store one demoted page under `digest` (MRU), LRU-evicting
        other entries until the byte budget holds. Returns
        `(stored, evicted_digests)` — the caller drops the chain nodes
        of every evicted digest (demote-of-demoted = final eviction).
        `protect` digests (an in-flight admission's matched host run)
        are never evicted, even if the budget temporarily overshoots.
        An entry that alone exceeds the budget is refused. Every entry
        the store drops here (refused, replaced or evicted) returns its
        slab slot."""
        if entry.nbytes > self.max_bytes:
            self.rejects += 1
            self._release(entry)
            return False, []
        old = self._entries.pop(digest, None)
        if old is not None:
            self._bytes -= old.nbytes
            self._release(old)
        self._entries[digest] = entry
        self._bytes += entry.nbytes
        self.demotions += 1
        monitor.stat_add("STAT_kv_tier_demotions")
        evicted: List[bytes] = []
        if self._bytes > self.max_bytes:
            keep = set(protect)
            keep.add(digest)
            for d in list(self._entries):
                if self._bytes <= self.max_bytes:
                    break
                if d in keep:
                    continue
                ev = self._entries.pop(d)
                self._bytes -= ev.nbytes
                self._release(ev)
                self.evictions += 1
                monitor.stat_add("STAT_kv_tier_evictions")
                evicted.append(d)
        monitor.stat_set("STAT_kv_tier_host_bytes", self._bytes)
        return True, evicted

    def get(self, digest: bytes) -> Optional[HostEntry]:
        """Entry for `digest` (touches LRU recency) or None."""
        entry = self._entries.get(digest)
        if entry is not None:
            self._entries.move_to_end(digest)
        return entry

    def pop(self, digest: bytes,
            final: bool = False) -> Optional[HostEntry]:
        """Remove and return the entry for `digest` (None if absent).
        Promotion uses move semantics — the host copy leaves the store
        as its content heads back to the device, holding the one-copy
        invariant. `final=True` counts the pop as a tier eviction (a
        cascade drop of an orphaned descendant, or an abandon discard)
        rather than a promotion-side move. The entry's slab slot returns
        now: a caller that reads the entry (a promotion's uploads) does
        so before the step thread takes another slot, and on the card a
        gather into a slot first waits for the uploads still reading
        it."""
        entry = self._entries.pop(digest, None)
        if entry is not None:
            self._bytes -= entry.nbytes
            self._release(entry)
            if final:
                self.evictions += 1
                monitor.stat_add("STAT_kv_tier_evictions")
            monitor.stat_set("STAT_kv_tier_host_bytes", self._bytes)
        return entry

    def note_promotion(self, pages: int) -> None:
        """Count `pages` pages re-uploaded to the device (one
        admission)."""
        self.promotions += int(pages)
        monitor.stat_add("STAT_kv_tier_promotions", int(pages))

    def note_hit(self) -> None:
        """Count one admission that matched >= 1 host-tier page."""
        self.hits += 1
        monitor.stat_add("STAT_kv_tier_hits")

    def note_abandon(self) -> None:
        """Count one promotion abandoned mid-upload (fault / failpoint
        — the admission fell back to cold prefill)."""
        self.abandons += 1
        monitor.stat_add("STAT_kv_tier_abandons")

    # -- read surface (any thread; GIL-atomic reads) -----------------------

    @property
    def host_bytes(self) -> int:
        return self._bytes

    @property
    def slab_bytes(self) -> int:
        """This rank's reserved slab bytes (its heads of each slot under
        tp; `host_bytes` counts the lane's)."""
        return 0 if self._slab is None else self._slab.reserved_bytes

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._entries

    def digests(self) -> List[bytes]:
        """Snapshot of stored digests, LRU-first (tests/bench leak
        accounting)."""
        return list(self._entries)

    def stats(self) -> Dict[str, int]:
        """Scraper-safe snapshot (each field one GIL-atomic read)."""
        return {
            "max_bytes": self.max_bytes,
            "host_bytes": self._bytes,
            "entries": len(self._entries),
            "demotions": self.demotions,
            "promotions": self.promotions,
            "evictions": self.evictions,
            "hits": self.hits,
            "abandons": self.abandons,
            "rejects": self.rejects,
        }
