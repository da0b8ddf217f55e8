"""Content-hash prefix cache over the paged KV pools.

Port of `paddle_tpu.serving.prefix_cache` without the host demotion tier
(`attach_tier`, `protect`, `consume_promoted`, `lookup_tiered` and the
host-node state), which comes with the host KV tier.

Chat and agent traffic is many requests sharing one system prompt;
without reuse every request prefills it from scratch. Already-computed
prompt K/V is indexed by a **content-hash block chain**: one node per
FULL page of prompt tokens, keyed by `blake2b(parent_digest +
page_token_ids)`, so a chain digest commits to every token before it and
two prompts share cached pages exactly as far as their token streams
agree. A request whose prompt walks the chain maps those pages READ-ONLY
(`PagedKVCache.alloc_shared`) and prefills only the tail; copy-on-write
covers the one divergent write (a full-prompt match must recompute its
last position's logits, so the page holding it is split private before
the tail prefill writes through it).

Ownership (the refcounts live in `kv_cache.py`):

- Registration (`register`, after a successful prefill) takes a cache
  reference on each full prompt page (`cache_hold`): the chain survives
  its producer sequence's free, content kept, not zeroed (zero-on-free
  defers until refcount 0).
- A chain page shared by live sequences is not reclaimable; once only the
  index holds it (refcount 1) it is *evictable* and counts toward
  `can_admit`/`headroom`.
- Eviction (`evict`, called by the engine BEFORE alloc when the free list
  alone is short) walks least-recently-used LEAF nodes, children before
  parents, so a surviving node is always reachable from the root. Pages
  freed NOW (refcount 0) are returned for the engine's zero-on-free;
  pages a live sequence still shares zero later through its free.

Single writer: the engine's step thread owns every mutation; `stats()`
reads snapshots for scraper threads.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..framework import monitor
from ..framework.flags import flag
from .kv_cache import PagedKVCache

__all__ = ["PrefixCache", "chain_digests"]

_ROOT = b"paged-prefix-root"


def chain_digests(token_ids, page_size: int) -> List[bytes]:
    """The blake2b chain digests of every FULL page of `token_ids`:
    digest i commits to tokens [0, (i+1)*page_size), so equal digests
    mean equal token streams up to that page boundary. Content only (the
    tokens as int32 bytes), byte-equal to the JAX package's, so a prompt
    hashes the same in both packages and on every replica."""
    P = int(page_size)
    toks = np.ascontiguousarray(np.asarray(token_ids, np.int32))
    out, parent = [], _ROOT
    for i in range(int(toks.size) // P):
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(toks[i * P:(i + 1) * P].tobytes())
        parent = h.digest()
        out.append(parent)
    return out


class _Node:
    """One full prompt page in the chain tree."""

    __slots__ = ("key", "parent", "page", "children", "tick")

    def __init__(self, key: bytes, parent: Optional[bytes], page: int,
                 tick: int):
        self.key = key
        self.parent = parent        # parent digest (None at depth 0)
        self.page = page            # physical page id in the pools
        self.children: set = set()  # child digests
        self.tick = tick            # LRU clock (max of hits on the path)


class PrefixCache:
    """Block-chain index of cached prompt-prefix pages for ONE engine's
    `PagedKVCache` (the engine's step thread is the only writer)."""

    def __init__(self, kv: PagedKVCache, engine: str = "generation",
                 max_pages: Optional[int] = None):
        self._kv = kv
        self.engine = engine
        self._nodes: Dict[bytes, _Node] = {}
        self._tick = itertools.count(1)
        # page-count budget: register() evicts eagerly back to it, so the
        # index cannot grow without bound between admissions that happen
        # to run short of free pages; 0/None = evict on demand only
        self.max_pages = int(flag("FLAGS_gen_prefix_cache_max_pages")
                             if max_pages is None else max_pages)
        # counted per ADMISSION via note_admitted, never per lookup: a
        # deferred head looks up again every engine iteration
        self.hits = 0           # admissions that matched >= 1 cached page
        self.misses = 0         # admissions that matched nothing
        self.hit_tokens = 0     # prompt tokens served from cached pages
        self.evictions = 0      # chain nodes evicted (LRU)

    def digests(self, prompt) -> List[bytes]:
        """`chain_digests` at this cache's page size."""
        return chain_digests(prompt, self._kv.page_size)

    # -- lookup / register -------------------------------------------------

    def lookup(self, prompt) -> Tuple[List[bytes], List[int]]:
        """(digests_of_all_full_pages, matched_page_ids): the longest
        cached chain this prompt's leading full pages walk. Touches the
        matched path's LRU clock but counts nothing (the engine calls
        `note_admitted` once per admitted request). The caller must `pin`
        the matched pages before any eviction can run."""
        digests = self.digests(prompt)
        pages: List[int] = []
        tick = next(self._tick)
        for d in digests:
            node = self._nodes.get(d)
            if node is None:
                break
            node.tick = tick
            pages.append(node.page)
        return digests, pages

    def note_admitted(self, hit_tokens: int) -> None:
        """Count one admission's outcome: `hit_tokens` prompt tokens
        served from cached pages (0 = a miss)."""
        if hit_tokens > 0:
            self.hits += 1
            self.hit_tokens += int(hit_tokens)
            monitor.stat_add("STAT_prefix_hits")
            monitor.stat_add("STAT_prefix_hit_tokens", int(hit_tokens))
        else:
            self.misses += 1

    def register(self, digests: List[bytes], pt_row) -> List[int]:
        """Index a freshly prefilled (or, at completion, decoded)
        sequence's full pages, after their K/V landed. Existing nodes are
        touched; new nodes take a cache reference on their page. A
        full-match CoW split never re-registers: its node already exists
        and keeps the ORIGINAL page.

        With a `max_pages` budget, registration that pushes the cached
        page count over it eagerly LRU-evicts OTHER chains back to budget
        (the chain just registered is excluded). Returns the page ids
        that eviction freed (refcount 0), for the engine to zero."""
        added = 0
        tick = next(self._tick)
        parent: Optional[bytes] = None
        own: List[int] = []
        for i, d in enumerate(digests):
            node = self._nodes.get(d)
            if node is None:
                page = int(pt_row[i])
                self._kv.cache_hold([page])
                node = _Node(d, parent, page, tick)
                self._nodes[d] = node
                if parent is not None and parent in self._nodes:
                    self._nodes[parent].children.add(d)
                added += 1
            else:
                node.tick = tick
            own.append(node.page)
            parent = d
        freed: List[int] = []
        if added and self.max_pages:
            # a live-shared victim releases the index reference without
            # freeing bytes now; it still leaves the budget, and its page
            # returns through the sharer's free
            refs = self._kv.refcounts()
            exclude = set(own)
            while (len(self._kv.cached_pages()) > self.max_pages
                   and self._nodes):
                victim = self._pick_victim(refs, exclude)
                if victim is None:
                    break
                freed.extend(self._evict_node(victim, refs))
        if added or freed:
            monitor.stat_set("STAT_prefix_cached_pages",
                             len(self._kv.cached_pages()))
        return freed

    # -- eviction ----------------------------------------------------------

    def evict(self, need_pages: int, exclude=()) -> List[int]:
        """Release least-recently-used LEAF chains until `need_pages`
        pages have returned to the free list (or nothing more can be
        evicted). Returns the freed page ids, which the engine zeroes
        before reuse. `exclude` pages (the admitting request's matched,
        pinned chain) are never victims."""
        refs = self._kv.refcounts()
        exclude = set(exclude)
        freed: List[int] = []
        while len(freed) < need_pages and self._nodes:
            victim = self._pick_victim(refs, exclude)
            if victim is None:
                break
            freed.extend(self._evict_node(victim, refs))
        monitor.stat_set("STAT_prefix_cached_pages",
                         len(self._kv.cached_pages()))
        return freed

    def _pick_victim(self, refs: Dict[int, int],
                     exclude: set) -> Optional[_Node]:
        """The next LRU LEAF to evict: prefer leaves whose page only the
        index holds (refcount 1, the ones that free bytes); else the LRU
        shared leaf, which frees nothing itself but exposes the freeable
        pages behind it (children leave the index before their parent).
        None when every leaf is excluded."""
        leaves = [n for n in self._nodes.values()
                  if n.page not in exclude
                  and not any(c in self._nodes for c in n.children)]
        if not leaves:
            return None
        victim = min((n for n in leaves if refs.get(n.page) == 1),
                     key=lambda n: n.tick, default=None)
        if victim is None:
            victim = min(leaves, key=lambda n: n.tick)
        return victim

    def _evict_node(self, victim: _Node,
                    refs: Dict[int, int]) -> List[int]:
        """Drop one node and its index reference; returns the pages
        freed NOW (refcount 0)."""
        del self._nodes[victim.key]
        if victim.parent is not None and victim.parent in self._nodes:
            self._nodes[victim.parent].children.discard(victim.key)
        out = self._kv.cache_release([victim.page])
        refs.pop(victim.page, None)
        self.evictions += 1
        monitor.stat_add("STAT_prefix_evictions")
        return out

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    def stats(self) -> dict:
        """Snapshot for `GenerationEngine.stats()["kv"]["prefix"]`."""
        return {
            "enabled": True,
            "engine": self.engine,
            "max_pages": self.max_pages,
            "nodes": len(self._nodes),
            "cached_pages": len(self._kv.cached_pages()),
            "evictable_pages": self._kv.evictable_pages,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
        }
