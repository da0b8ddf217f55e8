"""Content-hash prefix cache over the paged KV pools.

Port of `paddle_tpu.serving.prefix_cache`, host demotion tier included.

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

Tiered demotion: with a `HostTier` attached (`attach_tier`), a chain
node has THREE states: device (`page` is a physical page id,
cache-held), host (`page is None`, raw content in the host store under
the node's digest), gone (absent from the index). Eviction *demotes*
instead of discarding: the engine's gather callback copies the page's
raw bytes (and int8 scale rows) off the device into the host store (in
the port, the copies of one eviction pass land together at its end,
through the engine's flush callback), the device page is released and
zeroed as before, and the node survives in the host state. `lookup_tiered` walks THROUGH host nodes; the admission
promotes the matched host run back into fresh device pages via
`consume_promoted`, after which the post-prefill `register` re-creates
the nodes bound to the request's pages. Along any root path states run
device* then host* (demotion takes the deepest device nodes first;
`register` re-binds any host node it walks), so victim selection treats
"no device children" as leaf-ness and host nodes are never victims
themselves. Dropping a host node cascades over its (necessarily host)
descendants: demote-of-demoted is the final eviction.

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
        self.page = page            # physical page id in the pools, or
                                    # None = demoted to the host tier
                                    # (content under `key` in HostTier)
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
        # counted per ADMISSION via note_admitted, never per lookup — a
        # deferred head re-looks-up every engine iteration
        self.hits = 0           # admissions that matched >= 1 cached page
        self.misses = 0         # admissions that matched nothing
        self.hit_tokens = 0     # prompt tokens served from cached pages
        self.evictions = 0      # chain nodes evicted from the device
                                # (LRU; includes demotions: the page
                                # left the device either way)
        # host demotion tier (attach_tier wires all three; None keeps
        # the two-state prefix cache)
        self._tier = None       # serving.kv_tier.HostTier
        self._gather = None     # page -> HostEntry | None
        self._flush = None      # () -> None: lands an eviction pass's
                                # gathers
        self._audit = None      # engine AuditLog (KV_DEMOTE/TIER_EVICT)
        self._protect: set = set()  # digests an in-flight admission
                                    # matched host-side: never tier-evict

    # -- host tier ---------------------------------------------------------

    def attach_tier(self, tier, gather, audit=None, flush=None) -> None:
        """Enable the host demotion tier: `tier` is the bounded
        `HostTier` store, `gather` the engine's off-device page gather
        (`page -> HostEntry` of host tensors, or None when the gather
        failed / the `kv_tier.demote_gather` failpoint fired — the
        eviction then proceeds plain), `audit` the engine's AuditLog
        for KV_DEMOTE / KV_TIER_EVICT events. `flush`, when given, runs
        at the end of every eviction pass (`evict`, and `register`'s
        budget enforcement): a gather may only queue its copy, and the
        pass's copies land in one batch there, before the caller can
        zero or reuse a freed page."""
        self._tier = tier
        self._gather = gather
        self._audit = audit
        self._flush = flush

    def protect(self, digests) -> None:
        """Shield an admission's matched host run from tier eviction
        until `unprotect` — between `lookup_tiered` and
        `consume_promoted` the SAME admission may demote eviction
        victims into the tier, and the LRU must not cannibalize the
        entries it is about to promote."""
        self._protect = set(digests)

    def unprotect(self) -> None:
        self._protect = set()

    def consume_promoted(self, digests: List[bytes]):
        """Move an admission's matched host run out of the tier
        (promotion): pops each digest's `HostEntry` (the admission now
        owns the content — it re-uploads into its own fresh pages) and
        drops the nodes from the index; the chain re-registers bound to
        the request's pages after its prefill, exactly like a fresh
        one. Orphaned host descendants beyond the run cascade out
        (final eviction). Returns `(entries, cascade_dropped)`."""
        entries = [self._tier.pop(d) for d in digests]
        dropped = self._drop_host_node(digests[0], pop_entry=False)
        return entries, dropped

    def _drop_host_node(self, digest: bytes, pop_entry: bool) -> int:
        """Remove one host-state node and every descendant (all host by
        the HBM*-then-host* path invariant), popping their tier entries
        as final evictions; returns how many entries were dropped.
        `pop_entry=False` for a root whose entry the caller already
        consumed (tier LRU eviction / promotion)."""
        dropped = 0
        node = self._nodes.pop(digest, None)
        if pop_entry and self._tier is not None:
            if self._tier.pop(digest, final=True) is not None:
                dropped += 1
        if node is None:
            return dropped
        if node.parent is not None and node.parent in self._nodes:
            self._nodes[node.parent].children.discard(digest)
        for c in list(node.children):
            child = self._nodes.get(c)
            if child is not None and child.page is None:
                dropped += self._drop_host_node(c, pop_entry=True)
        return dropped

    # -- hashing -----------------------------------------------------------

    def digests(self, prompt: np.ndarray) -> List[bytes]:
        """`chain_digests` at this cache's page size — `lookup` and
        `register` key the index through this single implementation."""
        return chain_digests(prompt, self._kv.page_size)

    # -- lookup / register -------------------------------------------------

    def lookup(self, prompt: np.ndarray) -> Tuple[List[bytes], List[int]]:
        """(digests_of_all_full_pages, matched_page_ids): the longest
        cached chain this prompt's leading full pages walk. Touches the
        matched path's LRU clock but counts nothing — the engine calls
        `note_admitted` once per ADMITTED request (a deferred head
        re-looks-up every iteration and must not inflate the hit
        counters). The caller must `pin` the matched pages before any
        eviction can run (a hit is only a plan until the pages are
        referenced)."""
        digests = self.digests(prompt)
        pages: List[int] = []
        tick = next(self._tick)
        for d in digests:
            node = self._nodes.get(d)
            if node is None or node.page is None:
                break   # gone, or demoted to host: not an HBM hit
            node.tick = tick
            pages.append(node.page)
        return digests, pages

    def lookup_tiered(self, prompt: np.ndarray):
        """Promote-aware lookup: like `lookup`, but the walk
        continues THROUGH host-state nodes. Returns
        `(digests, hbm_pages, host_digests)` — the leading HBM run
        (map read-only, as ever) followed by the contiguous host run
        (the admission promotes these via `consume_promoted`), stopping
        at the first gone digest. Same counting contract as `lookup`:
        touches LRU clocks, counts nothing."""
        digests = self.digests(prompt)
        pages: List[int] = []
        host: List[bytes] = []
        tick = next(self._tick)
        for d in digests:
            node = self._nodes.get(d)
            if node is None:
                break
            node.tick = tick
            if node.page is not None:
                if host:
                    break   # HBM after host: impossible by the path
                            # invariant — stop defensively
                pages.append(node.page)
            else:
                if self._tier is None or d not in self._tier:
                    break   # host node without an entry: defensive
                host.append(d)
        return digests, pages, host

    def note_admitted(self, hit_tokens: int, host_tokens: int = 0) -> None:
        """Count one admission's cache outcome: `hit_tokens` prompt
        tokens served from cached pages (0 = a miss), of which
        `host_tokens` came up from the host tier (promotion)."""
        if hit_tokens > 0:
            self.hits += 1
            self.hit_tokens += int(hit_tokens)
            monitor.stat_add("STAT_prefix_hits")
            monitor.stat_add("STAT_prefix_hit_tokens", int(hit_tokens))
        else:
            self.misses += 1
        if host_tokens > 0 and self._tier is not None:
            self._tier.note_hit()

    def register(self, digests: List[bytes], pt_row) -> List[int]:
        """Index a freshly prefilled (or freshly decoded — generated
        suffixes register at completion) sequence's full
        pages (called by the step thread after the K/V landed).
        Existing nodes are touched, new nodes take a cache reference on
        their page (`cache_hold`). A full-match CoW split never
        re-registers: its node already exists and keeps the ORIGINAL
        page — the private copy belongs to the sequence alone.

        With a `max_pages` budget set, registration that pushes the
        cached-page count over it eagerly LRU-evicts OTHER chains back
        to budget (the just-registered chain is excluded — evicting
        what was registered a microsecond ago would be pure thrash).
        Returns the page ids freed by that eviction (refcount hit 0) —
        the engine zeroes them before reuse, exactly the evict()
        contract."""
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
                if node.page is None:
                    # host-state node walked by a fresh prefill (the
                    # admission cold-prefilled past it — e.g. after a
                    # promotion abandon): re-bind to the producer's
                    # page (identical content) and drop the host copy
                    # — at most ONE copy per digest, ever
                    page = int(pt_row[i])
                    self._kv.cache_hold([page])
                    node.page = page
                    if self._tier is not None:
                        self._tier.pop(d)   # content is back in HBM
                    added += 1
                node.tick = tick
            own.append(node.page)
            parent = d
        freed: List[int] = []
        if added and self.max_pages:
            # eager budget enforcement: shrink the CACHED page count
            # back to the cap (a live-shared victim releases the index
            # reference without freeing bytes NOW — it still leaves the
            # budget, and its page returns through the sharer's free)
            refs = self._kv.refcounts()
            exclude = set(own)
            while (len(self._kv.cached_pages()) > self.max_pages
                   and self._nodes):
                victim = self._pick_victim(refs, exclude)
                if victim is None:
                    break
                freed.extend(self._evict_node(victim, refs))
            if self._flush is not None:
                self._flush()
        if added or freed:
            monitor.stat_set("STAT_prefix_cached_pages",
                             len(self._kv.cached_pages()))
        return freed

    # -- eviction ----------------------------------------------------------

    def evict(self, need_pages: int, exclude=()) -> List[int]:
        """Release least-recently-used LEAF chains until `need_pages`
        pages have actually returned to the free list (or nothing more
        can be evicted). Returns the freed page ids — the engine zeroes
        them before reuse (this is the deferred zero-on-free point for
        cached pages).

        Victim policy: prefer leaves whose page ONLY the index holds
        (refcount 1 — the ones that actually free bytes); a leaf a live
        sequence still shares is victimized only when no freeable leaf
        exists, because a refcount-1 ancestor can be blocked behind it
        (children must leave the index before their parent, or the
        survivor would be unreachable from the root). `exclude` pages
        (the admitting request's just-matched — and pinned — chain) are
        never victimized: evicting them would force a needless re-prefill
        and, on a full-prompt match, re-register the chain against the
        CoW private copy."""
        refs = self._kv.refcounts()
        exclude = set(exclude)
        freed: List[int] = []
        while len(freed) < need_pages and self._nodes:
            victim = self._pick_victim(refs, exclude)
            if victim is None:
                break
            freed.extend(self._evict_node(victim, refs))
        if self._flush is not None:
            self._flush()
        monitor.stat_set("STAT_prefix_cached_pages",
                         len(self._kv.cached_pages()))
        return freed

    def _pick_victim(self, refs: Dict[int, int],
                     exclude: set) -> Optional[_Node]:
        """The next LRU LEAF to evict: prefer leaves whose page only
        the index holds (refcount 1 — the ones that actually free
        bytes); fall back to the LRU shared leaf, which frees nothing
        itself but exposes the freeable pages behind it (children must
        leave the index before their parent). None when every leaf is
        excluded. Host-state nodes are never victims (nothing in HBM
        to free) and never BLOCK one either — leaf-ness means "no HBM
        children", so a chain whose tail already demoted keeps
        draining parent-ward."""
        leaves = [n for n in self._nodes.values()
                  if n.page is not None and n.page not in exclude
                  and not any(
                      c is not None and c.page is not None
                      for c in (self._nodes.get(ck)
                                for ck in n.children))]
        if not leaves:
            return None
        victim = min((n for n in leaves if refs.get(n.page) == 1),
                     key=lambda n: n.tick, default=None)
        if victim is None:
            victim = min(leaves, key=lambda n: n.tick)
        return victim

    def _evict_node(self, victim: _Node,
                    refs: Dict[int, int]) -> List[int]:
        """Release one node's HBM page; returns the pages freed NOW
        (refcount 0). With a host tier attached the node DEMOTES —
        content gathered off-device into the store, node survives
        host-state — unless the gather fails (failpoint / reject), in
        which case the node drops exactly as before (and any host
        descendants it stranded cascade out)."""
        page = victim.page
        demoted = False
        if self._tier is not None and self._gather is not None:
            entry = self._gather(page)
            if entry is not None:
                stored, evicted = self._tier.put(
                    victim.key, entry, protect=self._protect)
                if evicted:
                    dropped = 0
                    for d in evicted:
                        dropped += 1
                        dropped += self._drop_host_node(
                            d, pop_entry=False)
                    if self._audit is not None:
                        self._audit.audit("KV_TIER_EVICT", None,
                                          entries=dropped)
                demoted = stored
        if demoted:
            victim.page = None   # node survives, host-state
            if self._audit is not None:
                self._audit.audit("KV_DEMOTE", None, page=page)
        else:
            del self._nodes[victim.key]
            if victim.parent is not None and victim.parent in self._nodes:
                self._nodes[victim.parent].children.discard(victim.key)
            # a failed demotion strands this node's host descendants
            # (unreachable from any future walk): cascade them out
            dropped = 0
            for c in list(victim.children):
                child = self._nodes.get(c)
                if child is not None and child.page is None:
                    dropped += self._drop_host_node(c, pop_entry=True)
            if dropped and self._audit is not None:
                self._audit.audit("KV_TIER_EVICT", None, entries=dropped)
        out = self._kv.cache_release([page])
        refs.pop(page, None)
        self.evictions += 1
        monitor.stat_add("STAT_prefix_evictions")
        return out

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    def stats(self) -> dict:
        """Scraper-safe snapshot (counters are GIL-atomic ints)."""
        out = {
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
            # host tier — zeros when no tier is attached so
            # report tooling reads one shape either way
            "tier_enabled": self._tier is not None,
            "host_bytes": 0,
            "rank_slab_bytes": 0,
            "host_entries": 0,
            "host_nodes": 0,
            "demotions": 0,
            "promotions": 0,
            "tier_hits": 0,
            "tier_evictions": 0,
            "tier_abandons": 0,
            "tier_hit_rate": 0.0,
        }
        if self._tier is not None:
            t = self._tier.stats()
            out["host_bytes"] = t["host_bytes"]
            out["rank_slab_bytes"] = self._tier.slab_bytes
            out["host_entries"] = t["entries"]
            out["host_nodes"] = sum(
                1 for n in list(self._nodes.values()) if n.page is None)
            out["demotions"] = t["demotions"]
            out["promotions"] = t["promotions"]
            out["tier_hits"] = t["hits"]
            out["tier_evictions"] = t["evictions"]
            out["tier_abandons"] = t["abandons"]
            out["tier_hit_rate"] = round(
                t["hits"] / max(1, self.hits + self.misses), 4)
        return out
