"""KV pools for continuous batching: contiguous slots and paged blocks.

Counterparts of ``repro.serve.kv_pool.SlotKVPool``, ``PagedKVPool`` and
``PrefixCache``.

``SlotKVPool`` owns one contiguous model cache ``(L, num_slots, S, kvh,
hd)`` plus per-slot lengths, task ids and a free list: admitting a request
copies its prefilled cache into its slot, and decode appends happen in the
model's decode step, which writes each slot's new KV row at that slot's own
depth.

``PagedKVPool`` keeps a global pool of ``block_size``-token pages plus
per-slot block tables. Memory is claimed page by page as requests deepen,
so capacity is bounded by tokens in flight, not ``num_slots * max_len``.
Page 0 is a reserved scratch page: dead padding tokens of the mixed step
write their KV there and unmapped block-table entries point at it (they
are only ever read masked). Pages are refcounted, so holders can share
them: :meth:`PagedKVPool.fork` (one prefill, n samples), the
:class:`PrefixCache` (finished requests' prompt pages, reused across
requests of the same task) and :meth:`PagedKVPool.compact` (duplicate
prompt pages folded together). A shared page is copied before any write
into it (copy-on-write in :meth:`PagedKVPool.ensure_append_page`).

Bookkeeping (slots, pages, refcounts, lengths, task ids, block tables,
cache entries) is host-side numpy and Python, mutated between device
steps; the device holds only the caches, which the model's steps, the
prefill installs and the copy-on-write copies write in place. Besides
free and mapped, a page of the paged pool can be cache-retained, seized
(fault injection takes it off the free list for a while) or quarantined
(a poisoned request's pages, held off the free list until released).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.kernels.decode_attention import round_kv_len


def chain_keys(task_id: int, toks, block_size: int,
               nblocks: int) -> List[bytes]:
    """Chained blake2b page keys of a task's token prefix:
    ``key_0 = H(task_id ‖ tokens[0:bs])``,
    ``key_i = H(key_{i-1} ‖ tokens[i·bs:(i+1)·bs])``, as the reference
    computes them. Equal keys mean an equal (task, token prefix); with the
    per-task bias independent of position, that means equal page contents
    (bitwise where the prefill computes each row the same way)."""
    toks = np.asarray(toks, np.int32)
    prev = b"task:%d" % task_id
    keys: List[bytes] = []
    for i in range(nblocks):
        block = toks[i * block_size:(i + 1) * block_size].tobytes()
        prev = hashlib.blake2b(prev + block, digest_size=16).digest()
        keys.append(prev)
    return keys


def _free_slot_findings(free_list, used, num_slots, cur_len) -> List[str]:
    """Slots partition into free and used, and free slots are empty."""
    bad: List[str] = []
    free = set(free_list)
    if len(free_list) != len(free):
        bad.append("duplicate slots on free list")
    both = free & used
    if both:
        bad.append(f"slots both free and used: {sorted(both)}")
    lost = set(range(num_slots)) - (free | used)
    if lost:
        bad.append(f"lost slots (neither free nor used): {sorted(lost)}")
    deep = [s for s in sorted(free) if cur_len[s] != 0]
    if deep:
        bad.append(f"freed slots with nonzero length: {deep}")
    return bad


class SlotKVPool:
    """Fixed-capacity slotted decode cache shared by all in-flight
    requests: slot ``s`` owns rows ``[:, s]`` of the contiguous cache."""

    def __init__(self, model, num_slots: int, max_len: int):
        self.num_slots = num_slots
        self.max_len = max_len
        # rounded as the reference rounds; rows past max_len stay masked
        self.alloc_len = round_kv_len(max_len)
        self.cache = model.init_cache(num_slots, self.alloc_len)
        self.cur_len = np.zeros(num_slots, np.int32)
        self.task_id = np.zeros(num_slots, np.int32)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._used: Set[int] = set()
        self._m = None                      # obs instruments, if attached

    def attach_metrics(self, registry) -> None:
        """The slot-occupancy gauge (the contiguous layout has no pages)."""
        self._m = {"slots_used": registry.gauge(
            "kv_slots_used", "occupied decode slots")}
        self._gauge_sync()

    def _gauge_sync(self) -> None:
        if self._m is not None:
            self._m["slots_used"].set(len(self._used))

    def has_free(self) -> bool:
        return bool(self._free)

    def alloc(self, task_id: int = 0) -> Optional[int]:
        """Claim a slot (None when full); cur_len is 0 until the prefill."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._used.add(slot)
        self.task_id[slot] = task_id
        self.cur_len[slot] = 0
        self._gauge_sync()
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        self.cur_len[slot] = 0
        self.task_id[slot] = 0
        self._free.append(slot)
        self._gauge_sync()

    def write_prefill(self, slot: int, req_cache, length: int) -> None:
        """Copy a request's batch-1 prefill cache ``{"k", "v"}: (L, 1, S,
        kvh, hd)`` into its slot, in place, at rows ``[0, S)``. ``length``
        real prompt tokens become visible; rows past it (bucket padding)
        stay masked by ``cur_len`` until decode overwrites them."""
        if length > self.max_len:
            raise ValueError(f"prompt length {length} exceeds pool max_len "
                             f"{self.max_len}")
        for name, c in req_cache.items():
            self.cache[name][:, slot, :c.shape[2]] = c[:, 0]
        self.cur_len[slot] = length

    def advance(self, slots) -> None:
        """Record one decode append for each slot in ``slots``."""
        for s in slots:
            self.cur_len[s] += 1

    def leak_report(self) -> List[str]:
        """Invariant sweep: every slot exactly one of free / used, free
        slots empty. Returns findings (empty = clean)."""
        return _free_slot_findings(self._free, self._used, self.num_slots,
                                   self.cur_len)


@dataclass
class _PrefixEntry:
    """One cached full page of prompt KV, addressed by its chained key.
    ``parent`` is the entry one block earlier in the same prefix (None for
    block 0), ``children`` the reverse edges. Only childless entries are
    evicted, so the cache always holds chains contiguous from block 0."""
    key: bytes
    page: int
    depth: int                          # block index within the prefix
    parent: Optional[bytes] = None
    pins: int = 0                       # live slots matched through it
    children: Set[bytes] = field(default_factory=set)


class PrefixCache:
    """Cross-request shared-prefix page cache over a :class:`PagedKVPool`.

    Many requests of one task open with the same system prompt, and equal
    (task, prefix) pairs give equal KV pages. A finishing request's full
    prompt pages are retained here (the cache holds one refcount on each,
    like a phantom slot); admission maps a new request's longest matching
    run of full pages into its block table and starts its chunked prefill
    at the first uncached token. Keys are :func:`chain_keys` (the task id
    in the root). Capacity is ``capacity`` entries (pages), with LRU
    eviction of childless, unpinned entries: an entry matched by a live
    slot is pinned until that slot frees. Eviction drops the cache's
    refcount; the page returns to the free list only when no slot maps it.
    """

    def __init__(self, pool: "PagedKVPool", capacity: int):
        assert capacity >= 1, capacity
        self.pool = pool
        self.capacity = capacity
        self.block_size = pool.block_size
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self._slot_pins: Dict[int, List[bytes]] = {}    # slot -> pinned keys
        self.hits = 0                   # admissions that matched >= 1 page
        self.misses = 0                 # admissions that matched nothing
        self.hit_tokens = 0             # prefill tokens skipped by matches
        self.retained_pages = 0         # entries ever inserted
        self.evicted_pages = 0          # entries ever evicted
        self._m = None                  # obs instruments, if attached

    def match(self, task_id: int, toks) -> List[bytes]:
        """Keys of the longest cached run of full pages prefixing ``toks``
        (block 0 first), at most ``(len(toks) - 1) // block_size`` of them:
        the last prefill token is always recomputed, as its logits seed
        the first decode step. Each matched entry gets an LRU touch."""
        limit = (len(toks) - 1) // self.block_size
        keys: List[bytes] = []
        for key in chain_keys(task_id, toks, self.block_size, limit):
            if key not in self._entries:
                break
            keys.append(key)
        for key in keys:
            self._entries.move_to_end(key)
        return keys

    def pages(self, keys: Sequence[bytes]) -> List[int]:
        return [self._entries[k].page for k in keys]

    def record_lookup(self, matched_tokens: int) -> None:
        """Hit / miss accounting, one call per admission."""
        if matched_tokens > 0:
            self.hits += 1
            self.hit_tokens += matched_tokens
            if self._m is not None:
                self._m["hits"].inc()
                self._m["hit_tokens"].inc(matched_tokens)
        else:
            self.misses += 1
            if self._m is not None:
                self._m["misses"].inc()

    def retain(self, task_id: int, prompt, slot: int) -> int:
        """Retain a finishing slot's full prompt pages: one cache refcount
        per newly cached page, entries keyed by the prompt's chain.
        Already-cached keys get an LRU touch, not a new page (the first
        page to carry a prefix stays). Over capacity the coldest unpinned
        leaf outside this chain is evicted; if none is, the chain stops
        there. Returns the number of pages newly retained."""
        nfull = len(prompt) // self.block_size
        if nfull == 0:
            return 0
        pages = self.pool._pages[slot]
        keys = chain_keys(task_id, prompt, self.block_size, nfull)
        protect = set(keys)
        parent: Optional[bytes] = None
        added = 0
        for i, key in enumerate(keys):
            if key in self._entries:
                self._entries.move_to_end(key)
                parent = key
                continue
            if len(self._entries) >= self.capacity and \
                    not self._evict_lru(protect=protect):
                break
            page = pages[i]
            self._entries[key] = _PrefixEntry(key=key, page=page, depth=i,
                                              parent=parent)
            self.pool._refs[page] += 1
            if parent is not None:
                self._entries[parent].children.add(key)
            parent = key
            added += 1
        if added:
            self.retained_pages += added
            if self._m is not None:
                self._m["retained"].inc(added)
            self._gauge_sync()
        return added

    def pin(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            self._entries[k].pins += 1

    def unpin(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            self._entries[k].pins -= 1

    def bind_slot(self, slot: int, keys: Sequence[bytes]) -> None:
        """Record already-pinned ``keys`` against ``slot``, so that the
        pool releases the pins however the slot is torn down."""
        self._slot_pins[slot] = list(keys)

    def release_slot(self, slot: int) -> None:
        keys = self._slot_pins.pop(slot, None)
        if keys:
            self.unpin(keys)
            self._gauge_sync()

    def _evict_lru(self, protect: Optional[Set[bytes]] = None) -> bool:
        """Evict the least recently used childless, unpinned entry outside
        ``protect``. False when nothing is evictable."""
        for key, ent in self._entries.items():
            if ent.pins or ent.children or (protect and key in protect):
                continue
            self._evict_entry(key)
            return True
        return False

    def _evict_entry(self, key: bytes) -> None:
        ent = self._entries.pop(key)
        assert not ent.pins and not ent.children, "evicted a live entry"
        if ent.parent is not None:
            parent = self._entries.get(ent.parent)
            if parent is not None:
                parent.children.discard(key)
        pool = self.pool
        pool._refs[ent.page] -= 1
        if pool._refs[ent.page] == 0:
            pool._free_blocks.append(ent.page)
            if pool._m is not None:
                pool._m["freed"].inc()
        self.evicted_pages += 1
        if self._m is not None:
            self._m["evicted"].inc()
        self._gauge_sync()

    def reclaim(self, npages: int) -> bool:
        """Evict until the free list holds ``npages`` pages, or nothing
        more is evictable (False). Evicting an entry that a slot still maps
        frees no page but may unlock its parent, so the loop goes on while
        eviction makes any progress."""
        while len(self.pool._free_blocks) < npages:
            if not self._evict_lru():
                return False
        return True

    def evictable_free(self, exclude: Sequence[bytes] = ()) -> int:
        """Pages that eviction could return to the free list now, treating
        ``exclude`` as pinned (admission passes a hit's own keys, which it
        is about to pin). An entry is removable when it and every
        descendant are unpinned and not excluded; it frees a page only
        when the cache holds that page's last reference."""
        excl = set(exclude)
        removable: Dict[bytes, bool] = {}
        ents = sorted(self._entries.values(), key=lambda e: -e.depth)
        for ent in ents:                # children are deeper: done first
            removable[ent.key] = (
                ent.pins == 0 and ent.key not in excl
                and all(removable[c] for c in ent.children))
        return sum(1 for ent in ents
                   if removable[ent.key] and self.pool._refs[ent.page] == 1)

    def flush(self) -> int:
        """Evict every evictable entry (drain, shutdown); returns the pages
        returned to the free list. Pinned entries survive."""
        before = len(self.pool._free_blocks)
        while self._evict_lru():
            pass
        return len(self.pool._free_blocks) - before

    def __len__(self) -> int:
        return len(self._entries)

    def pinned_entries(self) -> int:
        return sum(1 for e in self._entries.values() if e.pins)

    def attach_metrics(self, registry) -> None:
        """The cache's instruments, under the reference's names."""
        self._m = {
            "hits": registry.counter(
                "prefix_cache_hits_total",
                "admissions that mapped >= 1 cached prefix page"),
            "misses": registry.counter(
                "prefix_cache_misses_total",
                "admissions that matched no cached prefix"),
            "hit_tokens": registry.counter(
                "prefix_cache_hit_tokens_total",
                "prefill tokens skipped via cached prefix pages"),
            "retained": registry.counter(
                "prefix_cache_retained_pages_total",
                "prompt pages retained at request finish"),
            "evicted": registry.counter(
                "prefix_cache_evicted_pages_total",
                "cache entries evicted (LRU or reclaim)"),
            "entries": registry.gauge(
                "prefix_cache_pages", "cached prefix pages right now"),
            "pinned": registry.gauge(
                "prefix_cache_pinned", "cache entries pinned by live slots"),
        }
        self._gauge_sync()

    def _gauge_sync(self) -> None:
        self.pool._gauge_sync()
        if self._m is not None:
            self._m["entries"].set(len(self._entries))
            self._m["pinned"].set(self.pinned_entries())


class PagedKVPool:
    """``num_blocks`` counts physical pages including scratch page 0, so
    usable capacity is ``(num_blocks - 1) * block_size`` tokens.
    ``num_slots`` bounds the batch width.

    Pages carry refcounts, the number of their holders: each slot that
    maps the page, plus one when the prefix cache retains it. :meth:`fork`
    claims a slot whose block table aliases every page of another (n > 1
    samples share one prefill); :meth:`alloc_cached` maps cached prefix
    pages into a new slot; :meth:`compact` folds duplicate prompt pages of
    running slots together. A page below a slot's depth is append-only
    history, the same for every holder, so reads never copy; the first
    append into a shared page copies it to a fresh one first
    (:meth:`ensure_append_page`), so that a tick never writes a page with
    more than one holder (checked before every dispatch by
    ``models.model.check_write_exclusive``). :meth:`free` drops the slot's
    refcounts and returns only pages that reach zero."""

    def __init__(self, model, num_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None):
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_pages = -(-max_len // block_size)
        if num_blocks is None:      # capacity parity with a contiguous pool
            num_blocks = num_slots * self.max_pages + 1
        assert num_blocks >= self.max_pages + 1, (
            f"num_blocks {num_blocks} cannot hold even one max_len request "
            f"({self.max_pages} pages + scratch)")
        self.num_blocks = num_blocks
        self.cache = model.init_paged_cache(num_blocks, block_size)
        self.block_tables = np.zeros((num_slots, self.max_pages), np.int32)
        self.cur_len = np.zeros(num_slots, np.int32)
        self.task_id = np.zeros(num_slots, np.int32)
        self._free_slots: List[int] = list(range(num_slots - 1, -1, -1))
        self._used_slots: Set[int] = set()
        self._free_blocks: List[int] = list(range(num_blocks - 1, 0, -1))
        self._pages: Dict[int, List[int]] = {}
        self._refs = np.zeros(num_blocks, np.int32)  # holders per page
        self._seized: Set[int] = set()      # pages held by fault injection
        self._quarantined: Set[int] = set()  # poisoned pages held back
        self.quarantined_pages_total = 0    # pages ever moved to the hold
        self.peak_pages = 0                 # high-water blocks_in_use
        self.forks = 0                      # slots claimed by fork()
        self.cow_copies = 0                 # shared pages copied on append
        self.compactions = 0                # compact() calls that freed pages
        self.pages_deduped = 0              # pages freed by compact()
        self.prefix_cache: Optional[PrefixCache] = None
        self._m = None                      # obs instruments, if attached

    def enable_prefix_cache(self, capacity: int) -> PrefixCache:
        """Layer a :class:`PrefixCache` of ``capacity`` pages over this
        pool's free list (before :meth:`attach_metrics`, so that the
        cache's instruments register with the pool's)."""
        assert self.prefix_cache is None, "prefix cache already enabled"
        self.prefix_cache = PrefixCache(self, capacity)
        return self.prefix_cache

    # ------------------------------------------------------------------
    # observability: page-lifecycle counters and pressure gauges
    # ------------------------------------------------------------------
    def attach_metrics(self, registry) -> None:
        """Register the pool's instruments (the reference's names) on an
        obs registry. They read host bookkeeping only."""
        self._m = {
            "claimed": registry.counter(
                "kv_pages_claimed_total", "pages taken off the free list"),
            "freed": registry.counter(
                "kv_pages_freed_total", "pages returned to the free list"),
            "forks": registry.counter(
                "kv_forks_total", "COW slot forks (n>1 sampling)"),
            "cow": registry.counter(
                "kv_cow_copies_total", "shared tail pages copied on first "
                "divergent append"),
            "free": registry.gauge("kv_pages_free", "free pages right now"),
            "used": registry.gauge("kv_pages_used", "mapped pages right now"),
            "peak": registry.gauge("kv_pages_peak", "high-water mapped pages"),
            "refs": registry.gauge(
                "kv_page_refs_max", "max sharers of any one page"),
            "slots_used": registry.gauge(
                "kv_slots_used", "occupied decode slots"),
            "quarantined_total": registry.counter(
                "kv_pages_quarantined_total",
                "poisoned pages moved to the quarantine hold"),
            "quarantined": registry.gauge(
                "kv_pages_quarantined", "pages in the quarantine hold now"),
            "compactions": registry.counter(
                "kv_compactions_total",
                "defrag passes that freed at least one page"),
            "deduped": registry.counter(
                "kv_pages_deduped_total",
                "duplicate prompt pages freed by compaction"),
        }
        if self.prefix_cache is not None:
            self.prefix_cache.attach_metrics(registry)
        self._gauge_sync()

    def _gauge_sync(self) -> None:
        """Raise ``peak_pages`` and, with metrics attached, set the
        gauges (where the reference syncs, so the values agree)."""
        used = self.blocks_in_use()
        self.peak_pages = max(self.peak_pages, used)
        m = self._m
        if m is None:
            return
        m["free"].set(len(self._free_blocks))
        m["used"].set(used)
        m["peak"].set_max(used)
        m["refs"].set(int(self._refs.max()))
        m["slots_used"].set(len(self._used_slots))
        m["quarantined"].set(len(self._quarantined))

    # ------------------------------------------------------------------
    # capacity queries
    # ------------------------------------------------------------------
    def has_free(self) -> bool:
        return bool(self._free_slots)

    def free_blocks(self) -> int:
        return len(self._free_blocks)

    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free_blocks)

    def num_seized(self) -> int:
        """Pages currently held by fault injection (:meth:`seize_pages`)."""
        return len(self._seized)

    def num_quarantined(self) -> int:
        """Pages in the quarantine hold (:meth:`quarantine_slot`)."""
        return len(self._quarantined)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_claim(self, npages: int, reserve: int = 0,
                  exclude_keys: Sequence[bytes] = ()) -> bool:
        """True when ``npages`` pages can be claimed while leaving at least
        ``reserve`` free (chunked admission reserves one append page per
        running decode row, so a prompt's claim never starves decode).
        Pages the prefix cache could free by eviction count, as claims
        evict on demand, except those of ``exclude_keys``: the entries a
        prefix hit is about to pin."""
        avail = len(self._free_blocks)
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_free(exclude=exclude_keys)
        return avail >= npages + reserve

    # ------------------------------------------------------------------
    # slot and page lifecycle
    # ------------------------------------------------------------------
    def _reclaim(self, npages: int) -> bool:
        """Ensure ``npages`` pages on the free list, evicting cold cache
        entries if needed; False when even eviction cannot."""
        if len(self._free_blocks) >= npages:
            return True
        if self.prefix_cache is None:
            return False
        return self.prefix_cache.reclaim(npages)

    def _claim_slot(self, task_id: int, pages: List[int]) -> int:
        slot = self._free_slots.pop()
        self._used_slots.add(slot)
        self.task_id[slot] = task_id
        self.cur_len[slot] = 0
        self._pages[slot] = pages
        self.block_tables[slot, :len(pages)] = pages
        return slot

    def alloc(self, task_id: int = 0, npages: int = 0) -> Optional[int]:
        """Claim a slot plus ``npages`` pages (None if either is short,
        after evicting cold cache entries)."""
        assert npages <= self.max_pages, (
            f"{npages} pages exceeds max_len ({self.max_pages} pages)")
        if not self._free_slots or not self._reclaim(npages):
            return None
        pages = [self._free_blocks.pop() for _ in range(npages)]
        self._refs[pages] = 1
        slot = self._claim_slot(task_id, pages)
        if self._m is not None:
            self._m["claimed"].inc(npages)
        self._gauge_sync()
        return slot

    def alloc_cached(self, task_id: int, keys: Sequence[bytes],
                     npages_total: int) -> Optional[int]:
        """Claim a slot whose leading pages alias the prefix-cache entries
        ``keys`` (a refcount each), plus fresh pages up to
        ``npages_total``. The entries stay pinned until the slot frees, so
        eviction never takes a prefix from a live request. None when no
        slot is free or the fresh pages cannot be claimed even after
        eviction."""
        cache = self.prefix_cache
        assert cache is not None and keys, "alloc_cached needs a cache hit"
        npages_new = npages_total - len(keys)
        assert 0 <= npages_new and npages_total <= self.max_pages
        if not self._free_slots:
            return None
        cache.pin(keys)         # freeze the hit before evicting for the claim
        if not self._reclaim(npages_new):
            cache.unpin(keys)
            return None
        shared = cache.pages(keys)
        for p in shared:
            self._refs[p] += 1
        fresh = [self._free_blocks.pop() for _ in range(npages_new)]
        self._refs[fresh] = 1
        slot = self._claim_slot(task_id, shared + fresh)
        cache.bind_slot(slot, keys)
        if self._m is not None:
            self._m["claimed"].inc(npages_new)
        cache._gauge_sync()
        return slot

    def fork(self, slot: int) -> Optional[int]:
        """Claim a new slot sharing every page of ``slot`` (a refcount
        each, no copy), with its depth and task. The first append into a
        shared page on either side copies it (:meth:`ensure_append_page`).
        None when no slot is free."""
        if slot not in self._used_slots:
            raise ValueError(f"slot {slot} is not allocated")
        if not self._free_slots:
            return None
        pages = list(self._pages[slot])
        for p in pages:
            self._refs[p] += 1
        new = self._claim_slot(int(self.task_id[slot]), pages)
        self.block_tables[new] = self.block_tables[slot]
        self.cur_len[new] = self.cur_len[slot]
        self.forks += 1
        if self._m is not None:
            self._m["forks"].inc()
        self._gauge_sync()
        return new

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` into ``dst`` on every layer's K and V, in
        place, on the current stream (before the tick that appends)."""
        for pool in self.cache.values():    # (L, num_blocks, bs, kvh, hd)
            pool[:, dst].copy_(pool[:, src])

    def ensure_append_page(self, slot: int) -> bool:
        """Map, and hold alone, the page of depth ``cur_len[slot]``: the
        next decode append. A page with other holders is first copied to
        a fresh page (copy-on-write); the last holder writes in place.
        False when the pool is out of pages, even after evicting cache
        entries: the caller must preempt someone."""
        need = int(self.cur_len[slot]) // self.block_size
        pages = self._pages[slot]
        if need < len(pages):
            page = pages[need]
            if self._refs[page] == 1:
                return True
            if not self._reclaim(1):    # the copy needs a destination
                return False
            new = self._free_blocks.pop()
            self._copy_page(page, new)
            self._refs[page] -= 1
            self._refs[new] = 1
            pages[need] = new
            self.block_tables[slot, need] = new
            self.cow_copies += 1
            if self._m is not None:
                self._m["cow"].inc()
                self._m["claimed"].inc()
            self._gauge_sync()
            return True
        assert need == len(pages), "append skipped a page"
        if not self._reclaim(1):
            return False
        page = self._free_blocks.pop()
        self._refs[page] = 1
        pages.append(page)
        self.block_tables[slot, need] = page
        if self._m is not None:
            self._m["claimed"].inc()
        self._gauge_sync()
        return True

    def seize_pages(self, n: int) -> List[int]:
        """Fault injection: pull up to ``n`` pages off the free list, so
        the pool looks exhausted to the scheduler (admission backpressure,
        preemption, prefill aborts run for real). Cache entries are not
        evicted for it. Seized pages are never mapped; :meth:`restore_pages`
        gives them back, and until then :meth:`leak_report` lists them."""
        take = min(max(n, 0), len(self._free_blocks))
        pages = [self._free_blocks.pop() for _ in range(take)]
        self._seized.update(pages)
        self._gauge_sync()
        return pages

    def restore_pages(self, pages: List[int]) -> None:
        """Return pages taken by :meth:`seize_pages` to the free list."""
        for p in pages:
            if p not in self._seized:
                raise ValueError(f"page {p} was not seized")
            self._seized.remove(p)
            self._free_blocks.append(p)
        self._gauge_sync()

    def flush_prefix_cache(self) -> int:
        """Evict every evictable cache entry; returns the pages released
        to the free list (0 without a cache)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.flush()

    def _release_slot(self, slot: int, hold: Optional[Set[int]]) -> int:
        """Unmap ``slot`` and release its cache pins; each page it was the
        last holder of goes to the free list, or into ``hold`` when given.
        Returns those pages' count."""
        if slot not in self._used_slots:
            raise ValueError(f"slot {slot} is not allocated")
        self._used_slots.remove(slot)
        if self.prefix_cache is not None:
            self.prefix_cache.release_slot(slot)
        released = 0
        for page in reversed(self._pages.pop(slot)):
            self._refs[page] -= 1
            if self._refs[page] == 0:
                if hold is None:
                    self._free_blocks.append(page)
                else:
                    hold.add(page)
                released += 1
        self.block_tables[slot] = 0
        self.cur_len[slot] = 0
        self.task_id[slot] = 0
        self._free_slots.append(slot)
        return released

    def free(self, slot: int) -> None:
        returned = self._release_slot(slot, None)
        if self._m is not None:
            self._m["freed"].inc(returned)
        self._gauge_sync()

    def quarantine_slot(self, slot: int) -> int:
        """:meth:`free` for a poisoned request (non-finite logits): the slot
        returns to the free list, but the pages it held alone go to a
        quarantine hold, never handed out again until
        :meth:`release_quarantined` (the scheduler's shutdown calls it), so
        the K/V that gave the bad logits stays readable. Pages still shared
        with other slots or the cache only drop this slot's refcount.
        Returns the number of pages held."""
        held = self._release_slot(slot, self._quarantined)
        self.quarantined_pages_total += held
        if self._m is not None:
            self._m["quarantined_total"].inc(held)
        self._gauge_sync()
        return held

    def release_quarantined(self) -> int:
        """Return every quarantined page to the free list; returns how
        many. Their stale K/V is harmless: a new holder writes each row
        before any read of it, and reads past a row's length are masked."""
        n = len(self._quarantined)
        self._free_blocks.extend(sorted(self._quarantined, reverse=True))
        self._quarantined.clear()
        if self._m is not None and n:
            self._m["freed"].inc(n)
        self._gauge_sync()
        return n

    def compact(self, slot_prompts: Dict[int, object]) -> int:
        """Deduplicate equal full prompt pages across running slots by
        remapping block tables (host bookkeeping only), so that duplicate
        prompts give pages back without a preemption.

        ``slot_prompts`` maps each candidate slot to its request's prompt.
        Callers pass only slots whose prompt is resident (decode rows),
        never a slot mid-prefill. Pages below a slot's append page are
        never written again, equal chained keys stand for equal contents,
        and every later append goes through :meth:`ensure_append_page`,
        which copies a shared page first. Cache entries seed the canonical
        owner of each key, so duplicates fold into cached pages first.
        Returns the pages returned to the free list."""
        owner: Dict[bytes, int] = {}
        if self.prefix_cache is not None:
            for ent in self.prefix_cache._entries.values():
                owner[ent.key] = ent.page
        freed = 0
        for slot in sorted(slot_prompts):
            if slot not in self._used_slots:
                continue
            prompt = np.asarray(slot_prompts[slot])
            # never the page that decode appends into
            nfull = min(len(prompt) // self.block_size,
                        int(self.cur_len[slot]) // self.block_size,
                        len(self._pages[slot]))
            if nfull <= 0:
                continue
            keys = chain_keys(int(self.task_id[slot]), prompt,
                              self.block_size, nfull)
            pages = self._pages[slot]
            for i, key in enumerate(keys):
                page = pages[i]
                canon = owner.setdefault(key, page)
                if canon == page:
                    continue
                self._refs[canon] += 1
                self._refs[page] -= 1
                if self._refs[page] == 0:
                    self._free_blocks.append(page)
                    freed += 1
                pages[i] = canon
                self.block_tables[slot, i] = canon
        if freed:
            self.compactions += 1
            self.pages_deduped += freed
            if self._m is not None:
                self._m["compactions"].inc()
                self._m["deduped"].inc(freed)
                self._m["freed"].inc(freed)
            self._gauge_sync()
        return freed

    def write_prefill(self, slot: int, req_cache, length: int) -> None:
        """Scatter a request's batch-1 contiguous prefill cache ``{"k",
        "v"}: (L, 1, S, kvh, hd)`` into the slot's mapped pages, in place.
        ``length`` is the number of real prompt tokens; the slot must
        already hold ``pages_needed(length)`` pages (admission claims
        them)."""
        if length > self.max_len:
            raise ValueError(f"prompt length {length} exceeds pool max_len "
                             f"{self.max_len}")
        npages = self.pages_needed(length)
        pages = self._pages[slot][:npages]
        assert len(pages) == npages, (
            f"slot {slot}: {len(self._pages[slot])} pages mapped, prefill "
            f"needs {npages}")
        need = npages * self.block_size
        for name, c in req_cache.items():
            pool = self.cache[name]           # (L, num_blocks, bs, kvh, hd)
            rows = c[:, 0, :need]
            if rows.shape[1] < need:    # the tail page runs past the cache
                rows = torch.nn.functional.pad(
                    rows, (0, 0, 0, 0, 0, need - rows.shape[1]))
            idx = torch.as_tensor(pages, dtype=torch.long, device=pool.device)
            pool.index_copy_(1, idx, rows.reshape(
                (rows.shape[0], npages, self.block_size) + rows.shape[2:]))
        self.cur_len[slot] = length

    def commit_prefill(self, slot: int, length: int) -> None:
        """Publish a prefill whose KV the mixed step already wrote into
        this slot's mapped pages: bookkeeping only."""
        if length > self.max_len:
            raise ValueError(f"prompt length {length} exceeds pool max_len "
                             f"{self.max_len}")
        assert len(self._pages[slot]) >= self.pages_needed(length), (
            f"slot {slot}: {len(self._pages[slot])} pages mapped, prefill "
            f"wrote {length} tokens")
        self.cur_len[slot] = length

    def advance(self, slots) -> None:
        """Record one decode append for each slot in ``slots``."""
        for s in slots:
            self.cur_len[s] += 1

    # ------------------------------------------------------------------
    def leak_report(self) -> List[str]:
        """Invariant sweep: slots partition into free and used; each page's
        refcount equals its holders (the slots mapping it, plus one if the
        cache retains it); cache chains are contiguous and pin counts match
        the slots' bindings; pages partition into free, mapped, seized,
        cache-retained and quarantined (scratch page 0 excluded).
        Cache-retained and quarantined pages are accounted, not a finding
        (a warm cache at drain is by design); pages still seized are one
        (a fault plan must restore them). The findings' wording is the
        reference's. Returns findings (empty = clean)."""
        bad = _free_slot_findings(self._free_slots, self._used_slots,
                                  self.num_slots, self.cur_len)
        if set(self._pages) != self._used_slots:
            bad.append("page map out of sync with used slots: "
                       f"{sorted(set(self._pages) ^ self._used_slots)}")
        fb = set(self._free_blocks)
        if len(self._free_blocks) != len(fb):
            bad.append("duplicate pages on free list")
        if 0 in fb:
            bad.append("scratch page 0 leaked onto the free list")
        refs = np.zeros(self.num_blocks, np.int32)
        for slot, pages in self._pages.items():
            ps = set(pages)
            if len(pages) != len(ps):
                bad.append(f"slot {slot} double-mapped a page")
            if 0 in ps:
                bad.append(f"slot {slot} mapped the scratch page")
            if len(pages) < self.pages_needed(int(self.cur_len[slot])):
                bad.append(f"slot {slot} is deeper than its mapped pages")
            refs[pages] += 1
        cached: Set[int] = set()
        cache = self.prefix_cache
        if cache is not None:
            ents = list(cache._entries.values())
            cpages = [e.page for e in ents]
            cached = set(cpages)
            if len(cpages) != len(cached):
                bad.append("prefix cache retained the same page twice")
            if 0 in cached:
                bad.append("prefix cache retained the scratch page")
            refs[cpages] += 1   # the cache's own hold on each page
            for e in ents:
                if e.parent is not None and e.parent not in cache._entries:
                    bad.append(f"prefix cache chain broken at depth "
                               f"{e.depth} (parent entry evicted under a "
                               "child)")
            pins: Dict[bytes, int] = {}
            for keys in cache._slot_pins.values():
                for k in keys:
                    pins[k] = pins.get(k, 0) + 1
            if any(e.pins != pins.get(e.key, 0) for e in ents):
                bad.append("prefix cache pin counts out of sync with slot "
                           "bindings")
            stray = set(cache._slot_pins) - self._used_slots
            if stray:
                bad.append(f"prefix cache pins held by freed slots: "
                           f"{sorted(stray)}")
        if not np.array_equal(refs, self._refs):
            off = np.nonzero(refs != self._refs)[0]
            bad.append(f"page refcounts out of sync at pages {off.tolist()}")
        mapped = {p for pages in self._pages.values() for p in pages}
        if fb & mapped:
            bad.append(f"pages both free and mapped: {sorted(fb & mapped)}")
        if fb & cached:
            bad.append(f"pages both free and cache-retained: "
                       f"{sorted(fb & cached)}")
        seized, held = self._seized, self._quarantined
        if seized & (fb | mapped | cached):
            bad.append(f"seized pages also free, mapped, or cached: "
                       f"{sorted(seized & (fb | mapped | cached))}")
        if held & (fb | mapped | cached | seized):
            bad.append(f"quarantined pages also free, mapped, cached, or "
                       f"seized: "
                       f"{sorted(held & (fb | mapped | cached | seized))}")
        if seized:
            bad.append(f"pages still seized by fault injection: "
                       f"{sorted(seized)}")
        leaked = set(range(1, self.num_blocks)) - (
            fb | mapped | seized | cached | held)
        if leaked:
            bad.append(f"leaked pages (neither free, mapped, "
                       f"cache-retained, nor quarantined): {sorted(leaked)}")
        return bad
