"""KV pools for continuous batching: contiguous slots and paged blocks.

Counterparts of ``repro.serve.kv_pool.SlotKVPool`` and of the core of
``repro.serve.kv_pool.PagedKVPool``.

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
are only ever read masked).

Bookkeeping (slots, pages, refcounts, lengths, task ids, block tables) is
host-side numpy, mutated between device steps; the device holds only the
caches, which the model's steps and the prefill installs write in place.
Besides free and mapped, a page of the paged pool can be seized (fault
injection takes it off the free list for a while) or quarantined (a
poisoned request's pages, held off the free list until released).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.kernels.decode_attention import round_kv_len


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
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        self.cur_len[slot] = 0
        self.task_id[slot] = 0
        self._free.append(slot)

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


class PagedKVPool:
    """``num_blocks`` counts physical pages including scratch page 0, so
    usable capacity is ``(num_blocks - 1) * block_size`` tokens.
    ``num_slots`` bounds the batch width. Pages carry refcounts (holders
    per page); in this port every mapped page has exactly one holder, as
    page sharing (fork, prefix cache) is not ported yet."""

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
        self.peak_pages = 0                 # high-water blocks_in_use

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

    def can_claim(self, npages: int, reserve: int = 0) -> bool:
        """True when ``npages`` pages can be claimed while leaving at least
        ``reserve`` free (chunked admission reserves one append page per
        running decode row, so a prompt's claim never starves decode)."""
        return len(self._free_blocks) >= npages + reserve

    # ------------------------------------------------------------------
    # slot and page lifecycle
    # ------------------------------------------------------------------
    def _note_peak(self) -> None:
        self.peak_pages = max(self.peak_pages, self.blocks_in_use())

    def alloc(self, task_id: int = 0, npages: int = 0) -> Optional[int]:
        """Claim a slot plus ``npages`` pages (None if either is short)."""
        assert npages <= self.max_pages, (
            f"{npages} pages exceeds max_len ({self.max_pages} pages)")
        if not self._free_slots or len(self._free_blocks) < npages:
            return None
        slot = self._free_slots.pop()
        self._used_slots.add(slot)
        self.task_id[slot] = task_id
        self.cur_len[slot] = 0
        pages = [self._free_blocks.pop() for _ in range(npages)]
        self._pages[slot] = pages
        self._refs[pages] = 1
        self.block_tables[slot, :npages] = pages
        self._note_peak()
        return slot

    def ensure_append_page(self, slot: int) -> bool:
        """Map the page holding depth ``cur_len[slot]``, the next decode
        append. Returns False when the pool is out of pages: the caller
        must preempt someone."""
        need = int(self.cur_len[slot]) // self.block_size
        pages = self._pages[slot]
        if need < len(pages):
            return True
        assert need == len(pages), "append skipped a page"
        if not self._free_blocks:
            return False
        page = self._free_blocks.pop()
        self._refs[page] = 1
        pages.append(page)
        self.block_tables[slot, need] = page
        self._note_peak()
        return True

    def seize_pages(self, n: int) -> List[int]:
        """Fault injection: pull up to ``n`` pages off the free list, so
        the pool looks exhausted to the scheduler (admission backpressure,
        preemption, prefill aborts run for real). Seized pages are never
        mapped; :meth:`restore_pages` gives them back, and until then
        :meth:`leak_report` lists them."""
        take = min(max(n, 0), len(self._free_blocks))
        pages = [self._free_blocks.pop() for _ in range(take)]
        self._seized.update(pages)
        return pages

    def restore_pages(self, pages: List[int]) -> None:
        """Return pages taken by :meth:`seize_pages` to the free list."""
        for p in pages:
            if p not in self._seized:
                raise ValueError(f"page {p} was not seized")
            self._seized.remove(p)
            self._free_blocks.append(p)

    def _release_slot(self, slot: int, hold: Optional[Set[int]]) -> int:
        """Unmap ``slot``; each page it was the last holder of goes to the
        free list, or into ``hold`` when given. Returns those pages' count."""
        if slot not in self._used_slots:
            raise ValueError(f"slot {slot} is not allocated")
        self._used_slots.remove(slot)
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
        self._release_slot(slot, None)

    def quarantine_slot(self, slot: int) -> int:
        """:meth:`free` for a poisoned request (non-finite logits): the slot
        returns to the free list, but the pages it held go to a quarantine
        hold, never handed out again until :meth:`release_quarantined` (the
        scheduler's shutdown calls it), so the K/V that gave the bad logits
        stays readable. Returns the number of pages held."""
        return self._release_slot(slot, self._quarantined)

    def release_quarantined(self) -> int:
        """Return every quarantined page to the free list; returns how
        many. Their stale K/V is harmless: a new holder writes each row
        before any read of it, and reads past a row's length are masked."""
        n = len(self._quarantined)
        self._free_blocks.extend(sorted(self._quarantined, reverse=True))
        self._quarantined.clear()
        return n

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
        refcount equals the number of slots mapping it; pages partition
        into free, mapped, seized and quarantined (scratch page 0
        excluded). Quarantined pages are accounted, not a finding; pages
        still seized are one (a fault plan must restore them). Returns
        findings (empty = clean)."""
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
        if not np.array_equal(refs, self._refs):
            off = np.nonzero(refs != self._refs)[0]
            bad.append(f"page refcounts out of sync at pages {off.tolist()}")
        mapped = {p for pages in self._pages.values() for p in pages}
        if fb & mapped:
            bad.append(f"pages both free and mapped: {sorted(fb & mapped)}")
        seized, held = self._seized, self._quarantined
        if seized & (fb | mapped):
            bad.append(f"seized pages also free or mapped: "
                       f"{sorted(seized & (fb | mapped))}")
        if held & (fb | mapped | seized):
            bad.append(f"quarantined pages also free, mapped or seized: "
                       f"{sorted(held & (fb | mapped | seized))}")
        if seized:
            bad.append(f"pages still seized by fault injection: "
                       f"{sorted(seized)}")
        leaked = set(range(1, self.num_blocks)) - (fb | mapped | seized | held)
        if leaked:
            bad.append(f"leaked pages (neither free, mapped nor "
                       f"quarantined): {sorted(leaked)}")
        return bad
