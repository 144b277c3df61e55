"""Host-side page allocator for the paged KV cache.

Free-list bookkeeping (the device only ever sees the static page pool
and int32 block tables — no dynamic shapes). The scheduler
asks `can_grow`/`grow` before every device step; a refusal means the
request must wait or a running one must be preempted (sched/scheduler.py
policy). Page P-1 is the reserved null page (cache/paged.py) and is
never handed out.

The JAX package also binds a C++ twin of this free list (identical
semantics); the port uses the pure-Python class until that binding is
carried over (ROADMAP.md, PyTorch/CUDA port queue).
"""
from __future__ import annotations

from typing import Dict, List, Optional


class PageAllocator:
    """Free-list allocator over `num_pages` usable pages per slot table."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}  # slot -> page ids, in order

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def pages_needed(self, slot: int, new_length: int) -> int:
        have = len(self._owned.get(slot, ()))
        want = -(-new_length // self.page_size)
        return max(0, want - have)

    def can_grow(self, slot: int, new_length: int) -> bool:
        if new_length > self.max_pages_per_seq * self.page_size:
            return False
        return self.pages_needed(slot, new_length) <= self.free_pages

    # -- mutations ----------------------------------------------------------

    def _take_free(self) -> int:
        """Pop one free page. Subclass hook: PrefixCachingAllocator
        evicts a warm cached page here when the raw free list is dry."""
        return self._free.pop()

    def grow(self, slot: int, new_length: int) -> Optional[List[int]]:
        """Allocate pages so `slot` can hold new_length tokens.

        Returns the newly allocated page ids (possibly empty), or None if
        out of pages / over the per-seq limit — in that case nothing is
        allocated (all-or-nothing).
        """
        if not self.can_grow(slot, new_length):
            return None
        n = self.pages_needed(slot, new_length)
        fresh = [self._take_free() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(fresh)
        return fresh

    def release(self, slot: int) -> List[int]:
        """Free all pages of `slot` (request finished or preempted)."""
        pages = self._owned.pop(slot, [])
        self._free.extend(reversed(pages))
        return pages

    # -- prefix-caching interface (no-op here; cache/prefix.py overrides) ----

    def admit(self, slot: int, tokens, need_len: int) -> Optional[int]:
        """Allocate a fresh slot through need_len tokens; returns the
        number of prompt tokens already cached (always 0 here) or None
        if it cannot fit. PrefixCachingAllocator shares matched pages."""
        return None if self.grow(slot, need_len) is None else 0

    def register(self, slot: int, tokens) -> int:
        """Publish a slot's pages for reuse (no registry here)."""
        return 0


def make_page_allocator(num_pages: int, page_size: int,
                        max_pages_per_seq: int, num_slots: int = 4096):
    """The page allocator for a scheduler: the pure-Python free list
    (the native binding is not carried over yet; `num_slots` keeps the
    JAX factory's signature)."""
    return PageAllocator(num_pages, page_size, max_pages_per_seq)
