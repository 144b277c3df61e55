"""Automatic prefix caching: content-addressed KV page reuse.

A copy of butterfly_tpu/cache/prefix.py (stdlib only; the port imports
nothing of the JAX package). The semantics follow the public vLLM
"automatic prefix caching" design:

* Every FULL page of a finished/running sequence is registered in a
  host-side registry keyed by a rolling content hash over the token
  chain (page i's key commits to all tokens of pages 0..i, so a hash
  hit implies the whole prefix matches).
* Admission walks the new request's prompt page-by-page through the
  registry; matched pages are attached to the slot read-only (the
  request's first private page starts after them) and their tokens are
  skipped entirely — the engine's warm-prefill path continues from
  `start = cached_tokens` against K/V that is already in device memory.
* Pages are refcounted. A registered page with refcount 0 stays warm
  in an LRU "evictable" list and is only recycled when the free list
  runs dry, so `free_pages` counts it as available; a hit on an
  evictable page revives it at zero cost.

Device-side invariant that makes read-only sharing safe: writes land
at absolute positions >= the writer's `start`, and a matched prefix is
always a whole number of pages, so a sharing slot never scatters into
a shared page (its first write position opens its first private page).
The match is additionally capped at len(tokens)-1 so at least one real
token remains to produce last-token logits.

Interface-compatible with cache.allocator.PageAllocator (grow/release/
pages_of/can_grow/free_pages) plus `admit` and `register`; the
scheduler talks to either through the same calls.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set

from butterfly_tpu_torch.cache.allocator import PageAllocator


def chain_block_hashes(tokens: List[int], page_size: int,
                       max_pages: Optional[int] = None) -> List[bytes]:
    """SHA-256 chain digests, one per FULL page-sized block of `tokens`.

    Block i's digest commits to all tokens of blocks 0..i, so equality of
    digest i implies the whole leading prefix matches. Cryptographic, NOT
    Python hash(): token ids are client-controlled (/generate accepts raw
    id lists), and a constructible collision would silently alias another
    prefix — in the allocator that means attaching another request's K/V
    pages (cross-request output leakage), in the router it means
    steerable affinity placement.

    The keys of PrefixCachingAllocator's page registry, of the host KV
    tier and of the KV transfer payloads; the JAX package's router hashes
    blocks the same way for prefix affinity, so its placement lines up
    with where cached pages live.
    """
    ps = page_size
    n = len(tokens) // ps
    if max_pages is not None:
        n = min(n, max_pages)
    hashes: List[bytes] = []
    h = b""
    for i in range(n):
        m = hashlib.sha256(h)
        m.update(b",".join(b"%d" % t for t in tokens[i * ps:(i + 1) * ps]))
        h = m.digest()
        hashes.append(h)
    return hashes


class PrefixCachingAllocator(PageAllocator):
    """PageAllocator plus content-hash prefix reuse.

    Inherits the free-list bookkeeping and query surface (pages_of /
    pages_needed / can_grow — the latter reads the overridden
    `free_pages`, which counts warm evictable pages as available);
    overrides the mutation surface for refcounts and LRU eviction.
    """

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int):
        super().__init__(num_pages, page_size, max_pages_per_seq)
        self._slot_ref: Dict[int, Set[int]] = {}  # slot -> refcounted subset
        self._entries: Dict[bytes, int] = {}      # chain digest -> page id
        self._page_hash: Dict[int, bytes] = {}    # page id -> chain digest
        self._ref: Dict[int, int] = {}            # page id -> refcount
        self._evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        self.hit_tokens = 0      # stats: prompt tokens served from cache
        self.lookup_tokens = 0   # stats: prompt tokens looked up
        # Host-tier hooks (cache/hosttier.py wiring), opt-in with the
        # scheduler's attribute-is-None contract:
        # * on_evict(chain_digest, page_id) fires as a registered page
        #   is recycled, AFTER deregistration and BEFORE the page id
        #   returns to the free list — the one moment the device bytes
        #   are both stable (registered pages are content-immutable)
        #   and about to be lost. The hook must not re-enter this
        #   allocator; failures are swallowed (the tier is best-effort
        #   — losing a demotion costs a future prefill, never
        #   correctness).
        # * reviver(chain_digest) -> page_id|None fires on a registry
        #   miss during admission's prefix walk: a tier hit claims a
        #   page via import_page, lands the bytes, and returns the page
        #   id so the walk continues as if the page had stayed warm.
        self.on_evict = None
        self.reviver = None

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Pages available right now: truly free + warm-but-unreferenced."""
        return len(self._free) + len(self._evictable)

    # -- registry internals --------------------------------------------------

    def _chain_hashes(self, tokens: List[int], max_pages: int) -> List[bytes]:
        """Registry keys: the shared chain_block_hashes at page size."""
        return chain_block_hashes(tokens, self.page_size, max_pages)

    def _evict_one(self) -> None:
        pid, _ = self._evictable.popitem(last=False)  # oldest first
        h = self._page_hash.pop(pid)
        del self._entries[h]
        del self._ref[pid]
        if self.on_evict is not None:
            try:
                self.on_evict(h, pid)
            except Exception:
                pass  # demotion is best-effort; eviction must proceed
        self._free.append(pid)

    def _take_free(self) -> int:
        if not self._free:
            self._evict_one()
        return self._free.pop()

    def _incref(self, pid: int) -> None:
        self._ref[pid] += 1
        self._evictable.pop(pid, None)

    def _decref(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._evictable[pid] = None  # newest at the end

    # -- mutations ----------------------------------------------------------

    def admit(self, slot: int, tokens: List[int],
              need_len: int) -> Optional[int]:
        """Attach the longest registered prefix of `tokens` to the fresh
        slot, then allocate private pages through `need_len` tokens.
        Returns the number of prompt tokens already in cache (0 if no
        hit), or None if the request cannot fit (nothing is allocated).
        """
        assert slot not in self._owned, "admit() requires an empty slot"
        if need_len > self.max_pages_per_seq * self.page_size:
            return None
        ps = self.page_size
        # cap: leave >= 1 token to prefill so last-token logits exist
        matchable = (len(tokens) - 1) // ps
        matched: List[int] = []
        for h in self._chain_hashes(tokens, matchable):
            pid = self._entries.get(h)
            if pid is None and self.reviver is not None:
                # registry miss: give the host tier a chance to revive
                # the chain's next page (import_page + a device write on
                # the scheduler side). The revive may itself evict — the
                # inline incref below is what keeps THIS chain's earlier
                # matches off the evictable list while that happens.
                pid = self.reviver(h)
            if pid is None:
                break
            # incref BEFORE counting availability: a matched page may
            # sit in the evictable list, and it must count as held, not
            # as free.
            self._incref(pid)
            matched.append(pid)
        want = -(-need_len // ps) - len(matched)
        if want > len(self._free) + len(self._evictable):
            for pid in matched:  # rollback, nothing allocated
                self._decref(pid)
            return None
        # stats only for admissions that actually happen: the scheduler
        # retries a refused head-of-queue request every tick, and those
        # retries must not inflate the hit rate
        self.lookup_tokens += len(tokens)
        self.hit_tokens += len(matched) * ps
        self._owned[slot] = list(matched)
        self._slot_ref[slot] = set(matched)
        fresh = [self._take_free() for _ in range(max(0, want))]
        self._owned[slot].extend(fresh)
        return len(matched) * ps

    def register(self, slot: int, tokens: List[int]) -> int:
        """Publish `slot`'s full pages holding `tokens` into the registry
        so future admissions can share them. `tokens` must be exactly the
        tokens whose K/V the device has written for this slot (callers
        pass the written prefix, which can trail all_tokens by one: the
        latest sampled token's K/V lands on the *next* decode step).
        Returns the number of newly registered pages."""
        pages = self._owned.get(slot, ())
        refset = self._slot_ref.setdefault(slot, set())
        new = 0
        for i, h in enumerate(self._chain_hashes(tokens, len(pages))):
            pid = pages[i]
            if pid in refset:
                continue  # already shared/registered under this chain
            if h in self._entries or pid in self._page_hash:
                # content already cached via another page (duplicate
                # prompt completed concurrently) — keep the existing
                # entry; this slot's copy stays private
                continue
            self._entries[h] = pid
            self._page_hash[pid] = h
            self._ref[pid] = 1  # the slot's own reference
            refset.add(pid)
            new += 1
        return new

    def release(self, slot: int) -> List[int]:
        """Return `slot`'s pages: refcounted ones are decref'd (staying
        warm for future hits), private ones go back to the free list."""
        pages = self._owned.pop(slot, [])
        refset = self._slot_ref.pop(slot, set())
        freed = []
        for pid in reversed(pages):
            if pid in refset:
                self._decref(pid)
            else:
                self._free.append(pid)
                freed.append(pid)
        return freed

    # -- cross-replica transfer (fleet/kvtransfer.py) ------------------------

    def lookup(self, h: bytes) -> Optional[int]:
        """Registered page id for a chain digest, or None. The export
        path resolves the requester's hash chain page-by-page; the
        leading matched run is what ships (pages after a gap could
        never be attached by `admit`, which stops at the first miss)."""
        return self._entries.get(h)

    def pin(self, pids: List[int]) -> None:
        """Hold pages against eviction/recycling while their contents
        are read out for a cross-replica transfer. Refcount-based, so a
        pinned warm page leaves the evictable list exactly like a page
        attached to a slot; callers MUST unpin in a finally block —
        transfer pins are transient and are not slot holders, so
        check_invariants only balances once they are released."""
        for pid in pids:
            self._incref(pid)

    def unpin(self, pids: List[int]) -> None:
        for pid in pids:
            self._decref(pid)

    def import_page(self, h: bytes) -> Optional[int]:
        """Claim a page for externally produced K/V content keyed by
        chain digest `h` and register it warm (refcount 0, evictable —
        exactly the state a released registered page sits in, so a
        later `admit` revives it as a normal prefix hit). Returns the
        page id the caller must now write the K/V bytes into, None if
        the digest is already cached (idempotent re-import), and raises
        MemoryError when every page is held by a live slot. Import in
        chain order: on MemoryError the pages already landed form a
        leading run, which is the only shape `admit` can use."""
        if h in self._entries:
            return None
        if not self._free and not self._evictable:
            raise MemoryError("no free or evictable pages for KV import")
        pid = self._take_free()
        self._entries[h] = pid
        self._page_hash[pid] = h
        self._ref[pid] = 0
        self._evictable[pid] = None
        return pid

    # -- diagnostics ---------------------------------------------------------

    def check_invariants(self) -> None:
        """Every page is in exactly one place; refcounts match holders."""
        seen: Dict[int, str] = {}

        def claim(pid, where):
            assert pid not in seen or (
                where == "shared" and seen[pid] == "shared"), \
                f"page {pid} in {seen.get(pid)} and {where}"
            seen[pid] = where

        for pid in self._free:
            claim(pid, "free")
        counts: Dict[int, int] = {}
        for slot, pages in self._owned.items():
            refset = self._slot_ref.get(slot, set())
            for pid in pages:
                if pid in refset:
                    claim(pid, "shared")
                    counts[pid] = counts.get(pid, 0) + 1
                else:
                    claim(pid, "private")
        for pid in self._evictable:
            claim(pid, "shared")
        for pid, rc in self._ref.items():
            assert rc == counts.get(pid, 0), \
                f"page {pid} refcount {rc} != holders {counts.get(pid, 0)}"
            assert (rc == 0) == (pid in self._evictable)
            assert pid in self._page_hash
        assert len(seen) == self.num_pages, \
            f"{len(seen)} pages accounted, expected {self.num_pages}"
