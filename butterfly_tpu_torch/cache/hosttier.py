"""Host-RAM KV tier: chain-hash-addressed page store behind eviction.

The port of butterfly_tpu/cache/hosttier.py. One host representation
throughout: page bytes are CPU tensors in the pool's own dtype (bf16
included, which numpy cannot hold), exactly what the engine's
`read_pages` returns and `write_pages` takes.

The prefix cache (cache/prefix.py) recycles warm pages when the free
list runs dry — before this tier, recycling DROPPED the page contents,
so a cold chain's next admission paid its full prefill again. The tier
turns that drop into a demotion: the scheduler's evict hook reads the
page to the host (`engine.read_pages` — the same gather the
cross-replica export uses) and parks the bytes here, keyed by the very
chain digest the registry was keyed by. On the next prefix hit against
that digest the scheduler's reviver pulls the bytes back
(`engine.write_pages` into a freshly claimed page) and the admission
proceeds as a normal prefix-cache hit — the Mooncake-style second
cache tier, host DRAM under device memory.

Addressing is identical to fleet/kvtransfer.py — SHA-256 chain digests
over page-sized token blocks — so the tier also serves as an export
source: a decode replica asking /kv/pages for a chain this replica
evicted still gets the bytes (export_payload continues the leading run
from the tier when the device registry misses).

Capacity is byte-bounded with LRU demotion. An optional spill
directory turns the LRU drop into a disk demotion (one ``.pt`` file per
page, written by torch.save) so the tier degrades cold-to-disk instead
of cold-to-gone; spilled entries promote back to RAM on access.
Correctness never depends on the tier holding anything: a miss just
means the admission prefills the uncovered tail itself.

Thread-safe: one lock around the index. Device I/O never happens in
here — callers (the scheduler's hooks) read/write pages themselves and
hand this module CPU tensors only — so the lock never nests with the
serving lock's device work.

stdlib + torch (CPU tensors) only.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

#: (k, v, k_scale, v_scale) CPU tensors in the engine.read_pages per-page
#: layout: k/v [L, Kv, page, H] in the pool's dtype; scales [L, Kv*page]
#: f32 iff the pool is int8, else None.
PageData = Tuple[torch.Tensor, torch.Tensor,
                 Optional[torch.Tensor], Optional[torch.Tensor]]


def _nbytes(data: PageData) -> int:
    return sum(a.nbytes for a in data if a is not None)


def _host_copy(a) -> Optional[torch.Tensor]:
    """A contiguous CPU copy (callers hand views into a larger gather)."""
    if a is None:
        return None
    return torch.as_tensor(a).to("cpu").clone(
        memory_format=torch.contiguous_format)


class HostKVTier:
    """Byte-bounded LRU store of evicted KV pages, chain-digest keyed."""

    def __init__(self, capacity_bytes: int,
                 spill_dir: Optional[str] = None):
        if capacity_bytes <= 0:
            raise ValueError("host KV tier needs a positive capacity")
        self.capacity_bytes = capacity_bytes
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        # digest -> PageData (RAM-resident), LRU order: oldest first
        self._ram: "OrderedDict[bytes, PageData]" = OrderedDict()
        # digest -> .pt path (disk-resident); plain dict, no LRU — disk
        # is the terminal tier and is not capacity-managed here
        self._disk: Dict[bytes, str] = {}
        self.bytes_used = 0
        # monotonic stats the scheduler's kv_tier_* metrics read
        self.saves = 0       # pages parked (evict hook)
        self.restores = 0    # pages handed back (reviver / export)
        self.misses = 0      # lookups that found nothing anywhere
        self.spills = 0      # RAM -> disk demotions
        self.drops = 0       # pages lost at capacity (no spill dir)

    # -- internals (lock held) ----------------------------------------------

    def _spill_path(self, h: bytes) -> str:
        return os.path.join(self.spill_dir, h.hex() + ".pt")

    def _demote_oldest(self) -> None:
        h, data = self._ram.popitem(last=False)
        self.bytes_used -= _nbytes(data)
        if self.spill_dir is None:
            self.drops += 1
            return
        arrays = {"k": data[0], "v": data[1]}
        if data[2] is not None:
            arrays["k_scale"], arrays["v_scale"] = data[2], data[3]
        try:
            torch.save(arrays, self._spill_path(h))
            self._disk[h] = self._spill_path(h)
            self.spills += 1
        except OSError:
            self.drops += 1  # disk full/unwritable: degrade to a drop

    def _load_spilled(self, h: bytes) -> Optional[PageData]:
        path = self._disk.get(h)
        if path is None:
            return None
        try:
            z = torch.load(path, map_location="cpu", weights_only=True)
            data = (z["k"], z["v"], z.get("k_scale"), z.get("v_scale"))
        except (OSError, KeyError, ValueError, RuntimeError):
            del self._disk[h]  # corrupt/vanished spill: forget it
            return None
        return data

    # -- the tier surface ----------------------------------------------------

    def save(self, h: bytes, k: torch.Tensor, v: torch.Tensor,
             k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None) -> None:
        """Park one evicted page's host bytes under chain digest `h`.
        Tensors are copied to the host (callers hand views into a larger
        gather); re-saving a digest refreshes its LRU position."""
        data: PageData = (_host_copy(k), _host_copy(v), _host_copy(k_scale),
                          _host_copy(v_scale))
        with self._lock:
            old = self._ram.pop(h, None)
            if old is not None:
                self.bytes_used -= _nbytes(old)
            self._ram[h] = data
            self.bytes_used += _nbytes(data)
            self.saves += 1
            while self.bytes_used > self.capacity_bytes and \
                    len(self._ram) > 1:
                self._demote_oldest()

    def load(self, h: bytes) -> Optional[PageData]:
        """Page bytes for digest `h`, or None (a counted miss). A hit
        refreshes LRU position; a spilled entry promotes back to RAM."""
        with self._lock:
            data = self._ram.pop(h, None)
            if data is not None:
                self._ram[h] = data  # refresh: newest at the end
                self.restores += 1
                return data
            data = self._load_spilled(h)
            if data is None:
                self.misses += 1
                return None
            # promote to RAM: the copy here is authoritative again, so
            # the spill file goes away rather than rotting stale
            path = self._disk.pop(h)
            try:
                os.unlink(path)
            except OSError:
                pass
            self._ram[h] = data
            self.bytes_used += _nbytes(data)
            while self.bytes_used > self.capacity_bytes and \
                    len(self._ram) > 1:
                self._demote_oldest()
            self.restores += 1
            return data

    def contains(self, h: bytes) -> bool:
        """Membership without touching LRU order or the stats."""
        with self._lock:
            return h in self._ram or h in self._disk

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": float(len(self._ram)),
                "spilled_entries": float(len(self._disk)),
                "bytes": float(self.bytes_used),
                "capacity_bytes": float(self.capacity_bytes),
                "saves": float(self.saves),
                "restores": float(self.restores),
                "misses": float(self.misses),
                "spills": float(self.spills),
                "drops": float(self.drops),
            }
