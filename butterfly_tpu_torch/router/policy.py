"""Routing policy: prefix-affinity consistent hashing with a
least-outstanding-requests fallback.

Why affinity beats round-robin here: each replica runs a
PrefixCachingAllocator (cache/prefix.py) whose page registry is keyed by
SHA-256 chain hashes over page-sized token blocks. Two requests sharing
a prompt prefix only reuse K/V pages if they land on the SAME replica —
spread them round-robin and every replica pays the full prefill;
concentrate them and one replica serves the shared blocks from HBM
(SGLang-style cache-aware routing). The affinity key is therefore
computed with the very same block hashing (`chain_block_hashes`) the
allocator uses, over the prompt's leading `affinity_blocks` full blocks:
requests agreeing on that many leading blocks — the shared-system-prompt
case — get the same key, regardless of how their tails differ.

The key lands on a consistent-hash ring (vnode-replicated so removal of
one replica only remaps its own arc, keeping every OTHER replica's warm
cache intact). Ring order also provides the deterministic failover
sequence: when the affinity target is saturated, draining, or down, the
request falls back to least-outstanding-requests among the remaining
candidates — cache misses spread by load instead of piling onto one
secondary.

stdlib-only. A copy of butterfly_tpu/router/policy.py.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

from butterfly_tpu_torch.cache.prefix import chain_block_hashes
from butterfly_tpu_torch.router.pool import Replica, ReplicaPool


def affinity_key(tokens: Optional[List[int]], page_size: int,
                 affinity_blocks: int) -> Optional[bytes]:
    """Routing key for a prompt: the chain digest of its leading full
    page-blocks (capped at `affinity_blocks`), or a digest of the raw
    tokens for sub-block prompts. None when there is nothing to hash —
    the caller then routes purely by load."""
    if not tokens:
        return None
    hashes = chain_block_hashes(tokens, page_size, affinity_blocks)
    if hashes:
        return hashes[-1]
    # shorter than one block: still deterministic so identical tiny
    # prompts share a replica (their sub-page K/V can't be shared, but
    # sampler/compile warmth and dedup still benefit)
    return hashlib.sha256(
        b"," .join(b"%d" % t for t in tokens)).digest()


def _point(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over replica ids with virtual nodes."""

    def __init__(self, rids: List[str], vnodes: int = 64):
        points: List[Tuple[int, str]] = []
        for rid in rids:
            for i in range(vnodes):
                points.append((_point(f"{rid}#{i}".encode()), rid))
        points.sort()
        self._points = points

    def ordered(self, key: bytes) -> List[str]:
        """Distinct replica ids in ring order starting at `key`'s
        successor point: element 0 is the affinity target, the rest the
        deterministic failover sequence."""
        if not self._points:
            return []
        import bisect
        start = bisect.bisect_right(self._points,
                                    (int.from_bytes(key[:8], "big"), ""))
        seen, order = set(), []
        n = len(self._points)
        for i in range(n):
            rid = self._points[(start + i) % n][1]
            if rid not in seen:
                seen.add(rid)
                order.append(rid)
        return order


class PrefixAffinityPolicy:
    """Pick an ordered candidate list for one request.

    `plan(tokens)` returns ``(candidates, affinity_rid)``:

    * ``candidates`` — replicas to try in order (the proxy walks this on
      retryable failures); empty means nothing is routable.
    * ``affinity_rid`` — the ring target's id when the FIRST candidate is
      it (i.e. the request is being routed for cache affinity), else
      None. The proxy counts router_affinity_hits_total from this.

    The affinity target leads unless it is saturated (its outstanding
    count reaches `saturate_after`) or not routable; remaining
    candidates follow by least-outstanding.
    """

    def __init__(self, pool: ReplicaPool, page_size: int = 16,
                 affinity_blocks: int = 4, saturate_after: int = 8,
                 vnodes: int = 64):
        self.pool = pool
        self.page_size = page_size
        self.affinity_blocks = affinity_blocks
        self.saturate_after = saturate_after
        self._vnodes = vnodes
        self.ring = HashRing(list(pool.replicas), vnodes=vnodes)

    def rebuild_ring(self) -> None:
        """Re-derive the ring from current pool membership — the fleet
        elasticity hook (autoscaler spawn/retire). Vnode placement is
        deterministic per rid, so surviving replicas keep their arcs
        (consistent hashing's point): only the joined/removed member's
        arcs remap. Atomic swap: plan() readers see old or new ring,
        never a half-built one."""
        self.ring = HashRing(list(self.pool.replicas), vnodes=self._vnodes)

    def plan(self, tokens: Optional[List[int]], role: Optional[str] = None
             ) -> Tuple[List[Replica], Optional[str]]:
        """`role` restricts the candidate pool to one fleet tier
        (pool.candidates(role)); the ring is still walked over ALL
        replica ids, so a tier's affinity arcs stay stable when the
        other tier's membership changes."""
        cands = self.pool.candidates(role)
        if not cands:
            return [], None
        by_load = sorted(cands, key=Replica.load_score)
        key = affinity_key(tokens, self.page_size, self.affinity_blocks)
        if key is None:
            return by_load, None
        by_rid = {r.rid: r for r in cands}
        target = None
        for rid in self.ring.ordered(key):
            r = by_rid.get(rid)
            if r is not None:
                target = r
                break
        if target is None or target.outstanding >= self.saturate_after:
            return by_load, None
        rest = [r for r in by_load if r is not target]
        return [target] + rest, target.rid
