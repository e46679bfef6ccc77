"""Device-resident pool of warm H-states, keyed by graph version and
personalization cluster (the port's copy of ``repro.serving.pool``).

The §2.2 residual identity ``F' = B' − H + P·H`` makes *any* held H a
valid warm start, and the closer H's provenance is to the incoming RHS
the smaller |F'| — so the pool keys on ``(store_version,
personalization-cluster)``: requests of the same family re-enter the
lane loop with most of their diffusion already banked, while a graph
delta bumps ``store_version`` and every pre-delta entry *naturally
misses* — the staleness discipline of a checkpoint's version guard,
applied to pooled fluid instead of persisted fluid.

Entries hold device tensors (each a lane's H column, cloned when its
lane retires); nothing round-trips through host numpy on the hit path.
Capacity is bounded with LRU eviction — an evicted cluster simply pays
the cold path again, it is never wrong.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["PoolEntry", "SessionPool"]


@dataclasses.dataclass
class PoolEntry:
    """One pooled H-state: the device-resident history vector plus the
    provenance the benchmark reports (how much work the entry banks)."""

    h: object  # [N] float32 tensor on the serving device
    store_version: int
    cluster: int
    ops_banked: int = 0
    puts: int = 0


class SessionPool:
    """LRU map ``(store_version, cluster) -> PoolEntry``.

    ``get`` refreshes recency (a hit is a use); ``put`` inserts or
    refreshes and evicts the least-recently-used entry beyond
    ``capacity``.  ``invalidate`` drops entries from other store
    versions in bulk — optional hygiene after a graph delta: stale
    entries can never hit again (the key includes the version), so
    invalidation only frees device memory earlier.
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: "collections.OrderedDict[Tuple[int, int], PoolEntry]" \
            = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def _key(self, store_version, cluster: int) -> Tuple[int, int]:
        # a store-less Problem (no GraphStore) has version None: its
        # graph can never drift, so it keys as the constant version 0
        return (0 if store_version is None else int(store_version),
                int(cluster))

    def get(self, store_version: int, cluster: int) -> Optional[PoolEntry]:
        entry = self._entries.get(self._key(store_version, cluster))
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(self._key(store_version, cluster))
        self.hits += 1
        return entry

    def put(self, store_version: int, cluster: int, h,
            ops_banked: int = 0) -> PoolEntry:
        key = self._key(store_version, cluster)
        entry = self._entries.get(key)
        if entry is None:
            entry = PoolEntry(h=h, store_version=key[0],
                              cluster=int(cluster))
            self._entries[key] = entry
        else:
            entry.h = h
        entry.ops_banked += int(ops_banked)
        entry.puts += 1
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def invalidate(self, keep_version: Optional[int] = None) -> int:
        """Drop entries whose version != ``keep_version`` (all entries
        when None).  Returns the number dropped."""
        if keep_version is None:
            dropped = len(self._entries)
            self._entries.clear()
        else:
            stale = [k for k in self._entries if k[0] != int(keep_version)]
            for k in stale:
                del self._entries[k]
            dropped = len(stale)
        self.invalidations += dropped
        return dropped

    def __contains__(self, key: Tuple[int, int]) -> bool:
        return self._key(*key) in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def device_buffers(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_jsonable(self) -> Dict:
        return {"capacity": self.capacity, "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4),
                "evictions": self.evictions,
                "invalidations": self.invalidations}
