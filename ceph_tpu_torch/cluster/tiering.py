"""Cache tiering: HitSet access tracking + tier agent (the last
src/osd/ feature-plane rows — HitSet.h, TierAgentState/PrimaryLogPG
agent_work, osd_types pg_hit_set_history_t).

Reference shape: a CACHE pool fronts a BASE pool; the OSD records
object accesses into per-PG HitSets (bloom / explicit) rotated on a
period, keeping the last N; the tier agent uses hit-set membership as
the temperature signal to EVICT clean cold objects when the cache
fills, and FLUSHES dirty objects back to the base pool; a read miss in
the cache PROMOTES the object from base.

Implemented as a proxy over the cluster simulator (the
objecter-with-cache-pool view librados clients get):

  * ``BloomHitSet`` / ``ExplicitHitSet`` — the HitSet impl family
    (src/osd/HitSet.h: BloomHitSet :146, ExplicitHashHitSet :250).
  * ``HitSetHistory`` — rotation by op-count period, last N kept
    (pool options hit_set_count / hit_set_period).
  * ``CacheTier`` — read/write proxy + agent_work(): flush dirty,
    evict cold-clean down to the target size (target_max_objects /
    cache_target_full_ratio roles).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from ..ops import hashing


class BloomHitSet:
    """Fixed-size Bloom filter over object names (BloomHitSet role).
    False positives over-estimate warmth (safe: keeps objects cached);
    never false-negative."""

    def __init__(self, bits: int = 4096, k: int = 4):
        self.bits = bits
        self.k = k
        self._bf = np.zeros(bits, dtype=bool)
        self.inserts = 0

    def _idx(self, name: str):
        h1 = hashing.str_hash_rjenkins(name.encode())
        h2 = hashing.str_hash_rjenkins((name + "#").encode()) | 1
        return [((h1 + i * h2) & 0xFFFFFFFF) % self.bits
                for i in range(self.k)]

    def insert(self, name: str) -> None:
        self._bf[self._idx(name)] = True
        self.inserts += 1

    def contains(self, name: str) -> bool:
        return bool(self._bf[self._idx(name)].all())


class ExplicitHitSet:
    """Exact membership (ExplicitHashHitSet role)."""

    def __init__(self):
        self._names: Set[str] = set()
        self.inserts = 0

    def insert(self, name: str) -> None:
        self._names.add(name)
        self.inserts += 1

    def contains(self, name: str) -> bool:
        return name in self._names


class HitSetHistory:
    """Rotating stack of recent hit sets (pg_hit_set_history_t)."""

    def __init__(self, count: int = 4, period_ops: int = 64,
                 kind: str = "bloom"):
        self.count = count
        self.period_ops = period_ops
        self.kind = kind
        self._current = self._make()
        self._ops = 0
        self.history: List[object] = []

    def _make(self):
        return BloomHitSet() if self.kind == "bloom" else ExplicitHitSet()

    def record(self, name: str) -> None:
        self._current.insert(name)
        self._ops += 1
        if self._ops >= self.period_ops:
            self.rotate()

    def rotate(self) -> None:
        self.history.append(self._current)
        if len(self.history) > self.count:
            self.history.pop(0)
        self._current = self._make()
        self._ops = 0

    def temperature(self, name: str) -> int:
        """How many recent hit sets saw this object (0..count+1)."""
        t = int(self._current.contains(name))
        return t + sum(1 for hs in self.history if hs.contains(name))


class CacheTier:
    """Cache-pool proxy over the simulator (tier agent included)."""

    def __init__(self, sim, cache_pool_id: int, base_pool_id: int, *,
                 target_max_objects: int = 16, hit_set_count: int = 4,
                 hit_set_period_ops: int = 64, hit_set_type: str = "bloom"):
        self.sim = sim
        self.cache = cache_pool_id
        self.base = base_pool_id
        self.target_max_objects = target_max_objects
        self.hitsets = HitSetHistory(hit_set_count, hit_set_period_ops,
                                     hit_set_type)
        self.dirty: Set[str] = set()
        self.stats = {"promotions": 0, "flushes": 0, "evictions": 0,
                      "cache_hits": 0, "cache_misses": 0}

    # ------------------------------------------------------------- state --
    def _in_cache(self, name: str) -> bool:
        return (self.cache, name) in self.sim.objects

    def cached_objects(self) -> List[str]:
        return sorted(n for (pid, n) in self.sim.objects
                      if pid == self.cache and "@" not in n)

    # --------------------------------------------------------------- I/O --
    def write(self, name: str, data: bytes) -> None:
        """Writes land in the cache tier and mark the object dirty
        (writeback mode)."""
        self.sim.put(self.cache, name, data)
        self.dirty.add(name)
        self.hitsets.record(name)

    def read(self, name: str) -> bytes:
        self.hitsets.record(name)
        if self._in_cache(name):
            self.stats["cache_hits"] += 1
            return self.sim.get(self.cache, name)
        # read miss: promote from base (proxy + promote policy)
        self.stats["cache_misses"] += 1
        data = self.sim.get(self.base, name)
        self.sim.put(self.cache, name, data)
        self.stats["promotions"] += 1
        return data

    # -------------------------------------------------------------- agent --
    def flush(self, name: str) -> None:
        """Write a dirty cache object back to the base tier."""
        if name in self.dirty:
            self.sim.put(self.base, name, self.sim.get(self.cache, name))
            self.dirty.discard(name)
            self.stats["flushes"] += 1

    def evict(self, name: str) -> None:
        """Drop a CLEAN object from the cache (flush first if dirty)."""
        self.flush(name)
        if self._in_cache(name):
            self.sim.delete(self.cache, name)
            self.stats["evictions"] += 1

    def agent_work(self) -> Dict[str, int]:
        """One agent pass (PrimaryLogPG::agent_work role): flush all
        dirty objects, then evict the COLDEST clean objects until the
        cache is back at target_max_objects.  Coldness = hit-set
        temperature, coldest first; ties evict lexicographically."""
        for name in sorted(self.dirty):
            self.flush(name)
        cached = self.cached_objects()
        excess = len(cached) - self.target_max_objects
        if excess > 0:
            by_temp = sorted(cached,
                             key=lambda n: (self.hitsets.temperature(n),
                                            n))
            for name in by_temp[:excess]:
                self.evict(name)
        return dict(self.stats)
