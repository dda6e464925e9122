"""OSDMap — the versioned cluster map and the object→PG→OSD pipeline.

Copy of ``ceph_tpu/cluster/osdmap.py`` whose batched path runs the port's
mapper (placement/xla_mapper.py) on the map's device (the package
default, the card, unless the caller asks for the CPU).  With the
sharded data plane on, ``map_pgs_batch`` splits the PG lanes over the
plane's mesh (parallel/data_plane.py).

Re-creates the placement policy surface of the reference's OSDMap
(src/osd/OSDMap.{h,cc}): pools, OSD existence/up/in states and weights,
pg_temp / primary_temp overrides, pg_upmap / pg_upmap_items exceptions,
primary affinity, and the full pipeline

    _pg_to_raw_osds (CRUSH) → _apply_upmap → _raw_to_up_osds →
    _pick_primary/_apply_primary_affinity → pg_temp override
    (reference: src/osd/OSDMap.cc:2435-2715)

with two execution paths:

  * scalar per-PG (`pg_to_up_acting_osds`) — oracle + control plane;
  * batched (`map_pgs_batch`) — all PGs of a pool in one batched CRUSH
    call via XlaMapper, with the host-side pipeline stages vectorized in
    NumPy.  This supersedes the thread-pool ParallelPGMapper
    (src/osd/OSDMapMapping.h:18).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import tracer as _tracing
from ..ops import hashing
from ..placement.crush_map import ITEM_NONE, CrushMap
from ..placement import scalar_mapper
from ..placement.xla_mapper import UnsupportedMapError, XlaMapper

# pool types (reference: src/osd/osd_types.h pg_pool_t::TYPE_*)
POOL_REPLICATED = 1
POOL_ERASURE = 3

# flags (subset)
FLAG_HASHPSPOOL = 1 << 0
FLAG_EC_OVERWRITES = 1 << 17   # reference: src/osd/osd_types.h:1244

# cluster-wide osdmap flags an operator sets to ride out known events
# (reference: CEPH_OSDMAP_NOOUT / CEPH_OSDMAP_NODOWN,
# src/osd/OSDMap.h get_flags; `ceph osd set noout`): "noout" stops the
# automatic down->out transition, "nodown" stops failure reports from
# marking OSDs down — both honored by the heartbeat/markdown path
CLUSTER_FLAGS = ("noout", "nodown")

MAX_PRIMARY_AFFINITY = 0x10000
WEIGHT_IN = 0x10000


def _calc_bits_of(n: int) -> int:
    bits = 0
    while n:
        n >>= 1
        bits += 1
    return bits


def pg_num_mask(pg_num: int) -> int:
    """(1 << cbits(pg_num-1)) - 1 (reference: pg_pool_t::calc_pg_masks)."""
    return (1 << _calc_bits_of(pg_num - 1)) - 1 if pg_num else 0


def stable_mod(x: int, b: int, bmask: int) -> int:
    """ceph_stable_mod (reference: src/include/ceph_hash.h semantics;
    cited via src/osd/osd_types.cc:1781)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


@dataclass
class PGId:
    """pg_t: (pool, ps)."""
    pool: int
    ps: int

    def __hash__(self):
        return hash((self.pool, self.ps))


@dataclass
class PGPool:
    """pg_pool_t subset relevant to placement (src/osd/osd_types.h)."""
    id: int
    name: str = ""
    type: int = POOL_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 8
    pgp_num: int = 0
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    erasure_code_profile: str = ""
    # EC stripe unit (reference: osd_pool_erasure_code_stripe_unit,
    # default 4 KiB); chunk size of every stripe in the pool
    stripe_unit: int = 4096
    # pool snapshot context (pg_pool_t::snap_seq / snaps)
    snap_seq: int = 0
    snaps: Dict[int, str] = field(default_factory=dict)
    # cache tiering (pg_pool_t::tier_of / read_tier / write_tier,
    # src/osd/osd_types.h): a CACHE pool carries tier_of = its base
    # pool; the BASE pool carries read_tier/write_tier = the cache
    # pool the op engine redirects reads/writes to
    tier_of: int = -1
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = ""

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return pg_num_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return pg_num_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated pools compact holes; EC pools are positional
        (src/osd/osd_types.h pg_pool_t::can_shift_osds)."""
        return self.type == POOL_REPLICATED

    def raw_pg_to_pg(self, ps: int) -> int:
        return stable_mod(ps, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, ps: int) -> int:
        """Placement seed (src/osd/osd_types.cc:1798-1811)."""
        if self.flags & FLAG_HASHPSPOOL:
            return hashing.hash2(
                stable_mod(ps, self.pgp_num, self.pgp_num_mask), self.id)
        return stable_mod(ps, self.pgp_num, self.pgp_num_mask) + self.id

    def raw_pg_to_pps_batch(self, pss: np.ndarray) -> np.ndarray:
        ps = np.asarray(pss, dtype=np.int64)
        masked = ps & self.pgp_num_mask
        sm = np.where(masked < self.pgp_num, masked,
                      ps & (self.pgp_num_mask >> 1))
        if self.flags & FLAG_HASHPSPOOL:
            return hashing.np_hash2(sm.astype(np.uint32),
                                    np.uint32(self.id)).astype(np.int64)
        return sm + self.id


@dataclass
class Incremental:
    """A versioned map delta (OSDMap::Incremental role): the mon
    publishes these per epoch; consumers apply them in order instead of
    refetching full maps.  Only the mutation surface the simulator uses."""
    epoch: int                                   # resulting epoch
    new_up: Dict[int, bool] = field(default_factory=dict)
    new_weight: Dict[int, int] = field(default_factory=dict)
    new_primary_affinity: Dict[int, int] = field(default_factory=dict)
    new_pg_upmap_items: Dict[Tuple[int, int],
                             Optional[List[Tuple[int, int]]]] = \
        field(default_factory=dict)              # None = remove
    new_pg_temp: Dict[Tuple[int, int], Optional[List[int]]] = \
        field(default_factory=dict)
    # pool mutations (OSDMap::Incremental new_pools subset)
    new_pool_pg_num: Dict[int, int] = field(default_factory=dict)
    # pool creation/removal (new_pools full specs / old_pools):
    # values are PGPool constructor kwargs so the delta is
    # JSON-serializable for the mon quorum's decree log
    new_pools: Dict[int, dict] = field(default_factory=dict)
    old_pools: List[int] = field(default_factory=list)
    # cache-tier wiring: pool id -> {tier_of|read_tier|write_tier|
    # cache_mode} field updates (OSDMonitor 'osd tier add' role)
    new_pool_tier: Dict[int, dict] = field(default_factory=dict)
    # cluster flag changes: name -> set (True) / clear (False)
    # (OSDMap::Incremental new_flags role)
    new_flags: Dict[str, bool] = field(default_factory=dict)


class OSDMap:
    """The cluster map: crush + osd states + pools + exception tables."""

    def __init__(self, crush: CrushMap, max_osd: int = 0, epoch: int = 1,
                 device=None):
        self.epoch = epoch
        self.device = device         # batched mapper's device (None: default)
        self.crush = crush
        self.max_osd = max(max_osd, crush.max_devices)
        n = self.max_osd
        self.osd_exists = np.zeros(n, dtype=bool)
        self.osd_up = np.zeros(n, dtype=bool)
        self.osd_weight = np.zeros(n, dtype=np.int64)    # 16.16 in/out
        self.osd_primary_affinity = np.full(n, MAX_PRIMARY_AFFINITY,
                                            dtype=np.int64)
        self.pools: Dict[int, PGPool] = {}
        # cluster-wide flags (noout/nodown — CLUSTER_FLAGS)
        self.flags: set = set()
        # monotonic pool-id high-water mark (the reference's
        # new_pool_max): a deleted pool's id is NEVER reused, or the
        # next pool would inherit its surviving objects/snap state
        self.pool_id_max = 0
        self.pg_temp: Dict[Tuple[int, int], List[int]] = {}
        self.primary_temp: Dict[Tuple[int, int], int] = {}
        self.pg_upmap: Dict[Tuple[int, int], List[int]] = {}
        self.pg_upmap_items: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        self._mapper: Optional[XlaMapper] = None
        self._mapper_map: Optional[CrushMap] = None

    # ------------------------------------------------------------ mutate --
    def bump_epoch(self) -> None:
        self.epoch += 1

    def apply_incremental(self, inc: Incremental) -> None:
        """Consume a map delta (OSDMap::apply_incremental): must be the
        next epoch in sequence."""
        with _tracing.start_span("osdmap.apply_incremental"):
            self._apply_incremental(inc)

    def _apply_incremental(self, inc: Incremental) -> None:
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != {self.epoch} + 1")
        for osd, up in inc.new_up.items():
            self.osd_up[osd] = up
        for osd, w in inc.new_weight.items():
            self.osd_weight[osd] = w
        for osd, a in inc.new_primary_affinity.items():
            self.osd_primary_affinity[osd] = a
        for pgid, items in inc.new_pg_upmap_items.items():
            if items is None:
                self.pg_upmap_items.pop(pgid, None)
            else:
                self.pg_upmap_items[pgid] = list(items)
        for pgid, temp in inc.new_pg_temp.items():
            if temp is None:
                self.pg_temp.pop(pgid, None)
            else:
                self.pg_temp[pgid] = list(temp)
        for pid, pg_num in inc.new_pool_pg_num.items():
            pool = self.pools.get(pid)
            if pool is not None:
                pool.pg_num = pg_num
                pool.pgp_num = pg_num
        for pid, spec in inc.new_pools.items():
            self.pools[pid] = PGPool(**{**spec, "id": pid})
            self.pool_id_max = max(self.pool_id_max, pid)
        for pid, fields in inc.new_pool_tier.items():
            pool = self.pools.get(pid)
            if pool is None:
                continue
            for fk in ("tier_of", "read_tier", "write_tier"):
                if fk in fields:
                    setattr(pool, fk, int(fields[fk]))
            if "cache_mode" in fields:
                pool.cache_mode = str(fields["cache_mode"])
        for flag, on in inc.new_flags.items():
            if on:
                self.flags.add(flag)
            else:
                self.flags.discard(flag)
        for pid in inc.old_pools:
            self.pools.pop(pid, None)
            # stale placement overrides keyed by the dead pool go too
            for table in (self.pg_temp, self.primary_temp,
                          self.pg_upmap, self.pg_upmap_items):
                for key in [k for k in table if k[0] == pid]:
                    del table[key]
        self.epoch = inc.epoch

    def set_osd(self, osd: int, *, exists=True, up=True,
                weight=WEIGHT_IN) -> None:
        self.osd_exists[osd] = exists
        self.osd_up[osd] = up
        self.osd_weight[osd] = weight

    def mark_all_in_up(self) -> None:
        self.osd_exists[:] = True
        self.osd_up[:] = True
        self.osd_weight[:] = WEIGHT_IN

    def mark_down(self, osd: int) -> None:
        self.osd_up[osd] = False
        self.bump_epoch()

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0
        self.bump_epoch()

    def add_pool(self, pool: PGPool) -> None:
        self.pools[pool.id] = pool
        self.pool_id_max = max(self.pool_id_max, pool.id)

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_exists[osd])

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_up[osd])

    # -------------------------------------------------- pipeline (scalar) --
    def _crush_rule_for(self, pool: PGPool) -> int:
        return pool.crush_rule

    def _pg_to_raw_osds(self, pool: PGPool, ps: int) -> Tuple[List[int], int]:
        pps = pool.raw_pg_to_pps(ps)
        raw = scalar_mapper.do_rule(
            self.crush, self._crush_rule_for(pool), pps, pool.size,
            list(self.osd_weight[:self.crush.max_devices]))
        self._remove_nonexistent(pool, raw)
        return raw, pps

    def _remove_nonexistent(self, pool: PGPool, raw: List[int]) -> None:
        """(OSDMap.cc _remove_nonexistent_osds)"""
        if pool.can_shift_osds():
            raw[:] = [o for o in raw
                      if o == ITEM_NONE or self.exists(o)]
            raw[:] = [o for o in raw if o != ITEM_NONE]
        else:
            raw[:] = [o if o != ITEM_NONE and self.exists(o) else ITEM_NONE
                      for o in raw]

    def _apply_upmap(self, pool: PGPool, pgid: Tuple[int, int],
                     raw: List[int]) -> List[int]:
        """(OSDMap.cc:2465-2510)"""
        p = self.pg_upmap.get(pgid)
        if p is not None:
            if any(o != ITEM_NONE and 0 <= o < self.max_osd and
                   self.osd_weight[o] == 0 for o in p):
                # any out target rejects the whole exception — including
                # pg_upmap_items (OSDMap.cc:2475 returns, not falls through)
                return raw
            raw = list(p)
        q = self.pg_upmap_items.get(pgid)
        if q is not None:
            for frm, to in q:
                exists_ = False
                pos = -1
                for i, o in enumerate(raw):
                    if o == to:
                        exists_ = True
                        break
                    if o == frm and pos < 0 and not (
                            to != ITEM_NONE and 0 <= to < self.max_osd and
                            self.osd_weight[to] == 0):
                        pos = i
                if not exists_ and pos >= 0:
                    raw[pos] = to
        return raw

    def _raw_to_up(self, pool: PGPool, raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw if self.is_up(o)]
        return [o if o != ITEM_NONE and self.is_up(o) else ITEM_NONE
                for o in raw]

    @staticmethod
    def _pick_primary(osds: Sequence[int]) -> int:
        for o in osds:
            if o != ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, pps: int, pool: PGPool,
                                up: List[int], primary: int
                                ) -> Tuple[List[int], int]:
        """(OSDMap.cc:2537-2590)"""
        if not any(o != ITEM_NONE and
                   self.osd_primary_affinity[o] != MAX_PRIMARY_AFFINITY
                   for o in up):
            return up, primary
        pos = -1
        for i, o in enumerate(up):
            if o == ITEM_NONE:
                continue
            a = int(self.osd_primary_affinity[o])
            if a < MAX_PRIMARY_AFFINITY and \
                    (hashing.hash2(pps, o) >> 16) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return up, primary
        primary = up[pos]
        if pool.can_shift_osds() and pos > 0:
            up = [up[pos]] + up[:pos] + up[pos + 1:]
        return up, primary

    def _get_temp_osds(self, pool: PGPool, pgid: Tuple[int, int]
                       ) -> Tuple[List[int], int]:
        """(OSDMap.cc:2592-2625)"""
        temp = []
        raw_temp = self.pg_temp.get(pgid)
        if raw_temp:
            for o in raw_temp:
                if not self.is_up(o):
                    if pool.can_shift_osds():
                        continue
                    temp.append(ITEM_NONE)
                else:
                    temp.append(o)
        temp_primary = self.primary_temp.get(pgid, -1)
        if temp_primary == -1 and temp:
            temp_primary = self._pick_primary(temp)
        return temp, temp_primary

    def pg_to_up_acting_osds(self, pool_id: int, ps: int
                             ) -> Tuple[List[int], int, List[int], int]:
        """The full pipeline (OSDMap.cc:2667-2715): returns
        (up, up_primary, acting, acting_primary)."""
        pool = self.pools.get(pool_id)
        if pool is None or ps >= pool.pg_num:
            return [], -1, [], -1
        pgid = (pool_id, pool.raw_pg_to_pg(ps))
        acting, acting_primary = self._get_temp_osds(pool, pgid)
        raw, pps = self._pg_to_raw_osds(pool, ps)
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    # ------------------------------------------------- pipeline (batched) --
    def _batched_mapper(self) -> XlaMapper:
        # keyed on the CrushMap object, not the epoch: osd weights are
        # runtime operands of map_batch, so up/down/out changes must NOT
        # recompile; only crush topology edits (a new map value) do
        if self._mapper is None or self._mapper_map is not self.crush:
            self._mapper = XlaMapper(self.crush, device=self.device)
            self._mapper_map = self.crush
        return self._mapper

    def map_pgs_batch(self, pool_id: int,
                      pss: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Map many PGs of one pool in a single batched CRUSH call.

        Returns (up [N, size] int32 with ITEM_NONE holes per EC semantics,
        up_primary [N] int32).  pg_temp/primary_temp are control-plane
        overlays applied by callers that need acting sets (they are sparse
        dicts; see pg_to_up_acting_osds).

        Traced as the span ``osdmap.map_pgs_batch`` with the stages
        ``osdmap.pps`` and ``osdmap.post_crush`` beneath it, beside the
        mapper's own.
        """
        with _tracing.start_span("osdmap.map_pgs_batch"):
            return self._map_pgs_batch(pool_id, pss)

    def _map_pgs_batch(self, pool_id: int, pss: Optional[np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        pool = self.pools.get(pool_id)
        if pool is None:
            raise KeyError(f"no pool {pool_id}")
        if pss is None:
            pss = np.arange(pool.pg_num, dtype=np.int64)
        pss = np.asarray(pss, dtype=np.int64)
        with _tracing.child_span("osdmap.pps"):
            pps = pool.raw_pg_to_pps_batch(pss)
        mapper = self._batched_mapper()
        # sharded data plane: the PG lane axis splits across the mesh
        # (the multi-device ParallelPGMapper, src/osd/OSDMapMapping.h:18);
        # identical results, the mapper pads lanes to the mesh size
        from ..parallel.data_plane import plane as _data_plane
        dp = _data_plane()
        raw = mapper.map_batch(
            self._crush_rule_for(pool), pps, pool.size,
            self.osd_weight[:self.crush.max_devices],
            mesh=dp.mesh if dp is not None else None).astype(np.int64)
        if dp is not None:
            dp.account("map", len(pss), 4 * pool.size)
        with _tracing.child_span("osdmap.post_crush"):
            return self._post_crush_batch(pool, pss, pps, raw)

    def _post_crush_batch(self, pool: PGPool, pss, pps, raw
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized upmap/up/primary stages on host (NumPy)."""
        N, R = raw.shape
        # nonexistent / down → NONE
        ids = np.clip(raw, 0, self.max_osd - 1)
        valid = (raw >= 0) & (raw < self.max_osd) & \
            self.osd_exists[ids] & self.osd_up[ids]
        up = np.where(valid & (raw != ITEM_NONE), raw, ITEM_NONE)
        # sparse upmap exceptions via the scalar path
        if self.pg_upmap or self.pg_upmap_items:
            pgids = [(pool.id, pool.raw_pg_to_pg(int(p))) for p in pss]
            hit = [i for i, g in enumerate(pgids)
                   if g in self.pg_upmap or g in self.pg_upmap_items]
            for i in hit:
                raw_i = [int(v) for v in raw[i]]
                self._remove_nonexistent(pool, raw_i)
                raw_i = self._apply_upmap(pool, pgids[i], raw_i)
                up_i = self._raw_to_up(pool, raw_i)
                row = np.full(R, ITEM_NONE, dtype=np.int64)
                row[:len(up_i)] = up_i
                up[i] = row
        if pool.can_shift_osds():
            # compact NONE holes leftward, preserving order: a stable
            # argsort on the hole mask is the whole permutation
            order = np.argsort(up == ITEM_NONE, axis=1, kind="stable")
            up = np.take_along_axis(up, order, axis=1)
        # primary: first non-NONE (affinity overlay for the non-default case)
        primary = np.full(N, -1, dtype=np.int64)
        has = (up != ITEM_NONE)
        anyrow = has.any(axis=1)
        primary[anyrow] = up[anyrow, has[anyrow].argmax(axis=1)]
        if np.any(self.osd_primary_affinity != MAX_PRIMARY_AFFINITY):
            up, primary = self._apply_primary_affinity_batch(
                pool, pps, up, primary)
        return up.astype(np.int32), primary.astype(np.int32)

    def _apply_primary_affinity_batch(self, pool: PGPool, pps, up, primary):
        """Array form of _apply_primary_affinity (OSDMap.cc:2537-2590):
        position-ordered scan becomes accept/reject masks + one gather.

        Scalar semantics per row: walking non-NONE entries left to
        right, an entry with affinity a < MAX is REJECTED when
        hash(pps, osd) >> 16 >= a; the first accepted entry becomes
        primary (breaking the scan), else the first rejected one; for
        shifting pools the winner rotates to the front."""
        from ..ops import hashing
        N, R = up.shape
        valid = up != ITEM_NONE
        ids = np.clip(up, 0, self.max_osd - 1)
        aff = np.where(valid, self.osd_primary_affinity[ids],
                       MAX_PRIMARY_AFFINITY).astype(np.int64)
        h = hashing.np_hash2(
            np.broadcast_to(np.asarray(pps, dtype=np.uint32)[:, None],
                            (N, R)),
            ids.astype(np.uint32)).astype(np.int64) >> 16
        rejected = valid & (aff < MAX_PRIMARY_AFFINITY) & (h >= aff)
        accepted = valid & ~rejected
        any_acc = accepted.any(axis=1)
        any_rej = rejected.any(axis=1)
        first_acc = accepted.argmax(axis=1)
        first_rej = rejected.argmax(axis=1)
        pos = np.where(any_acc, first_acc,
                       np.where(any_rej, first_rej, -1))
        rows = np.arange(N)
        picked = pos >= 0
        primary = np.where(picked, up[rows, np.maximum(pos, 0)], primary)
        if pool.can_shift_osds():
            # rotate the winner to the front of each picked row
            idx = np.broadcast_to(np.arange(R), (N, R)).copy()
            p = np.maximum(pos, 0)[:, None]
            src = np.where(idx == 0, p, np.where(idx <= p, idx - 1, idx))
            rotated = np.take_along_axis(up, src, axis=1)
            up = np.where((picked & (pos > 0))[:, None], rotated, up)
        return up, primary

    # ---------------------------------------------------------- analytics --
    def pg_counts_per_osd(self, pool_ids: Optional[Sequence[int]] = None
                          ) -> np.ndarray:
        """PG replica count per OSD across pools (balancer input)."""
        counts = np.zeros(self.max_osd, dtype=np.int64)
        for pid in (pool_ids if pool_ids is not None else self.pools):
            up, _ = self.map_pgs_batch(pid)
            vals = up[up != ITEM_NONE]
            np.add.at(counts, vals, 1)
        return counts
