"""Upmap balancer — calc_pg_upmaps as a batched workload.

Role of the reference's `OSDMap::calc_pg_upmaps` (src/osd/OSDMap.h:1428,
impl OSDMap.cc) driven by the mgr balancer module's upmap mode
(src/pybind/mgr/balancer/module.py:1019): compute per-OSD deviation
from target PG counts and emit `pg_upmap_items` exception-table entries
that move single replicas from overfull to underfull OSDs, without
violating the CRUSH rule's failure-domain separation.

Batched design: the expensive part — mapping every PG of every pool —
is one `map_pgs_batch` device sweep per pool per round; deviations,
candidate selection, and domain checks are NumPy/host logic on the
resulting [N, R] arrays.  Domain validity uses the map's ancestor
tables (the role of CrushWrapper::verify_upmap): a replacement OSD must
not share its failure-domain ancestor with any other OSD in the PG's
up set.

Port of ``ceph_tpu/cluster/balancer.py``: host code around the port's
``OSDMap.map_pgs_batch``, which maps on the OSDMap's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..placement.crush_map import (
    ITEM_NONE, RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP,
    RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP, CrushMap)
from .osdmap import OSDMap, PGPool


def rule_failure_domain(cmap: CrushMap, ruleno: int) -> int:
    """The bucket type a rule separates replicas across (the last
    choose step's type; 0 = device)."""
    rule = cmap.rules[ruleno]
    domain = 0
    for op, a1, a2 in rule.steps:
        if op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                  RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
            domain = a2
    return domain


def osd_ancestors(cmap: CrushMap, domain_type: int) -> np.ndarray:
    """[max_devices] bucket id of each device's ancestor of
    ``domain_type`` (ITEM_NONE if unplaced); devices are their own
    domain when domain_type == 0."""
    anc = np.full(cmap.max_devices, ITEM_NONE, dtype=np.int64)
    if domain_type == 0:
        anc[:] = np.arange(cmap.max_devices)
        return anc
    # walk down from every bucket of the domain type
    shadows = set(cmap.class_bucket_ids.values())
    for b in cmap.buckets:
        if b is None or b.type != domain_type or b.id in shadows:
            continue
        stack = [b.id]
        while stack:
            cur = stack.pop()
            cb = cmap.bucket(cur)
            if cb is None:
                continue
            for it in cb.items:
                if it >= 0:
                    if it < len(anc):
                        anc[it] = b.id
                else:
                    stack.append(it)
    return anc


def osd_crush_weights(cmap: CrushMap) -> np.ndarray:
    """[max_devices] 16.16 crush weight of each device (sum over
    appearances outside class shadows)."""
    w = np.zeros(cmap.max_devices, dtype=np.float64)
    shadows = set(cmap.class_bucket_ids.values())
    for b in cmap.buckets:
        if b is None or b.id in shadows:
            continue
        for pos, it in enumerate(b.items):
            if it >= 0 and it < len(w):
                w[it] += b.item_weight(pos)
    return w


@dataclass
class BalanceResult:
    rounds: int
    moves: int
    max_deviation_before: float
    max_deviation_after: float
    upmap_items: Dict[Tuple[int, int], List[Tuple[int, int]]] = \
        field(default_factory=dict)


def calc_pg_upmaps(om: OSDMap, pool_ids: Optional[Sequence[int]] = None,
                   max_deviation: float = 1.0, max_rounds: int = 32,
                   max_moves_per_round: int = 64) -> BalanceResult:
    """Greedy upmap optimization (OSDMap::calc_pg_upmaps semantics).

    Mutates ``om.pg_upmap_items`` (and bumps the epoch once if any
    moves landed); returns a summary.  Deviation is measured in
    replicas vs the crush-weight-proportional target over in+up OSDs.
    """
    pools = [om.pools[p] for p in (pool_ids or sorted(om.pools))]
    cw = osd_crush_weights(om.crush)
    in_w = (om.osd_weight[:len(cw)] / 0x10000) * om.osd_up[:len(cw)] * \
        om.osd_exists[:len(cw)]
    eff = cw * in_w
    if eff.sum() <= 0:
        return BalanceResult(0, 0, 0.0, 0.0)
    domains = {p.id: osd_ancestors(om.crush,
                                   rule_failure_domain(om.crush,
                                                       p.crush_rule))
               for p in pools}
    total_moves = 0
    dev_before = None
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        # one batched sweep per pool: PG -> up set
        ups = {p.id: om.map_pgs_batch(p.id)[0] for p in pools}
        counts = np.zeros(len(eff), dtype=np.float64)
        for p in pools:
            vals = ups[p.id][ups[p.id] != ITEM_NONE]
            np.add.at(counts, vals[(vals >= 0) & (vals < len(eff))], 1)
        total = counts.sum()
        target = eff / eff.sum() * total
        dev = counts - target
        if dev_before is None:
            dev_before = float(np.abs(dev).max())
        if np.abs(dev).max() <= max_deviation:
            break
        moves = 0
        # most-overfull first
        for src in np.argsort(-dev):
            if moves >= max_moves_per_round or dev[src] <= max_deviation:
                break
            src = int(src)
            for p in pools:
                up = ups[p.id]
                rows, cols = np.nonzero(up == src)
                if not len(rows):
                    continue
                dom = domains[p.id]
                order = np.argsort(dev)     # most-underfull candidates
                for r, c in zip(rows, cols):
                    pgid = (p.id, p.raw_pg_to_pg(int(r)))
                    if pgid in om.pg_upmap_items or pgid in om.pg_upmap:
                        continue            # one exception per PG
                    pg_doms = {dom[o] for o in up[r]
                               if o != ITEM_NONE and o != src}
                    dst = None
                    for cand in order:
                        cand = int(cand)
                        if dev[cand] >= -max_deviation / 2 and \
                                dev[cand] >= dev[src] - 1:
                            break
                        if eff[cand] <= 0 or cand in up[r]:
                            continue
                        if dom[cand] != ITEM_NONE and \
                                dom[cand] in pg_doms:
                            continue        # would collapse domains
                        dst = cand
                        break
                    if dst is None:
                        continue
                    om.pg_upmap_items[pgid] = \
                        om.pg_upmap_items.get(pgid, []) + [(src, dst)]
                    dev[src] -= 1
                    dev[dst] += 1
                    moves += 1
                    total_moves += 1
                    if dev[src] <= max_deviation or \
                            moves >= max_moves_per_round:
                        break
                if dev[src] <= max_deviation or \
                        moves >= max_moves_per_round:
                    break
        if moves == 0:
            break
    # final measurement
    counts = np.zeros(len(eff), dtype=np.float64)
    for p in pools:
        up, _ = om.map_pgs_batch(p.id)
        vals = up[up != ITEM_NONE]
        np.add.at(counts, vals[(vals >= 0) & (vals < len(eff))], 1)
    target = eff / eff.sum() * counts.sum()
    dev_after = float(np.abs(counts - target).max())
    if total_moves:
        om.bump_epoch()
    return BalanceResult(rounds, total_moves, dev_before or 0.0,
                        dev_after, dict(om.pg_upmap_items))
