"""Balancer dry-run advisor — `ceph balancer eval` / `propose`.

Role of the reference mgr balancer module's EVAL side
(src/pybind/mgr/balancer/module.py: ``plan``/``eval`` score a map and
build a plan WITHOUT executing it; ``execute`` is a separate verb).
This module is only the advisory half: score the CURRENT mapping from
the ClusterScope signals the mon already holds — per-PG heat (pool
HitSet role) times per-OSD store utilization — propose concrete
``pg_upmap_items`` moves, and VALIDATE each proposal by re-scoring
the same heat history under the proposed mapping.  Nothing in this
module may touch the osdmap: the wire handler asserts the epoch is
unchanged around every call, and accepting a proposal would be a
separate, explicit verb.

Scoring: each eligible OSD's load is the summed decayed heat of the
PGs currently mapped to it, scaled by ``1 + utilization`` (a byte-
full OSD hurts more at equal heat — the utilization-history term).
The imbalance score is the RMS deviation of per-OSD load from the
crush-weight-proportional target, normalized by the mean load, so 0
means perfectly proportional and the number is comparable across
cluster sizes.  A proposal is kept only if the re-scored imbalance
under the virtual move strictly drops.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..cluster.balancer import (osd_ancestors, osd_crush_weights,
                                rule_failure_domain)
from ..placement.crush_map import ITEM_NONE


def imbalance_score(loads: Dict[int, float],
                    shares: Dict[int, float]) -> float:
    """Normalized RMS deviation of per-OSD load vs the weight-
    proportional target.  ``shares`` maps osd -> effective weight
    fraction (sums to 1 over eligible OSDs)."""
    if not loads:
        return 0.0
    total = sum(loads.values())
    if total <= 0:
        return 0.0
    mean = total / len(loads)
    acc = 0.0
    for osd, load in loads.items():
        target = total * shares.get(osd, 0.0)
        acc += (load - target) ** 2
    return round(math.sqrt(acc / len(loads)) / mean, 6)


def _eligible(om) -> Tuple[np.ndarray, Dict[int, float]]:
    """Effective weights (crush x in x up) and the share map over
    eligible OSDs — the same eligibility calc_pg_upmaps uses."""
    cw = osd_crush_weights(om.crush)
    n = len(cw)
    eff = cw * (om.osd_weight[:n] / 0x10000) * om.osd_up[:n] * \
        om.osd_exists[:n]
    s = eff.sum()
    shares = {int(i): float(eff[i] / s)
              for i in np.nonzero(eff > 0)[0]} if s > 0 else {}
    return eff, shares


def _pg_rows(cs, pool: Optional[int]) -> List[Dict[str, Any]]:
    rows = cs.pg_heat(pool=pool)
    return [r for r in rows if r.get("heat", 0.0) > 0.0]


def _util_by_osd(cs) -> Dict[int, float]:
    out: Dict[int, float] = {}
    for row in cs.osd_df():
        d = row.get("daemon", "")
        if d.startswith("osd."):
            out[int(d[4:])] = float(row.get("utilization", 0.0))
    return out


def _loads(pg_map: Dict[Tuple[int, int], Tuple[List[int], float]],
           util: Dict[int, float],
           shares: Dict[int, float]) -> Dict[int, float]:
    """Per-OSD combined load: summed heat of mapped PGs, scaled by
    1 + utilization.  Every eligible OSD appears (zero-load OSDs are
    exactly the underfull candidates)."""
    loads = {osd: 0.0 for osd in shares}
    for (_pool, _pg), (up, heat) in pg_map.items():
        per = heat / max(1, len([o for o in up if o != ITEM_NONE]))
        for osd in up:
            if osd != ITEM_NONE and osd in loads:
                loads[osd] += per
    for osd in loads:
        loads[osd] *= 1.0 + util.get(osd, 0.0)
    return loads


def evaluate(om, cs, max_moves: int = 8,
             pool: Optional[int] = None) -> Dict[str, Any]:
    """Score the current mapping and propose upmap moves as a
    REPORT.  ``om`` is never mutated (the caller asserts the epoch);
    proposals are validated by re-scoring the heat history under the
    virtual mapping and kept only when the score strictly drops."""
    pool = None if pool is None else int(pool)
    eff, shares = _eligible(om)
    rows = _pg_rows(cs, pool)
    util = _util_by_osd(cs)
    # pg -> (current up set, merged decayed heat)
    pg_map: Dict[Tuple[int, int], Tuple[List[int], float]] = {}
    domains: Dict[int, np.ndarray] = {}
    for r in rows:
        pid, pg = (int(x) for x in r["pgid"].split(".", 1))
        p = om.pools.get(pid)
        if p is None:
            continue
        up, _pri, _act, _apri = om.pg_to_up_acting_osds(pid, pg)
        if not up:
            continue
        pg_map[(pid, pg)] = (list(up), float(r["heat"]))
        if pid not in domains:
            domains[pid] = osd_ancestors(
                om.crush, rule_failure_domain(om.crush, p.crush_rule))
    loads = _loads(pg_map, util, shares)
    score_before = imbalance_score(loads, shares)
    out: Dict[str, Any] = {
        "epoch": om.epoch,
        "score_before": score_before,
        "score_after": score_before,
        "proposals": [],
        "osd_load": {f"osd.{o}": round(v, 6)
                     for o, v in sorted(loads.items())},
        "pgs_considered": len(pg_map),
    }
    if not pg_map or not shares:
        return out
    # greedy dry-run: repeatedly move the hottest PG off the most
    # overloaded OSD onto the most underloaded valid candidate,
    # applying each move VIRTUALLY (pg_map copy, never the osdmap)
    virt = {k: (list(up), heat) for k, (up, heat) in pg_map.items()}
    cur = dict(loads)
    cur_score = score_before
    total = sum(cur.values())
    targets = {o: total * shares.get(o, 0.0) for o in cur}
    proposals: List[Dict[str, Any]] = []
    for _ in range(max(0, int(max_moves))):
        over = sorted(cur, key=lambda o: targets[o] - cur[o])
        best = None
        for src in over[:2]:                    # most overloaded first
            if cur[src] <= targets[src]:
                break
            # hottest PG currently touching src, not already upmapped
            cands = sorted(
                ((heat, k, up) for k, (up, heat) in virt.items()
                 if src in up and k not in om.pg_upmap_items
                 and k not in om.pg_upmap
                 and not any(k == p["key"] for p in proposals)),
                key=lambda t: -t[0])
            for heat, k, up in cands[:8]:
                dom = domains[k[0]]
                pg_doms = {dom[o] for o in up
                           if o != ITEM_NONE and o != src
                           and o < len(dom)}
                for dst in sorted(cur, key=lambda o: cur[o] -
                                  targets[o]):
                    if dst == src or dst in up:
                        continue
                    if dst < len(dom) and dom[dst] != ITEM_NONE \
                            and dom[dst] in pg_doms:
                        continue            # would collapse domains
                    # virtual apply + re-score
                    share = (heat *
                             (1.0 + util.get(src, 0.0)) /
                             max(1, len([o for o in up
                                         if o != ITEM_NONE])))
                    trial = dict(cur)
                    trial[src] -= share
                    trial[dst] += heat * (1.0 + util.get(dst, 0.0)) \
                        / max(1, len([o for o in up
                                      if o != ITEM_NONE]))
                    s = imbalance_score(trial, shares)
                    if s < cur_score:
                        best = (s, k, up, src, dst, heat, trial)
                    break                   # only the best candidate
                if best is not None:
                    break
            if best is not None:
                break
        if best is None:
            break
        s, k, up, src, dst, heat, trial = best
        cur = trial
        cur_score = s
        virt[k] = ([dst if o == src else o for o in up], heat)
        proposals.append({
            "key": k,
            "pgid": f"{k[0]}.{k[1]}",
            "pool": k[0],
            "from": int(src),
            "to": int(dst),
            "heat": round(heat, 6),
            "score_after": s,
        })
    # validation sweep: rebuild loads FROM SCRATCH under the proposed
    # mapping (not the incremental trail) and re-score — the number
    # the report promises is the recomputed one
    final_loads = _loads(virt, util, shares)
    score_after = imbalance_score(final_loads, shares)
    if proposals and score_after >= score_before:
        # the incremental trail lied (rounding, overlapping moves):
        # an advisor must not promise a non-improvement
        proposals = []
        score_after = score_before
    for p in proposals:
        p.pop("key", None)
    out["proposals"] = proposals
    out["score_after"] = score_after if proposals else score_before
    out["moves"] = len(proposals)
    return out
