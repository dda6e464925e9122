"""pg_autoscaler mgr module (src/pybind/mgr/pg_autoscaler role).

The reference autoscaler computes, per pool, a target PG count from
the pool's share of cluster usage and the per-OSD PG budget, rounds to
a power of two, and only acts when the actual count is off by more
than a 3x threshold (pg_autoscale_mode=on) — small drifts are left
alone to avoid data movement churn.  Same math here:

  target_raw = usage_share * osd_count * mon_target_pg_per_osd / size
  target     = next power of two >= target_raw (>= pool minimum)
  act if max(target, actual) / min(target, actual) >= threshold

Usage share uses the pool's logical bytes over total logical bytes
(capacity-based estimation is a refinement the sim's stores don't
model); empty clusters fall back to an even split.
"""
from __future__ import annotations

from typing import Dict, List

from .module_host import MgrModule

MON_TARGET_PG_PER_OSD = 100      # reference default option
MIN_PG = 4
THRESHOLD = 3.0


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class PgAutoscaler(MgrModule):
    NAME = "pg_autoscaler"

    def __init__(self, host):
        super().__init__(host)
        # mode "on" is safe: set_pool_pg_num reshards the pool's
        # objects to their new PGs before the map change commits
        # (ClusterSim.reshard_pool, the PG-split data movement);
        # default remains "warn" per the reference's conservative
        # pg_autoscale_mode posture — operators opt in
        self.mode = "warn"           # on | warn (off = module disabled)
        self.last_recommendations: List[Dict] = []

    # ------------------------------------------------------------ policy --
    def recommendations(self) -> List[Dict]:
        m = self.get("osd_map")
        stats = self.get("pool_stats")
        osd = self.get("osd_stats")
        n_osds = max(1, sum(1 for v in osd["in"] if v))
        total_bytes = sum(s["bytes"] for s in stats.values())
        out = []
        for pid, pool in sorted(m.pools.items()):
            share = (stats.get(pid, {}).get("bytes", 0) / total_bytes
                     if total_bytes else 1.0 / max(1, len(m.pools)))
            raw = share * n_osds * MON_TARGET_PG_PER_OSD / max(1,
                                                               pool.size)
            target = max(MIN_PG, _next_pow2(max(1, round(raw))))
            actual = pool.pg_num
            ratio = max(target, actual) / max(1, min(target, actual))
            out.append({
                "pool_id": pid, "pool_name": pool.name,
                "actual_pg_num": actual, "target_pg_num": target,
                "usage_share": round(share, 4),
                "would_adjust": ratio >= THRESHOLD,
            })
        self.last_recommendations = out
        return out

    def serve_tick(self) -> None:
        for rec in self.recommendations():
            if rec["would_adjust"] and self.mode == "on":
                self.set_pool_pg_num(rec["pool_id"],
                                     rec["target_pg_num"])


def register(host) -> None:
    host.register(PgAutoscaler.NAME, PgAutoscaler)
