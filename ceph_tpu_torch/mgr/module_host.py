"""Mgr module host — the ActivePyModules/mgr_module role.

The reference mgr embeds CPython and hosts modules (balancer,
pg_autoscaler, prometheus, ...) behind a stable module API
(src/mgr/ActivePyModules.cc, src/pybind/mgr/mgr_module.py): each module
sees cluster state (maps, pg dump, perf counters, pool stats, config)
and can command the mon.  Here the host is native Python from the
start; the module contract is the same shape:

  * ``MgrModule.serve_tick()`` — one pass of the module's periodic work
    (the serve() loop body; the host drives ticks so tests and the
    daemon can pump deterministically).
  * ``self.get("osd_map") / get("pg_dump") / get("pool_stats")`` —
    cluster state queries (MgrModule.get role).
  * ``self.set_pool_pg_num(...)`` etc. — mon commands via the host.

Modules register by name; enable/disable matches ``ceph mgr module
enable`` semantics.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class MgrModule:
    """Base module (mgr_module.MgrModule role)."""

    NAME = "module"

    def __init__(self, host: "MgrModuleHost"):
        self.host = host

    # ------------------------------------------------------------ queries --
    def get(self, what: str) -> Any:
        return self.host.get(what)

    # ------------------------------------------------------------- actions --
    def set_pool_pg_num(self, pool_id: int, pg_num: int) -> None:
        self.host.set_pool_pg_num(pool_id, pg_num)

    # -------------------------------------------------------------- serve --
    def serve_tick(self) -> None:        # pragma: no cover - abstract-ish
        pass


class MgrModuleHost:
    """Hosts modules over a live cluster (sim + monitor)."""

    def __init__(self, sim, mon=None):
        self.sim = sim
        self.mon = mon
        self._available: Dict[str, Callable[["MgrModuleHost"], MgrModule]] = {}
        self.modules: Dict[str, MgrModule] = {}

    # ----------------------------------------------------------- registry --
    def register(self, name: str,
                 factory: Callable[["MgrModuleHost"], MgrModule]) -> None:
        self._available[name] = factory

    def enable(self, name: str) -> MgrModule:
        if name not in self._available:
            raise KeyError(f"no mgr module {name!r}")
        if name not in self.modules:
            self.modules[name] = self._available[name](self)
        return self.modules[name]

    def disable(self, name: str) -> None:
        self.modules.pop(name, None)

    def enabled(self) -> List[str]:
        return sorted(self.modules)

    def tick(self) -> None:
        """One serve pass of every enabled module."""
        for m in list(self.modules.values()):
            m.serve_tick()

    # ------------------------------------------------------ state queries --
    def get(self, what: str) -> Any:
        m = self.sim.osdmap
        if what == "osd_map":
            return m
        if what == "osd_stats":
            n = m.max_osd
            return {
                "up": [bool(v) for v in m.osd_up[:n]],
                "in": [int(w) > 0 for w in m.osd_weight[:n]],
                "weight": [int(w) for w in m.osd_weight[:n]],
            }
        if what == "pg_dump":
            out = {}
            for pid, pool in m.pools.items():
                up, prim = m.map_pgs_batch(pid)
                out[pid] = {"up": up, "primary": prim}
            return out
        if what == "pool_stats":
            stats: Dict[int, Dict[str, int]] = {}
            for (pid, _name), info in self.sim.objects.items():
                s = stats.setdefault(pid, {"objects": 0, "bytes": 0})
                s["objects"] += 1
                s["bytes"] += info.size
            for pid in m.pools:
                stats.setdefault(pid, {"objects": 0, "bytes": 0})
            return stats
        if what == "pg_counts_per_osd":
            return self.sim.osdmap.pg_counts_per_osd()
        if what == "cluster_stats":
            # the ClusterTelemetry aggregator (None without a mon:
            # modules degrade to the per-process view)
            return None if self.mon is None \
                else getattr(self.mon, "cluster_stats", None)
        raise KeyError(f"unknown query {what!r}")

    # ------------------------------------------------------- mon commands --
    def mark_osd_out(self, osd: int) -> None:
        """Mark an OSD out (weight 0) — with a mon, as a committed
        incremental; standalone, directly on the sim's map (the
        `ceph osd out` / devicehealth self-heal path)."""
        if self.mon is not None:
            inc = self.mon.next_incremental()
            inc.new_weight[osd] = 0
            if not self.mon.commit_incremental(inc):
                raise RuntimeError(f"osd.{osd} mark-out lost quorum")
            return
        self.sim.osdmap.mark_out(osd)      # bumps the epoch itself

    def set_pool_pg_num(self, pool_id: int, pg_num: int) -> None:
        """Commit a pg_num change.  With a mon: consensus + durable
        incremental FIRST (no quorum -> RuntimeError, nothing moves),
        then the PG-split data movement reshards objects from the old
        geometry.  Without a mon: the sim reshards and bumps the epoch
        itself."""
        old = self.sim.osdmap.pools[pool_id].pg_num
        if self.mon is not None:
            inc = self.mon.next_incremental()
            inc.new_pool_pg_num[pool_id] = pg_num
            if not self.mon.commit_incremental(inc):
                raise RuntimeError(
                    f"pg_num change for pool {pool_id} lost quorum")
            if hasattr(self.sim, "reshard_pool"):
                self.sim.reshard_pool(pool_id, pg_num,
                                      bump_epoch=False, old_pg_num=old)
            return
        if hasattr(self.sim, "reshard_pool"):
            self.sim.reshard_pool(pool_id, pg_num)
            return
        pool = self.sim.osdmap.pools[pool_id]
        pool.pg_num = pg_num
        pool.pgp_num = pg_num
        self.sim.osdmap.bump_epoch()
