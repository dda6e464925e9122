"""Cluster admin commands — the `ceph daemon` / `ceph tell` surface.

Registers cluster-level commands on an AdminServer (common/admin.py)
over a live sim/mon, mirroring the reference's most-used admin and mon
commands: status, df, osd tree, pg dump, scrub, snapshot listing,
health.  Everything returns JSON-able structures so the socket serving
path works unchanged.
"""
from __future__ import annotations

from typing import Any, Dict


def register_cluster_commands(server, sim, mon=None) -> None:
    m = sim.osdmap

    def status(args: Dict[str, Any]) -> Any:
        n = m.max_osd
        ex = m.osd_exists[:n]
        return {
            "epoch": m.epoch,
            "osds": {"total": int(ex.sum()),
                     "up": int((ex & m.osd_up[:n]).sum()),
                     "in": int(sum(1 for i in range(n)
                                   if ex[i] and m.osd_weight[i]))},
            "pools": {pid: {"name": p.name, "pg_num": p.pg_num,
                            "size": p.size, "type": p.type}
                      for pid, p in sorted(m.pools.items())},
            "objects": sum(1 for (pid, n2) in sim.objects
                           if "@" not in n2),
        }

    def df(args: Dict[str, Any]) -> Any:
        out: Dict[int, Dict[str, int]] = {}
        for (pid, name), info in sim.objects.items():
            if "@" in name:
                continue
            s = out.setdefault(pid, {"objects": 0, "bytes": 0})
            s["objects"] += 1
            s["bytes"] += info.size
        for pid in m.pools:
            out.setdefault(pid, {"objects": 0, "bytes": 0})
        return out

    def osd_tree(args: Dict[str, Any]) -> Any:
        from ..placement.treedump import tree_dump
        return tree_dump(m.crush)

    def pg_dump(args: Dict[str, Any]) -> Any:
        """Reports both the raw up sets AND the acting overlays
        (pg_temp/primary_temp) — during recovery the acting set is
        what serves I/O."""
        pid = int(args["pool"])
        pool = m.pools[pid]
        up, prim = m.map_pgs_batch(pid)
        out = {}
        for i in range(len(up)):
            row = {"up": [int(v) for v in up[i]],
                   "primary": int(prim[i])}
            if (pid, i) in m.pg_temp or (pid, i) in m.primary_temp:
                u2, p2, acting, actp = m.pg_to_up_acting_osds(pid, i)
                row["acting"] = acting
                row["acting_primary"] = actp
            out[i] = row
        return {"pool": pid, "pgs": out}

    def scrub(args: Dict[str, Any]) -> Any:
        from .scrub_machine import ScrubMachine, ScrubReservations
        pid = int(args["pool"])
        pool = m.pools[pid]
        pgs = sorted({sim.object_pg(pool, n)
                      for (p2, n) in sim.objects
                      if p2 == pid and "@" not in n})
        res = ScrubReservations()
        out = []
        for pg in pgs:
            r = ScrubMachine(sim, pid, pg,
                             reservations=res).run_to_completion()
            out.append({"pg": f"{pid}.{pg}",
                        "objects": r.objects_scrubbed,
                        "chunks": r.chunks,
                        "inconsistent": r.inconsistent,
                        "missing": r.missing})
        return out

    def snap_ls(args: Dict[str, Any]) -> Any:
        pid = int(args["pool"])
        return {str(sid): name
                for sid, name in sorted(m.pools[pid].snaps.items())}

    server.register("status", status)
    server.register("df", df)
    server.register("osd tree", osd_tree)
    server.register("pg dump", pg_dump)
    server.register("scrub", scrub)
    server.register("snap ls", snap_ls)
    if mon is not None:
        server.register(
            "health",
            lambda a: [
                {"code": c.code, "severity": c.severity,
                 "summary": c.summary}
                for c in mon.health(sim)])
