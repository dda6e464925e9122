"""Heartbeat-based failure detection.

Role of the reference's OSD↔OSD heartbeats (OSD::handle_osd_ping,
src/osd/OSD.cc:5327; peer selection maybe_update_heartbeat_peers
:5188): each OSD pings a small peer set every tick; peers that miss
`grace` consecutive ticks get reported to the mon, which marks them
down after enough distinct reporters (Monitor.report_failure).

Partition tolerance: pings consult the ``net.partition``
faultpoint — a peer that is ALIVE but unreachable (netsplit) misses
heartbeats exactly like a dead one, and a reporter cut off from the
mon cannot deliver its report (the minority side of a split detects
the majority as down but can never act on it).  The tick counter is
installed as the Monitor's flap clock so markdown hysteresis runs on
deterministic sim time, and the optional ``down_out_ticks`` grace
drives the automatic down→out transition (mon_osd_down_out_interval
role) that the ``noout`` cluster flag vetoes.

Simulation-time driven (tick()), deterministic peer rings — the piece
under test is the detection/report/mark-down pipeline, not wall-clock
timers.

Port of ``ceph_tpu/cluster/heartbeat.py``: host code.  The telemetry
rollup reads the port's single-process ``parallel.multihost`` answers
(one ``client`` entity, host label ``host0``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..common import faults
from .monitor import Monitor


@dataclass
class HeartbeatConfig:
    n_peers: int = 3          # ring neighbors each OSD monitors
    grace_ticks: int = 3      # missed ticks before reporting
    down_out_ticks: int = 0   # down->out grace (0 = no auto-out)


class HeartbeatMonitor:
    """Drives ping rounds over a ClusterSim's OSD liveness."""

    def __init__(self, sim, mon: Monitor,
                 cfg: Optional[HeartbeatConfig] = None):
        self.sim = sim
        self.mon = mon
        # None -> a FRESH config per monitor: the old
        # `cfg=HeartbeatConfig()` default was evaluated once at class
        # definition, so every default-constructed monitor SHARED one
        # mutable instance (a test tweaking grace_ticks on its monitor
        # silently retuned every other default monitor in the process)
        self.cfg = cfg if cfg is not None else HeartbeatConfig()
        self.missed: Dict[int, Dict[int, int]] = {}   # target -> {peer: n}
        self.marked_down: List[int] = []
        self.ticks = 0
        # boot-fsck damage delivery (the STORE_DAMAGED pipeline): an
        # OSD whose power-loss boot quarantined objects reports the
        # count on its next heartbeat; one clearing zero follows on
        # the tick after, mirroring the daemon tier's slow-op rollup
        self._damage_reported: Set[int] = set()
        self._down_ticks: Dict[int, int] = {}   # map-down tick counts
        self._util_cache: Dict[int, Dict] = {}  # osd -> last util scan
        self.auto_outs: List[int] = []
        # deterministic time for the mon's flap-dampening windows: the
        # heartbeat tick IS the sim's clock (never clobber a clock a
        # test installed explicitly)
        if mon.flap_clock is None:
            mon.flap_clock = lambda: float(self.ticks)

    def peers_of(self, osd: int) -> List[int]:
        """Deterministic ring peers (the front/back messenger peer set)."""
        n = len(self.sim.osds)
        return [(osd + d) % n for d in range(1, self.cfg.n_peers + 1)]

    def _reaches(self, src: int, dst_entity: str) -> bool:
        """Can osd.src deliver a frame to dst right now?  A severed
        link counts a net.partition fire (the proof the cut carried)."""
        return not faults.partitioned(f"osd.{src}", dst_entity)

    # utilization scans are O(store); refresh every N ticks and ship
    # the cached snapshot in between (the daemon tier's
    # _UTIL_SCAN_INTERVAL_S, sim-clock shaped)
    UTIL_SCAN_TICKS = 5

    def _scan_util(self, o) -> Dict:
        """One OSD's store utilization.  Iterates over SNAPSHOTS of
        the store dicts (dispatcher threads mutate them concurrently)
        and treats a mid-scan mutation as 'keep last snapshot' — a
        failed scan must never abort the tick that marks peers down."""
        objects = 0
        nbytes = 0
        pools: Dict = {}
        try:
            for coll, objs in list(o.objectstore._colls.items()):
                vals = list(objs.values())
                objects += len(vals)
                row = pools.setdefault(int(coll[0]),
                                       {"objects": 0, "bytes": 0})
                row["objects"] += len(vals)
                for ob in vals:
                    sz = len(ob.data)
                    nbytes += sz
                    row["bytes"] += sz
        except RuntimeError:
            return self._util_cache.get(o.id) or {
                "bytes": 0, "total_bytes": 0, "objects": 0,
                "pools": {}}
        return {"bytes": nbytes, "total_bytes": 0,
                "objects": objects, "pools": pools}

    def _report_telemetry(self) -> None:
        """ClusterStats rollup, sim tier: per-OSD store utilization,
        per-OSD PG heat tables, and per-OSD ``osd.io`` counters
        SYNTHESIZED from the heat ledger's raw totals (one process is
        one perf domain, so real per-OSD counters don't exist here —
        deriving them from the same ledger makes the heat↔osd.io
        agreement exact by construction and feeds the metrics-history
        rate pipeline per OSD).  The process perf dump still ships
        once under the client entity, mirroring what daemonized OSDs
        ship on their wire heartbeats."""
        import time as _time
        from ..common.perf_counters import COUNTER
        from ..common.perf_counters import perf as _perf
        now = _time.time()
        rescan = (self.ticks % self.UTIL_SCAN_TICKS == 1)
        services = getattr(self.sim, "services", None) or []
        for o in self.sim.osds:
            if not o.alive or not self._reaches(o.id, "mon"):
                continue
            if rescan or o.id not in self._util_cache:
                self._util_cache[o.id] = self._scan_util(o)
            report = {"util": self._util_cache[o.id], "ts": now}
            svc = services[o.id] if o.id < len(services) else None
            heat = getattr(svc, "heat", None)
            if heat is not None:
                # decay runs on the TICK clock: deterministic per seed
                heat.advance(float(self.ticks))
                report["heat"] = heat.dump()
                report["perf"] = {
                    "osd.io": {k: (COUNTER, v)
                               for k, v in heat.totals().items()}}
            self.mon.record_daemon_perf(f"osd.{o.id}", report)
        # the process perf dump carries the data-plane chip counters;
        # under the multi-process plane each rank reports as its own
        # client daemon tagged with its host label, so the mgr's
        # mesh_rollup sees per-(host, chip) cells instead of two
        # ranks overwriting one "client" row
        from ..parallel import multihost as _mh
        label = _mh.host_label()
        entity = "client" if not _mh.is_active() else f"client.{label}"
        self.mon.record_daemon_perf(
            entity, {"perf": _perf().dump_typed(), "ts": now,
                     "host": label})

    def tick(self) -> List[int]:
        """One heartbeat round; returns OSDs newly marked down."""
        self.ticks += 1
        self._report_telemetry()
        newly_down: List[int] = []
        om = self.sim.osdmap
        # store-damage rollup: deliver boot-fsck counts to the mon
        # (only when the reporter can actually reach it), then one
        # clearing zero once the damage report has been delivered
        for o in self.sim.osds:
            if not o.alive or not self._reaches(o.id, "mon"):
                continue
            if o.fsck_errors:
                self.mon.record_store_damage(
                    f"osd.{o.id}", o.fsck_errors,
                    repaired=o.fsck_errors)
                self._damage_reported.add(o.id)
                o.fsck_errors = 0
            elif o.id in self._damage_reported:
                self.mon.record_store_damage(f"osd.{o.id}", 0)
                self._damage_reported.discard(o.id)
        for osd in range(len(self.sim.osds)):
            if not self.sim.osds[osd].alive or not om.is_up(osd):
                continue                      # dead OSDs don't ping
            for peer in self.peers_of(osd):
                if not om.is_up(peer):
                    continue                  # already marked down
                if self.sim.osds[peer].alive and \
                        self._reaches(osd, f"osd.{peer}") and \
                        self._reaches(peer, f"osd.{osd}"):
                    # a ping is a ROUND TRIP: the request must reach
                    # the peer AND the reply must come back, so a
                    # one-way cut in EITHER direction reads as a miss
                    # (the mute-minority half-open link included)
                    self.missed.get(peer, {}).pop(osd, None)
                    continue
                # dead OR alive-but-partitioned: a netsplit looks
                # exactly like death to the ping path
                cnt = self.missed.setdefault(peer, {})
                cnt[osd] = cnt.get(osd, 0) + 1
                if cnt[osd] >= self.cfg.grace_ticks:
                    if not self._reaches(osd, "mon"):
                        continue   # cut off from the mon: the report
                        # never lands (minority-side reporters)
                    if self.mon.report_failure(peer, reporter=osd):
                        newly_down.append(peer)
                        self.missed.pop(peer, None)
                        break
        self.marked_down.extend(newly_down)
        if self.cfg.down_out_ticks:
            self._tick_down_out()
        return newly_down

    def _tick_down_out(self) -> None:
        """Automatic down->out after the grace (the reference mon's
        mon_osd_down_out_interval); ``noout`` vetoes inside the mon."""
        om = self.sim.osdmap
        for osd in range(len(self.sim.osds)):
            if om.is_up(osd):
                self._down_ticks.pop(osd, None)
                continue
            if om.osd_weight[osd] == 0:
                continue                      # already out
            n = self._down_ticks.get(osd, 0) + 1
            self._down_ticks[osd] = n
            if n >= self.cfg.down_out_ticks:
                if self.mon.auto_out_down(osd):
                    self.auto_outs.append(osd)
                    self._down_ticks.pop(osd, None)
