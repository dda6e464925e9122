"""Monitor — the control plane: consensus log, map service, config db,
health checks.

Compact re-creation of the mon's roles (src/mon/):

  * ``QuorumModel`` — the consensus substrate (src/mon/Paxos.{h,cc}): a
    proposal/accept/commit state machine over N in-process ranks with
    majority acceptance and monotone proposal numbers.  One class,
    testable, with the properties that matter: committed versions are
    sequential, a minority cannot commit, a new leader's higher
    proposal number supersedes a stalled one.
  * ``Monitor`` — PaxosService analog hosting:
      - the OSDMap service: full map + Incremental history; consumers
        catch up via get_incrementals(since) (OSDMonitor role —
        src/mon/OSDMonitor.cc map publication);
      - the config db (src/mon/ConfigMonitor.cc): committed key=value
        options pushed into the process options registry at FILE level;
      - health checks (src/mon/HealthMonitor.cc + the osdmap checks):
        OSD_DOWN / OSD_OUT / PG_DEGRADED computed from the current map
        and (optionally) a ClusterSim's shard state;
      - failure reports: OSD peers report a down OSD; past the quorum
        threshold the mon commits a map epoch marking it down
        (OSDMonitor::prepare_failure semantics).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import faults
from ..common.options import LEVEL_FILE, OptionError, config
from ..placement.crush_map import ITEM_NONE
from .osdmap import Incremental, OSDMap

faults.declare("mon.map_churn",
               "piggyback an extra empty epoch bump on a committed "
               "incremental — map churn without state change, forcing "
               "every subscriber through its catch-up/resend path "
               "(the thrash-map-epochs axis)")


# ------------------------------------------------------------- consensus ---

class QuorumModel:
    """In-process MODEL of single-decree quorum acceptance (NOT the
    deployable consensus — that is cluster/mon_quorum.QuorumNode, a
    real elected multi-mon log over the wire; this class backs
    standalone single-mon setups and the consensus unit tests).

    The reference pipelines one decree at a time through
    collect/begin/accept/commit (Paxos.h:57-88 'The Leader election ...
    proposal pipeline').  Here: `propose(value)` runs one round as the
    current leader; commit succeeds iff a majority of live ranks
    accept.  Ranks can be marked unreachable to model partitions.
    """

    def __init__(self, n_ranks: int = 3):
        if n_ranks < 1:
            raise ValueError("need at least one rank")
        self.n_ranks = n_ranks
        self.reachable = [True] * n_ranks
        self.leader = 0
        # per-rank acceptor state: (promised_pn, accepted_pn)
        self.promised = [0] * n_ranks
        self.accepted_pn = [0] * n_ranks
        self.committed: List[Any] = []        # version v = index + 1
        self._pn = 0

    @property
    def version(self) -> int:
        return len(self.committed)

    def quorum(self) -> int:
        return self.n_ranks // 2 + 1

    def elect(self, leader: int) -> int:
        """New leader takes over with a higher proposal number
        (collect phase)."""
        self.leader = leader
        self._pn = (max(self.promised) // 100 + 1) * 100 + leader
        n_promised = 0
        for r in range(self.n_ranks):
            if self.reachable[r] and self.promised[r] < self._pn:
                self.promised[r] = self._pn
                n_promised += 1
        return n_promised

    def propose(self, value: Any) -> bool:
        """begin/accept/commit one value; False when no quorum."""
        if self._pn == 0 or self.promised[self.leader] > self._pn:
            self.elect(self.leader)
        accepts = 0
        for r in range(self.n_ranks):
            if not self.reachable[r]:
                continue
            if self.promised[r] <= self._pn:
                self.accepted_pn[r] = self._pn
                accepts += 1
        if accepts < self.quorum():
            return False
        self.committed.append(value)
        return True


# --------------------------------------------------------------- monitor ---

@dataclass
class HealthCheck:
    code: str
    severity: str          # "HEALTH_WARN" | "HEALTH_ERR"
    summary: str


class Monitor:
    """Single logical mon cluster (QuorumModel-backed) owning the OSDMap.
    Committed state persists into a KeyValueDB (the MonitorDBStore
    role, src/mon/MonitorDBStore.h over src/kv/): prefixes `osdmap`
    (per-epoch incrementals), `config` (central options), `paxos`
    (commit markers)."""

    def __init__(self, osdmap: OSDMap, n_ranks: int = 3,
                 failure_reports_needed: int = 2, db=None,
                 proposer: Optional[Callable[[Tuple], bool]] = None):
        from .kv import MemDB
        self.osdmap = osdmap
        self.paxos = QuorumModel(n_ranks)
        self.incrementals: List[Incremental] = []
        self.config_db: Dict[str, Any] = {}
        self.failure_reports_needed = failure_reports_needed
        self._failure_reports: Dict[int, set] = {}
        self.db = db if db is not None else MemDB()
        # consensus seam: None = the in-process QuorumModel decides AND
        # this object applies inline; a wire-quorum daemon installs its
        # QuorumNode.propose here, and application happens through the
        # quorum's apply path (apply_committed_*) on every rank —
        # including this one — so proposal success implies local state
        # is already updated
        self._proposer = proposer
        # slow-op rollup from daemonized OSDs (each OSD process owns
        # its OWN OpTracker; its heartbeat reports slow_ops_summary()
        # so SLOW_OPS covers the whole cluster, not just this
        # process's tracker): daemon entity -> last nonzero summary
        self._daemon_slow: Dict[str, Dict[str, Any]] = {}
        # boot-time fsck damage rollup (the CrashDev pipeline): an OSD
        # that browned out reports objects its fsck quarantined; the
        # STORE_DAMAGED health check surfaces them until the daemon
        # reports clean (or the reporter ages out like slow ops)
        self._store_damage: Dict[str, Dict[str, Any]] = {}
        # ClusterTelemetry stats aggregation (the PGMap + mgr
        # prometheus role): daemons ship perf counters / histograms /
        # utilization over the heartbeat path; the aggregator merges
        # them into cluster p50/p99/p999, io rates, df / osd df
        from ..mgr.cluster_stats import ClusterStats
        self.cluster_stats = ClusterStats()
        # ------ flap dampening (the osd_markdown_log role) ------
        # an OSD marked down >= _flap_count times inside _flap_window
        # gets its next boot HELD for a doubling backoff (capped), so
        # a flapping link cannot churn the map/peering every tick.
        # Disabled by default (_flap_count = 0): the process tier opts
        # in via the cluster spec, sims via configure_flap_dampening.
        # Time source: wall clock unless a tick clock is installed
        # (HeartbeatMonitor installs its tick counter — seeded soaks
        # must not depend on wall time).
        self._flap_count = 0
        self._flap_window = 60.0
        self._flap_hold = 5.0
        self._flap_hold_cap = 30.0
        self.flap_clock: Optional[Callable[[], float]] = None
        self._markdown_log: Dict[int, List[float]] = {}
        self._boot_hold_until: Dict[int, float] = {}
        self.boots_held = 0           # hysteresis-refused boots

    def set_proposer(self,
                     fn: Optional[Callable[[Tuple], bool]]) -> None:
        self._proposer = fn

    @staticmethod
    def _inc_json(inc: Incremental) -> bytes:
        """Complete serialization — a lossy record would replay into a
        wrong acting set."""
        import json
        return json.dumps({
            "epoch": inc.epoch,
            "new_up": {str(k): v for k, v in inc.new_up.items()},
            "new_weight": {str(k): int(v)
                           for k, v in inc.new_weight.items()},
            "new_primary_affinity": {
                str(k): int(v)
                for k, v in inc.new_primary_affinity.items()},
            "new_pg_upmap_items": {
                f"{p}.{g}": items
                for (p, g), items in inc.new_pg_upmap_items.items()},
            "new_pg_temp": {
                f"{p}.{g}": temp
                for (p, g), temp in inc.new_pg_temp.items()},
            "new_pool_pg_num": {str(k): int(v)
                                for k, v in inc.new_pool_pg_num.items()},
            "new_pools": {str(k): v for k, v in inc.new_pools.items()},
            "old_pools": list(inc.old_pools),
            "new_pool_tier": {str(k): v for k, v in
                              inc.new_pool_tier.items()},
            "new_flags": dict(inc.new_flags),
        }).encode()

    @staticmethod
    def _inc_from_json(blob: bytes) -> Incremental:
        import json
        d = json.loads(blob.decode())
        return Incremental(
            epoch=d["epoch"],
            new_up={int(k): v for k, v in d["new_up"].items()},
            new_weight={int(k): int(v)
                        for k, v in d["new_weight"].items()},
            new_primary_affinity={
                int(k): int(v)
                for k, v in d["new_primary_affinity"].items()},
            new_pg_upmap_items={
                (int(s.split(".")[0]), int(s.split(".")[1])): items
                for s, items in d["new_pg_upmap_items"].items()},
            new_pg_temp={
                (int(s.split(".")[0]), int(s.split(".")[1])): temp
                for s, temp in d["new_pg_temp"].items()},
            new_pool_pg_num={int(k): int(v)
                             for k, v in d.get("new_pool_pg_num",
                                               {}).items()},
            new_pools={int(k): v
                       for k, v in d.get("new_pools", {}).items()},
            old_pools=[int(p) for p in d.get("old_pools", [])],
            new_pool_tier={int(k): v for k, v in
                           d.get("new_pool_tier", {}).items()},
            new_flags={str(k): bool(v) for k, v in
                       d.get("new_flags", {}).items()},
        )

    @classmethod
    def open(cls, base_osdmap: OSDMap, db, n_ranks: int = 3,
             failure_reports_needed: int = 2) -> "Monitor":
        """Mount a monitor from its durable store: replay every
        committed osdmap incremental beyond the base map's epoch and
        reload the config db (MonitorDBStore recovery,
        src/mon/MonitorDBStore.h + Monitor::preinit's map load)."""
        import json
        mon = cls(base_osdmap, n_ranks=n_ranks,
                  failure_reports_needed=failure_reports_needed, db=db)
        for _, blob in db.iterate("osdmap"):
            inc = cls._inc_from_json(blob)
            if inc.epoch <= base_osdmap.epoch:
                continue                    # already in the base map
            if inc.epoch != base_osdmap.epoch + 1:
                raise ValueError(
                    f"mon store gap: incremental epoch {inc.epoch} "
                    f"against map epoch {base_osdmap.epoch} — wrong "
                    "base map for this store")
            base_osdmap.apply_incremental(inc)
            mon.incrementals.append(inc)
        for key, blob in db.iterate("config"):
            value = json.loads(blob.decode())
            mon.config_db[key] = value
            try:
                config().set(key, value, level=LEVEL_FILE)
            except OptionError:
                pass
        # consensus log resumes after the highest committed version
        # (decree payloads are not re-read; markers hold the positions)
        versions = db.keys("paxos")
        if versions:
            mon.paxos.committed = [("recovered",)] * int(versions[-1])
        return mon

    # ------------------------------------------------------- map service --
    def commit_incremental(self, inc: Incremental) -> bool:
        """Propose a map mutation through consensus, then apply.
        Epoch is validated BEFORE proposing so the consensus log can
        never hold a decree the map refused (direct bump_epoch callers
        can race the mon)."""
        if inc.epoch != self.osdmap.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != "
                f"{self.osdmap.epoch} + 1")
        if self._proposer is not None:
            # wire quorum: commit applies on every rank (incl. here)
            # through apply_committed_incremental before this returns
            ok = self._proposer(("osdmap", inc))
        else:
            if not self.paxos.propose(("osdmap", inc)):
                return False
            self.apply_committed_incremental(inc, paxos_marker=True)
            ok = True
        if ok and not getattr(self, "_churning", False) and \
                faults.fire("mon.map_churn") is not None:
            # one extra EMPTY epoch: subscribers must catch up again.
            # Reentrancy-guarded — the churn commit re-enters here and
            # an `always` schedule would otherwise recurse forever.
            self._churning = True
            try:
                self.commit_incremental(self.next_incremental())
            finally:
                self._churning = False
        return ok

    def apply_committed_incremental(self, inc: Incremental,
                                    paxos_marker: bool = False) -> None:
        """Apply + persist an incremental the quorum already decided
        (the commit path every mon rank runs)."""
        if inc.epoch != self.osdmap.epoch + 1:
            raise ValueError(
                f"committed incremental epoch {inc.epoch} does not "
                f"follow map epoch {self.osdmap.epoch}")
        self.osdmap.apply_incremental(inc)
        self.incrementals.append(inc)
        from .kv import WriteBatch
        b = WriteBatch().set("osdmap", f"{inc.epoch:010d}",
                             self._inc_json(inc))
        if paxos_marker:
            b.set("paxos", f"{self.paxos.version:010d}", b"osdmap")
        self.db.submit(b)

    def next_incremental(self) -> Incremental:
        return Incremental(epoch=self.osdmap.epoch + 1)

    def get_incrementals(self, since_epoch: int) -> List[Incremental]:
        """Deltas a consumer at `since_epoch` needs (map subscription)."""
        return [i for i in self.incrementals if i.epoch > since_epoch]

    # --------------------------------------------------------- config db --
    def config_set(self, key: str, value: Any) -> bool:
        """Central config commit (ConfigMonitor): consensus first, then
        push into the process registry at FILE level."""
        if self._proposer is not None:
            return self._proposer(("config", key, value))
        if not self.paxos.propose(("config", key, value)):
            return False
        self.apply_committed_config(key, value, paxos_marker=True)
        return True

    def apply_committed_config(self, key: str, value: Any,
                               paxos_marker: bool = False) -> None:
        self.config_db[key] = value
        import json
        from .kv import WriteBatch
        b = WriteBatch().set("config", key,
                             json.dumps(value).encode())
        if paxos_marker:
            b.set("paxos", f"{self.paxos.version:010d}", b"config")
        self.db.submit(b)
        try:
            config().set(key, value, level=LEVEL_FILE)
        except OptionError:
            pass          # unknown keys stay mon-side only

    def config_get(self, key: str) -> Any:
        return self.config_db.get(key)

    # ------------------------------------------------------------- flags --
    def set_flag(self, flag: str, on: bool = True) -> bool:
        """Set/clear a cluster-wide osdmap flag (noout/nodown) through
        a committed incremental — `ceph osd set noout` (OSDMonitor
        prepare_command CEPH_OSDMAP_* role)."""
        from .osdmap import CLUSTER_FLAGS
        if flag not in CLUSTER_FLAGS:
            raise ValueError(f"unknown osdmap flag {flag!r} "
                             f"(known: {CLUSTER_FLAGS})")
        if (flag in self.osdmap.flags) == on:
            return True              # idempotent: already there
        inc = self.next_incremental()
        inc.new_flags[flag] = on
        return self.commit_incremental(inc)

    # ----------------------------------------------------- flap damping --
    def configure_flap_dampening(self, count: int, window: float,
                                 hold: float,
                                 hold_cap: float) -> None:
        """Arm markdown hysteresis: ``count`` markdowns inside
        ``window`` hold the next boot for ``hold`` (doubling per extra
        markdown, capped at ``hold_cap``).  count=0 disables."""
        self._flap_count = int(count)
        self._flap_window = float(window)
        self._flap_hold = float(hold)
        self._flap_hold_cap = float(hold_cap)

    def _flap_now(self) -> float:
        import time as _time
        return self.flap_clock() if self.flap_clock is not None \
            else _time.monotonic()

    def _record_markdown(self, osd: int) -> None:
        if not self._flap_count:
            return
        now = self._flap_now()
        log = [t for t in self._markdown_log.get(osd, [])
               if now - t <= self._flap_window]
        log.append(now)
        self._markdown_log[osd] = log
        extra = len(log) - self._flap_count
        if extra >= 0:
            hold = min(self._flap_hold_cap,
                       self._flap_hold * (2.0 ** extra))
            self._boot_hold_until[osd] = now + hold

    def flap_status(self, osd: int) -> Dict[str, Any]:
        now = self._flap_now()
        return {
            "markdowns_in_window": len(
                [t for t in self._markdown_log.get(osd, [])
                 if now - t <= self._flap_window]),
            "held_for": max(0.0, self._boot_hold_until.get(osd, 0.0)
                            - now),
        }

    # ---------------------------------------------------- failure reports --
    def report_failure(self, target: int, reporter: int) -> bool:
        """OSD peers report a dead peer; at the threshold the mon
        commits an epoch marking it down (OSDMonitor::prepare_failure).
        Returns True when the target was marked down.  The ``nodown``
        cluster flag vetoes the markdown (reports still accumulate, so
        clearing the flag acts on the evidence immediately) — the
        operator's ride-out-a-known-partition knob."""
        if not self.osdmap.is_up(target):
            return False
        reps = self._failure_reports.setdefault(target, set())
        reps.add(reporter)
        if len(reps) < self.failure_reports_needed:
            return False
        if "nodown" in self.osdmap.flags:
            return False
        inc = self.next_incremental()
        inc.new_up[target] = False
        if self.commit_incremental(inc):
            del self._failure_reports[target]
            self._record_markdown(target)
            return True
        return False

    def auto_out_down(self, osd: int) -> bool:
        """Down->out transition after the grace (the
        mon_osd_down_out_interval role, driven by the heartbeat
        monitor's tick): vetoed by the ``noout`` flag."""
        if "noout" in self.osdmap.flags:
            return False
        if self.osdmap.is_up(osd) or self.osdmap.osd_weight[osd] == 0:
            return False
        inc = self.next_incremental()
        inc.new_weight[osd] = 0
        return self.commit_incremental(inc)

    def osd_boot(self, osd: int, weight: int = 0x10000) -> bool:
        """An OSD announces itself up (the MOSDBoot path,
        OSDMonitor::prepare_boot): commits a map epoch marking it up
        and restoring its in-weight, so subscribed clients catch up.
        A flapping OSD (markdown hysteresis engaged) is HELD down for
        its backoff: the boot returns False and the announcer retries
        — the reference's osd_markdown_log suicide/backoff shape."""
        hold = self._boot_hold_until.get(osd)
        if hold is not None:
            if self._flap_now() < hold:
                self.boots_held += 1
                return False
            del self._boot_hold_until[osd]
        inc = self.next_incremental()
        inc.new_up[osd] = True
        inc.new_weight[osd] = weight
        if not self.commit_incremental(inc):
            return False
        # a boot cancels pending failure reports (prepare_boot):
        # otherwise stale pre-boot reporters count toward marking the
        # fresh OSD down again
        self._failure_reports.pop(osd, None)
        return True

    # ------------------------------------------------------------ health --
    def health(self, sim=None,
               include_pg_state: bool = True) -> List[HealthCheck]:
        """HealthMonitor analog over the current map (+ optional sim
        shard state for degraded-PG detection).

        ``include_pg_state=False`` skips the PG_DEGRADED sweep: it
        runs the batched device mapper over every pool, which is the
        right cost in-process but compiles the mapper inside a mon
        DAEMON whose only other duties are map/auth bookkeeping — the
        wire `health` command defaults it off and lets callers opt
        in (``{"cmd": "health", "pgs": True}``)."""
        checks: List[HealthCheck] = []
        om = self.osdmap
        exists = om.osd_exists
        down = int((exists & ~om.osd_up).sum())
        if down:
            checks.append(HealthCheck(
                "OSD_DOWN", "HEALTH_WARN", f"{down} osds down"))
        out = int((exists & (om.osd_weight == 0)).sum())
        if out:
            checks.append(HealthCheck(
                "OSD_OUT", "HEALTH_WARN", f"{out} osds out"))
        degraded = 0
        ups = {}
        for pid in (om.pools if include_pg_state else ()):
            up, _ = om.map_pgs_batch(pid)
            ups[pid] = up
            holes = (up == ITEM_NONE).any(axis=1)
            degraded += int(holes.sum())
        stale = 0
        if sim is not None:
            # real shard-state input: PGs whose log is ahead of some up
            # member's last applied version — reusing the batched up
            # arrays computed above (one scalar do_rule per PG would be
            # exactly the cost the batched mapper exists to remove);
            # the sparse pg_temp overlay still takes the scalar path
            from .pglog import ZERO
            for (pid, pg), log in sim.pg_logs.items():
                pool = om.pools.get(pid)
                if pool is None or log.head == ZERO:
                    continue
                if (pid, pg) in om.pg_temp:
                    members = sim.pg_up(pool, pg)
                elif pid in ups and pg < len(ups[pid]):
                    members = [int(o) for o in ups[pid][pg]]
                else:
                    continue
                for o in members:
                    if o == ITEM_NONE:
                        continue
                    lc = sim.osds[o].last_complete.get((pid, pg), ZERO)
                    if lc < log.head:
                        stale += 1
                        break
        if degraded or stale:
            checks.append(HealthCheck(
                "PG_DEGRADED", "HEALTH_WARN",
                f"{degraded} pgs with unfilled slots, "
                f"{stale} pgs with stale replicas"))
        # SLOW_OPS (the HealthMonitor "N slow ops" rollup): ops
        # currently blocked past op_tracker_complaint_time plus
        # recently completed slow ops, from this process's tracker
        # (which sees everything in the in-process sim) MERGED with
        # the summaries daemonized OSDs report over the wire
        # (report_slow_ops on their heartbeat) — their trackers live
        # in other processes
        import time as _time
        from ..common.op_tracker import tracker as _op_tracker
        slow = _op_tracker().slow_ops_summary()
        num = int(slow["num"])
        oldest = float(slow["oldest_s"])
        daemons = list(slow["daemons"])
        now = _time.time()
        for entity, rep in sorted(self._daemon_slow.items()):
            if now - float(rep.get("ts", now)) > 600.0:
                continue              # reporter gone silent: stale
            num += int(rep.get("num", 0))
            oldest = max(oldest, float(rep.get("oldest_s", 0.0)))
            for d in rep.get("daemons") or [entity]:
                if d not in daemons:
                    daemons.append(d)
        if num:
            names = ",".join(sorted(daemons)) or "unknown"
            checks.append(HealthCheck(
                "SLOW_OPS", "HEALTH_WARN",
                f"{num} slow ops, oldest one blocked for "
                f"{oldest:.3f} sec, daemons [{names}] "
                f"have slow ops"))
        # STORE_DAMAGED (the CrashDev boot-fsck rollup): a power-cut
        # OSD quarantined torn objects at boot — recovery must
        # re-replicate them, and the operator must know it happened
        dmg_n = 0
        dmg_daemons = []
        for entity, rep in sorted(self._store_damage.items()):
            if now - float(rep.get("ts", now)) > 600.0:
                continue              # reporter gone silent: stale
            if int(rep.get("errors", 0)) > 0:
                dmg_n += int(rep["errors"])
                dmg_daemons.append(entity)
        if dmg_n:
            checks.append(HealthCheck(
                "STORE_DAMAGED", "HEALTH_WARN",
                f"{dmg_n} objects quarantined by boot-time fsck on "
                f"[{','.join(dmg_daemons)}] (power-loss damage; "
                f"recovery re-replicates)"))
        return checks

    def record_daemon_slow_ops(self, daemon: str,
                               summary: Dict[str, Any]) -> None:
        """Ingest one daemon's ``slow_ops_summary()`` (reported over
        the wire on its heartbeat).  A zero report clears the entry —
        an OSD whose slow window drained stops contributing; a daemon
        that stops reporting entirely ages out of health() after 600s."""
        import time as _time
        if summary and int(summary.get("num", 0)) > 0:
            self._daemon_slow[daemon] = dict(summary,
                                             ts=_time.time())
        else:
            self._daemon_slow.pop(daemon, None)

    def record_daemon_perf(self, daemon: str,
                           report: Dict[str, Any]) -> None:
        """Ingest one daemon's telemetry report (perf counter dump +
        store utilization, shipped on its heartbeat like the slow-op
        summaries) into the cluster stats aggregator."""
        self.cluster_stats.ingest(daemon, report)

    def record_store_damage(self, daemon: str, errors: int,
                            repaired: int = 0) -> None:
        """Ingest one daemon's boot-fsck report (the heartbeat
        carries it).  A zero-error report clears the entry — the
        daemon's store fsck'd clean again."""
        import time as _time
        if int(errors) > 0:
            self._store_damage[daemon] = {
                "errors": int(errors), "repaired": int(repaired),
                "ts": _time.time()}
        else:
            self._store_damage.pop(daemon, None)

    def health_status(self, sim=None) -> str:
        checks = self.health(sim)
        if any(c.severity == "HEALTH_ERR" for c in checks):
            return "HEALTH_ERR"
        return "HEALTH_WARN" if checks else "HEALTH_OK"
