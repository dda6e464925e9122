"""Thrasher — seeded kill/revive soak with self-healing invariants.

The role of teuthology's ``thrashosds`` task (qa/tasks/thrashosds.py +
ceph_manager.py kill_osd/revive_osd/out_osd/in_osd): under client
load, randomly kill and revive OSDs, mark them out and in, and arm
fault-injection points — then prove the failure pipeline actually
self-heals:

  I1  every client op completes (OpTracker shows zero stuck in-flight)
  I2  zero data loss (readback of every object matches the oracle)
  I3  deep scrub reports 0 inconsistencies after repair
  I4  health converges to HEALTH_OK within a bounded number of ticks
  I5  every armed faultpoint fired at least once (perf-counter proof —
      a soak whose injections never happened proves nothing)

Everything is driven off ONE seeded ``random.Random``: the kill/revive
schedule, write payloads, and the faultpoint schedules (seeded from
the run seed) — the same seed reproduces the identical schedule and
identical fire counts, which is what turns "it survived chaos once"
into a regression test (the determinism the online-EC studies need to
measure degraded-mode behavior under *correlated* failures).

Runs against the in-process tier (ClusterSim + Monitor +
HeartbeatMonitor + Objecter): kills are undetected process deaths
(``fail_osd``) that the heartbeat → failure-report → mark-down →
peering → log-delta-recovery pipeline must notice and repair, exactly
the pipeline the reference exercises.  Time is simulation ticks —
heartbeat ticks and the objecter's TickClock — so a full soak takes no
wall-clock sleeps.

Netsplit mode (``ceph thrash --netsplit``): instead of
killing processes, seeded cut/heal cycles sever a minority of OSDs
from the rest of the cluster via the ``net.partition`` faultpoint —
sometimes one-way (half-open links), sometimes ridden out under the
operator's ``noout``/``nodown`` flags — while ``msg.drop_ack`` loses
committed ops' completions so the session-replay dedup is exercised.
Two invariants join the set: **no op applies twice** (the replay
idempotency oracle, ``ClusterSim.reqid_stats``) and **mon epoch
history is linear** (gapless, forkless — no split brain).  Flap
dampening (markdown hysteresis) runs on the heartbeat tick clock, so
repeated cut/heal flapping holds the flapper down and the settle loop
must out-wait the hold, exactly as a real cluster would.

Port of ``ceph_tpu/cluster/thrasher.py``.  ``build_default_stack``
builds its ``ClusterSim`` on the package default device (the card
unless the caller asked for the CPU), so the EC pool (``plugin=jax``,
bitsliced) stages its shards there and encodes, decodes and rebuilds
on kernel K1; ``python -m ceph_tpu_torch.cluster.thrasher`` runs on the
card.  ``PowerCycleThrasher`` drives the port's vstart daemons (each
asked for the CPU) and a ``RemoteCluster`` on the package default
device; unlike the reference it polls a rebooted victim's admin socket
for the post-cycle fsck instead of asking once while the daemon may
still be booting.
"""
from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import faults
from ..common.op_tracker import tracker as _op_tracker
from .heartbeat import HeartbeatConfig, HeartbeatMonitor
from .monitor import Monitor
from .objecter import Objecter, TooManyRetries, WriteBlocked

# (name, mode, n) triples armed by default: the wire axis (in-process
# messenger frame drops) and the device-EIO axis — the acceptance
# pair.  Seeds derive from the run seed so schedules reproduce.
DEFAULT_FAULTPOINTS: Tuple[Tuple[str, str, int], ...] = (
    ("msg.drop_op", "one_in", 6),
    ("device.eio", "one_in", 8),
)

# the netsplit scenario's default mix: ack loss rides along so the
# session-replay dedup is exercised (committed op, dropped completion,
# resend suppressed) — net.partition itself is armed per cut with its
# seeded GROUPS, not from this table
NETSPLIT_FAULTPOINTS: Tuple[Tuple[str, str, int], ...] = (
    ("msg.drop_op", "one_in", 10),
    ("device.eio", "one_in", 10),
    ("msg.drop_ack", "one_in", 4),
)


def random_bytes(rng: random.Random, n: int) -> bytes:
    """``bytes(rng.getrandbits(8) for _ in range(n))``, drawn at once.

    ``getrandbits(8)`` is the top byte of one 32-bit word of the
    generator, and ``getrandbits(32 * n)`` fills its little-endian
    result with n such words in draw order, so the top byte of each
    word gives the same bytes and leaves the generator in the same
    state.  ``n == 0`` draws nothing."""
    if n <= 0:
        return b""
    words = np.frombuffer(rng.getrandbits(32 * n).to_bytes(4 * n, "little"),
                          dtype="<u4")
    return (words >> 24).astype(np.uint8).tobytes()


@dataclass
class ThrashConfig:
    seed: int = 0
    cycles: int = 5                   # kill/revive rounds
    objects: int = 6                  # oracle objects per pool
    object_size: int = 6144
    writes_per_cycle: int = 3         # client load between fault events
    reads_per_cycle: int = 3          # oracle reads between fault
    # events (continuous I2 verification AND the read-path injection
    # surface — a writes-only soak never evaluates device.eio)
    max_down: int = 2                 # concurrent undetected deaths;
    # must stay <= EC m and < replicated size or kills alone lose data
    revive_prob: float = 0.5          # chance a cycle revives someone
    mark_out_prob: float = 0.3        # chance a down OSD is marked out
    settle_ticks: int = 25            # health-convergence bound (I4)
    grace_ticks: int = 1              # heartbeat grace before report
    faultpoints: Sequence[Tuple[str, str, int]] = DEFAULT_FAULTPOINTS
    # ---- netsplit scenario (`ceph thrash --netsplit`) ----
    netsplit: bool = False            # cut/heal instead of kill/revive
    partition_prob: float = 0.7       # chance a cycle cuts (when whole)
    heal_prob: float = 0.6            # chance a cycle heals (when cut)
    oneway_prob: float = 0.25         # asymmetric (half-open) cuts
    flags_prob: float = 0.2           # ride a cut out under noout+nodown
    max_minority: int = 2             # minority size; <= EC m and
    # < replicated size so the majority side always stays writable
    # markdown hysteresis (Monitor flap dampening), in heartbeat ticks:
    flap_count: int = 3               # markdowns in window -> hold
    flap_window: float = 200.0
    flap_hold: float = 2.0
    flap_hold_cap: float = 12.0


class Thrasher:
    """One seeded soak over a ClusterSim + Monitor stack."""

    def __init__(self, sim, mon: Monitor, pool_ids: Sequence[int],
                 cfg: Optional[ThrashConfig] = None):
        self.sim = sim
        self.mon = mon
        self.pool_ids = list(pool_ids)
        self.cfg = cfg or ThrashConfig()
        self.rng = random.Random(self.cfg.seed)
        self.hb = HeartbeatMonitor(
            sim, mon, HeartbeatConfig(grace_ticks=self.cfg.grace_ticks))
        if self.cfg.netsplit:
            # markdown hysteresis on the heartbeat TICK clock (the
            # HeartbeatMonitor installed itself as mon.flap_clock):
            # repeated cut/heal flapping holds the flapper down
            mon.configure_flap_dampening(
                count=self.cfg.flap_count,
                window=self.cfg.flap_window,
                hold=self.cfg.flap_hold,
                hold_cap=self.cfg.flap_hold_cap)
        self.client = Objecter(sim, mon, max_retries=16,
                               seed=self.cfg.seed)
        self.schedule: List[Tuple] = []   # the reproducibility record
        self.oracle: Dict[Tuple[int, str], bytes] = {}
        self.down: List[int] = []         # currently-killed OSDs
        self.out: List[int] = []          # currently-marked-out OSDs
        self.partition: Optional[Dict[str, Any]] = None  # active cut
        self.flags_set: List[str] = []    # cluster flags we set
        self.failures: List[str] = []     # broken invariants, as found
        # writes blocked below the min_size floor mid-cut, PARKED for
        # re-drive once the cluster can give them parity headroom
        # (heal / markdown re-home): (pool_id, name, data)
        self.parked: List[Tuple[int, str, bytes]] = []
        self.writes_parked = 0            # cumulative park events

    # ------------------------------------------------------------ pieces --
    def _log(self, *event: Any) -> None:
        self.schedule.append(tuple(event))

    def _blob(self, n: int) -> bytes:
        return random_bytes(self.rng, n)

    def _write(self, pool_id: int, name: str) -> None:
        """One tracked client write; retried across map catch-up (the
        resend contract) — a TooManyRetries here after detection ticks
        is a genuine invariant failure and surfaces in the report."""
        data = self._blob(self.cfg.object_size)
        try:
            self.client.put(pool_id, name, data)
        except WriteBlocked:
            # sub-(k+1) landing under a ride-out: the write is durably
            # applied at >= k (reads see the new bytes) but must not
            # ack until the PG has parity headroom again — PARK it
            # first, re-drive after heal/markdown gives the map a way
            # forward.  A parked write that never unblocks is an
            # invariant failure at settle, not here.
            self.parked.append((pool_id, name, data))
            self.writes_parked += 1
            self.oracle[(pool_id, name)] = data
            self._log("write_blocked", pool_id, name)
            return
        except TooManyRetries as e:
            self.failures.append(f"write {pool_id}/{name} did not "
                                 f"complete: {e}")
            return
        self.oracle[(pool_id, name)] = data
        self._log("write", pool_id, name)

    def _read(self, pool_id: int, name: str) -> None:
        """One tracked client read, checked against the oracle AS the
        cluster degrades — reads mid-thrash are both continuous
        data-loss verification and the read-path injection surface
        (device.eio / replica failover / degraded decode)."""
        want = self.oracle.get((pool_id, name))
        if want is None:
            return
        try:
            got = self.client.get(pool_id, name)
        except (TooManyRetries, IOError) as e:
            self.failures.append(f"read {pool_id}/{name} did not "
                                 f"complete: {e}")
            return
        if got != want:
            self.failures.append(f"read {pool_id}/{name}: payload "
                                 f"mismatch mid-thrash")
        self._log("read", pool_id, name)

    def _pick(self) -> Tuple[int, str]:
        pool_id = self.pool_ids[self.rng.randrange(
            len(self.pool_ids))]
        return pool_id, f"thrash-{self.rng.randrange(self.cfg.objects)}"

    def _load(self) -> None:
        for _ in range(self.cfg.writes_per_cycle):
            self._write(*self._pick())
        for _ in range(self.cfg.reads_per_cycle):
            self._read(*self._pick())

    def _kill_one(self) -> None:
        alive = [o.id for o in self.sim.osds
                 if o.alive and o.id not in self.down]
        if not alive or len(self.down) >= self.cfg.max_down:
            return
        victim = alive[self.rng.randrange(len(alive))]
        self.sim.fail_osd(victim)          # undetected death: the
        self.down.append(victim)           # heartbeat pipeline's job
        self._log("kill", victim)
        if self.rng.random() < self.cfg.mark_out_prob:
            inc = self.mon.next_incremental()
            inc.new_weight[victim] = 0
            if self.mon.commit_incremental(inc):
                self.out.append(victim)
                self._log("out", victim)

    def _revive_one(self) -> None:
        if not self.down:
            return
        osd = self.down.pop(self.rng.randrange(len(self.down)))
        self.sim.restart_osd(osd)
        self.mon.osd_boot(osd)             # epoch reaches subscribers
        if osd in self.out:
            self.out.remove(osd)
            self._log("in", osd)
        self._log("revive", osd)

    def _tick_detection(self) -> None:
        """Heartbeat rounds until every current death is map-visible
        (bounded): client resends need the epoch to move."""
        for _ in range(self.cfg.grace_ticks + 2):
            newly = self.hb.tick()
            if newly:
                self._log("marked_down", tuple(sorted(newly)))

    # ------------------------------------------------------- netsplit --
    def _cut(self) -> None:
        """Sever a seeded minority of OSDs from the rest of the
        cluster (client and mon ride the majority side — the sim has
        ONE mon; quorum-side splits are the wire/mon_quorum tier's
        scenario).  Sometimes asymmetric, sometimes ridden out under
        the operator flags."""
        cfg = self.cfg
        candidates = [o.id for o in self.sim.osds if o.alive]
        size = 1 + self.rng.randrange(cfg.max_minority)
        if len(candidates) <= size:
            return
        minority = sorted(self.rng.sample(candidates, size))
        min_ent = [f"osd.{o}" for o in minority]
        maj_ent = ["client", "mon"] + [
            f"osd.{o.id}" for o in self.sim.osds
            if o.id not in minority]
        oneway = self.rng.random() < cfg.oneway_prob
        # oneway cuts groups[0] -> others; orientation decides which
        # half-open shape we get (majority can't reach the minority,
        # or the minority is mute toward the majority)
        min_first = self.rng.random() < 0.5
        groups = [min_ent, maj_ent] if min_first else [maj_ent,
                                                       min_ent]
        if self.rng.random() < cfg.flags_prob:
            # operator rides the known partition out: no markdowns,
            # no auto-outs while the flags hold
            for flag in ("noout", "nodown"):
                if self.mon.set_flag(flag, True):
                    self.flags_set.append(flag)
            self._log("flags_set", tuple(self.flags_set))
        faults.arm("net.partition", groups=groups, oneway=oneway)
        self.partition = {"minority": minority, "oneway": oneway,
                          "min_first": min_first}
        self._log("cut", tuple(minority), oneway, min_first)

    def _heal(self) -> None:
        """Disarm the cut, clear ride-out flags, and re-announce every
        partition victim the map marked down (flap dampening may HOLD
        a flapper — the settle loop keeps re-announcing, exactly like
        the daemon's heartbeat re-boot)."""
        if self.partition is None:
            return
        faults.disarm("net.partition")
        for flag in self.flags_set:
            self.mon.set_flag(flag, False)
        if self.flags_set:
            self._log("flags_cleared", tuple(self.flags_set))
        self.flags_set = []
        self._log("heal", tuple(self.partition["minority"]))
        self.partition = None
        self._boot_survivors()

    def _boot_survivors(self) -> int:
        """Re-announce alive-but-marked-down OSDs (the OSD's own
        MOSDBoot re-send when it sees itself down in a newer map).
        Returns how many announcements the mon REFUSED (held by flap
        dampening or quorum-less)."""
        held = 0
        om = self.sim.osdmap
        for o in self.sim.osds:
            if not o.alive or om.is_up(o.id) or o.id in self.down:
                continue
            if self.mon.osd_boot(o.id):
                self._log("boot", o.id)
            else:
                held += 1
        return held

    def _recover(self) -> None:
        for pool_id in self.pool_ids:
            st = self.sim.recover_delta(pool_id)
            self._log("recover", pool_id, st.get("delta_objects", 0),
                      st.get("backfill_pgs", 0))

    def _unpark(self) -> None:
        """Re-drive writes parked below the min_size floor — an
        idempotent full rewrite under a fresh reqid.  Ones that ack
        unblock; ones still below the floor stay parked for the next
        pass (heal or markdown must eventually free them: a write
        still parked at settle end is an invariant failure)."""
        if not self.parked:
            return
        still: List[Tuple[int, str, bytes]] = []
        for pool_id, name, data in self.parked:
            try:
                self.client.put(pool_id, name, data)
            except WriteBlocked:
                still.append((pool_id, name, data))
                continue
            except TooManyRetries as e:
                self.failures.append(
                    f"parked write {pool_id}/{name} failed on "
                    f"re-drive: {e}")
                continue
            self._log("write_unblocked", pool_id, name)
        self.parked = still

    # --------------------------------------------------------------- run --
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        # fire counts are reported as THIS run's delta: the registry's
        # cumulative tally survives disarm (by design — proof outlives
        # the schedule), so back-to-back runs must not double-count
        fires0 = faults.fire_counts()
        reqid0 = self.sim.reqid_stats()
        for i, (name, mode, n) in enumerate(cfg.faultpoints):
            faults.arm(name, mode=mode, n=n, seed=cfg.seed * 1000 + i)
            self._log("arm", name, mode, n)
        proven = [name for name, _, _ in cfg.faultpoints]
        if cfg.netsplit:
            proven.append("net.partition")
        failures = self.failures
        try:
            # steady-state oracle before the first fault
            for pool_id in self.pool_ids:
                for j in range(cfg.objects):
                    self._write(pool_id, f"thrash-{j}")
            for cycle in range(cfg.cycles):
                self._log("cycle", cycle)
                if cfg.netsplit:
                    if self.partition is None and \
                            self.rng.random() < cfg.partition_prob:
                        self._cut()
                    self._tick_detection()
                    self._load()
                    self._recover()
                    if self.partition is not None and \
                            self.rng.random() < cfg.heal_prob:
                        self._heal()
                        self._tick_detection()
                        self._recover()
                    # parked sub-min_size writes re-drive once the
                    # cluster moved (heal above, or a non-ride-out
                    # cut's markdowns re-homed their PGs)
                    self._unpark()
                else:
                    self._kill_one()
                    self._tick_detection()
                    self._load()
                    self._recover()
                    if self.rng.random() < cfg.revive_prob:
                        self._revive_one()
                        self._tick_detection()
                        self._recover()
                    self._unpark()
            # settle: stop injecting, bring everyone back, repair
            # until health converges (the reference's thrasher also
            # stops thrashing before its final wait_for_clean)
            fire_counts = {
                name: faults.fire_counts().get(name, 0) -
                fires0.get(name, 0)
                for name in proven}
            for name, _, _ in cfg.faultpoints:
                faults.disarm(name)
            self._log("settle")
            if cfg.netsplit:
                self._heal()       # also disarms net.partition
            # _revive_one un-marks out AND restores in-weight
            # (osd_boot commits weight 0x10000), so draining `down`
            # also drains `out` — out is only ever a subset of down
            while self.down:
                self._revive_one()
            self._tick_detection()
            # every parked write must unblock once the cluster is
            # whole — the min_size floor blocks, it must not lose
            self._unpark()
            if self.parked:
                failures.append(
                    f"{len(self.parked)} write(s) still blocked "
                    f"below min_size after full heal")
            health = ""
            health_ticks = cfg.settle_ticks
            for tick in range(cfg.settle_ticks):
                if cfg.netsplit:
                    # flap-held victims keep re-announcing each tick
                    # (the daemon heartbeat's MOSDBoot re-send); the
                    # hold expires on this same tick clock
                    self._boot_survivors()
                self._recover()
                self.hb.tick()
                health = self.mon.health_status(self.sim)
                if health == "HEALTH_OK":
                    health_ticks = tick + 1
                    break
            if health != "HEALTH_OK":                        # I4
                checks = [f"{c.code}: {c.summary}"
                          for c in self.mon.health(self.sim)]
                failures.append(
                    f"health did not converge within "
                    f"{cfg.settle_ticks} ticks: {health} ({checks})")
            # I1: nothing stuck in flight
            inflight = _op_tracker().dump_ops_in_flight()["num_ops"]
            if inflight:
                failures.append(f"{inflight} ops stuck in flight")
            # I2: readback against the oracle — zero data loss
            lost: List[str] = []
            for (pool_id, name), want in sorted(self.oracle.items()):
                try:
                    got = self.client.get(pool_id, name)
                except (IOError, KeyError) as e:
                    lost.append(f"{pool_id}/{name}: unreadable ({e})")
                    continue
                if got != want:
                    lost.append(f"{pool_id}/{name}: payload mismatch")
            failures.extend(lost)
            # I3: deep scrub (EC parity re-encode) clean after repair
            scrub_bad = 0
            for pool_id in self.pool_ids:
                bad = self.sim.scrub(pool_id)
                if bad:
                    self._recover()              # repair, then re-check
                    bad = self.sim.scrub(pool_id)
                scrub_bad += len(bad)
            if scrub_bad:
                failures.append(
                    f"deep scrub: {scrub_bad} inconsistencies "
                    f"after repair")
            # I5: the injections really happened
            for name in proven:
                if fire_counts.get(name, 0) < 1:
                    failures.append(
                        f"faultpoint {name} armed but never fired — "
                        f"the soak exercised nothing")
            # I6 (netsplit): replay idempotency — no logical op was
            # durably applied twice, however many times the cut/ack
            # loss forced the client to resend it
            reqid = self.sim.reqid_stats()
            double_commits = reqid["double_commits"] - \
                reqid0["double_commits"]
            replay_dups = self.client.replay_dups
            if double_commits:
                failures.append(
                    f"replay idempotency broken: {double_commits} "
                    f"ops applied more than once")
            if cfg.netsplit and \
                    fire_counts.get("msg.drop_ack", 0) >= 1 and \
                    replay_dups < 1:
                failures.append(
                    "acks were dropped but no resend was ever "
                    "dup-suppressed — the replay path never ran")
            # I7 (netsplit): mon epoch history is LINEAR — committed
            # incrementals form one gapless, forkless chain ending at
            # the live map (a split brain would fork or repeat epochs)
            epochs = [i.epoch for i in self.mon.incrementals]
            linear = epochs == sorted(set(epochs)) and \
                (not epochs or
                 (epochs == list(range(epochs[0], epochs[-1] + 1)) and
                  epochs[-1] == self.sim.osdmap.epoch))
            if cfg.netsplit and not linear:
                failures.append(
                    f"mon epoch history not linear: "
                    f"{epochs[:5]}..{epochs[-5:]} vs map epoch "
                    f"{self.sim.osdmap.epoch}")
            return {
                "seed": cfg.seed,
                "cycles": cfg.cycles,
                "netsplit": cfg.netsplit,
                "schedule": [list(e) for e in self.schedule],
                "fire_counts": fire_counts,
                "invariants": {
                    "ops_in_flight": inflight,
                    "objects_checked": len(self.oracle),
                    "data_loss": lost,
                    "scrub_inconsistencies": scrub_bad,
                    "health": health,
                    "health_ticks": health_ticks,
                    "backoff_ticks": self.client.clock.sleeps,
                    "replay_double_commits": double_commits,
                    "replay_dups_suppressed": replay_dups,
                    "mon_epochs_linear": linear,
                    "boots_held": self.mon.boots_held,
                    "writes_parked": self.writes_parked,
                    "writes_still_parked": len(self.parked),
                },
                "failures": failures,
                "ok": not failures,
            }
        finally:
            for name, _, _ in cfg.faultpoints:
                faults.disarm(name)
            faults.disarm("net.partition")


# ----------------------------------------------------------- powercycle --

@dataclass
class PowerCycleConfig:
    """`ceph thrash --powercycle`: power-cycle whole OSD *daemons* —
    SIGKILL-class death driven by the store-tier power-loss
    faultpoints, crash-state mutation of the backing BlueStore, then
    reboot under client load."""
    seed: int = 0
    cycles: int = 3
    n_osds: int = 4
    objects: int = 6                  # steady-state oracle objects
    object_size: int = 3072
    writes_per_cycle: int = 3         # steady overwrites (must ack)
    kill_writes: int = 14             # fresh-name writes driven while
    # the armed faultpoint waits to brown the victim out; ones that
    # ack join the oracle, ones the cut interrupts carry no promise
    hb_interval: float = 0.25
    wait_ticks: int = 240             # state-poll budget (0.25s each)


class PowerCycleThrasher:
    """Seeded daemon power-cycle soak (the thrashosds powercycle
    flavor: qa's thrashosds with powercycle=true).

    Per cycle: seeded steady writes (retried until acked), then a
    victim OSD gets ``device.power_loss`` or ``device.torn_write``
    armed over its OWN asok (``exit=True``) — its next store barrier
    or data write browns it out mid-transaction, exactly a power cut.
    If the schedule's write budget never touches the victim's store,
    a SIGKILL fallback keeps the run moving WITHOUT entering the
    schedule (so schedules stay bit-identical per seed).  The dead
    store then takes a crash-state mutation (``tear_wal_tail``: bytes
    off the trailing *partial* WAL record — a fragment that never
    completed its commit), and the daemon reboots: its boot sees the
    POWER_LOSS marker, runs fsck(repair=True), and reports
    STORE_DAMAGED up the heartbeat.

    Invariants: **zero acked-write loss** against the oracle after
    recovery, fsck errors post-cycle reported (and expected 0 — the
    WAL/COW ordering makes power cuts lossless), and the same seed
    reproduces the identical schedule."""

    def __init__(self, cluster_dir: str,
                 cfg: Optional[PowerCycleConfig] = None):
        self.dir = cluster_dir
        self.cfg = cfg or PowerCycleConfig()
        self.rng = random.Random(self.cfg.seed)
        self.schedule: List[Tuple] = []
        self.oracle: Dict[Tuple[int, str], bytes] = {}
        self.failures: List[str] = []
        self.fsck_errors_post_cycle = 0
        self.fsck_repaired = 0
        self.powercycles = 0
        self.fallback_kills = 0

    def _log(self, *event: Any) -> None:
        self.schedule.append(tuple(event))

    def _blob(self, n: int) -> bytes:
        return random_bytes(self.rng, n)

    def _wait(self, fn, desc: str) -> bool:
        """Bounded wait-for-state: the budget is POLLS, not wall
        clock, and a connection error costs one poll (a rebooting
        daemon must not burn the whole window)."""
        import time as _time
        for _ in range(self.cfg.wait_ticks):
            try:
                if fn():
                    return True
            except (OSError, IOError):
                pass
            _time.sleep(0.25)
        self.failures.append(f"wait-for-state timed out: {desc}")
        return False

    def _steady_write(self, rc, name: str) -> None:
        data = self._blob(self.cfg.object_size)
        # the schedule event is logged BEFORE the attempt: whether
        # the write needed one try or twenty is timing, and timing
        # must never leak into the seeded schedule
        self._log("write", 1, name)
        # steady writes are the oracle seed and MUST ack — give them
        # the same poll budget as every other wait-for-state (a
        # daemon rebooting from the previous cycle can eat the put
        # path's own retry budget under contention)
        if self._wait(lambda: rc.put(1, name, data) >= 1,
                      f"steady write {name} acked"):
            self.oracle[(1, name)] = data

    def _powercycle(self, rc, v, cycle: int) -> None:
        from ..common.admin import admin_request
        cfg = self.cfg
        victim = self.rng.randrange(cfg.n_osds)
        point = ("device.power_loss"
                 if self.rng.random() < 0.5 else "device.torn_write")
        n_in = 2 + self.rng.randrange(3)
        self._log("powercycle", cycle, victim, point, n_in)
        asok = os.path.join(self.dir, f"osd.{victim}.asok")
        try:
            admin_request(asok, {
                "prefix": "fault_injection", "action": "arm",
                "name": point, "mode": "one_in", "n": n_in,
                "seed": cfg.seed * 1000 + cycle,
                "params": {"exit": True}})
        except (OSError, IOError) as e:
            self.failures.append(f"arming {point} on osd.{victim} "
                                 f"failed: {e}")
        # fresh-name kill-window writes: acked ones join the oracle
        # (an ack means every landing daemon fsynced), interrupted
        # ones carry no promise.  The rng draws are unconditional so
        # the schedule never depends on WHEN the victim dies.
        for i in range(cfg.kill_writes):
            name = f"pc-{cycle}-{i}"
            data = self._blob(cfg.object_size)
            self._log("kill_write", 1, name)
            try:
                rc.put(1, name, data)
                self.oracle[(1, name)] = data
            except (OSError, IOError):
                pass                  # unacked: no promise
            if not v.alive(f"osd.{victim}"):
                break
        if v.alive(f"osd.{victim}"):
            # the write budget never hit the victim's store: SIGKILL
            # keeps the soak moving (timing-dependent, so it stays
            # OUT of the seeded schedule)
            v.kill9(f"osd.{victim}")
            self.fallback_kills += 1
        self.powercycles += 1
        # crash-state mutation of the dead backing store: tear the
        # WAL's trailing partial record (never a completed commit)
        from .crashdev import tear_wal_tail
        store = os.path.join(self.dir, f"osd.{victim}.store")
        # torn-byte count is timing-dependent (did a partial record
        # exist?) so it stays OUT of the seeded schedule; the rng
        # draw inside tear_wal_tail is unconditional, keeping rng
        # state — and therefore the schedule — bit-identical per seed
        tear_wal_tail(store, self.rng)
        self._log("wal_tear", cycle, victim)
        # reboot: boot-time fsck(repair) runs iff a POWER_LOSS marker
        # landed; collect its verdict over the asok
        v.start_osd(victim, hb_interval=cfg.hb_interval)
        self._wait(lambda: rc.status()["n_up"] >= cfg.n_osds - 1,
                   f"osd.{victim} back up after cycle {cycle}")
        self._post_cycle_fsck(asok, victim)
        try:
            rc.refresh_map()
        except (OSError, IOError):
            pass

    def _post_cycle_fsck(self, asok: str, victim: int) -> None:
        """Collect the rebooted victim's boot-fsck verdict over its asok.
        The wait above counts the OTHER daemons too (n_up >= n - 1), so
        the victim may still be booting: its admin socket refuses until
        then, and each refusal costs one poll of the same budget."""
        from ..common.admin import admin_request
        n_errors: List[int] = []

        def fsck() -> bool:
            r = admin_request(asok, {"prefix": "store_fsck"})["result"]
            n_errors.append(int(r["n_errors"]))
            return True
        try:
            if self._wait(fsck, f"post-cycle fsck on osd.{victim}"):
                self.fsck_errors_post_cycle += n_errors[-1]
        except KeyError as e:
            self.failures.append(
                f"post-cycle fsck on osd.{victim} failed: {e}")

    def run(self) -> Dict[str, Any]:
        from ..client.remote import RemoteCluster
        from ..tools.vstart import Vstart, build_cluster_dir
        cfg = self.cfg
        build_cluster_dir(self.dir, n_osds=cfg.n_osds,
                          osds_per_host=1, fsync=True)
        v = Vstart(self.dir)
        v.start(cfg.n_osds, hb_interval=cfg.hb_interval)
        rc = None
        try:
            rc = RemoteCluster(self.dir)
            for j in range(cfg.objects):
                self._steady_write(rc, f"pcobj-{j}")
            for cycle in range(cfg.cycles):
                self._log("cycle", cycle)
                for _ in range(cfg.writes_per_cycle):
                    self._steady_write(
                        rc, f"pcobj-{self.rng.randrange(cfg.objects)}")
                self._powercycle(rc, v, cycle)
            # settle: everyone up, recover, then the oracle readback
            self._wait(lambda: rc.status()["n_up"] == cfg.n_osds,
                       "all OSDs up at settle")
            rc.refresh_map()
            try:
                rc.recover_pool(1)
            except (OSError, IOError) as e:
                self.failures.append(f"settle recovery failed: {e}")
            lost: List[str] = []
            for (pool_id, name), want in sorted(self.oracle.items()):
                try:
                    got = rc.get(pool_id, name)
                except (OSError, IOError, KeyError) as e:
                    lost.append(f"{pool_id}/{name}: unreadable ({e})")
                    continue
                if got != want:
                    lost.append(f"{pool_id}/{name}: payload mismatch")
            if lost:
                self.failures.extend(lost)
            if self.fsck_errors_post_cycle:
                self.failures.append(
                    f"boot fsck found {self.fsck_errors_post_cycle} "
                    f"damaged objects after power cycles (the WAL/COW "
                    f"ordering should make cuts lossless)")
            return {
                "seed": cfg.seed,
                "cycles": cfg.cycles,
                "powercycle": True,
                "schedule": [list(e) for e in self.schedule],
                "invariants": {
                    "acked_writes_lost": len(lost),
                    "objects_checked": len(self.oracle),
                    "fsck_errors_post_cycle":
                        self.fsck_errors_post_cycle,
                    "powercycles": self.powercycles,
                    "fallback_kills": self.fallback_kills,
                },
                "failures": self.failures,
                "ok": not self.failures,
            }
        finally:
            if rc is not None:
                rc.close()
            v.stop()


# ------------------------------------------------------------ standalone --

def build_default_stack(n_hosts: int = 8, osds_per_host: int = 3,
                        k: int = 4, m: int = 2):
    """A self-contained sim cluster for `ceph thrash` and the
    robustness smoke: replicated + EC pools over a flat host tree
    (same geometry as the test suite's standard sim).  The sim runs on
    the package default device."""
    from ..placement.builder import build_flat_cluster
    from ..placement.crush_map import (RULE_CHOOSELEAF_FIRSTN,
                                       RULE_CHOOSELEAF_INDEP,
                                       RULE_EMIT, RULE_TAKE, Rule)
    from .osdmap import OSDMap, PGPool, POOL_ERASURE, POOL_REPLICATED
    from .simulator import ClusterSim
    cmap, root = build_flat_cluster(n_hosts=n_hosts,
                                    osds_per_host=osds_per_host,
                                    seed=0)
    host_type = 1
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, host_type),
                              (RULE_EMIT, 0, 0)]))
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, host_type),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                       pg_num=32, crush_rule=0))
    om.add_pool(PGPool(id=2, name="ec", type=POOL_ERASURE, size=k + m,
                       pg_num=32, crush_rule=1,
                       erasure_code_profile="default"))
    sim = ClusterSim(om)
    sim.create_ec_profile("default", {"plugin": "jax", "k": str(k),
                                      "m": str(m)})
    mon = Monitor(sim.osdmap, failure_reports_needed=2)
    return sim, mon


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    """`ceph thrash --seed N --cycles K --json`: a self-contained
    seeded soak emitting the invariant report (exit 1 on any broken
    invariant).  Needs no cluster dir — like `ceph lint`, it builds
    its own stack."""
    import argparse
    import sys
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="ceph thrash",
        description="seeded kill/revive soak with self-healing "
                    "invariants (the thrashosds role)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--netsplit", action="store_true",
                    help="seeded partition/heal soak instead of "
                         "kill/revive: cuts a minority of OSDs off "
                         "(sometimes one-way, sometimes ridden out "
                         "under noout/nodown), with session-replay "
                         "and mon-epoch-linearity invariants")
    ap.add_argument("--powercycle", action="store_true",
                    help="power-cycle whole OSD daemons instead: arm "
                         "device.power_loss/torn_write over each "
                         "victim's asok so its store barrier browns "
                         "it out mid-transaction, tear the dead "
                         "store's partial WAL tail, reboot (boot "
                         "fsck reports STORE_DAMAGED) — invariants: "
                         "zero acked-write loss, fsck clean, "
                         "bit-identical schedule per seed")
    ap.add_argument("--json", action="store_true")
    ns = ap.parse_args(argv)
    if ns.powercycle:
        import tempfile
        import shutil
        d = tempfile.mkdtemp(prefix="ceph-powercycle-")
        try:
            t = PowerCycleThrasher(d, PowerCycleConfig(
                seed=ns.seed, cycles=ns.cycles,
                objects=ns.objects))
            report = t.run()
        finally:
            shutil.rmtree(d, ignore_errors=True)
        if ns.json:
            out.write(json.dumps(report, indent=2, sort_keys=True,
                                 default=str) + "\n")
        else:
            inv = report["invariants"]
            out.write(
                f"powercycle seed={report['seed']} "
                f"cycles={report['cycles']}: "
                f"{inv['powercycles']} power cycles "
                f"({inv['fallback_kills']} SIGKILL fallbacks), "
                f"{inv['objects_checked']} objects checked, "
                f"acked_writes_lost={inv['acked_writes_lost']}, "
                f"fsck_errors_post_cycle="
                f"{inv['fsck_errors_post_cycle']}\n")
            for f in report["failures"]:
                out.write(f"FAIL: {f}\n")
            if report["ok"]:
                out.write("all invariants held\n")
        return 0 if report["ok"] else 1
    sim, mon = build_default_stack()
    try:
        cfg = ThrashConfig(seed=ns.seed, cycles=ns.cycles,
                           objects=ns.objects)
        if ns.netsplit:
            cfg.netsplit = True
            cfg.faultpoints = NETSPLIT_FAULTPOINTS
            cfg.settle_ticks = max(cfg.settle_ticks, 40)
        t = Thrasher(sim, mon, [1, 2], cfg)
        report = t.run()
    finally:
        sim.shutdown()
    if ns.json:
        out.write(json.dumps(report, indent=2, sort_keys=True,
                             default=str) + "\n")
    else:
        inv = report["invariants"]
        out.write(
            f"thrash seed={report['seed']} cycles={report['cycles']}: "
            f"{len(report['schedule'])} events, "
            f"fires={report['fire_counts']}, "
            f"objects={inv['objects_checked']}, "
            f"health={inv['health']} "
            f"(in {inv['health_ticks']} ticks)\n")
        for f in report["failures"]:
            out.write(f"FAIL: {f}\n")
        if report["ok"]:
            out.write("all invariants held\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":      # pragma: no cover
    raise SystemExit(main())
