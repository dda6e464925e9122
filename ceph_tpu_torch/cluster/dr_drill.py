"""DR drill — two-zone disaster recovery as a gated scenario.

``ceph serve --dr`` (and this module's ``drill_main``): run a seeded
S3 workload against zone A while zone B syncs, sever the zones with
the existing ``net.partition`` faultpoint (entities ``zone.a`` /
``zone.b`` — the same axis the daemons' netsplits arm), FAIL WRITES
OVER to zone B, heal, and gate HARD on convergence:

  * every acked ETag readable in BOTH zones (the acked-oracle rule
    the serving harness uses, applied cross-zone);
  * zero replay double-applies and zero full-sync restarts
    (structural counters on the sync agents);
  * bounded replication lag, read as p99 off the MERGED per-agent
    lag histograms (mgr.cluster_stats.merge_histograms/quantile —
    the cluster histogram-merge path);
  * the sever provably bit (partition fire counts + a blocked pump),
    and — when a reshard ran mid-catch-up — the generation cutover
    actually happened.

The gate is falsifiable: ``--lose-bilog`` arms the seeded
``rgw.bilog_lost_entry`` fault for exactly one append (an acked write
whose bilog entry is silently dropped) and the drill MUST exit red.

Tiers: the default drill runs on two in-process sim clusters (fast,
deterministic — same-seed runs produce identical schedules, asserted
via the schedule digest).  ``--chaos`` makes zone A a live Vstart
cluster and composes kill9 + powercycle (device.power_loss +
torn-WAL reboot) of zone-A OSDs into the catch-up phase, while zone B
keeps syncing across the process boundary.

In this package the sim zones' ``ClusterSim`` and the live zone's
``RemoteCluster`` take the package default device (the card) unless
``--device`` (or ``set_default_device``) asks for another; the live
zone's daemons run on the CPU.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common import faults

_BUCKET = "dr"


@dataclass
class DrillConfig:
    seed: int = 0
    keys: int = 16                 # distinct hot keys per phase
    phase_ops: int = 36            # ops per write phase
    shards: int = 4                # source bucket index shards
    reshard_to: int = 8            # 0 = no mid-catch-up reshard
    lag_bound_s: float = 60.0      # replication-lag p99 gate
    heal_rounds: int = 60          # pump budget for convergence
    lose_bilog: bool = False       # falsifiability: drop one append
    chaos: bool = False            # live zone A + kill/powercycle
    n_osds: int = 3                # live-tier zone A size
    hb_interval: float = 0.25
    chaos_hold_s: float = 0.8
    workdir: Optional[str] = None  # live-tier cluster dir root
    json_out: bool = False


# ------------------------------------------------------------- zones --

class _SimZone:
    """One in-process zone: sim cluster + Rados client + gateway."""

    def __init__(self, name: str):
        from ..client.rados import Rados
        from ..rgw.gateway import RGWGateway
        from .thrasher import build_default_stack
        self.name = name
        self.sim, mon = build_default_stack(n_hosts=4,
                                            osds_per_host=2,
                                            k=2, m=1)
        self.ioctx = Rados(self.sim, mon).connect().open_ioctx("rep")
        self.gw = RGWGateway(self.ioctx)
        self.live = False

    def close(self) -> None:
        self.sim.shutdown()


class _LiveZone:
    """One process-tier zone: Vstart daemons + remote client +
    gateway (the chaos tier — kill9/powercycle need real PIDs and a
    real store to tear)."""

    def __init__(self, name: str, workdir: str, n_osds: int,
                 hb_interval: float):
        from ..client.remote import RemoteCluster
        from ..client.remote_ioctx import RemoteIoCtx
        from ..rgw.gateway import RGWGateway
        from ..tools.vstart import Vstart, build_cluster_dir
        self.name = name
        self.n_osds = n_osds
        self.hb_interval = hb_interval
        self.dir = os.path.join(workdir, f"zone_{name}")
        build_cluster_dir(self.dir, n_osds=n_osds, osds_per_host=1,
                          fsync=True, n_mons=1)
        self.v = Vstart(self.dir)
        self.v.start(n_osds, hb_interval=hb_interval)
        self.rc = RemoteCluster(self.dir)
        self.ioctx = RemoteIoCtx(self.rc, "rep")
        self.gw = RGWGateway(self.ioctx)
        self.live = True

    def close(self) -> None:
        try:
            self.rc.close()
        finally:
            self.v.stop()


# ------------------------------------------------------------- drill --

class DrDrill:
    """One seeded sever -> failover -> heal -> verify run."""

    def __init__(self, cfg: DrillConfig):
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.oracle: Dict[str, Dict[str, Any]] = {}
        self.schedule: List[Tuple] = []
        self.events: List[str] = []
        self.failures: List[str] = []
        self.chaos_log: List[Tuple[str, int]] = []

    # ------------------------------------------------------- workload --
    def _data(self, key: str, i: int, zone: str) -> bytes:
        return (f"{key}:{i}:{zone}|".encode()
                * self.rng.randrange(8, 64))

    def _one_op(self, zone, phase: str, i: int) -> None:
        """One seeded put/delete against ``zone``; only ACKED results
        enter the oracle (a raised write proves nothing either way —
        the serving harness's acked-oracle rule)."""
        key = f"k{self.rng.randrange(self.cfg.keys):03d}"
        live = [k for k, v in self.oracle.items()
                if not v.get("deleted") and k.startswith("k")]
        do_delete = live and self.rng.random() < 0.18
        if do_delete:
            key = live[self.rng.randrange(len(live))]
        data = b"" if do_delete else self._data(key, i, zone.name)
        self.schedule.append((phase, zone.name,
                              "delete" if do_delete else "put",
                              key, len(data)))
        try:
            b = zone.gw.bucket(_BUCKET)
            if do_delete:
                b.delete_object(key)
                self.oracle[key] = {"deleted": True}
            else:
                etag = b.put_object(key, data)
                self.oracle[key] = {"etag": etag}
        except (IOError, OSError) as e:
            # un-acked op: the oracle keeps the previous acked state
            self.events.append(f"{phase} op {i} {key}: "
                               f"{type(e).__name__}: {e}")

    # ----------------------------------------------------------- sync --
    def _pump(self, agents: List, rounds: int = 1
              ) -> Tuple[int, int]:
        """Run each agent ``rounds`` passes; -> (applied, errors)."""
        applied = errors = 0
        for _ in range(rounds):
            for ag in agents:
                if ag is None:
                    continue
                try:
                    s = ag.sync()
                    applied += s["puts"] + s["deletes"]
                    errors += len(ag.last_errors)
                except (IOError, OSError) as e:
                    errors += 1
                    self.events.append(f"sync {ag.src_zone}->"
                                       f"{ag.zone}: "
                                       f"{type(e).__name__}: {e}")
        return applied, errors

    def _pump_until_quiet(self, agents: List,
                          budget: int) -> bool:
        """Pump until two consecutive all-quiet rounds (nothing
        applied, no errors) — the convergence condition."""
        quiet = 0
        for _ in range(budget):
            applied, errors = self._pump(agents)
            if applied == 0 and errors == 0:
                quiet += 1
                if quiet >= 2:
                    return True
            else:
                quiet = 0
        return False

    # ---------------------------------------------------------- chaos --
    def _chaos_event(self, zone, kind: str) -> None:
        """kill9 or powercycle one zone-A OSD mid-catch-up (live
        tier only).  Each event heals before the drill continues —
        catch-up must survive the shape, not an unbounded pileup."""
        import contextlib

        from ..common.admin import admin_request
        from .crashdev import tear_wal_tail
        victim = self.rng.randrange(zone.n_osds)
        self.chaos_log.append((kind, victim))
        self.events.append(f"chaos: {kind} osd.{victim}")
        if kind == "kill":
            zone.v.kill9(f"osd.{victim}")
            time.sleep(self.cfg.chaos_hold_s)
        else:                                     # powercycle
            with contextlib.suppress(OSError, IOError):
                admin_request(
                    os.path.join(zone.dir, f"osd.{victim}.asok"),
                    {"prefix": "fault_injection", "action": "arm",
                     "name": "device.power_loss", "mode": "one_in",
                     "n": 2, "seed": self.cfg.seed * 7 + victim,
                     "params": {"exit": True}})
            # scratch traffic trips the armed barrier (these writes
            # are MEANT to die; they never enter the oracle)
            with contextlib.suppress(OSError, IOError):
                sb = zone.gw.bucket("chaos-scratch")
                for i in range(8):
                    if not zone.v.alive(f"osd.{victim}"):
                        break
                    sb.put_object(f"s{i}", b"brownout" * 32)
            if zone.v.alive(f"osd.{victim}"):
                zone.v.kill9(f"osd.{victim}")   # fallback: keep moving
            tear_wal_tail(
                os.path.join(zone.dir, f"osd.{victim}.store"),
                self.rng)
        zone.v.start_osd(victim, hb_interval=zone.hb_interval)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                not zone.v.alive(f"osd.{victim}"):
            time.sleep(0.2)
        with contextlib.suppress(OSError, IOError):
            zone.rc.refresh_map()

    # ------------------------------------------------------------ run --
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        from ..common.perf_counters import perf as _perf
        from ..rgw.sync import BucketSyncAgent, make_sync_engine
        for pair in ("a.b", "b.a"):
            _perf(f"geosync.{pair}").reset()
        za = zb = None
        engine = make_sync_engine(4)
        resharded = False
        try:
            if cfg.chaos:
                import tempfile
                workdir = cfg.workdir or tempfile.mkdtemp(
                    prefix="drdrill_")
                za = _LiveZone("a", workdir, cfg.n_osds,
                               cfg.hb_interval)
            else:
                za = _SimZone("a")
            zb = _SimZone("b")
            za.gw.create_bucket(_BUCKET, num_shards=cfg.shards)
            if cfg.chaos:
                za.gw.create_bucket("chaos-scratch")
            ab = BucketSyncAgent(za.gw, zb.gw, _BUCKET, zone="b",
                                 src_zone="a", engine=engine)
            ba = None
            agents = [ab]
            # ---- phase 1: normal serving against A, B catching up --
            chaos_at = {}
            if cfg.chaos:
                chaos_at = {cfg.phase_ops // 3: "kill",
                            (2 * cfg.phase_ops) // 3: "powercycle"}
            for i in range(cfg.phase_ops):
                self._one_op(za, "normal", i)
                if cfg.reshard_to and i == cfg.phase_ops // 2:
                    self.schedule.append(("reshard", "a",
                                          cfg.reshard_to))
                    za.gw.reshard_bucket(_BUCKET, cfg.reshard_to)
                    resharded = True
                    self.events.append(
                        f"resharded {_BUCKET} {cfg.shards} -> "
                        f"{cfg.reshard_to} mid-catch-up")
                if i in chaos_at:
                    self._chaos_event(za, chaos_at[i])
                if i % 6 == 5:
                    self._pump(agents)
            if not self._pump_until_quiet(agents, cfg.heal_rounds):
                self.failures.append("pre-sever catch-up never went "
                                     "quiet")
            # the reverse agent exists from here: B's bucket is real
            ba = BucketSyncAgent(zb.gw, za.gw, _BUCKET, zone="a",
                                 src_zone="b", engine=engine)
            agents = [ab, ba]
            # ---- sever ---------------------------------------------
            fires0 = faults.fire_counts().get("net.partition", 0)
            faults.arm("net.partition",
                       groups=[["zone.a"], ["zone.b"]])
            self.events.append("severed zone.a <-> zone.b")
            # a canary acked on A during the partition must cross
            # after heal; pumping it NOW must visibly fail
            try:
                etag = za.gw.bucket(_BUCKET).put_object(
                    "canary-sever", b"written during the partition")
                self.oracle["canary-sever"] = {"etag": etag}
                self.schedule.append(("sever", "a", "put",
                                      "canary-sever", 31))
            except (IOError, OSError) as e:
                self.events.append(f"canary write failed: {e}")
            _applied, errs = self._pump([ab])
            sever_verified = (
                errs > 0 and
                faults.fire_counts().get("net.partition", 0) > fires0)
            # ---- failover: writes move to B ------------------------
            for i in range(cfg.phase_ops):
                self._one_op(zb, "failover", i)
            if cfg.lose_bilog:
                # falsifiability: ONE acked write whose bilog entry
                # is dropped — replication can never learn about it,
                # so the convergence gate below MUST go red
                faults.arm("rgw.bilog_lost_entry", mode="always",
                           count=1)
                try:
                    etag = zb.gw.bucket(_BUCKET).put_object(
                        "lost-canary", b"this entry never logs")
                    self.oracle["lost-canary"] = {"etag": etag}
                    self.schedule.append(("failover", "b", "put",
                                          "lost-canary", 26))
                finally:
                    faults.disarm("rgw.bilog_lost_entry")
            # ---- heal ----------------------------------------------
            faults.disarm("net.partition")
            self.events.append("healed the partition")
            converged = self._pump_until_quiet(agents,
                                               cfg.heal_rounds)
            # ---- gate ----------------------------------------------
            gate = evaluate_gate(
                self.oracle, za, zb, [a for a in agents if a],
                lag_bound_s=cfg.lag_bound_s,
                sever_verified=sever_verified, converged=converged,
                resharded=resharded)
            self.failures.extend(gate["failures"])
            digest = hashlib.sha256(
                json.dumps(self.schedule, sort_keys=True).encode()
            ).hexdigest()
            return {
                "seed": cfg.seed,
                "ok": not self.failures,
                "failures": self.failures,
                "converged": converged,
                "sever_verified": sever_verified,
                "resharded": resharded,
                "keys": len(self.oracle),
                "lag_p99_s": gate["lag_p99_s"],
                "lag_samples": gate["lag_samples"],
                "agents": {f"{a.src_zone}->{a.zone}": dict(a.stats)
                           for a in agents if a},
                "chaos": list(self.chaos_log),
                "events": self.events,
                "schedule_digest": digest,
            }
        finally:
            faults.disarm("net.partition")
            faults.disarm("rgw.bilog_lost_entry")
            engine.close()
            for z in (za, zb):
                if z is not None:
                    try:
                        z.close()
                    except Exception:
                        pass


def evaluate_gate(oracle: Dict[str, Dict[str, Any]], za, zb,
                  agents: List, lag_bound_s: float,
                  sever_verified: bool, converged: bool,
                  resharded: bool) -> Dict[str, Any]:
    """The hard convergence verdict, pure over its inputs: acked
    ETags in BOTH zones, structural at-most-once counters, merged
    replication-lag p99 under the bound, and drill honesty (the
    sever bit; the reshard cut over)."""
    from ..mgr.cluster_stats import merge_histograms, quantile
    from ..rgw.gateway import RGWError
    failures: List[str] = []
    if not converged:
        failures.append("zones did not converge within the heal "
                        "budget")
    if not sever_verified:
        failures.append("net.partition never blocked a pump — the "
                        "drill severed nothing")
    for zname, zone in (("a", za), ("b", zb)):
        try:
            b = zone.gw.bucket(_BUCKET)
        except RGWError:
            failures.append(f"zone {zname}: bucket {_BUCKET!r} "
                            f"missing")
            continue
        for key, want in sorted(oracle.items()):
            try:
                _data, ent = b.get_object(key)
                if want.get("deleted"):
                    failures.append(f"zone {zname}: {key} readable "
                                    f"after acked delete")
                elif ent["etag"] != want["etag"]:
                    failures.append(
                        f"zone {zname}: {key} etag "
                        f"{ent['etag'][:8]} != acked "
                        f"{want['etag'][:8]}")
            except RGWError:
                if not want.get("deleted"):
                    failures.append(f"zone {zname}: acked key {key} "
                                    f"unreadable")
    double = sum(a.stats["double_applies"] for a in agents)
    if double:
        failures.append(f"{double} double-applies — at-most-once "
                        f"replay broke")
    fulls = sum(a.stats["full_syncs"] for a in agents)
    if fulls:
        failures.append(f"{fulls} full-sync restarts — cutover must "
                        f"drain, not restart")
    if resharded and not any(a.stats["gen_cutovers"] for a in agents):
        failures.append("reshard ran but no generation cutover was "
                        "recorded")
    merged = merge_histograms([a.lag_dump() for a in agents])
    p99 = quantile(merged, 0.99)
    if p99 is None:
        failures.append("no replication-lag samples recorded — the "
                        "lag bound was never exercised")
    elif p99 > lag_bound_s:
        failures.append(f"replication-lag p99 {p99:.3f}s exceeds "
                        f"the {lag_bound_s}s bound")
    return {"failures": failures, "lag_p99_s": p99,
            "lag_samples": int(merged.get("count", 0))}


def run_drill(cfg: DrillConfig) -> Dict[str, Any]:
    return DrDrill(cfg).run()


def drill_main(argv: Optional[Sequence[str]] = None,
               out=None) -> int:
    """`ceph serve --dr [--seed N --chaos --lose-bilog --json]` —
    exit 0 only when the convergence gate holds."""
    import argparse
    import sys
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="ceph serve --dr",
        description="two-zone DR drill: sever, fail over, heal, "
                    "gate on convergence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=16)
    ap.add_argument("--phase-ops", type=int, default=36)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reshard-to", type=int, default=8,
                    help="reshard the source bucket to this many "
                         "shards mid-catch-up (0 = skip)")
    ap.add_argument("--lag-bound-s", type=float, default=60.0)
    ap.add_argument("--lose-bilog", action="store_true",
                    help="falsifiability check: drop one acked "
                         "write's bilog entry — the gate MUST fail")
    ap.add_argument("--chaos", action="store_true",
                    help="zone A runs live OSD daemons and eats "
                         "kill9 + powercycle during catch-up")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the zones' clusters (default: the "
                         "package default, cuda)")
    ns = ap.parse_args(list(argv or []))
    if ns.device is not None:
        from .. import set_default_device
        set_default_device(ns.device)
    cfg = DrillConfig(seed=ns.seed, keys=ns.keys,
                      phase_ops=ns.phase_ops, shards=ns.shards,
                      reshard_to=ns.reshard_to,
                      lag_bound_s=ns.lag_bound_s,
                      lose_bilog=ns.lose_bilog, chaos=ns.chaos,
                      json_out=ns.json)
    report = run_drill(cfg)
    if ns.json:
        out.write(json.dumps(report, indent=2, sort_keys=True)
                  + "\n")
    else:
        out.write(f"dr drill seed={report['seed']} "
                  f"keys={report['keys']} "
                  f"lag_p99={report['lag_p99_s']} "
                  f"{'OK' if report['ok'] else 'FAILED'}\n")
        for f in report["failures"]:
            out.write(f"  FAIL: {f}\n")
    return 0 if report["ok"] else 1
