"""Realm / zonegroup / zone / period — multisite configuration.

The COVERAGE gap "no zone/period configuration".  Reference roles:
src/rgw/rgw_zone.h (RGWRealm / RGWZoneGroup / RGWZoneParams),
src/rgw/rgw_period.cc (RGWPeriod: immutable config snapshots with a
commit flow; the realm points at its current period).  Re-derived on
this repo's seams rather than ported:

  * a REALM is the top-level namespace; it owns a staging config and a
    pointer to the current committed period, all durable in an admin
    ioctx ("rgw.realm.<name>", "rgw.period.<realm>.<id>");
  * a PERIOD is an immutable snapshot {id, epoch, zonegroups} produced
    by ``commit_period`` — in-place epoch bumps happen only for
    non-topology changes (endpoint edits), topology changes (zones
    added/removed, master moved) mint a NEW period id whose
    predecessor field chains the history, like the reference's
    period_update --commit;
  * SYNC IS DRIVEN BY THE PERIOD MAP: ``PeriodSync`` reads the
    committed period, pairs the master zone with every peer in each
    zonegroup, and runs the existing bilog BucketSyncAgents — this
    replaces ad-hoc zone registration as the source of truth for who
    replicates what (sync.py's agents stay the data plane).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .gateway import RGWGateway
from .sync import BucketSyncAgent, make_sync_engine


class RealmError(RuntimeError):
    pass


@dataclass
class Zone:
    name: str
    endpoints: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"name": self.name, "endpoints": list(self.endpoints)}


@dataclass
class ZoneGroup:
    name: str
    master_zone: str = ""
    zones: Dict[str, Zone] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "master_zone": self.master_zone,
                "zones": {n: z.to_dict() for n, z in self.zones.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ZoneGroup":
        return cls(d["name"], d["master_zone"],
                   {n: Zone(z["name"], list(z["endpoints"]))
                    for n, z in d["zones"].items()})


@dataclass
class Period:
    """Immutable committed config snapshot (RGWPeriod)."""
    period_id: str
    epoch: int
    realm: str
    predecessor: str
    master_zonegroup: str
    zonegroups: Dict[str, ZoneGroup]

    def to_dict(self) -> dict:
        return {"period_id": self.period_id, "epoch": self.epoch,
                "realm": self.realm, "predecessor": self.predecessor,
                "master_zonegroup": self.master_zonegroup,
                "zonegroups": {n: g.to_dict()
                               for n, g in self.zonegroups.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "Period":
        return cls(d["period_id"], d["epoch"], d["realm"],
                   d["predecessor"], d["master_zonegroup"],
                   {n: ZoneGroup.from_dict(g)
                    for n, g in d["zonegroups"].items()})

    def all_zones(self) -> List[str]:
        return sorted(z for g in self.zonegroups.values()
                      for z in g.zones)


class Realm:
    """Durable realm: staging config + committed period chain."""

    def __init__(self, ioctx, name: str):
        self.ioctx = ioctx
        self.name = name
        self._load_or_create()

    # ----------------------------------------------------------- storage --
    def _oid(self) -> str:
        return f"rgw.realm.{self.name}"

    def _period_oid(self, period_id: str) -> str:
        return f"rgw.period.{self.name}.{period_id}"

    def _load_or_create(self) -> None:
        try:
            blob = self.ioctx.read(self._oid())
        except KeyError:
            # ObjectNotFound only — a transient read failure must not
            # reset a durable realm (clobbering the period pointer)
            blob = None
        if blob is None:
            self.current_period_id = ""
            self._period_seq = 0
            self.staging: Dict[str, ZoneGroup] = {}
            self.staging_master = ""
            self._save()
            return
        d = json.loads(bytes(blob).decode())
        self.current_period_id = d["current_period"]
        self._period_seq = d["period_seq"]
        self.staging = {n: ZoneGroup.from_dict(g)
                        for n, g in d["staging"].items()}
        self.staging_master = d["staging_master"]

    def _save(self) -> None:
        self.ioctx.write_full(self._oid(), json.dumps(
            {"current_period": self.current_period_id,
             "period_seq": self._period_seq,
             "staging": {n: g.to_dict()
                         for n, g in self.staging.items()},
             "staging_master": self.staging_master}).encode())

    # ----------------------------------------------------------- staging --
    def create_zonegroup(self, name: str,
                         master: bool = False) -> ZoneGroup:
        if name in self.staging:
            raise RealmError(f"zonegroup exists: {name}")
        g = ZoneGroup(name)
        self.staging[name] = g
        if master or not self.staging_master:
            self.staging_master = name
        self._save()
        return g

    def create_zone(self, zonegroup: str, name: str,
                    endpoints: Optional[List[str]] = None,
                    master: bool = False) -> Zone:
        g = self.staging.get(zonegroup)
        if g is None:
            raise RealmError(f"no zonegroup {zonegroup}")
        if any(name in gg.zones for gg in self.staging.values()):
            raise RealmError(f"zone exists: {name}")
        z = Zone(name, endpoints or [])
        g.zones[name] = z
        if master or not g.master_zone:
            g.master_zone = name
        self._save()
        return z

    def remove_zone(self, zonegroup: str, name: str) -> None:
        g = self.staging.get(zonegroup)
        if g is None or name not in g.zones:
            raise RealmError(f"no zone {name} in {zonegroup}")
        del g.zones[name]
        if g.master_zone == name:
            g.master_zone = min(g.zones) if g.zones else ""
        self._save()

    def set_endpoints(self, zonegroup: str, zone: str,
                      endpoints: List[str]) -> None:
        g = self.staging.get(zonegroup)
        if g is None or zone not in g.zones:
            raise RealmError(f"no zone {zone} in {zonegroup}")
        g.zones[zone].endpoints = list(endpoints)
        self._save()

    # ------------------------------------------------------------ commit --
    def current_period(self) -> Optional[Period]:
        if not self.current_period_id:
            return None
        blob = self.ioctx.read(self._period_oid(self.current_period_id))
        return Period.from_dict(json.loads(bytes(blob).decode()))

    def _topology(self, zonegroups: Dict[str, ZoneGroup],
                  master: str) -> list:
        return [master] + sorted(
            (n, g.master_zone, tuple(sorted(g.zones)))
            for n, g in zonegroups.items())

    def commit_period(self) -> Period:
        """period_update --commit: mint the staging config.  Topology
        changes start a new period (id chains to the predecessor);
        endpoint-only changes bump the current period's epoch."""
        if not self.staging or not self.staging_master:
            raise RealmError("staging is empty: nothing to commit")
        cur = self.current_period()
        same_topology = cur is not None and \
            self._topology(cur.zonegroups, cur.master_zonegroup) == \
            self._topology(self.staging, self.staging_master)
        if same_topology:
            period = Period(
                cur.period_id, cur.epoch + 1, self.name,
                cur.predecessor, self.staging_master,
                {n: ZoneGroup.from_dict(g.to_dict())
                 for n, g in self.staging.items()})
        else:
            self._period_seq += 1
            period = Period(
                f"{self.name}.{self._period_seq}", 1, self.name,
                cur.period_id if cur else "", self.staging_master,
                {n: ZoneGroup.from_dict(g.to_dict())
                 for n, g in self.staging.items()})
        self.ioctx.write_full(self._period_oid(period.period_id),
                              json.dumps(period.to_dict()).encode())
        self.current_period_id = period.period_id
        self._save()
        return period

    def period_history(self) -> List[str]:
        """Current-first chain of period ids (the period predecessor
        walk the reference exposes via `period list`)."""
        out = []
        pid = self.current_period_id
        while pid:
            out.append(pid)
            blob = self.ioctx.read(self._period_oid(pid))
            pid = Period.from_dict(
                json.loads(bytes(blob).decode())).predecessor
        return out


class PeriodSync:
    """Drive bilog sync agents from the committed period map: within
    each zonegroup, every non-master zone pulls every master-zone
    bucket (the rgw data-sync fan-out shape, with sync.py's bilog
    agents as the data plane)."""

    def __init__(self, realm: Realm, gateways: Dict[str, RGWGateway],
                 engine_workers: int = 4):
        self.realm = realm
        self.gateways = gateways
        self._agents: Dict[tuple, BucketSyncAgent] = {}
        # one shared fetch/apply pipeline for every agent: shard
        # drains across buckets AND zone pairs run concurrently,
        # FIFO-ordered only within one (bucket, zone, gen, shard)
        self._engine = None
        self._engine_workers = int(engine_workers)

    def engine(self):
        if self._engine is None and self._engine_workers > 0:
            self._engine = make_sync_engine(self._engine_workers)
        return self._engine

    def close(self) -> None:
        if self._engine is not None:
            self._engine.close()
            self._engine = None

    def _pairs(self) -> List[tuple]:
        period = self.realm.current_period()
        if period is None:
            raise RealmError("no committed period: commit one first")
        pairs = []
        for g in period.zonegroups.values():
            if g.master_zone not in self.gateways:
                continue
            for zname in g.zones:
                if zname != g.master_zone and zname in self.gateways:
                    pairs.append((g.master_zone, zname))
        return pairs

    def sync_all(self) -> Dict[tuple, Dict[str, int]]:
        """One pump over every (master bucket × peer zone); returns
        {(bucket, dst_zone): {"puts": n, "deletes": n}}."""
        applied: Dict[tuple, Dict[str, int]] = {}
        for src_zone, dst_zone in self._pairs():
            src_gw = self.gateways[src_zone]
            dst_gw = self.gateways[dst_zone]
            for bucket in src_gw.list_buckets():
                key = (bucket, dst_zone)
                agent = self._agents.get(key)
                if agent is None:
                    agent = BucketSyncAgent(src_gw, dst_gw, bucket,
                                            zone=dst_zone,
                                            src_zone=src_zone,
                                            engine=self.engine())
                    self._agents[key] = agent
                applied[key] = agent.sync()
        return applied
