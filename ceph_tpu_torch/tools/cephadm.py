"""cephadm analog — declarative cluster orchestration (VERDICT r4
next #7; the L11 gap).

The reference's cephadm (src/cephadm/cephadm, ~8k lines) turns a
declarative service spec into a running containerized cluster and
performs health-gated rolling operations (restart, upgrade) against
it; ceph-volume provisions each OSD's backing store.  Same roles
here, against the process cluster:

  * ``ClusterSpec`` — the declarative input: mons, hosts with OSD
    counts, pools, a version string.  JSON on disk (``spec.json``).
  * ``CephAdm.deploy`` — provision (cluster dir, crushmap from the
    host layout, keyrings, per-OSD stores — the ceph-volume role) +
    launch every daemon + wait for health.
  * ``CephAdm.rolling_restart`` / ``upgrade`` — restart daemons ONE
    at a time, each gated on the cluster returning to health before
    the next goes down (the reference's ok-to-stop sequencing);
    upgrade additionally records the new version per daemon in the
    mon's central config db, so ``status`` shows upgrade progress
    exactly the way `ceph orch upgrade status` does.

The deployed spec and versions are COMMITTED mon state (config db
keys ``cephadm/spec`` and ``cephadm/version/*``): any client can
audit what the orchestrator deployed, and a mon restart replays it.

Its daemons run on the CPU (``tools/vstart.py``); its ``RemoteCluster``
client runs on the package default device, the card, and the CLI's
``--device cpu`` asks for the CPU for the run.

CLI: ``python -m ceph_tpu_torch.tools.cephadm [--device cpu]
deploy|status|restart|upgrade|stop ...``
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ClusterSpec:
    """The declarative cluster description (service-spec role)."""
    name: str = "ceph-tpu"
    version: str = "1.0"
    mons: int = 1
    hosts: List[Dict] = field(default_factory=list)
    pools: List[Dict] = field(default_factory=list)
    fsync: bool = False
    objectstore: str = "bluestore"

    @property
    def n_osds(self) -> int:
        return sum(int(h.get("osds", 1)) for h in self.hosts)

    @property
    def osds_per_host(self) -> int:
        counts = {int(h.get("osds", 1)) for h in self.hosts}
        if len(counts) != 1:
            raise ValueError(
                "hosts must carry equal osd counts (crush builder "
                "provisions uniform hosts)")
        return counts.pop()

    @staticmethod
    def load(path: str) -> "ClusterSpec":
        d = json.load(open(path))
        return ClusterSpec(**d)

    def save(self, path: str) -> None:
        json.dump(self.__dict__, open(path, "w"), indent=1)


class HealthGateTimeout(IOError):
    pass


class CephAdm:
    """Orchestrator over one deployed cluster directory."""

    def __init__(self, cluster_dir: str):
        # daemons spawn with the repo as cwd: a relative dir from the
        # operator's shell must resolve from HERE, not from there
        self.dir = os.path.abspath(cluster_dir)
        from .vstart import Vstart
        self.v = Vstart(self.dir)
        self._rc = None

    # ------------------------------------------------------------ client --
    def rc(self):
        if self._rc is None:
            from ..client.remote import RemoteCluster
            self._rc = RemoteCluster(self.dir)
        return self._rc

    def _drop_rc(self) -> None:
        if self._rc is not None:
            try:
                self._rc.close()
            except Exception:
                pass
            self._rc = None

    # ------------------------------------------------------------ deploy --
    @staticmethod
    def deploy(spec: ClusterSpec, cluster_dir: str,
               timeout: float = 60.0) -> "CephAdm":
        """Provision + launch + health-gate (the cephadm bootstrap +
        apply flow; store/keyring provisioning is the ceph-volume
        role inside build_cluster_dir)."""
        from .vstart import build_cluster_dir
        cluster_dir = os.path.abspath(cluster_dir)
        pools = spec.pools or [
            {"id": 1, "name": "rep", "type": 1, "size": 3,
             "pg_num": 16, "crush_rule": 0}]
        build_cluster_dir(
            cluster_dir, n_osds=spec.n_osds,
            osds_per_host=spec.osds_per_host, pools=pools,
            fsync=spec.fsync, n_mons=spec.mons,
            objectstore=spec.objectstore)
        adm = CephAdm(cluster_dir)
        adm.v.start(spec.n_osds)
        adm.wait_health(timeout=timeout)
        # the deployed spec + version are committed mon state
        adm.rc().mon_call({"cmd": "config_set", "key": "cephadm/spec",
                           "value": spec.__dict__})
        for i in range(spec.n_osds):
            adm.rc().mon_call({
                "cmd": "config_set",
                "key": f"cephadm/version/osd.{i}",
                "value": spec.version})
        return adm

    # ------------------------------------------------------------ health --
    def health_ok(self) -> bool:
        try:
            rc = self.rc()
            st = rc.mon_call({"cmd": "status"})
            if st["n_up"] < st["n_osds"]:
                return False
            ms = rc.mon_call({"cmd": "mon_status"})
            if ms.get("n_mons", 1) > 1 and ms.get("leader") is None:
                return False
            return True
        except (OSError, IOError):
            self._drop_rc()
            return False

    def _wait_mon_rejoined(self, rank: int, n_mons: int,
                           timeout: float) -> None:
        """Poll the JUST-RESTARTED mon's own socket until it reports
        a leader (single-mon: until it serves at all)."""
        from ..cluster.daemon import WireClient
        from ..common import auth as cx
        ring = cx.Keyring.load(
            os.path.join(self.dir, "keyring.client"))
        sock = os.path.join(
            self.dir, f"mon.{rank}.sock" if n_mons > 1 else "mon.sock")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                c = WireClient(sock, "client.admin",
                               secret=ring.secret("client.admin"),
                               timeout=3.0)
                try:
                    st = c.call({"cmd": "mon_status"})
                finally:
                    c.close()
                if n_mons == 1 or st.get("leader") is not None:
                    return
            except (OSError, IOError, cx.AuthError):
                pass
            time.sleep(0.3)
        raise HealthGateTimeout(
            f"mon.{rank} did not rejoin within {timeout}s")

    def wait_health(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.health_ok():
                return
            time.sleep(0.5)
        raise HealthGateTimeout(
            f"cluster not healthy within {timeout}s")

    # ----------------------------------------------------------- rolling --
    def spec(self) -> ClusterSpec:
        d = self.rc().mon_call({"cmd": "config_get",
                                "key": "cephadm/spec"})["value"]
        return ClusterSpec(**d)

    def status(self) -> Dict:
        rc = self.rc()
        spec = self.spec()
        versions: Dict[str, Optional[str]] = {}
        for i in range(spec.n_osds):
            versions[f"osd.{i}"] = rc.mon_call({
                "cmd": "config_get",
                "key": f"cephadm/version/osd.{i}"})["value"]
        st = rc.mon_call({"cmd": "status"})
        ms = rc.mon_call({"cmd": "mon_status"})
        healthy = st["n_up"] >= st["n_osds"] and (
            ms.get("n_mons", 1) <= 1 or
            ms.get("leader") is not None)
        return {"spec": spec.__dict__, "health_ok": healthy,
                "n_up": st["n_up"], "versions": versions}

    def rolling_restart(self, version: Optional[str] = None,
                        timeout: float = 90.0) -> Dict:
        """Restart every daemon ONE at a time, health-gated: the next
        daemon goes down only after the cluster has fully re-healed
        (the ok-to-stop gate).  With ``version``, each restarted OSD
        records the new version in the mon config db (`ceph orch
        upgrade` semantics: version flips as the daemon cycles)."""
        spec = self.spec()
        restarted = []
        # mons first (the reference upgrades monitors first), then
        # OSDs — each gated
        for rank in range(spec.mons):
            name = f"mon.{rank}" if spec.mons > 1 else "mon"
            self.v.kill9(name)
            self._drop_rc()
            time.sleep(0.3)
            self.v.start_mon(rank)
            # the restarted mon itself must REJOIN (know the leader)
            # before the next one goes down — a surviving peer
            # reporting a leader is not the restarted rank's health
            self._wait_mon_rejoined(rank, spec.mons, timeout)
            self.wait_health(timeout=timeout)
            restarted.append(name)
        for i in range(spec.n_osds):
            self.v.kill9(f"osd.{i}")
            # give heartbeats a beat to notice, then restart
            time.sleep(0.3)
            self.v.start_osd(i)
            self.wait_health(timeout=timeout)
            if version is not None:
                self.rc().mon_call({
                    "cmd": "config_set",
                    "key": f"cephadm/version/osd.{i}",
                    "value": version})
            restarted.append(f"osd.{i}")
        if version is not None:
            spec.version = version
            self.rc().mon_call({"cmd": "config_set",
                                "key": "cephadm/spec",
                                "value": spec.__dict__})
        return {"restarted": restarted,
                "version": version or spec.version}

    def upgrade(self, new_version: str, timeout: float = 90.0) -> Dict:
        """Rolling upgrade: the rolling restart with the version bump
        recorded per daemon as it cycles."""
        return self.rolling_restart(version=new_version,
                                    timeout=timeout)

    def stop(self) -> None:
        self._drop_rc()
        self.v.stop()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="cephadm")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the client (cuda or cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("deploy")
    p.add_argument("spec")
    p.add_argument("dir")
    p = sub.add_parser("status")
    p.add_argument("dir")
    p = sub.add_parser("restart")
    p.add_argument("dir")
    p = sub.add_parser("upgrade")
    p.add_argument("dir")
    p.add_argument("version")
    p = sub.add_parser("stop")
    p.add_argument("dir")
    args = ap.parse_args(argv)
    # the client runs on the package default device: this run's
    from .. import using_device
    with using_device(args.device):
        return _run(args)


def _run(args) -> int:
    if args.cmd == "deploy":
        CephAdm.deploy(ClusterSpec.load(args.spec), args.dir)
        print(json.dumps({"deployed": args.dir}))
        return 0
    adm = CephAdm(args.dir)
    if args.cmd == "status":
        print(json.dumps(adm.status(), indent=1))
    elif args.cmd == "restart":
        print(json.dumps(adm.rolling_restart()))
    elif args.cmd == "upgrade":
        print(json.dumps(adm.upgrade(args.version)))
    elif args.cmd == "stop":
        adm.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
