"""vstart — dev cluster launcher (the src/vstart.sh role).

Builds a cluster directory (crushmap text, pool spec, cephx keyrings,
per-daemon durable stores), then launches ONE mon process and N OSD
processes (``python -m ceph_tpu_torch.cluster.daemon``) talking
authenticated typed envelopes over unix sockets.  The chaos tier kills
these with real SIGKILL and restarts them against the same stores.

Port of ``ceph_tpu/tools/vstart.py``.  Every daemon is started with
``--device cpu``: the daemons ask for the CPU explicitly, open no CUDA
context and host-scan their receive verify; the device work of an EC
pool runs in the client (``client/remote.py``), the card-attached
primary.

Usage (also importable as a library — tests drive Vstart directly):
    python -m ceph_tpu_torch.tools.vstart --dir /tmp/c1 --osds 6 start
    python -m ceph_tpu_torch.tools.vstart --dir /tmp/c1 status
    python -m ceph_tpu_torch.tools.vstart --dir /tmp/c1 stop
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..common import auth as cx


def build_cluster_dir(cluster_dir: str, n_osds: int = 6,
                      osds_per_host: int = 2,
                      pools: Optional[List[dict]] = None,
                      fsync: bool = True, n_mons: int = 1,
                      objectstore: str = "bluestore",
                      bluestore_device_bytes: int = 1 << 28,
                      bluestore_min_alloc_size: int = 4096,
                      bluestore_compression: str = "",
                      fsck_on_mount: bool = False,
                      ms_inject_socket_failures: int = 0,
                      qos_tenants: Optional[Dict[str, dict]] = None
                      ) -> None:
    """Write crushmap.txt, cluster.json and keyrings.

    ``qos_tenants``: {tenant: {"res": r, "wgt": w, "lim": l}} —
    per-tenant dmClock client-class overrides every OSD daemon loads
    at boot (the osd_mclock_scheduler_client_* per-client profiles).
    """
    os.makedirs(cluster_dir, exist_ok=True)
    from ..placement.builder import TYPE_HOST, build_flat_cluster
    from ..placement.compiler import decompile_crushmap
    from ..placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
        RULE_TAKE, Rule)
    n_hosts = -(-n_osds // osds_per_host)
    cmap, root = build_flat_cluster(n_hosts=n_hosts,
                                    osds_per_host=osds_per_host)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)], name="replicated"))
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)], name="ec"))
    with open(os.path.join(cluster_dir, "crushmap.txt"), "w") as f:
        f.write(decompile_crushmap(cmap))
    if pools is None:
        pools = [{"id": 1, "name": "rep", "type": 1, "size": 3,
                  "pg_num": 16, "crush_rule": 0}]
    json.dump({"pools": pools, "fsync": fsync, "n_osds": n_osds,
               "n_mons": n_mons, "objectstore": objectstore,
               "bluestore_device_bytes": bluestore_device_bytes,
               "bluestore_min_alloc_size": bluestore_min_alloc_size,
               "bluestore_compression_algorithm": bluestore_compression,
               "fsck_on_mount": fsck_on_mount,
               "ms_inject_socket_failures": ms_inject_socket_failures,
               "qos_tenants": qos_tenants or {}},
              open(os.path.join(cluster_dir, "cluster.json"), "w"))
    names = ["mon.", "client.admin"] + \
        [f"mon.{r}" for r in range(n_mons)] + \
        [f"osd.{i}" for i in range(n_osds)]
    ring = cx.Keyring.generate(names)
    ring.save(os.path.join(cluster_dir, "keyring.mon"))
    ring.subset("client.admin").save(
        os.path.join(cluster_dir, "keyring.client"))
    for i in range(n_osds):
        ring.subset(f"osd.{i}").save(
            os.path.join(cluster_dir, f"keyring.osd.{i}"))


class Vstart:
    """Process supervisor for one dev cluster."""

    def __init__(self, cluster_dir: str):
        self.dir = cluster_dir
        self.procs: Dict[str, subprocess.Popen] = {}

    def _spawn(self, *args: str,
               log_name: Optional[str] = None) -> subprocess.Popen:
        # daemon stderr lands in <dir>/<name>.log (the vstart.sh
        # out/ dir role): a daemon that dies to an unhandled
        # exception must leave its traceback somewhere a human — or
        # a flake hunt — can find it, not in /dev/null
        err = subprocess.DEVNULL
        if log_name is not None:
            err = open(os.path.join(self.dir, f"{log_name}.log"),
                       "ab")
        p = subprocess.Popen(
            # daemons never touch the card: they ask for the CPU
            [sys.executable, "-m", "ceph_tpu_torch.cluster.daemon", *args,
             "--device", "cpu"],
            stdout=subprocess.DEVNULL,
            stderr=err,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        if err is not subprocess.DEVNULL:
            err.close()                   # the child owns the fd now
        return p

    @staticmethod
    def _clear_stale_sock(path: str) -> None:
        """A SIGKILLed daemon leaves its socket file behind; remove it
        so the readiness wait below observes the NEW daemon's bind,
        not a stale file that refuses connections."""
        try:
            os.unlink(path)
        except OSError:
            pass

    def _n_mons(self) -> int:
        from ..cluster.daemon import mon_sockets
        return len(mon_sockets(self.dir))

    def start_mon(self, rank: int = 0, timeout: float = 30.0) -> None:
        from ..cluster.daemon import mon_sockets
        sock = mon_sockets(self.dir)[rank]
        self._clear_stale_sock(sock)
        p = self._spawn("mon", "--cluster-dir", self.dir,
                        "--id", str(rank),
                        log_name=f"mon.{rank}")
        self.procs[f"mon.{rank}"] = p
        if rank == 0:
            self.procs["mon"] = p          # legacy alias
        self._wait_sock(sock, timeout)

    def start_osd(self, osd_id: int, timeout: float = 30.0,
                  hb_interval: float = 0.5) -> None:
        sock = os.path.join(self.dir, f"osd.{osd_id}.sock")
        self._clear_stale_sock(sock)
        self.procs[f"osd.{osd_id}"] = self._spawn(
            "osd", "--cluster-dir", self.dir, "--id", str(osd_id),
            "--hb-interval", str(hb_interval),
            log_name=f"osd.{osd_id}")
        self._wait_sock(sock, timeout)

    @staticmethod
    def _wait_sock(path: str, timeout: float) -> None:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            if os.path.exists(path):
                return
            time.sleep(0.05)
        raise TimeoutError(f"daemon socket {path} never appeared")

    def start(self, n_osds: int, hb_interval: float = 0.5) -> None:
        for r in range(self._n_mons()):
            self.start_mon(r)
        for i in range(n_osds):
            self.start_osd(i, hb_interval=hb_interval)

    def kill9(self, name: str) -> None:
        """Real SIGKILL — the Thrasher's kill_osd."""
        p = self.procs.get(name)
        if p and p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
            p.wait()

    def stop(self) -> None:
        for name, p in self.procs.items():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()

    def alive(self, name: str) -> bool:
        p = self.procs.get(name)
        return p is not None and p.poll() is None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vstart")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--osds", type=int, default=6)
    ap.add_argument("action", choices=["start", "stop", "status"])
    args = ap.parse_args(argv)
    # daemons spawn with the repo as cwd: a relative dir from the
    # operator's shell must resolve from HERE, not from there
    args.dir = os.path.abspath(args.dir)
    if args.action == "start":
        if not os.path.exists(os.path.join(args.dir, "cluster.json")):
            build_cluster_dir(args.dir, n_osds=args.osds)
        v = Vstart(args.dir)
        v.start(args.osds)
        pids = {n: p.pid for n, p in v.procs.items()}
        json.dump(pids, open(os.path.join(args.dir, "pids.json"), "w"))
        print(json.dumps(pids))
        # detach: daemons keep running
        return 0
    if args.action == "stop":
        try:
            pids = json.load(open(os.path.join(args.dir, "pids.json")))
        except FileNotFoundError:
            return 0
        for name, pid in pids.items():
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        print("stopped")
        return 0
    # status
    from ..cluster.daemon import WireClient
    ring = cx.Keyring.load(os.path.join(args.dir, "keyring.client"))
    mon = WireClient(os.path.join(args.dir, "mon.sock"), "client.admin",
                     secret=ring.secret("client.admin"))
    print(json.dumps(mon.call({"cmd": "status"})))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
