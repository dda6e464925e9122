"""Recovery smoke check of the port — device-speed recovery, verified.

The twin of ``scripts/check_recovery.py``.  Two tiers, both fast enough
for the smoke sweep:

  1. SIM tier: a small cluster (8 hosts x 2 OSDs, an RS(4,2) pool of the
     ``jax`` codec at a 16 KiB stripe unit, on ``--device``) takes a
     batched put, loses one whole OSD (kill + out), and runs ONE
     recovery pass under a traced root span.  Asserts ZERO data loss
     (every object reads back byte-exact), shards actually moved
     (rebuilt + copied > 0), and the trace-driven ``stage_breakdown`` is
     present and attributes the sweep.  On the card the encode, the
     decodes and the per-stripe rebuild run on K1.

  2. PROCESS tier (skipped with ``--quick``): a 3-daemon vstart cluster
     (the daemons on the CPU, the client on ``--device``), replicated
     objects, one OSD killed + outed, then the reservation-gated
     CONCURRENT ``recover_pool`` sweep.  Asserts zero data loss and the
     reservation counters are CONSISTENT: every live daemon's held
     counts drained to zero and no peak ever exceeded
     ``osd_max_backfills``.

    python -m ceph_tpu_torch.tools.check_recovery                # the card
    python -m ceph_tpu_torch.tools.check_recovery --device cpu
    python -m ceph_tpu_torch.tools.check_recovery --quick        # sim tier
"""
from __future__ import annotations

import argparse
import os
import sys

RECOVERY_WAIT_S = 30         # the mon marking the killed OSD down


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def _check_sim_tier() -> int:
    import numpy as np

    from ..cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ..cluster.simulator import ClusterSim
    from ..common.tracer import stage_breakdown, tracer
    from ..placement.builder import TYPE_HOST, build_flat_cluster
    from ..placement.crush_map import (RULE_CHOOSELEAF_INDEP, RULE_EMIT,
                                       RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=2)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="ec", type=POOL_ERASURE, size=6,
                       pg_num=32, crush_rule=0,
                       erasure_code_profile="p", stripe_unit=1 << 14))
    sim = ClusterSim(om)
    try:
        sim.create_ec_profile("p", {"plugin": "jax", "k": "4",
                                    "m": "2"})
        rng = np.random.default_rng(0)
        blobs = {f"o{i}": rng.integers(0, 256, 40_000,
                                       dtype=np.uint8).tobytes()
                 for i in range(12)}
        placed = sim.put_many(1, list(blobs), list(blobs.values()))
        counts: dict = {}
        for osds in placed.values():
            for o in osds:
                counts[o] = counts.get(o, 0) + 1
        victim = max(counts, key=counts.get)
        sim.kill_osd(victim)
        sim.out_osd(victim)
        tracer().reset()
        with tracer().start_span("rebuild.sweep"):
            st = sim.recover_all(1)
        if st.get("shards_rebuilt", 0) + st.get("shards_copied",
                                                0) <= 0:
            return _fail(f"no shards moved rebuilding osd.{victim}: "
                         f"{st}")
        for name, data in blobs.items():
            if sim.get(1, name) != data:
                return _fail(f"data loss after rebuild: {name}")
        spans = tracer().dump_traces()["spans"]
        ids = {s["trace_id"] for s in spans
               if s.get("name") == "rebuild.sweep"}
        bd = stage_breakdown([s for s in spans
                              if s.get("trace_id") in ids])
        if "rebuild.sweep" not in bd:
            return _fail(f"stage_breakdown missing the rebuild root: "
                         f"{sorted(bd)}")
        print(f"sim tier ok: osd.{victim} rebuilt "
              f"({st['shards_rebuilt']} rebuilt / "
              f"{st['shards_copied']} copied), zero loss, "
              f"stages={sorted(bd)}")
        return 0
    finally:
        sim.shutdown()


def _check_process_tier() -> int:
    import shutil
    import tempfile
    import time

    import numpy as np

    from ..client.remote import RemoteCluster
    from .vstart import Vstart, build_cluster_dir
    tmp = tempfile.mkdtemp(prefix="check-recovery-")
    d = os.path.join(tmp, "cluster")
    n_osds = 3
    build_cluster_dir(d, n_osds=n_osds, osds_per_host=1, fsync=False)
    v = Vstart(d)
    try:
        v.start(n_osds, hb_interval=0.25, together=True)
        rc = RemoteCluster(d)
        rng = np.random.default_rng(1)
        blobs = {f"r{i}": rng.integers(0, 256, 3000,
                                       dtype=np.uint8).tobytes()
                 for i in range(8)}
        for name, data in blobs.items():
            if rc.put(1, name, data) < 2:
                return _fail(f"{name}: put under-replicated")
        v.kill9("osd.2")
        deadline = time.monotonic() + RECOVERY_WAIT_S
        while time.monotonic() < deadline:
            if rc.status()["n_up"] <= n_osds - 1:
                break
            time.sleep(0.25)
        rc.mon_call({"cmd": "mark_out", "osd": 2})
        rc.refresh_map()
        stats = rc.recover_pool(1)
        if "deferred_pgs" in stats:
            return _fail(f"recovery left deferred PGs: {stats}")
        for name, data in blobs.items():
            if rc.get(1, name) != data:
                return _fail(f"data loss after recovery: {name}")
        peaks = 0
        for o in range(n_osds - 1):
            st = rc.osd_call(o, {"cmd": "status"})
            resv = st.get("recovery_reservations")
            if resv is None:
                return _fail(f"osd.{o}: no reservation counters")
            if resv["held"] != {"local": 0, "remote": 0}:
                return _fail(f"osd.{o}: reservations leaked: {resv}")
            for role, peak in resv["peak"].items():
                if peak > 1:       # osd_max_backfills default
                    return _fail(f"osd.{o}: {role} peak {peak} "
                                 f"exceeds osd_max_backfills")
                peaks += peak
        if peaks <= 0:
            return _fail("no daemon ever took a reservation — the "
                         "gate did not run")
        rc.close()
        print(f"process tier ok: zero loss, reservations consistent "
              f"(sum of peaks {peaks}, cap held)")
        return 0
    finally:
        v.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    import ceph_tpu_torch
    ap = argparse.ArgumentParser(
        prog="check_recovery",
        description="one traced recovery pass on a sim, and a "
                    "reservation-gated recovery over three daemons")
    ap.add_argument("--device", default="cuda",
                    help="device of the sim and the client (default: "
                         "cuda); the daemons run on the CPU")
    ap.add_argument("--quick", action="store_true",
                    help="the sim tier only")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        rc = _check_sim_tier()
        if rc:
            return rc
        if not args.quick:
            rc = _check_process_tier()
            if rc:
                return rc
    print("check_recovery: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
