"""S3Serve smoke check of the port — the serving subsystem, verified.

The twin of ``scripts/check_serving.py``.  Three assertions, small enough
for the smoke sweep:

  1. DEFAULT GATE GREEN: a small multi-tenant serve run over live
     daemons (sharded bucket indexes, per-tenant dmClock classes) passes
     the SLO/QoS gate, the per-tenant p99s were read from the mon's
     cluster histogram merge (samples > 0), and every tenant's dmClock
     class actually dispatched on the daemons.

  2. FALSIFIABILITY: the deliberately starved config exits NONZERO with
     a per-tenant breach report naming the starved tenant — a gate that
     cannot fail proves nothing.

  3. SHARDING SEMANTICS: listing a bucket is IDENTICAL across shard
     counts (1 vs 8, same keys), and ``bucket limit check`` sees the
     shard layout; on a ClusterSim of ``--device`` (the reference test
     suite's snapshot cluster: 4 hosts x 2 OSDs, an RS(2,1) ``jax``
     pool, K1 on the card).

The daemons of the live legs run on the CPU (``--device cpu``), the
tenants' handles on ``--device``.  The live legs have no deadline of
their own (ROADMAP section C's serve hang lies on their path): the test
that runs them runs this check in a subprocess with a timeout.  On the
card, ``chip_smoke.py`` runs the sharding leg here (``--quick``); the
live legs run at full size in its phase 13c.

    python -m ceph_tpu_torch.tools.check_serving                # the card
    python -m ceph_tpu_torch.tools.check_serving --device cpu
    python -m ceph_tpu_torch.tools.check_serving --quick        # sharding
"""
from __future__ import annotations

import argparse
import io
import sys


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def make_sim(k: int = 2, m: int = 1):
    """The reference test suite's snapshot cluster (tests/test_snaps.py's
    ``make_sim``) on the port, on the package default device: 4 hosts x
    2 OSDs (seed 3, jittered weights), a 3-replica pool "rep" and an EC
    pool "ec" (k, m; the ``jax`` plugin), 16 PGs each."""
    from ..cluster.osdmap import OSDMap, PGPool, POOL_ERASURE, \
        POOL_REPLICATED
    from ..cluster.simulator import ClusterSim
    from ..placement.builder import TYPE_HOST, build_flat_cluster
    from ..placement.crush_map import (RULE_CHOOSELEAF_FIRSTN,
                                       RULE_CHOOSELEAF_INDEP, RULE_EMIT,
                                       RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=2, seed=3,
                                    weight_jitter=True)
    for op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
        cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                                  (op, 0, TYPE_HOST),
                                  (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                       pg_num=16, crush_rule=0))
    om.add_pool(PGPool(id=2, name="ec", type=POOL_ERASURE, size=k + m,
                       pg_num=16, crush_rule=1,
                       erasure_code_profile="p"))
    sim = ClusterSim(om)
    sim.create_ec_profile("p", {"plugin": "jax", "k": str(k),
                                "m": str(m)})
    return sim


def _check_sharding_semantics() -> int:
    from ..client.rados import Rados
    from ..cluster.monitor import Monitor
    from ..rgw import RGWGateway
    sim = make_sim(k=2, m=1)
    try:
        io_ = Rados(sim, Monitor(sim.osdmap)).connect() \
            .open_ioctx("ec")
        gw = RGWGateway(io_)
        keys = [f"k{i:03d}" for i in range(40)]
        b1 = gw.create_bucket("one", num_shards=1)
        b8 = gw.create_bucket("eight", num_shards=8)
        for k in keys:
            b1.put_object(k, k.encode())
            b8.put_object(k, k.encode())
        l1 = [c["key"] for c in
              b1.list_objects(max_keys=1000)["contents"]]
        l8 = [c["key"] for c in
              b8.list_objects(max_keys=1000)["contents"]]
        if l1 != l8 or l1 != sorted(keys):
            return _fail(f"listing differs across shard counts: "
                         f"{len(l1)} vs {len(l8)}")
        counts = b8.shard_entry_counts()
        if len(counts) != 8 or sum(counts) != len(keys):
            return _fail(f"shard entry counts wrong: {counts}")
        rows = {r["bucket"]: r for r in gw.bucket_limit_check()}
        if rows["eight"]["num_shards"] != 8:
            return _fail(f"limit check missed shards: {rows}")
        print(f"sharding ok: listing identical across 1/8 shards, "
              f"entries per shard {counts}")
        return 0
    finally:
        sim.shutdown()


def _check_gate_green() -> int:
    from ..rgw.serving import ServeConfig, TenantSpec, run_serve
    cfg = ServeConfig(seed=0, n_osds=3, index_shards=4, tenants=[
        TenantSpec("gold", clients=2, ops=30, qos_res=0.4,
                   min_share=0.05),
        TenantSpec("bronze", clients=3, ops=45, qos_res=0.0,
                   qos_wgt=4.0)])
    r = run_serve(cfg)
    if not r["ok"]:
        return _fail(f"default serve config breached the gate: "
                     f"{r['breaches']}")
    for name, m in r["tenants"].items():
        if m["ops"] and (not m["samples"] or m["p99_s"] is None):
            return _fail(f"{name}: no cluster-merged quantiles — "
                         f"the SLO was never read from the "
                         f"histogram merge")
    shares = r["scheduler"]["tenant_shares"]
    if not shares.get("gold") or not shares.get("bronze"):
        return _fail(f"tenant dmClock classes never dispatched on "
                     f"the daemons: {r['scheduler']}")
    print(f"gate green: {r['total_ops']} ops at {r['ops_s']} op/s, "
          f"dmClock tenant shares {shares}")
    return 0


def _check_gate_falsifiable() -> int:
    from ..rgw.serving import serve_main
    buf = io.StringIO()
    rc = serve_main(["--starve", "--osds", "3",
                     "--ops-scale", "0.4"], out=buf)
    text = buf.getvalue()
    if rc == 0:
        return _fail("starved config PASSED the gate — the SLO "
                     "gate is not falsifiable")
    if "BREACH" not in text or "gold" not in text:
        return _fail(f"starved run failed without a per-tenant "
                     f"breach report:\n{text}")
    print("falsifiability ok: starved config exits nonzero with a "
          "per-tenant breach report")
    return 0


def main(argv=None) -> int:
    import ceph_tpu_torch
    ap = argparse.ArgumentParser(
        prog="check_serving",
        description="S3Serve's gate green and red over live daemons, and "
                    "bucket-index sharding on a sim")
    ap.add_argument("--device", default="cuda",
                    help="device of the sim and the tenants' handles "
                         "(default: cuda); the daemons run on the CPU")
    ap.add_argument("--quick", action="store_true",
                    help="skip the live runs")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        rc = _check_sharding_semantics()
        if rc:
            return rc
        if not args.quick:
            rc = _check_gate_green() or _check_gate_falsifiable()
            if rc:
                return rc
    print("check_serving: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
