"""Multi-cell smoke check of the port — the sharded cluster data plane,
verified.

The twin of ``scripts/check_multichip.py``.  Drives a real ClusterSim
step (batched put -> degraded get -> recovery rebuild -> map_pgs_batch
sweep) twice — with the sharded data plane off, and on over
``N_CELLS`` cells of one device (``entry.plane_cells``; the reference
forces 8 XLA host devices, the port repeats its one device 8 times) —
and asserts the evidence the reference's MULTICHIP output claims:

  * every result bit-identical between the two modes (bytes, recovery
    stats, mapping arrays),
  * nonzero per-cell ``dataplane.shard<i>.*`` perf counters on every
    cell (put stripes) plus decode/recover/map dispatch counts and the
    psum'd row counter (the collective),
  * the ``dispatched_mesh`` event lands on tracked ops,
  * ``entry.cluster_sharded`` produces a well-formed ``cluster_sharded``
    section (the twin of ``__graft_entry__._cluster_sharded_impl``).

Runs on the card, or on the CPU when asked:

    python -m ceph_tpu_torch.tools.check_multichip                # the card
    python -m ceph_tpu_torch.tools.check_multichip --device cpu
    python -m ceph_tpu_torch.tools.check_multichip --quick        # no section
"""
from __future__ import annotations

import argparse
import contextlib
import sys

N_CELLS = 8                  # the reference's 8 forced host devices


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def make_sim(n_hosts: int = 8, osds_per_host: int = 3, k: int = 4,
             m: int = 2, seed: int = 0):
    """The reference test suite's ``make_sim`` (tests/test_simulator.py)
    on the port, on the package default device: ``n_hosts`` x
    ``osds_per_host`` OSDs (jittered weights), a 3-replica pool "rep"
    (CHOOSELEAF_FIRSTN host) and an EC pool "ec" (k, m; the ``jax``
    plugin; CHOOSELEAF_INDEP host), 32 PGs each."""
    from ..cluster.osdmap import OSDMap, PGPool, POOL_ERASURE, \
        POOL_REPLICATED
    from ..cluster.simulator import ClusterSim
    from ..placement.builder import TYPE_HOST, build_flat_cluster
    from ..placement.crush_map import (RULE_CHOOSELEAF_FIRSTN,
                                       RULE_CHOOSELEAF_INDEP, RULE_EMIT,
                                       RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=n_hosts,
                                    osds_per_host=osds_per_host, seed=seed,
                                    weight_jitter=True)
    for op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
        cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                                  (op, 0, TYPE_HOST),
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
    return sim


@contextlib.contextmanager
def _plane(shard: bool, device):
    """The data plane on over ``N_CELLS`` cells of ``device``, or off."""
    from ..common.options import config
    from ..entry import plane_cells
    if shard:
        with plane_cells(N_CELLS, 0, device):
            yield
        return
    config().set("parallel_data_plane", False)
    try:
        yield
    finally:
        config().clear("parallel_data_plane")


def drive(shard: bool, device=None):
    """The reference's step on ``make_sim``'s EC pool: (datas, degraded
    gets, recovery stats, the up sets after the remap)."""
    import numpy as np
    with _plane(shard, device):
        sim = make_sim()
        rng = np.random.default_rng(11)
        names = [f"c{i}" for i in range(8)]
        datas = [rng.integers(0, 256, int(s), dtype=np.uint8).tobytes()
                 for s in rng.integers(400, 20000, len(names))]
        sim.put_many(2, names, datas)
        pool = sim.osdmap.pools[2]
        up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
        victims = [o for o in up if o >= 0][:2]
        for v in victims:
            sim.kill_osd(v)
        gets = [sim.get(2, n) for n in names]
        for v in victims:
            sim.out_osd(v)
        rec = sim.recover_all(2)
        up1, _ = sim.osdmap.map_pgs_batch(2)
        sim.shutdown()
        return datas, gets, rec, up1.tolist()


def run_checks(device, quick: bool = False) -> int:
    from ..common.perf_counters import perf

    single = drive(False, device)
    perf("dataplane").reset()
    sharded = drive(True, device)

    if sharded[1] != single[1] or sharded[1] != single[0]:
        return _fail("degraded gets diverged between sharded and "
                     "single-device paths")
    if sharded[2] != single[2]:
        return _fail(f"recovery stats diverged: {sharded[2]} vs "
                     f"{single[2]}")
    if sharded[3] != single[3]:
        return _fail("map_pgs_batch diverged under the mesh")

    d = perf("dataplane").dump()
    for i in range(N_CELLS):
        if not d.get(f"shard{i}.put_stripes"):
            return _fail(f"chip {i}: no put-stripe accounting "
                         f"(dataplane.shard{i}.put_stripes)")
    for key in ("put_dispatches", "decode_dispatches",
                "recover_dispatches", "map_dispatches", "psum_rows"):
        if not d.get(key):
            return _fail(f"dataplane.{key} never incremented")

    # dispatched_mesh rides tracked ops (dump_historic_ops evidence)
    from ..cluster.monitor import Monitor
    from ..cluster.objecter import Objecter
    from ..common.op_tracker import tracker
    with _plane(True, device):
        sim = make_sim()
        client = Objecter(sim, Monitor(sim.osdmap))
        tracker().reset()
        client.put_many(2, ["m0", "m1"], [b"x" * 3000, b"y" * 5000])
        hist = tracker().dump_historic_ops()
        sim.shutdown()
    mesh_ops = [o for o in hist["ops"]
                if any(e["event"] == "dispatched_mesh"
                       for e in o["events"])]
    if not mesh_ops:
        return _fail("no dispatched_mesh event in dump_historic_ops")

    if not quick:
        # the MULTICHIP payload contract: a well-formed section with
        # per-cell accounting and the bit-identity verdict
        from ..entry import cluster_sharded
        section = cluster_sharded(N_CELLS, device=device)
        for key in ("bit_identical_to_single_device",
                    "degraded_get_ok", "per_chip", "psum_rows"):
            if key not in section:
                return _fail(f"cluster_sharded section missing {key}")
        if not section["bit_identical_to_single_device"]:
            return _fail("cluster_sharded reports divergence")
        if not section["per_chip"]:
            return _fail("cluster_sharded has no per-chip accounting")

    print(f"OK: sharded data plane verified on {N_CELLS} cells of "
          f"{device} (bit-identical step, per-cell counters, "
          f"dispatched_mesh, psum_rows={d.get('psum_rows')})")
    return 0


def main(argv=None) -> int:
    import ceph_tpu_torch
    ap = argparse.ArgumentParser(
        prog="check_multichip",
        description="the sharded cluster data plane over cells of one "
                    "device, held to the unsharded step")
    ap.add_argument("--device", default="cuda",
                    help="device of the sims and the plane's cells "
                         "(default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="skip the cluster_sharded section")
    args = ap.parse_args(argv)
    device = ceph_tpu_torch.resolve_device(args.device)
    with ceph_tpu_torch.using_device(device):
        return run_checks(device, args.quick)


if __name__ == "__main__":
    sys.exit(main())
