"""osdmaptool equivalent: full-cluster PG mapping sweeps.

Mirrors `osdmaptool --test-map-pgs` (reference: src/tools/osdmaptool.cc:630-676
— the per-pool, per-ps pg_to_up_acting_osds loop) with the sweep batched
per pool through OSDMap.map_pgs_batch, on the card unless ``--device cpu``
asks for the CPU.

The tool consumes a cluster JSON spec:
  {"crush": <CrushMap.to_spec()>,
   "pools": [{"id":1, "type":1, "size":3, "pg_num":64, "crush_rule":0}...],
   "osds": {"count": N} | {"down":[...], "out":[...]} }

Usage:
    python -m ceph_tpu_torch.tools.osdmaptool cluster.json --test-map-pgs \
        [--dump] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import resolve_device
from ..cluster.osdmap import OSDMap, PGPool
from ..placement.crush_map import ITEM_NONE, CrushMap


def load_cluster(spec: dict, device=None) -> OSDMap:
    cmap = CrushMap.from_spec(spec["crush"])
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    for o in spec.get("osds", {}).get("down", []):
        om.osd_up[o] = False
    for o in spec.get("osds", {}).get("out", []):
        om.osd_weight[o] = 0
    for p in spec["pools"]:
        om.add_pool(PGPool(**p))
    return om


def test_map_pgs(om: OSDMap, scalar: bool = False) -> dict:
    counts = np.zeros(om.max_osd, dtype=np.int64)
    primaries = np.zeros(om.max_osd, dtype=np.int64)
    total_pgs = 0
    t0 = time.perf_counter()
    for pid, pool in sorted(om.pools.items()):
        if scalar:
            rows = []
            prims = []
            for ps in range(pool.pg_num):
                up, upp, _, _ = om.pg_to_up_acting_osds(pid, ps)
                rows.append(up + [ITEM_NONE] * (pool.size - len(up)))
                prims.append(upp)
            up_b = np.asarray(rows, dtype=np.int64)
            prim_b = np.asarray(prims, dtype=np.int64)
        else:
            up_b, prim_b = om.map_pgs_batch(pid)
        total_pgs += pool.pg_num
        vals = up_b[up_b != ITEM_NONE]
        np.add.at(counts, vals, 1)
        pv = prim_b[prim_b >= 0]
        np.add.at(primaries, pv, 1)
    dt = time.perf_counter() - t0
    in_osds = counts[counts > 0]
    return {
        "total_pgs": int(total_pgs),
        "seconds": dt,
        "pg_per_osd_min": int(in_osds.min()) if len(in_osds) else 0,
        "pg_per_osd_max": int(in_osds.max()) if len(in_osds) else 0,
        "pg_per_osd_avg": float(in_osds.mean()) if len(in_osds) else 0.0,
        "osds_used": int((counts > 0).sum()),
        "counts": counts,
        "primaries": primaries,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("mapfn", help="cluster JSON spec")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--scalar", action="store_true")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--upmap", metavar="OUT",
                    help="balance PGs via pg_upmap_items (reference: "
                         "osdmaptool --upmap); writes the proposed "
                         "items as JSON")
    ap.add_argument("--upmap-deviation", type=float, default=1.0)
    ap.add_argument("--upmap-max", type=int, default=128,
                    help="max upmap moves per round")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the batched mapper (cuda or cpu)")
    args = ap.parse_args(argv)
    # no card and no --device cpu: raise here, whatever the verb
    device = resolve_device(args.device)
    with open(args.mapfn) as f:
        spec = json.load(f)
    om = load_cluster(spec, device=device)
    if args.dump:
        print(json.dumps({
            "epoch": om.epoch, "max_osd": om.max_osd,
            "pools": {p.id: vars(p) for p in om.pools.values()}},
            default=str, indent=2))
        return 0
    if args.upmap:
        from ..cluster.balancer import calc_pg_upmaps
        res = calc_pg_upmaps(om, max_deviation=args.upmap_deviation,
                             max_moves_per_round=args.upmap_max)
        items = {f"{pid}.{pg}": [[int(a), int(b)] for a, b in pairs]
                 for (pid, pg), pairs in sorted(res.upmap_items.items())}
        with open(args.upmap, "w") as f:
            json.dump({"pg_upmap_items": items}, f, indent=1)
        print(f"balanced in {res.rounds} rounds: {res.moves} moves, "
              f"max deviation {res.max_deviation_before:.2f} -> "
              f"{res.max_deviation_after:.2f}")
        return 0
    if args.test_map_pgs:
        stats = test_map_pgs(om, scalar=args.scalar)
        # timing is nondeterministic -> stderr (goldens pin stdout only)
        print(f"pool throughput: {stats['total_pgs']} pgs in "
              f"{stats['seconds']:.3f}s "
              f"({stats['total_pgs'] / stats['seconds']:,.0f} pg/s)",
              file=sys.stderr)
        print(f" avg {stats['pg_per_osd_avg']:.2f} "
              f"min {stats['pg_per_osd_min']} max {stats['pg_per_osd_max']} "
              f"over {stats['osds_used']} osds")
        size = sum(p.size * p.pg_num for p in om.pools.values())
        print(f" total replicas {size}")
        return 0
    ap.error("nothing to do")
    return 1


if __name__ == "__main__":
    sys.exit(main())
