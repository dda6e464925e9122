"""Entry points of the port: the twins of ``__graft_entry__.py``.

  * ``entry()`` — (fn, example_args) of the flagship data path: batched
    RS(8,3) erasure encode as the bit-sliced masked region-XOR over
    packet planes (kernel K1 on the card, its plain version on the CPU),
    on the same inputs as ``__graft_entry__.entry``.
  * ``cluster_step(device, layout, seed)`` — the single-device leg of
    ``__graft_entry__._cluster_sharded_impl``: a ClusterSim on an
    8-host CRUSH map drives batched put, a degraded get, kill and out
    OSDs, a recovery round and the ``map_pgs_batch`` remap sweep, and
    returns the same dict.  ``layout`` picks the EC pool's chunk layout:
    ``bitsliced`` (the cluster default, HBM-staged, K1) or ``bytes``
    (host tier, K2).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def entry():
    """(fn, example_args): the batched RS(8,3) masked-XOR encode."""
    from .ops import gf, gf2
    from .ops.xor_kernel import xor_matmul_w32

    masks = gf2.bitmatrix_masks(gf.gf8_bitmatrix(
        gf.vandermonde_parity(8, 3)))
    rng = np.random.default_rng(0)
    words = rng.integers(-(1 << 31), 1 << 31,
                         size=(16, 64, 512), dtype=np.int32)
    return xor_matmul_w32, (masks, words)


def build_sim(k: int = 4, m: int = 2, layout: Optional[str] = None,
              device=None):
    """The dry run's cluster: 8 hosts of one OSD, TAKE root /
    CHOOSELEAF_INDEP 0 host / EMIT, one EC pool (id 1, 16 PGs,
    stripe_unit 64) of profile ``p`` on the ``jax`` codec."""
    from .cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from .cluster.simulator import ClusterSim
    from .placement.builder import TYPE_HOST, build_flat_cluster
    from .placement.crush_map import (
        RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=1)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="ec", type=POOL_ERASURE,
                       size=k + m, pg_num=16, crush_rule=0,
                       erasure_code_profile="p", stripe_unit=64))
    sim = ClusterSim(om, device=device)
    prof = {"plugin": "jax", "k": str(k), "m": str(m)}
    if layout is not None:
        prof["layout"] = layout
    sim.create_ec_profile("p", prof)
    return sim


def cluster_step(device=None, layout: str = "bitsliced", seed: int = 0,
                 n_objects: int = 16) -> Dict:
    """Batched put -> degraded get -> kill/out -> recover_all -> remap
    sweep -> get again, on ``device`` (the package default when None).
    Returns {placed, datas, gets, gets2, rec, up0, up1, victims} as the
    reference's ``run(False)`` does."""
    sim = build_sim(layout=layout, device=device)
    try:
        rng = np.random.default_rng(seed)
        names = [f"o{i}" for i in range(n_objects)]
        datas = [rng.integers(0, 256, int(sz), dtype=np.uint8).tobytes()
                 for sz in rng.integers(200, 4000, len(names))]
        placed = sim.put_many(1, names, datas)
        # kill members of the first object's up set so the gets
        # genuinely decode and recovery genuinely rebuilds
        pool = sim.osdmap.pools[1]
        up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
        victims = [o for o in up if o >= 0][:2]
        up0, _ = sim.osdmap.map_pgs_batch(1)
        for v in victims:
            sim.kill_osd(v)
        gets = [sim.get(1, nm) for nm in names]
        for v in victims:
            sim.out_osd(v)       # re-home so recovery REBUILDS
        rec = sim.recover_all(1)
        up1, _ = sim.osdmap.map_pgs_batch(1)
        gets2 = [sim.get(1, nm) for nm in names]
    finally:
        sim.shutdown()
    return {"placed": {nm: len(p) for nm, p in placed.items()},
            "datas": datas, "gets": gets, "gets2": gets2,
            "rec": rec, "up0": up0.tolist(), "up1": up1.tolist(),
            "victims": victims}
