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
  * ``cluster_sharded(n_cells, stripes, device)`` — the twin of
    ``__graft_entry__._cluster_sharded_impl``: the same cluster step with
    the sharded data plane off, then on over ``n_cells`` cells of one
    device (``stripes`` >= 2: the (stripe, shard) 2-D mesh), asserted
    bit-identical; returns the ``cluster_sharded`` section.  The
    reference's ``dryrun_multichip`` subprocess wrapper is not ported:
    the port picks its cells in the process (``plane_cells``).
"""
from __future__ import annotations

import contextlib
import time
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
              device=None, n_hosts: int = 8, osds_per_host: int = 1,
              pg_num: int = 16, stripe_unit: int = 64,
              technique: Optional[str] = None):
    """The dry run's cluster: 8 hosts of one OSD, TAKE root /
    CHOOSELEAF_INDEP 0 host / EMIT, one EC pool (id 1, 16 PGs,
    stripe_unit 64) of profile ``p`` on the ``jax`` codec.  The keywords
    size it otherwise (``chip_smoke.py`` runs 32 hosts x 4 OSDs, RS(8,3),
    pg_num 256, 128 KiB stripe units)."""
    from .cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from .cluster.simulator import ClusterSim
    from .placement.builder import TYPE_HOST, build_flat_cluster
    from .placement.crush_map import (
        RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=n_hosts,
                                    osds_per_host=osds_per_host)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="ec", type=POOL_ERASURE,
                       size=k + m, pg_num=pg_num, crush_rule=0,
                       erasure_code_profile="p", stripe_unit=stripe_unit))
    sim = ClusterSim(om, device=device)
    prof = {"plugin": "jax", "k": str(k), "m": str(m)}
    if layout is not None:
        prof["layout"] = layout
    if technique is not None:
        prof["technique"] = technique
    sim.create_ec_profile("p", prof)
    return sim


def cluster_step(device=None, layout: str = "bitsliced", seed: int = 0,
                 n_objects: int = 16, obj_bytes: Optional[int] = None,
                 n_victims: int = 2, **sim_kw) -> Dict:
    """Batched put -> degraded get -> kill/out -> recover_all -> remap
    sweep -> get again, on ``device`` (the package default when None).
    Returns {placed, datas, gets, gets2, rec, up0, up1, victims} as the
    reference's ``run(False)`` does, and the host wall time of each step
    (``times``).  Objects are 200-4000 bytes, or ``obj_bytes`` each;
    ``n_victims`` members of the first object's up set are killed;
    ``sim_kw`` goes to :func:`build_sim`."""
    sim = build_sim(layout=layout, device=device, **sim_kw)
    times: Dict[str, float] = {}

    def timed(step, fn):
        t0 = time.perf_counter()
        out = fn()
        times[step] = time.perf_counter() - t0
        return out

    try:
        rng = np.random.default_rng(seed)
        names = [f"o{i}" for i in range(n_objects)]
        sizes = rng.integers(200, 4000, len(names)) if obj_bytes is None \
            else [obj_bytes] * len(names)
        datas = [rng.integers(0, 256, int(sz), dtype=np.uint8).tobytes()
                 for sz in sizes]
        placed = timed("put_many_s", lambda: sim.put_many(1, names, datas))
        # kill members of the first object's up set so the gets
        # genuinely decode and recovery genuinely rebuilds
        pool = sim.osdmap.pools[1]
        up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
        victims = [o for o in up if o >= 0][:n_victims]
        up0, _ = timed("map_pgs_batch_s",
                       lambda: sim.osdmap.map_pgs_batch(1))
        for v in victims:
            sim.kill_osd(v)
        gets = timed("degraded_get_s",
                     lambda: [sim.get(1, nm) for nm in names])
        for v in victims:
            sim.out_osd(v)       # re-home so recovery REBUILDS
        rec = timed("recover_all_s", lambda: sim.recover_all(1))
        up1, _ = timed("remap_s", lambda: sim.osdmap.map_pgs_batch(1))
        gets2 = timed("get_after_recovery_s",
                      lambda: [sim.get(1, nm) for nm in names])
    finally:
        sim.shutdown()
    return {"placed": {nm: len(p) for nm, p in placed.items()},
            "datas": datas, "gets": gets, "gets2": gets2,
            "rec": rec, "up0": up0.tolist(), "up1": up1.tolist(),
            "victims": victims, "times": times}


@contextlib.contextmanager
def plane_cells(n_cells: int, stripes: int = 0, device=None):
    """The sharded data plane on, over ``n_cells`` cells of ``device``'s
    kind (the package default when None; one card gives a mesh that
    repeats it), 1-D or, with ``stripes`` >= 2, (stripes, n_cells //
    stripes).  Sets the package default device, the cells per device and
    the plane's options for the block, and yields the resolved plane."""
    import torch
    from . import default_device, resolve_device, set_default_device
    from .common.options import config
    from .parallel import data_plane, mesh
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    prev = (default_device(), mesh.cells_per_device)
    cfg = config()
    set_default_device(dev)
    mesh.cells_per_device = -(-int(n_cells) // n_dev)
    cfg.set("parallel_data_plane", True)
    cfg.set("parallel_data_plane_devices", int(n_cells))
    cfg.set("parallel_data_plane_stripes", int(stripes))
    try:
        dp = data_plane.plane()
        if dp is None or dp.n_shards != n_cells:
            raise RuntimeError(f"no data plane of {n_cells} cells "
                               f"(stripes {stripes}) on {dev}")
        yield dp
    finally:
        for opt in ("parallel_data_plane", "parallel_data_plane_devices",
                    "parallel_data_plane_stripes"):
            cfg.clear(opt)
        set_default_device(prev[0])
        mesh.cells_per_device = prev[1]


def cluster_sharded(n_cells: int, stripes: int = 0, device=None,
                    **step_kw) -> Dict:
    """The sharded SYSTEM dry run: :func:`cluster_step` with the data
    plane off, then on over ``n_cells`` cells (``plane_cells``), asserted
    bit-identical (every read, the recovery stats, both up sets).
    Returns the ``cluster_sharded`` section: per-cell accounting from the
    plane-on run, the dispatch counts and the identity verdict.
    ``step_kw`` goes to :func:`cluster_step` (``n_objects`` defaults to
    2 x ``n_cells``, as the reference's)."""
    from .common.options import config
    from .common.perf_counters import perf
    step_kw.setdefault("n_objects", 2 * n_cells)
    config().set("parallel_data_plane", False)
    try:
        single = cluster_step(device=device, **step_kw)
    finally:
        config().clear("parallel_data_plane")
    perf("dataplane").reset()      # section counters = the ON run only
    with plane_cells(n_cells, stripes, device) as dp:
        sharded = cluster_step(device=device, **step_kw)
        mesh_shape = list(dp.mesh.devices.shape)
    identical = all(single[k] == sharded[k] for k in
                    ("gets", "gets2", "rec", "up0", "up1", "placed")) \
        and single["gets"] == single["datas"]
    if not identical:
        raise AssertionError(
            "sharded cluster step diverged from single-device")
    dump = perf("dataplane").dump()

    def cells(prefix):
        out = {}
        for key in (f"{prefix}{i}" for i in range(n_cells)) \
                if prefix == "shard" else \
                (f"r{r}c{c}" for r in range(mesh_shape[0])
                 for c in range(mesh_shape[-1])):
            cell = {k.split(".", 1)[1]: v for k, v in dump.items()
                    if k.startswith(f"{key}.")}
            if cell:
                out[key[len(prefix):] if prefix == "shard" else key] = cell
        return out

    section = {
        "n_cells": n_cells,
        "mesh_shape": mesh_shape,
        "objects": len(single["datas"]),
        "bytes": sum(len(d) for d in single["datas"]),
        "bit_identical_to_single_device": identical,
        "degraded_get_ok": single["gets"] == single["datas"],
        "recover": single["rec"],
        "times_off": single["times"], "times_on": sharded["times"],
    }
    for key in ("put_dispatches", "decode_dispatches", "recover_dispatches",
                "map_dispatches", "psum_rows", "allgather_rows"):
        section[key] = dump.get(key, 0)
    section["per_chip"] = cells("shard")
    if stripes >= 2:
        section["allgather_rows_stripe"] = dump.get(
            "allgather_rows_stripe", 0)
        section["allgather_rows_shard"] = dump.get("allgather_rows_shard", 0)
        section["per_cell"] = cells("r")
    return section
