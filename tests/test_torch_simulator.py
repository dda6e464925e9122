"""The slice as a whole: the port's ClusterSim against ceph_tpu's.

``ceph_tpu_torch.entry.cluster_step`` runs the single-device leg of
``__graft_entry__._cluster_sharded_impl`` (batched put, degraded get,
kill and out OSDs, recover_all, the map_pgs_batch remap sweep, get
again) on the CPU; the same steps run on ``ceph_tpu``'s ClusterSim, built
as ``__graft_entry__.py:140-196`` builds it, with seed 0, for the default
bitsliced layout (HBM-staged, K1) and for ``layout=bytes`` (host tier,
K2).  Everything the step returns must be equal between the packages.
A few cases of tests/test_simulator.py and tests/test_device_staging.py
follow: mixed sizes in two stripe classes, a kill beyond m.  Then one pool
per erasure-code plugin (jerasure's bitmatrix and matrix techniques, isa,
shec, lrc and clay) on the same map runs put, degraded get, kill/out and
recover_all in both packages; shard bytes, reads and recovery stats must
be equal.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch import entry
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.ec import bitmatrix_codec
from ceph_tpu_torch.ops import gf_pallas, xor_kernel

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

KEYS = ("placed", "gets", "gets2", "rec", "up0", "up1", "victims")
# the dry run's 2 x n_devices objects at n_devices = 4 (each stripe class
# costs the reference a compile on the CPU)
N_OBJECTS = 8


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def ref_crush():
    """The dry run's CRUSH map and ONE reference XlaMapper for it, shared
    by both layouts' reference sims (weights are runtime operands of the
    mapper, so sharing it changes no result; its jit compile on the CPU
    is the bulk of this file's time)."""
    from ceph_tpu.placement.builder import TYPE_HOST, build_flat_cluster
    from ceph_tpu.placement.crush_map import (
        RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    from ceph_tpu.placement.xla_mapper import XlaMapper
    cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=1)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    mapper = XlaMapper(cmap)
    mapper.map_batch(0, np.arange(16), 6, [0x10000] * cmap.max_devices)
    return cmap, mapper


def ref_cluster_step(ref_crush, layout, seed=0, n_objects=N_OBJECTS):
    """``__graft_entry__._cluster_sharded_impl``'s run(False) on
    ceph_tpu, with the pool's layout named (None: the cluster default)."""
    from ceph_tpu.cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ceph_tpu.cluster.simulator import ClusterSim
    k, m = 4, 2
    cmap, mapper = ref_crush
    om = OSDMap(cmap)
    om._mapper, om._mapper_map = mapper, cmap
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="ec", type=POOL_ERASURE, size=k + m,
                       pg_num=16, crush_rule=0, erasure_code_profile="p",
                       stripe_unit=64))
    sim = ClusterSim(om)
    prof = {"plugin": "jax", "k": str(k), "m": str(m)}
    if layout is not None:
        prof["layout"] = layout
    sim.create_ec_profile("p", prof)
    rng = np.random.default_rng(seed)
    names = [f"o{i}" for i in range(n_objects)]
    datas = [rng.integers(0, 256, int(sz), dtype=np.uint8).tobytes()
             for sz in rng.integers(200, 4000, len(names))]
    placed = sim.put_many(1, names, datas)
    pool = sim.osdmap.pools[1]
    up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
    victims = [o for o in up if o >= 0][:2]
    up0, _ = sim.osdmap.map_pgs_batch(1)
    for v in victims:
        sim.kill_osd(v)
    gets = [sim.get(1, nm) for nm in names]
    for v in victims:
        sim.out_osd(v)
    rec = sim.recover_all(1)
    up1, _ = sim.osdmap.map_pgs_batch(1)
    gets2 = [sim.get(1, nm) for nm in names]
    sim.shutdown()
    return {"placed": {nm: len(p) for nm, p in placed.items()},
            "datas": datas, "gets": gets, "gets2": gets2, "rec": rec,
            "up0": np.asarray(up0).tolist(),
            "up1": np.asarray(up1).tolist(), "victims": victims}


@pytest.mark.parametrize("layout", ["bitsliced", "bytes"])
def test_cluster_step_equals_reference(ref_crush, layout):
    got = entry.cluster_step(device="cpu", layout=layout, seed=0,
                             n_objects=N_OBJECTS)
    want = ref_cluster_step(ref_crush,
                            None if layout == "bitsliced" else layout)
    assert got["datas"] == want["datas"]
    assert got["gets"] == got["datas"]
    assert got["gets2"] == got["datas"]
    for key in KEYS:
        assert got[key] == want[key], key
    assert got["rec"]["shards_rebuilt"] > 0


def run_dispatches(layout, fn):
    """(ec.jax encode+decode dispatches, K1 plain runs, K2 plain runs)
    made by ``fn()``: on the CPU every kernel wrapper takes its plain
    version, one trip per dispatch of its layout."""
    pc = perf("ec.jax")

    def snap():
        d = pc.dump()
        return (d.get("encode_dispatches", 0) + d.get("decode_dispatches", 0),
                xor_kernel.plain_runs, gf_pallas.plain_runs)

    before = snap()
    fn()
    return tuple(a - b for a, b in zip(snap(), before))


@pytest.mark.parametrize("layout", ["bitsliced", "bytes"])
def test_each_dispatch_reaches_its_layouts_kernel_wrapper(layout):
    dispatches, k1, k2 = run_dispatches(
        layout, lambda: entry.cluster_step(device="cpu", layout=layout,
                                           n_objects=N_OBJECTS))
    assert dispatches > 0
    if layout == "bytes":
        assert (k1, k2) == (0, dispatches)
    else:     # the rebuild sweep also calls K1 directly, once per batch
        assert k2 == 0 and k1 > dispatches


@pytest.mark.parametrize("layout", ["bitsliced", "bytes"])
def test_mixed_sizes_in_two_stripe_classes(layout):
    sim = entry.build_sim(layout=layout, device="cpu")
    try:
        rng = np.random.default_rng(3)
        # stripe width 4 x 64 B: 1-stripe and 3-stripe objects
        sizes = [100, 256, 600, 700, 17, 768]
        names = [f"m{i}" for i in range(len(sizes))]
        datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
                 for s in sizes]
        placed = sim.put_many(1, names, datas)
        assert all(len(p) == 6 for p in placed.values())
        for nm, d in zip(names, datas):
            info = sim.objects[(1, nm)]
            assert info.size == len(d)
            assert info.n_stripes == (1 if len(d) <= 256 else 3)
            assert sim.get(1, nm) == d
    finally:
        sim.shutdown()


@pytest.mark.parametrize("layout", ["bitsliced", "bytes"])
def test_kill_beyond_m_raises_ioerror(layout):
    sim = entry.build_sim(layout=layout, device="cpu")
    try:
        data = np.random.default_rng(4).integers(
            0, 256, 900, dtype=np.uint8).tobytes()
        sim.put(1, "x", data)
        pool = sim.osdmap.pools[1]
        up = sim.pg_up(pool, sim.object_pg(pool, "x"))
        for o in up[:2]:
            sim.kill_osd(o)
        assert sim.get(1, "x") == data          # m = 2 losses: decodes
        sim.kill_osd(up[2])
        with pytest.raises(IOError):
            sim.get(1, "x")
    finally:
        sim.shutdown()


def test_byte_pool_runs_the_host_tier_and_bitsliced_the_staging_tier():
    for layout, staged in (("bitsliced", True), ("bytes", False)):
        sim = entry.build_sim(layout=layout, device="cpu")
        try:
            codec = sim.codec_for(sim.osdmap.pools[1])
            assert codec.layout == layout
            assert sim._device_staging(codec) is staged
        finally:
            sim.shutdown()


def tier_and_cls_on_the_dry_run_sim(sim, om_mod):
    """``exec_cls`` and the tier paths (``_tier_hits`` under them) on the
    dry run's sim with a replicated cache pool added over a replicated
    base; object classes on the EC pool are refused."""
    import json
    for pid, name in ((2, "base"), (3, "cache")):
        sim.osdmap.add_pool(om_mod.PGPool(
            id=pid, name=name, type=om_mod.POOL_REPLICATED, size=3,
            pg_num=8, crush_rule=0))
    out = []

    def rec(fn):
        try:
            out.append(fn())
        except Exception as e:       # noqa: BLE001 — compared by name
            out.append(type(e).__name__)
    lock = json.dumps({"name": "a", "type": "exclusive",
                       "cookie": ""}).encode()
    rec(lambda: sim.exec_cls(1, "x", "lock", "lock", lock))
    rec(lambda: sim.exec_cls(2, "x", "lock", "lock", lock))
    rec(lambda: sim.exec_cls(2, "x", "lock", "info"))
    rec(lambda: sim.exec_cls(2, "x", "lock", "lock", lock.replace(
        b'"a"', b'"b"')))
    rec(lambda: sorted(sim._tier_hits(2)))
    rec(lambda: sim.tier_add(2, 3))
    rec(lambda: sim.put(2, "t", b"tiered" * 300))
    rec(lambda: sorted(sim._tier_hits(2)["dirty"]))
    rec(lambda: sim._tier_hits(2)["hits"].temperature("t"))
    rec(lambda: sim.tier_flush(2, "t"))
    rec(lambda: sim.tier_evict(2, "t"))
    rec(lambda: sim.get(2, "t"))
    rec(lambda: sim.tier_agent_work(2, target_objects=0))
    rec(lambda: sorted(sim.objects))
    return out


def test_tiering_and_object_classes_equal_the_reference(ref_crush):
    """``exec_cls`` (through ``cluster/class_handler.py``) and
    ``_tier_hits`` (through ``cluster/tiering.py``) answer as the
    reference's on the same sim."""
    from ceph_tpu.cluster import osdmap as ref_om
    from ceph_tpu.cluster.simulator import ClusterSim
    from ceph_tpu_torch.cluster import osdmap as port_om
    sim = entry.build_sim(device="cpu")
    try:
        got = tier_and_cls_on_the_dry_run_sim(sim, port_om)
    finally:
        sim.shutdown()
    cmap, mapper = ref_crush
    om = ref_om.OSDMap(cmap)
    om._mapper, om._mapper_map = mapper, cmap
    om.mark_all_in_up()
    om.add_pool(ref_om.PGPool(id=1, name="ec", type=ref_om.POOL_ERASURE,
                              size=6, pg_num=16, crush_rule=0,
                              erasure_code_profile="p", stripe_unit=64))
    ref = ClusterSim(om)
    ref.create_ec_profile("p", {"plugin": "jax", "k": "4", "m": "2"})
    try:
        want = tier_and_cls_on_the_dry_run_sim(ref, ref_om)
    finally:
        ref.shutdown()
    assert got == want
    assert got[0] == "OSError" and got[1] == b"" and got[3] == "ClsError"
    assert got[4] == ["dirty", "hits"] and got[7] == ["t"]
    assert got[11] == b"tiered" * 300


# one pool per plugin, every profile six chunks wide so that the module's
# reference mapper (compiled for 6 results) serves them all
PLUGIN_POOLS = {
    "jerasure-liber8tion": {"plugin": "jerasure", "technique": "liber8tion",
                            "k": "4", "m": "2", "w": "8"},
    "jerasure-cauchy_good": {"plugin": "jerasure",
                             "technique": "cauchy_good", "k": "4",
                             "m": "2"},
    "isa": {"plugin": "isa", "k": "4", "m": "2"},
    "shec": {"plugin": "shec", "k": "3", "m": "3", "c": "2"},
    "lrc": {"plugin": "lrc", "k": "2", "m": "2", "l": "2"},
    "clay": {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
}


def plugin_pool_step(sim, seed=5, n_objects=N_OBJECTS):
    """put_many, two OSDs of the first object's up set killed, every
    object read, both marked out, recover_all, every object read again;
    returns what both packages must agree on."""
    rng = np.random.default_rng(seed)
    names = [f"p{i}" for i in range(n_objects)]
    datas = [rng.integers(0, 256, int(sz), dtype=np.uint8).tobytes()
             for sz in rng.integers(200, 4000, len(names))]
    placed = sim.put_many(1, names, datas)
    pool = sim.osdmap.pools[1]

    def shards():
        out = {}
        for nm in names:
            pg = sim.object_pg(pool, nm)
            up = sim.pg_up(pool, pg)
            for shard in range(len(up)):
                f = sim._read_shard(1, pg, nm, shard, up)
                out[(nm, shard)] = None if f is None else bytes(f)
        return out

    stored = shards()
    up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
    victims = [o for o in up if o >= 0][:2]
    for v in victims:
        sim.kill_osd(v)
    gets = [sim.get(1, nm) for nm in names]
    for v in victims:
        sim.out_osd(v)
    rec = sim.recover_all(1)
    gets2 = [sim.get(1, nm) for nm in names]
    return {"placed": {nm: sorted(p) for nm, p in placed.items()},
            "datas": datas, "stored": stored, "gets": gets,
            "gets2": gets2, "rec": rec, "after": shards(),
            "victims": victims}


@pytest.mark.parametrize("name", list(PLUGIN_POOLS))
def test_plugin_pool_equals_reference(ref_crush, name):
    from ceph_tpu.cluster.osdmap import OSDMap as RefOSDMap
    from ceph_tpu.cluster.osdmap import PGPool as RefPGPool
    from ceph_tpu.cluster.simulator import ClusterSim as RefClusterSim
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ceph_tpu_torch.cluster.simulator import ClusterSim
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    prof = PLUGIN_POOLS[name]
    pool_args = dict(id=1, name=name, type=POOL_ERASURE, size=6, pg_num=16,
                     crush_rule=0, erasure_code_profile="p", stripe_unit=64)
    cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=1)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device="cpu")
    om.mark_all_in_up()
    om.add_pool(PGPool(**pool_args))
    sim = ClusterSim(om, device="cpu")
    ref_cmap, mapper = ref_crush
    rom = RefOSDMap(ref_cmap)
    rom._mapper, rom._mapper_map = mapper, ref_cmap
    rom.mark_all_in_up()
    rom.add_pool(RefPGPool(**pool_args))
    ref = RefClusterSim(rom)
    try:
        sim.create_ec_profile("p", dict(prof))
        ref.create_ec_profile("p", dict(prof))
        codec = sim.codec_for(om.pools[1])
        assert codec.get_chunk_count() == 6
        assert codec.device == torch.device("cpu")
        assert not sim._device_staging(codec)      # the host tier
        before = kernel_trips()
        got = plugin_pool_step(sim)
        trips = [b - a for a, b in zip(before, kernel_trips())]
        want = plugin_pool_step(ref)
    finally:
        sim.shutdown()
        ref.shutdown()
    assert got["gets"] == got["datas"] and got["gets2"] == got["datas"]
    for key in ("datas", "placed", "victims", "stored", "gets", "gets2",
                "rec", "after"):
        assert got[key] == want[key], key
    assert got["rec"]["shards_rebuilt"] > 0
    if prof["plugin"] == "clay":
        assert got["rec"].get("ranged_repairs", 0) > 0
    # (K1 trips, bitmatrix codec dispatches, K2 trips, ec.jax dispatches):
    # on the CPU each kernel wrapper takes its plain version, once per
    # dispatch of the codec that runs it; the host codecs run neither
    k1, bitmatrix, k2, jax = trips
    assert (k1, k2) == (bitmatrix, jax)
    if prof.get("technique") == "liber8tion":
        assert k1 > 0 and k2 == 0
    elif prof["plugin"] in ("lrc", "clay"):
        assert k2 > 0 and k1 == 0
    else:
        assert k1 == k2 == 0


def kernel_trips():
    def dispatches(group):
        d = perf(group).dump()
        return d.get("encode_dispatches", 0) + d.get("decode_dispatches", 0)

    return (xor_kernel.plain_runs,
            bitmatrix_codec.encode_dispatches +
            bitmatrix_codec.decode_dispatches,
            gf_pallas.plain_runs, dispatches("ec.jax"))


def test_perf_groups_carry_the_references_keys(ref_crush, monkeypatch):
    """The port's perf registry holds what the reference's holds: after
    the bitsliced cluster step (seed 0, 8 objects) and a liber8tion
    bitmatrix pool's put, run in each package against an empty registry,
    every group has the same key set.  Kernel launches, the bitmatrix
    codec's dispatches, the rebuild sweep's dispatches and the readback
    bytes are module counts of the port, outside the registry."""
    from ceph_tpu.cluster.osdmap import OSDMap as RefOSDMap
    from ceph_tpu.cluster.osdmap import PGPool as RefPGPool
    from ceph_tpu.cluster.simulator import ClusterSim as RefClusterSim
    from ceph_tpu.common import perf_counters as ref_pc
    from ceph_tpu_torch.common import perf_counters as port_pc
    monkeypatch.setattr(ref_pc, "_collection", None)
    monkeypatch.setattr(port_pc, "_collection", None)
    # the reference writes its ``jit`` group on a first-seen K1 shape or
    # GF matrix of the process; another file in the same worker may have
    # dispatched them all already, so this test starts from empty caches
    import collections

    from ceph_tpu.ops import gf_jax as ref_gf_jax
    from ceph_tpu.ops import xor_kernel as ref_xor_kernel
    monkeypatch.setattr(ref_xor_kernel, "_seen_shapes", set())
    monkeypatch.setattr(ref_gf_jax, "_seen_matrices",
                        collections.OrderedDict())
    prof = PLUGIN_POOLS["jerasure-liber8tion"]
    pool_args = dict(id=2, name="bm", type=2, size=6, pg_num=16,
                     crush_rule=0, erasure_code_profile="bm",
                     stripe_unit=64)
    rng = np.random.default_rng(9)
    names = [f"b{i}" for i in range(4)]
    datas = [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
             for _ in names]

    entry.cluster_step(device="cpu", layout="bitsliced", seed=0,
                       n_objects=N_OBJECTS)
    sim = entry.build_sim(device="cpu")
    from ceph_tpu_torch.cluster.osdmap import PGPool
    try:
        sim.osdmap.add_pool(PGPool(**pool_args))
        sim.create_ec_profile("bm", dict(prof))
        sim.put_many(2, names, datas)
    finally:
        sim.shutdown()

    ref_cluster_step(ref_crush, None)
    cmap, mapper = ref_crush
    rom = RefOSDMap(cmap)
    rom._mapper, rom._mapper_map = mapper, cmap
    rom.mark_all_in_up()
    rom.add_pool(RefPGPool(**pool_args))
    ref = RefClusterSim(rom)
    try:
        ref.create_ec_profile("bm", dict(prof))
        ref.put_many(2, names, datas)
    finally:
        ref.shutdown()

    # a group of the reference that the port lacks is one whose keys the
    # port never writes: ``jit``, the reference's XLA compiles
    got = {g: sorted(d) for g, d in port_pc.perf().dump().items()}
    want = {g: sorted(d) for g, d in ref_pc.perf().dump().items()}
    # a group the port created without writing a key counts as absent
    differ = {g: (want.get(g, []), got[g]) for g in got
              if want.get(g, []) != got[g]}
    assert not differ, f"groups whose keys differ (want, got): {differ}"
    assert set(want) - set(got) == {"jit"}, (sorted(want), sorted(got))
    assert {"compiles", "compile_s", "ec.xor_kernel.compiles"} <= set(
        want["jit"]), want["jit"]
    assert got["ec.jax"] and got["hbm"] and got["crush.mapper"]
