"""The port's cache tiering and object classes against ceph_tpu's.

``cluster/tiering.py`` (the HitSets, their rotating history and the
``CacheTier`` proxy with its agent) and the ``ClusterSim`` tier op paths
that use it (``tier_add``/``tier_remove``, ``copy_from``, writeback
writes, ``tier_flush``/``tier_evict``, promote on a read miss,
``tier_agent_work``), and ``ClusterSim.exec_cls`` through
``cluster/class_handler.py``.  Every scenario of tests/test_tiering.py,
the sim cases of tests/test_tier_ops.py and tests/test_cls.py runs in
both packages, the port's ClusterSim on the CPU, and records every
answer: object bytes in each pool, the dirty sets, the hit-set
temperatures, the ``osd.tier`` counters (as deltas over the scenario)
and exceptions by name.  The records must be equal, and the port's
answers must hold the reference tests' assertions.
"""
import json
import types

import numpy as np
import pytest
import torch

import ceph_tpu_torch

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def _pkg(name):
    if name == "ref":
        from ceph_tpu.client import rados
        from ceph_tpu.cluster import (class_handler, monitor, osdmap,
                                      simulator, tiering)
        from ceph_tpu.common import perf_counters
        from ceph_tpu.placement import builder, crush_map
    else:
        from ceph_tpu_torch.client import rados
        from ceph_tpu_torch.cluster import (class_handler, monitor, osdmap,
                                            simulator, tiering)
        from ceph_tpu_torch.common import perf_counters
        from ceph_tpu_torch.placement import builder, crush_map
    return types.SimpleNamespace(
        name=name, rados=rados, ch=class_handler, mon=monitor, om=osdmap,
        sim=simulator, tiering=tiering, perf=perf_counters.perf,
        builder=builder, cm=crush_map)


REF, PORT = _pkg("ref"), _pkg("port")
BASE, CACHE = 1, 2


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def _rules(pkg, cmap, root, ops):
    cm = pkg.cm
    for op in ops:
        cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                     (op, 0, pkg.builder.TYPE_HOST),
                                     (cm.RULE_EMIT, 0, 0)]))


def snaps_sim(pkg):
    """tests/test_snaps.py's make_sim: 4 hosts x 2 OSDs, a 3-replica
    pool and a k=2 m=1 pool of 16 PGs."""
    om_mod, cm = pkg.om, pkg.cm
    cmap, root = pkg.builder.build_flat_cluster(n_hosts=4, osds_per_host=2,
                                                seed=3)
    _rules(pkg, cmap, root, (cm.RULE_CHOOSELEAF_FIRSTN,
                             cm.RULE_CHOOSELEAF_INDEP))
    om = om_mod.OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(om_mod.PGPool(id=1, name="rep", type=om_mod.POOL_REPLICATED,
                              size=3, pg_num=16, crush_rule=0))
    om.add_pool(om_mod.PGPool(id=2, name="ec", type=om_mod.POOL_ERASURE,
                              size=3, pg_num=16, crush_rule=1,
                              erasure_code_profile="p"))
    sim = pkg.sim.ClusterSim(om)
    sim.create_ec_profile("p", {"plugin": "jax", "k": "2", "m": "1"})
    return sim


def tiered_sim(pkg):
    """tests/test_tier_ops.py's make_tiered_sim: a size-2 cache pool
    over a 3-replica base pool on 6 hosts x 2 OSDs."""
    om_mod, cm = pkg.om, pkg.cm
    cmap, root = pkg.builder.build_flat_cluster(n_hosts=6, osds_per_host=2,
                                                seed=0)
    _rules(pkg, cmap, root, (cm.RULE_CHOOSELEAF_FIRSTN,))
    om = om_mod.OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(om_mod.PGPool(id=BASE, name="base",
                              type=om_mod.POOL_REPLICATED, size=3,
                              pg_num=16, crush_rule=0))
    om.add_pool(om_mod.PGPool(id=CACHE, name="cache",
                              type=om_mod.POOL_REPLICATED, size=2,
                              pg_num=16, crush_rule=0))
    sim = pkg.sim.ClusterSim(om)
    sim.tier_add(BASE, CACHE)
    return sim


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 — compared by name
        return ("raised", type(e).__name__)


def _objects(sim):
    """Every object's bytes, by (pool, name), read raw (no routing)."""
    return {key: sim._get_raw(*key) for key in sorted(sim.objects)}


class _TierCounters:
    """``osd.tier`` counters as deltas (the registry is per process)."""

    KEYS = ("promote_ops", "flush_ops", "evict_ops")

    def __init__(self, pkg):
        self.pc = pkg.perf("osd.tier")
        self.base = {k: self.pc.get(k) or 0 for k in self.KEYS}

    def __call__(self):
        return {k: (self.pc.get(k) or 0) - self.base[k] for k in self.KEYS}


# ------------------------------------------------------------ hit sets ---

def hitsets(pkg):
    t = pkg.tiering
    out = []
    for hs in (t.BloomHitSet(), t.ExplicitHitSet()):
        for i in range(50):
            hs.insert(f"obj{i}")
        out.append([hs.contains(f"obj{i}") for i in range(50)])
        out.append(hs.inserts)
    bf = t.BloomHitSet()
    for i in range(50):
        bf.insert(f"obj{i}")
    out += [[bf._idx(f"obj{i}") for i in range(8)],
            [bf.contains(f"other{i}") for i in range(1000)],
            np.flatnonzero(bf._bf).tolist()]
    h = t.HitSetHistory(count=2, period_ops=4, kind="explicit")
    for _ in range(3):
        h.record("hot")
        h.record("x1")
        h.rotate()
    h.record("cold-now")
    out += [h.temperature(n) for n in ("hot", "cold-now", "never", "x1")]
    out.append(len(h.history))
    hb = t.HitSetHistory(count=3, period_ops=5)
    for i in range(40):
        hb.record(f"n{i % 7}")
    out.append([hb.temperature(f"n{i}") for i in range(9)])
    return out


def cache_tier_writeback(pkg):
    """tests/test_tiering.py's writeback, flush and promote."""
    sim = snaps_sim(pkg)
    try:
        tier = pkg.tiering.CacheTier(sim, cache_pool_id=1, base_pool_id=2,
                                     target_max_objects=4,
                                     hit_set_period_ops=8)
        rng = np.random.default_rng(6)
        data = {f"o{i}": rng.integers(0, 256, 3000, dtype=np.uint8)
                .tobytes() for i in range(3)}
        for n, d in data.items():
            tier.write(n, d)
        out = [(2, "o0") in sim.objects, sorted(tier.dirty)]
        out.append(tier.agent_work())
        out += [(2, "o0") in sim.objects, sim.get(2, "o0") == data["o0"]]
        tier.evict("o0")
        out += [(1, "o0") in sim.objects, tier.read("o0") == data["o0"],
                dict(tier.stats), (1, "o0") in sim.objects,
                tier.read("o0") == data["o0"], dict(tier.stats),
                tier.cached_objects(), _objects(sim)]
        return out
    finally:
        sim.shutdown()


def cache_tier_agent_evicts_coldest(pkg):
    """tests/test_tiering.py's agent pass: the hot pair survives."""
    sim = snaps_sim(pkg)
    try:
        tier = pkg.tiering.CacheTier(sim, cache_pool_id=1, base_pool_id=2,
                                     target_max_objects=4,
                                     hit_set_period_ops=8)
        rng = np.random.default_rng(7)
        for i in range(8):
            tier.write(f"t{i}", rng.integers(0, 256, 500,
                                             dtype=np.uint8).tobytes())
        for _ in range(20):
            tier.read("t0")
            tier.read("t1")
        out = [[tier.hitsets.temperature(f"t{i}") for i in range(8)],
               tier.agent_work(), tier.cached_objects()]
        out.append([tier.read(f"t{i}") for i in range(8)])
        out += [dict(tier.stats), sorted(tier.dirty), _objects(sim)]
        return out
    finally:
        sim.shutdown()


# ------------------------------------------------------- tier op paths ---

def tier_copy_from(pkg):
    sim = tiered_sim(pkg)
    try:
        sim.tier_remove(BASE, CACHE)
        data = b"copy-me" * 500
        out = [sim.put(BASE, "src", data),
               sim.copy_from(CACHE, "dst", BASE, "src"),
               sim.get(CACHE, "dst"), sim.get(BASE, "src"), _objects(sim)]
        return out
    finally:
        sim.shutdown()


def tier_writeback_and_flush_demote(pkg):
    sim = tiered_sim(pkg)
    pc = _TierCounters(pkg)
    try:
        data = b"hot-object" * 300
        out = [sim.put(BASE, "obj", data), (CACHE, "obj") in sim.objects,
               (BASE, "obj") in sim.objects,
               sorted(sim._tier_hits(BASE)["dirty"]), sim.get(BASE, "obj"),
               _outcome(lambda: sim.tier_evict(BASE, "obj"))]
        sim.tier_flush(BASE, "obj")
        out += [sim.get(BASE, "obj"), (BASE, "obj") in sim.objects,
                sorted(sim._tier_hits(BASE)["dirty"]), pc()]
        sim.tier_evict(BASE, "obj")
        out += [(CACHE, "obj") in sim.objects, sim.get(BASE, "obj"), pc(),
                (CACHE, "obj") in sim.objects, _objects(sim)]
        return out
    finally:
        sim.shutdown()


def tier_delete_and_drain(pkg):
    sim = tiered_sim(pkg)
    pc = _TierCounters(pkg)
    try:
        sim.put(BASE, "doomed", b"bye" * 200)
        sim.delete(BASE, "doomed")
        out = [_outcome(lambda: sim.get(BASE, "doomed")),
               (CACHE, "doomed") in sim.objects]
        sim.put(BASE, "held", b"x" * 100)
        out.append(_outcome(lambda: sim.tier_remove(BASE, CACHE)))
        out.append(sim.tier_agent_work(BASE, target_objects=0))
        sim.tier_evict(BASE, "held")
        sim.tier_remove(BASE, CACHE)
        out += [sim.osdmap.pools[BASE].read_tier,
                sim.osdmap.pools[BASE].write_tier,
                sim.osdmap.pools[CACHE].tier_of, sim.get(BASE, "held"),
                pc(), _objects(sim)]
        return out
    finally:
        sim.shutdown()


def tier_add_refusals(pkg):
    sim = tiered_sim(pkg)
    try:
        out = [_outcome(lambda: sim.tier_add(BASE, CACHE)),
               _outcome(lambda: sim.tier_add(CACHE, BASE)),
               _outcome(lambda: sim.tier_add(BASE, BASE))]
        sim.tier_remove(BASE, CACHE)
        sim.snap_create(BASE, "s1")
        out += [_outcome(lambda: sim.tier_add(BASE, CACHE)),
                sim.osdmap.pools[BASE].read_tier]
        return out
    finally:
        sim.shutdown()


def tier_read_promotes(pkg):
    sim = tiered_sim(pkg)
    pc = _TierCounters(pkg)
    try:
        data = b"cold" * 400
        out = [sim._put_raw(BASE, "cold", data),
               (CACHE, "cold") in sim.objects, sim.get(BASE, "cold"),
               (CACHE, "cold") in sim.objects, pc(),
               sim._tier_hits(BASE)["hits"].temperature("cold"),
               _objects(sim)]
        return out
    finally:
        sim.shutdown()


def tier_agent_pass(pkg):
    sim = tiered_sim(pkg)
    pc = _TierCounters(pkg)
    try:
        for i in range(6):
            sim.put(BASE, f"o{i}", f"payload-{i}".encode() * 100)
        sim._tier_hits(BASE)["hits"].rotate()
        for _ in range(5):
            sim.get(BASE, "o0")
            sim.get(BASE, "o1")
        out = [sim.tier_agent_work(BASE, target_objects=2),
               sorted(nm for (pid, nm) in sim.objects if pid == CACHE),
               sorted(sim._tier_hits(BASE)["dirty"]), pc()]
        out.append([sim.get(BASE, f"o{i}") for i in range(6)])
        out += [pc(), _objects(sim)]
        return out
    finally:
        sim.shutdown()


# ------------------------------------------------------- object classes --

def _lock(sim, oid, name, typ="exclusive", cookie=""):
    return sim.exec_cls(1, oid, "lock", "lock", json.dumps(
        {"name": name, "type": typ, "cookie": cookie}).encode())


def object_classes(pkg):
    """tests/test_cls.py on one sim: lock contention, shared locks and
    break_lock, the refcount lifecycle, an unknown class, the EC-pool
    refusal and the librados ``exec`` surface."""
    sim = snaps_sim(pkg)
    try:
        out = [_lock(sim, "locked", "client-a"),
               _outcome(lambda: _lock(sim, "locked", "client-b")),
               sim.exec_cls(1, "locked", "lock", "info"),
               _outcome(lambda: sim.exec_cls(
                   1, "locked", "lock", "unlock",
                   json.dumps({"name": "client-b"}).encode())),
               sim.exec_cls(1, "locked", "lock", "unlock",
                            json.dumps({"name": "client-a"}).encode()),
               _lock(sim, "locked", "client-b")]
        _lock(sim, "shared", "r1", typ="shared")
        _lock(sim, "shared", "r2", typ="shared")
        out += [_outcome(lambda: _lock(sim, "shared", "w1")),
                sim.exec_cls(1, "shared", "lock", "break_lock",
                             json.dumps({"name": "r1"}).encode()),
                sim.exec_cls(1, "shared", "lock", "info")]
        sim.put(1, "counted", b"shared payload")
        out += [sim.exec_cls(1, "counted", "refcount", "get", b"tagA"),
                sim.exec_cls(1, "counted", "refcount", "get", b"tagB"),
                sim.exec_cls(1, "counted", "refcount", "read"),
                sim.exec_cls(1, "counted", "refcount", "put", b"tagA"),
                sim.exec_cls(1, "counted", "refcount", "put", b"tagB")]
        pool = sim.osdmap.pools[1]
        pg = sim.object_pg(pool, "counted")
        up = sim.pg_up(pool, pg)
        out += [up, sim.osds[up[0]].objectstore.exists((1, pg),
                                                        "0:counted"),
                _outcome(lambda: sim.exec_cls(1, "x", "nope", "nothing")),
                _outcome(lambda: sim.exec_cls(2, "x", "lock", "info"))]
        ioctx = pkg.rados.Rados(sim, pkg.mon.Monitor(sim.osdmap)) \
            .connect().open_ioctx("rep")
        _lock(sim, "via-api", "x")
        out.append(ioctx.exec("via-api", "lock", "info"))
        return out
    finally:
        sim.shutdown()


SCENARIOS = [hitsets, cache_tier_writeback, cache_tier_agent_evicts_coldest,
             tier_copy_from, tier_writeback_and_flush_demote,
             tier_delete_and_drain, tier_add_refusals, tier_read_promotes,
             tier_agent_pass, object_classes]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_tiering_equals_reference(scenario):
    assert scenario(PORT) == scenario(REF)


def test_hitsets_hold_the_reference_contract():
    out = hitsets(PORT)
    assert all(out[0]) and all(out[2])
    assert sum(out[5]) < 20                 # bloom false positives
    assert out[7] >= 2 and out[8:10] == [1, 0] and out[11] == 2


def test_tier_ops_hold_the_reference_contract():
    out = tier_writeback_and_flush_demote(PORT)
    assert out[1:4] == [True, False, ["obj"]]
    assert out[5] == ("raised", "OSError")
    assert out[7:10] == [True, [], {"promote_ops": 0, "flush_ops": 1,
                                    "evict_ops": 0}]
    assert out[10] is False and out[12]["promote_ops"] == 1
    out = tier_agent_pass(PORT)
    assert out[0] == {"flushed": 6, "evicted": 4}
    assert out[1] == ["o0", "o1"]
    assert out[4] == [f"payload-{i}".encode() * 100 for i in range(6)]
    out = tier_delete_and_drain(PORT)
    assert out[0] == ("raised", "KeyError") and out[1] is False
    assert out[2] == ("raised", "OSError")
    assert out[4:7] == [-1, -1, -1] and out[7] == b"x" * 100
    out = cache_tier_agent_evicts_coldest(PORT)
    assert len(out[2]) == 4 and {"t0", "t1"} <= set(out[2])
    assert all(len(b) == 500 for b in out[3])


def test_exec_cls_holds_the_reference_contract():
    """``exec_cls`` answers (no NotImplementedError) as tests/test_cls.py
    asserts."""
    out = object_classes(PORT)
    assert out[1] == ("raised", "ClsError")
    info = json.loads(out[2].decode())
    assert info["type"] == "exclusive"
    assert info["holders"] == [{"name": "client-a", "cookie": ""}]
    assert out[3] == ("raised", "ClsError")
    assert out[6] == ("raised", "ClsError")
    assert [h["name"] for h in json.loads(out[8].decode())["holders"]] == \
        ["r2"]
    assert out[9:14] == [b"1", b"2", b'["tagA", "tagB"]', b"1", b"0"]
    assert out[15] is False
    assert out[16] == ("raised", "ClsError")
    assert out[17] == ("raised", "OSError")
    assert json.loads(out[18].decode())["holders"][0]["name"] == "x"
