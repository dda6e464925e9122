"""The port's copied host substrate against ceph_tpu's.

``placement/treedump``, ``common/backoff``, ``common/log``,
``common/admin``, ``cluster/striper``, ``cluster/scrub_machine`` and
``cluster/admin_commands`` are host-only copies.  The same inputs go
through both packages and the outputs must be equal: tree dumps and crush
locations, backoff and tick-clock sequences from one seed, log rings,
admin replies, striping extents, and one scrub plus the ``osd tree``,
``pg dump`` and ``scrub`` admin commands on a small ClusterSim.  Mirrors
tests/test_aux_components.py, tests/test_common.py, the backoff cases of
tests/test_faults.py and the layout math under tests/test_striper_swift.py.
"""
import json
import re

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.cluster import striper as ref_striper
from ceph_tpu.common import backoff as ref_backoff
from ceph_tpu.common import log as ref_log
from ceph_tpu.placement import compiler as ref_compiler
from ceph_tpu.placement import treedump as ref_treedump
from ceph_tpu_torch.cluster import striper as port_striper
from ceph_tpu_torch.common import backoff as port_backoff
from ceph_tpu_torch.common import log as port_log
from ceph_tpu_torch.placement import compiler as port_compiler
from ceph_tpu_torch.placement import treedump as port_treedump

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

CRUSH_TEXTS = ("tests/cli/basic.crush", "tests/cli/classes.crush")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


# ------------------------------------------------------------- treedump --

@pytest.mark.parametrize("path", CRUSH_TEXTS)
def test_tree_dump_and_location_equal_reference(path):
    text = open(path).read()
    ref = ref_compiler.compile_crushmap(text)
    port = port_compiler.compile_crushmap(text)
    out = port_treedump.tree_dump(port)
    assert out == ref_treedump.tree_dump(ref)
    assert "~ssd" not in out and "~hdd" not in out
    for osd in range(port.max_devices):
        assert port_treedump.crush_location(port, osd) == \
            ref_treedump.crush_location(ref, osd)


# -------------------------------------------------------------- backoff --

@pytest.mark.parametrize("kw", [
    dict(base=0.05, factor=2.0, cap=0.4, jitter=0.5, seed=9),
    dict(seed=10),
    dict(base=0.5, cap=8.0, jitter=0.0, seed=0),
])
def test_exp_backoff_and_tick_clock_equal_reference(kw):
    sequences = []
    for mod in (ref_backoff, port_backoff):
        clk = mod.TickClock()
        bo = mod.ExpBackoff(sleep=clk.sleep, **kw)
        delays = [bo.delay(i) for i in range(8)]
        slept = [bo.sleep(i) for i in range(6)]
        sequences.append((delays, slept, clk.now, clk.sleeps))
    assert sequences[0] == sequences[1]
    assert all(0 < d <= kw.get("cap", 1.0) for d in sequences[1][0])


@pytest.mark.parametrize("kw", [dict(base=0), dict(factor=0.5),
                                dict(cap=0.01), dict(jitter=1.0)])
def test_exp_backoff_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        ref_backoff.ExpBackoff(**kw)
    with pytest.raises(ValueError):
        port_backoff.ExpBackoff(**kw)


# ------------------------------------------------------------------ log --

def test_log_ring_equals_reference():
    stamp = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d ")
    runs = []
    for mod in (ref_log, port_log):
        lines = []
        log = mod.Log(writer=lines.append)
        log.set_level("osd", 10, 20)
        log.set_level("ms", 1)
        for subsys, level, msg in (("osd", 5, "emitted"),
                                   ("osd", 15, "gathered only"),
                                   ("osd", 25, "dropped"),
                                   ("crush", 4, "default subsys"),
                                   ("ms", 1, "messenger"),
                                   ("ms", 20, "ms gathered")):
            log.dout(subsys, level, msg)
        runs.append(([stamp.sub("", l) for l in lines],
                     [stamp.sub("", l) for l in log.dump_recent()],
                     log.dump_recent(2) == log.dump_recent()[-2:],
                     log.emitted, log.gathered, log.levels("ms"),
                     log.should_gather("osd", 20),
                     log.should_gather("osd", 21)))
    assert runs[0] == runs[1]
    assert runs[1][3:5] == (3, 5)


# ---------------------------------------------------------------- admin --

def test_admin_replies_equal_reference(tmp_path):
    from ceph_tpu.common.admin import AdminServer as RefAdmin
    from ceph_tpu_torch.common.admin import AdminServer, admin_request
    from ceph_tpu_torch.common.options import config
    ref, port = RefAdmin(), AdminServer()
    for req in ({"prefix": "config get", "key": "fastmap_enabled"},
                {"prefix": "config get", "key": "mapper_max_lanes_per_call"},
                {"prefix": "bogus"},
                {"prefix": "config get"}):
        assert port.handle(req) == ref.handle(req)
    assert port.handle({"prefix": "help"})["result"] == \
        ref.handle({"prefix": "help"})["result"]
    r = port.handle({"prefix": "config set", "key": "fastmap_extra_tries",
                     "value": 10})
    try:
        assert r["result"]["success"]
        assert config().get("fastmap_extra_tries") == 10
    finally:
        config().clear("fastmap_extra_tries")
    path = str(tmp_path / "admin.sock")
    port.serve(path)
    try:
        got = admin_request(path, {"prefix": "config get",
                                   "key": "fastmap_enabled"})
        assert got == json.loads(json.dumps(
            ref.handle({"prefix": "config get", "key": "fastmap_enabled"})))
        assert "result" in admin_request(path, {"prefix": "perf dump"})
    finally:
        port.close()


# -------------------------------------------------------------- striper --

LAYOUTS = [(4096, 1, 16384), (4096, 3, 8192), (1 << 16, 4, 1 << 18),
           (512, 7, 512)]


@pytest.mark.parametrize("su,sc,osz", LAYOUTS)
def test_striping_extents_equal_reference(su, sc, osz):
    rng = np.random.default_rng(su + sc)
    ref_l = ref_striper.FileLayout(su, sc, osz)
    port_l = port_striper.FileLayout(su, sc, osz)
    assert port_l.stripes_per_object == ref_l.stripes_per_object
    for _ in range(12):
        off = int(rng.integers(0, 4 * osz * sc))
        length = int(rng.integers(1, 3 * osz * sc))
        assert port_striper.file_to_extents(port_l, off, length) == \
            ref_striper.file_to_extents(ref_l, off, length)
        data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
        frags = port_striper.extents_to_objects(port_l, data, off)
        assert frags == ref_striper.extents_to_objects(ref_l, data, off)
        objs = {o: b"".join(v for _, v in sorted(f.items()))
                for o, f in frags.items() if min(f) == 0}
        assert port_striper.read_from_objects(port_l, objs, off, length) \
            == ref_striper.read_from_objects(ref_l, objs, off, length)


def test_striping_layout_errors_equal_reference():
    for args in ((0, 1, 4096), (4096, 1, 6144)):
        with pytest.raises(ValueError):
            ref_striper.FileLayout(*args)
        with pytest.raises(ValueError):
            port_striper.FileLayout(*args)


# ------------------------------------------- scrub and admin commands ---

class _ScalarMapper:
    """The reference OSDMap's batched mapper replaced by the reference's
    scalar mapper (its bit-exact oracle), so the reference sim pays no
    jit compile here."""

    def __init__(self, cmap):
        self.cmap = cmap

    def map_batch(self, ruleno, xs, result_max, weights, mesh=None):
        from ceph_tpu.placement import scalar_mapper
        from ceph_tpu.placement.crush_map import ITEM_NONE
        out = np.full((len(xs), result_max), ITEM_NONE, dtype=np.int32)
        for i, x in enumerate(xs):
            row = scalar_mapper.do_rule(self.cmap, ruleno, int(x),
                                        result_max, list(weights))
            out[i, :len(row)] = row
        return out


def _sims():
    """The same small cluster in both packages: a straw-hosted map
    (the general mapper's path on the port) with a replicated pool."""
    from ceph_tpu.cluster.osdmap import OSDMap as RefOSDMap
    from ceph_tpu.cluster.osdmap import PGPool as RefPool
    from ceph_tpu.cluster.osdmap import POOL_REPLICATED
    from ceph_tpu.cluster.simulator import ClusterSim as RefSim
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool
    from ceph_tpu_torch.cluster.simulator import ClusterSim
    from tests.test_torch_compiler import legacy_text
    text = legacy_text(alg_hosts=("straw",) * 4, osds_per_host=2)
    sims = []
    for compile_, osdmap, pool, sim_cls in (
            (ref_compiler.compile_crushmap, RefOSDMap, RefPool, RefSim),
            (port_compiler.compile_crushmap, OSDMap, PGPool, ClusterSim)):
        cmap = compile_(text)
        om = osdmap(cmap)
        if sim_cls is RefSim:
            om._mapper, om._mapper_map = _ScalarMapper(cmap), cmap
        om.mark_all_in_up()
        om.add_pool(pool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                         pg_num=16, crush_rule=0))
        sim = sim_cls(om)
        for i in range(6):
            sim.put(1, f"obj{i}", bytes([i]) * (300 + 97 * i))
        sims.append(sim)
    return sims


def test_scrub_and_admin_commands_equal_reference():
    from ceph_tpu.cluster.admin_commands import \
        register_cluster_commands as ref_register
    from ceph_tpu.cluster.scrub_machine import ScrubMachine as RefScrub
    from ceph_tpu.common.admin import AdminServer as RefAdmin
    from ceph_tpu_torch.cluster.admin_commands import \
        register_cluster_commands
    from ceph_tpu_torch.cluster.scrub_machine import (FINISHED,
                                                      ScrubMachine,
                                                      ScrubReservations)
    from ceph_tpu_torch.common.admin import AdminServer
    ref_sim, sim = _sims()
    try:
        pool = sim.osdmap.pools[1]
        pg = sim.object_pg(pool, "obj0")
        # corrupt one replica of obj0 on both sides: the scrub must see it
        for s in (ref_sim, sim):
            up = s.pg_up(s.osdmap.pools[1], pg)
            key = (1, pg, "obj0", 0)
            bad = np.array(s.osds[up[1]].get(key), copy=True)
            bad[0] ^= 0xFF
            s.osds[up[1]].put(key, bad)
        res = ScrubReservations()
        m = ScrubMachine(sim, 1, pg, reservations=res, chunk_objects=1)
        states = [m.tick() for _ in range(3)]
        r = m.run_to_completion()
        assert m.state == FINISHED and states[0] != FINISHED
        want = RefScrub(ref_sim, 1, pg, chunk_objects=1).run_to_completion()
        for f in ("objects_scrubbed", "chunks", "preemptions",
                  "reserve_waits", "inconsistent", "missing"):
            assert getattr(r, f) == getattr(want, f), f
        assert ("obj0", -1) in r.inconsistent
        srv, ref_srv = AdminServer(), RefAdmin()
        register_cluster_commands(srv, sim)
        ref_register(ref_srv, ref_sim)
        for req in ({"prefix": "osd tree"}, {"prefix": "pg dump", "pool": 1},
                    {"prefix": "scrub", "pool": 1}, {"prefix": "status"},
                    {"prefix": "df"}, {"prefix": "snap ls", "pool": 1}):
            got = srv.handle_json(json.dumps(req))
            assert json.loads(got) == json.loads(
                ref_srv.handle_json(json.dumps(req))), req["prefix"]
        scrub = srv.handle({"prefix": "scrub", "pool": 1})["result"]
        assert sum(row["objects"] for row in scrub) == 6
    finally:
        ref_sim.shutdown()
        sim.shutdown()
