"""The port's control plane against ceph_tpu's.

``cluster/monitor.py``, ``cluster/mon_quorum.py``, ``cluster/objecter.py``,
``client/rados.py`` (with ``mgr/cluster_stats.py`` under the monitor)
and the single-process part of ``parallel/multihost.py``.  Each scenario
runs the same steps through both packages, the port's ClusterSim on the
CPU, and records every answer: map epochs and incrementals, consensus
versions, config values, health codes, failure-report verdicts, the
objecter's placements, epochs and retries, the librados-shaped IoCtx
reads, and an in-process mon quorum's elections, commits, applied
decrees, leases and logs.  The records must be equal.  Mirrors
tests/test_control_plane.py (but its heartbeat cases: ``heartbeat.py``
is not ported), tests/test_mon_quorum.py and the Rados case of
tests/test_aux_components.py.
"""
import types
from typing import Dict

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.client import rados as ref_rados
from ceph_tpu.cluster import kv as ref_kv
from ceph_tpu.cluster import mon_quorum as ref_quorum
from ceph_tpu.cluster import monitor as ref_monitor
from ceph_tpu.cluster import objecter as ref_objecter
from ceph_tpu.cluster import osdmap as ref_osdmap
from ceph_tpu.cluster import simulator as ref_simulator
from ceph_tpu.common import options as ref_options
from ceph_tpu.parallel import multihost as ref_multihost
from ceph_tpu.placement import builder as ref_builder
from ceph_tpu.placement import crush_map as ref_crush_map
from ceph_tpu_torch.client import rados as port_rados
from ceph_tpu_torch.cluster import kv as port_kv
from ceph_tpu_torch.cluster import mon_quorum as port_quorum
from ceph_tpu_torch.cluster import monitor as port_monitor
from ceph_tpu_torch.cluster import objecter as port_objecter
from ceph_tpu_torch.cluster import osdmap as port_osdmap
from ceph_tpu_torch.cluster import simulator as port_simulator
from ceph_tpu_torch.common import options as port_options
from ceph_tpu_torch.parallel import multihost as port_multihost
from ceph_tpu_torch.placement import builder as port_builder
from ceph_tpu_torch.placement import crush_map as port_crush_map

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="ref", mon=ref_monitor, q=ref_quorum, obj=ref_objecter,
    om=ref_osdmap, sim=ref_simulator, opts=ref_options, rados=ref_rados,
    kv=ref_kv, builder=ref_builder, cm=ref_crush_map)
PORT = types.SimpleNamespace(
    name="port", mon=port_monitor, q=port_quorum, obj=port_objecter,
    om=port_osdmap, sim=port_simulator, opts=port_options,
    rados=port_rados, kv=port_kv, builder=port_builder, cm=port_crush_map)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def _crush(pkg):
    """tests/test_simulator.py's map: 8 hosts x 3 OSDs, a replicated
    and an indep rule."""
    cm = pkg.cm
    cmap, root = pkg.builder.build_flat_cluster(n_hosts=8, osds_per_host=3,
                                                seed=0)
    cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                 (cm.RULE_CHOOSELEAF_FIRSTN, 0,
                                  pkg.builder.TYPE_HOST),
                                 (cm.RULE_EMIT, 0, 0)]))
    cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                 (cm.RULE_CHOOSELEAF_INDEP, 0,
                                  pkg.builder.TYPE_HOST),
                                 (cm.RULE_EMIT, 0, 0)]))
    return cmap


@pytest.fixture(scope="module")
def ref_mapper():
    """One reference XlaMapper for the map, shared by every reference
    sim of this file (weights are runtime operands, so sharing changes
    no result; its jit compile is the bulk of the reference's time)."""
    from ceph_tpu.placement.xla_mapper import XlaMapper
    cmap = _crush(REF)
    return cmap, XlaMapper(cmap)


def make_sim(pkg, ref_mapper):
    """tests/test_simulator.py's make_sim in ``pkg``."""
    om_mod = pkg.om
    if pkg is REF:
        cmap, mapper = ref_mapper
        om = om_mod.OSDMap(cmap)
        om._mapper, om._mapper_map = mapper, cmap
    else:
        om = om_mod.OSDMap(_crush(pkg), device="cpu")
    om.mark_all_in_up()
    om.add_pool(om_mod.PGPool(id=1, name="rep", type=om_mod.POOL_REPLICATED,
                              size=3, pg_num=32, crush_rule=0))
    om.add_pool(om_mod.PGPool(id=2, name="ec", type=om_mod.POOL_ERASURE,
                              size=6, pg_num=32, crush_rule=1,
                              erasure_code_profile="default"))
    sim = pkg.sim.ClusterSim(om)
    sim.create_ec_profile("default", {"plugin": "jax", "k": "4", "m": "2"})
    return sim


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 — compared by name
        return ("raised", type(e).__name__)


def _inc(i):
    return (i.epoch, dict(i.new_up), dict(i.new_weight))


# ------------------------------------------------------------- monitor ---

def mon_incrementals(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap)
    e0 = sim.osdmap.epoch
    inc = mon.next_incremental()
    inc.new_up[5] = False
    out = [mon.commit_incremental(inc)]
    inc2 = mon.next_incremental()
    inc2.new_weight[4] = 0
    out += [mon.commit_incremental(inc2), sim.osdmap.epoch - e0,
            [_inc(i) for i in mon.get_incrementals(e0)],
            mon.get_incrementals(e0 + 2), mon.paxos.version,
            len(mon.paxos.committed)]
    return out


def mon_config_db(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap)
    cfg = pkg.opts.config()
    try:
        out = [mon.config_set("fastmap_extra_tries", 12),
               mon.config_get("fastmap_extra_tries"),
               cfg.get("fastmap_extra_tries")]
    finally:
        cfg.clear("fastmap_extra_tries", pkg.opts.LEVEL_FILE)
    out += [mon.config_set("osd_special_knob", "on"),
            mon.config_get("osd_special_knob"),
            cfg.get("fastmap_extra_tries")]
    return out


def mon_health(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap)
    out = [mon.health_status(sim)]
    sim.kill_osd(0)
    sim.out_osd(1)
    out.append(sorted((c.code, c.severity, c.summary)
                      for c in mon.health(sim)))
    out.append(mon.health_status(sim))
    return out


def mon_failure_reports(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap, failure_reports_needed=2)
    sim.fail_osd(3)
    out = [sim.osdmap.is_up(3), mon.report_failure(3, reporter=1),
           mon.report_failure(3, reporter=2), sim.osdmap.is_up(3)]
    sim.fail_osd(4)
    out += [mon.report_failure(4, reporter=7),
            mon.report_failure(4, reporter=7), sim.osdmap.is_up(4)]
    sim.fail_osd(5)
    mon.report_failure(5, reporter=1)
    sim.restart_osd(5)
    out.append(mon.osd_boot(5))
    sim.fail_osd(5)
    out += [mon.report_failure(5, reporter=2), sim.osdmap.is_up(5),
            mon.report_failure(5, reporter=3), sim.osdmap.is_up(5),
            [_inc(i) for i in mon.incrementals]]
    return out


# ------------------------------------------------------------ objecter ---

def objecter_io(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap, failure_reports_needed=1)
    client = pkg.obj.Objecter(sim, mon)
    data = bytes(range(256)) * 40
    out = [client.put(2, "obj", data), client.get(2, "obj") == data]
    hot = np.random.default_rng(3).integers(0, 256, 20000) \
        .astype(np.uint8).tobytes()
    placed = client.put(2, "hot", hot)
    e0 = client.osdmap.epoch
    victim = placed[0]
    sim.fail_osd(victim)
    mon.report_failure(victim, reporter=placed[1])
    out += [placed, client.osdmap.epoch == e0, client.get(2, "hot") == hot,
            client.osdmap.epoch - e0]
    sim.restart_osd(victim)
    out.append(mon.osd_boot(victim))
    sim.recover_delta(2)
    out += [client.get(2, "hot") == hot,
            client.osdmap.epoch == sim.osdmap.epoch,
            client.put(1, "r", b"lifecycle" * 300),
            client.get(1, "r") == b"lifecycle" * 300]
    return out


def objecter_gives_up(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap)
    client = pkg.obj.Objecter(sim, mon, max_retries=3)
    out = [client.put(2, "x", b"payload")]
    pool = sim.osdmap.pools[2]
    pg = sim.object_pg(pool, "x")
    real_up = sim.pg_up(pool, pg)
    sim.fail_osd(real_up[0])
    out.append(_outcome(lambda: client.put(2, "x", b"payload2")))
    return out


def rados_ioctx(pkg, sim):
    mon = pkg.mon.Monitor(sim.osdmap)
    cluster = pkg.rados.Rados(sim, mon).connect()
    out = [sorted(cluster.pool_list())]
    io = cluster.open_ioctx("ec")
    data = bytes(range(256)) * 64
    io.write_full("obj1", data)
    out += [io.read("obj1") == data, io.read("obj1", length=16, offset=256)]
    io.write("obj1", b"patch", offset=100)
    st = io.stat("obj1")
    out += [io.read("obj1", length=5, offset=100), st.size, st.n_stripes,
            io.list_objects()]
    io.aio_write_full("obj2", b"async-bytes").result(timeout=10)
    out.append(io.aio_read("obj2").result(timeout=10))
    io.remove("obj2")
    out += [_outcome(lambda: io.read("obj2")),
            _outcome(lambda: io.stat("missing")),
            cluster.cluster_stat(), cluster.health()]
    rep = cluster.open_ioctx("rep")
    rep.write_full("r", b"replicated" * 50)
    out += [rep.read("r"), rep.list_objects(),
            _outcome(lambda: cluster.open_ioctx("nope"))]
    cluster.shutdown()
    return out


def rados_striper(pkg, sim):
    """tests/test_striper_swift.py's striper cases over the sim IoCtx."""
    from ceph_tpu.client import striper as ref_striper
    from ceph_tpu.cluster import striper as ref_layout
    from ceph_tpu_torch.client import striper as port_striper
    from ceph_tpu_torch.cluster import striper as port_layout
    st, lay = (ref_striper, ref_layout) if pkg is REF else \
        (port_striper, port_layout)
    io = pkg.rados.Rados(sim, pkg.mon.Monitor(sim.osdmap)).connect() \
        .open_ioctx("rep")
    data = np.random.default_rng(5).integers(0, 256, 2000, dtype=np.uint8) \
        .tobytes()
    s = st.RadosStriper(io, lay.FileLayout(stripe_unit=64, stripe_count=3,
                                           object_size=256))
    s.write("big", data)
    out = [s.read("big") == data, s.read("big", 100, 57), s.stat("big"),
           sorted(io.list_objects())]
    s2 = st.RadosStriper(io, lay.FileLayout(stripe_unit=4096,
                                            stripe_count=1,
                                            object_size=4096))
    out += [s2.read("big") == data, s2.stat("big")]
    s.write("sp", b"tail", offset=1000)
    s.write("sp", b"head")
    out += [s.stat("sp"), s.read("sp")]
    s.truncate("big", 500)
    out += [s.stat("big"), s.read("big") == data[:500]]
    s.remove("big")
    out += [s.exists("big"), sorted(io.list_objects()),
            _outcome(lambda: s.read("big"))]
    return out


@pytest.mark.parametrize("scenario", [
    mon_incrementals, mon_config_db, mon_health, mon_failure_reports,
    objecter_io, objecter_gives_up, rados_ioctx, rados_striper],
    ids=lambda f: f.__name__)
def test_control_plane_equals_reference(scenario, ref_mapper):
    got = {}
    for pkg in (REF, PORT):
        sim = make_sim(pkg, ref_mapper)
        try:
            got[pkg.name] = scenario(pkg, sim)
        finally:
            sim.shutdown()
    assert got["port"] == got["ref"]


def test_control_plane_holds_the_reference_contract(ref_mapper):
    """The port's answers are the right ones, not only the same ones."""
    sim = make_sim(PORT, ref_mapper)
    try:
        out = mon_failure_reports(PORT, sim)
        assert out[:7] == [True, False, True, False, False, False, True]
        assert out[7:12] == [True, False, True, True, False]
    finally:
        sim.shutdown()
    sim = make_sim(PORT, ref_mapper)
    try:
        out = objecter_gives_up(PORT, sim)
        assert out[1] == ("raised", "TooManyRetries")
    finally:
        sim.shutdown()
    sim = make_sim(PORT, ref_mapper)
    try:
        out = mon_health(PORT, sim)
        codes = {c[0] for c in out[1]}
        assert out[0] == "HEALTH_OK" and out[2] == "HEALTH_WARN"
        assert {"OSD_DOWN", "OSD_OUT"} <= codes
    finally:
        sim.shutdown()


# ----------------------------------------------------------- QuorumModel --

def paxos_model(pkg):
    Q = pkg.mon.QuorumModel
    out = []
    p = Q(n_ranks=3)
    out += [p.propose("a"), p.propose("b"), p.committed, p.version]
    p = Q(n_ranks=3)
    p.reachable[1] = False
    out.append(p.propose("ok"))
    p.reachable[2] = False
    out += [p.propose("nope"), p.committed]
    p = Q(n_ranks=3)
    p.propose("v1")
    old_pn = p.accepted_pn[0]
    p.elect(leader=1)
    out += [p.propose("v2"), p.accepted_pn[0] > old_pn, p.committed,
            list(p.accepted_pn)]
    out.append(Q(n_ranks=1).propose("solo"))
    return out


# --------------------------------------------------- in-process quorum --

class SplitNet:
    """Directional in-process wire with a severable link set, and a
    per-rank down set (tests/test_mon_quorum.py's Net and SplitNet)."""

    def __init__(self):
        self.nodes: Dict[int, object] = {}
        self.cut = set()
        self.down = set()

    def send_from(self, src):
        def send(dst, msg):
            if dst in self.down or (src, dst) in self.cut or \
                    dst not in self.nodes:
                raise IOError(f"mon.{src} -> mon.{dst} severed")
            return self.nodes[dst].handle(msg)
        return send

    def split(self, minority):
        for a in range(len(self.nodes)):
            for b in range(len(self.nodes)):
                if (a in minority) != (b in minority):
                    self.cut.add((a, b))


def make_quorum(pkg, n=3, lease=None):
    net = SplitNet()
    clock = {"t": 0.0}
    applied = {r: [] for r in range(n)}
    kw = {} if lease is None else {"lease_duration": lease,
                                   "now_fn": lambda: clock["t"]}
    for r in range(n):
        def mk_apply(rr):
            return lambda v, blob: applied[rr].append(
                (v, pkg.q.decode_decree(blob)))
        net.nodes[r] = pkg.q.QuorumNode(r, n, pkg.kv.MemDB(), mk_apply(r),
                                        net.send_from(r), **kw)
    return net, applied, clock


def _log_of(node):
    return [(v, node.db.get("quorum", node._log_key(v)))
            for v in range(1, node.committed + 1)]


def _state(net, applied):
    return [(nd.leader, nd.election_epoch, nd.committed, _log_of(nd),
             applied[r]) for r, nd in sorted(net.nodes.items())]


def quorum_elect_commit(pkg):
    enc = pkg.q.encode_decree
    net, applied, _ = make_quorum(pkg)
    n = net.nodes
    out = [n[0].start_election(), n[0].propose(enc("x", n=1)),
           n[0].propose(enc("x", n=2)), _outcome(
               lambda: n[1].propose(enc("x", n=3)))]
    net.down |= {1, 2}
    out += [n[0].propose(enc("x", n=4)), _state(net, applied)]
    net2, _, _ = make_quorum(pkg)
    n2 = net2.nodes[2]
    out += [n2.handle({"q": "vote", "epoch": 5, "candidate": 0}),
            n2.handle({"q": "vote", "epoch": 5, "candidate": 1})]
    return out


def quorum_deposed_and_acked(pkg):
    enc, dec = pkg.q.encode_decree, pkg.q.decode_decree
    net, applied, _ = make_quorum(pkg)
    n = net.nodes
    out = [n[0].start_election()]
    net.down.add(0)
    out.append(n[1].start_election())
    net.down.remove(0)
    out += [n[0].propose(enc("stale", n=9)), _state(net, applied)]
    net, applied, _ = make_quorum(pkg)
    n = net.nodes
    out.append(n[0].start_election())
    value = enc("critical", n=42)
    e = n[0].election_epoch
    n[0]._store_entry(1, value, e)
    out.append(n[1].handle({"q": "begin", "epoch": e, "version": 1,
                            "value": value}))
    net.down.add(0)
    out += [n[2].start_election(), dec(n[2]._get_entry(1)),
            _state(net, applied)]
    return out


def quorum_stale_tail(pkg):
    enc = pkg.q.encode_decree
    net, applied, _ = make_quorum(pkg)
    n = net.nodes
    out = [n[0].start_election()]
    n[0]._store_entry(1, enc("stale", n=1), n[0].election_epoch)
    net.down.add(0)
    out.append(n[1].start_election())
    e2 = n[1].election_epoch
    good = enc("acked", n=2)
    n[1]._store_entry(1, good, e2)
    out.append(n[2].handle({"q": "begin", "epoch": e2, "version": 1,
                            "value": good}))
    net.down.add(1)
    net.down.remove(0)
    out += [[n[0].start_election() for _ in range(3)], _state(net, applied)]
    return out


def quorum_catch_up_and_replay(pkg):
    enc, dec = pkg.q.encode_decree, pkg.q.decode_decree
    net, applied, _ = make_quorum(pkg)
    n = net.nodes
    out = [n[0].start_election()]
    net.down.add(2)
    out += [n[0].propose(enc("x", n=i)) for i in range(3)]
    net.down.remove(2)
    out += [n[0].start_election(), _state(net, applied)]
    seen = []
    n1 = pkg.q.QuorumNode(1, 3, n[1].db,
                          lambda v, b: seen.append(dec(b)["n"]),
                          net.send_from(1))
    out += [n1.committed, n1.replay(0), seen]
    net, applied, _ = make_quorum(pkg)
    n = net.nodes
    out += [n[0].start_election(), n[0].propose(enc("x", n=0))]
    net.down.add(2)
    out.append(n[0].propose(enc("x", n=1)))
    net.down.remove(2)
    out += [n[0].propose(enc("x", n=2)), _state(net, applied)]
    return out


def quorum_leases_and_netsplit(pkg):
    enc = pkg.q.encode_decree
    net, applied, clock = make_quorum(pkg, lease=1.0)
    n = net.nodes
    out = [n[0].start_election(), [n[r].readable() for r in range(3)],
           n[0].extend_lease()]
    clock["t"] += 0.5
    out.append([n[r].readable() for r in range(3)])
    clock["t"] += 1.0
    out += [[n[r].readable() for r in range(3)], n[0].extend_lease(),
            n[0].propose(enc("e", n=1))]
    net.split({0})
    out += [n[0].extend_lease(),
            n[0].propose(enc("minority", n=2))]
    clock["t"] += 1.5
    out += [n[0].readable(), n[1].start_election(), n[1].extend_lease(),
            n[1].readable(), n[2].readable()]
    out += [n[1].propose(enc("major", n=i)) for i in (2, 3)]
    net.cut.clear()
    out += [n[1].propose(enc("major", n=4)), _state(net, applied)]
    clock["t"] += 5.0
    out += [n[0].readable(), n[1].extend_lease(), n[0].readable()]
    return out


@pytest.mark.parametrize("scenario", [
    paxos_model, quorum_elect_commit, quorum_deposed_and_acked,
    quorum_stale_tail, quorum_catch_up_and_replay,
    quorum_leases_and_netsplit], ids=lambda f: f.__name__)
def test_quorum_equals_reference(scenario):
    assert scenario(PORT) == scenario(REF)


def test_quorum_holds_the_reference_contract():
    """The healed minority's log is the majority's, with no fork."""
    out = quorum_leases_and_netsplit(PORT)
    logs = [st[3] for st in out[-4]]
    assert logs[0] == logs[1] == logs[2]
    assert [port_quorum.decode_decree(b)["n"] for _, b in logs[0]] == \
        [1, 2, 3, 4]
    out = quorum_elect_commit(PORT)
    assert out[3] == ("raised", "NotLeader")
    assert out[-2]["granted"] and not out[-1]["granted"]


# ------------------------------------------------------------ multihost ---

def test_multihost_single_process_answers_equal_the_reference():
    """Single-process, the port answers as the reference does with no
    fleet configured: rank 0, count 1, inactive, the host0 label and
    the identity fan-out order."""
    for fn in (lambda m: m.process_index(), lambda m: m.process_count(),
               lambda m: m.is_active(), lambda m: m.host_label(),
               lambda m: m.host_label(3),
               lambda m: m.stripe_order([5, -1, 2, 9, 0]),
               lambda m: m.stripe_order([])):
        assert fn(port_multihost) == fn(ref_multihost)


def test_multihost_fleet_functions_raise_until_the_plane_is_ported(
        monkeypatch):
    """The fleet half waits for the multi-GPU plane: joining, the
    fleet mesh and a chip's host raise NotImplementedError (the
    reference's ensure_initialized is a no-op returning False with no
    coordinator), as does an active fleet's fan-out order."""
    assert ref_multihost.ensure_initialized() is False
    for fn in (port_multihost.ensure_initialized,
               port_multihost.global_mesh_2d,
               lambda: port_multihost.host_of_chip(None, 0)):
        with pytest.raises(NotImplementedError, match="item 7"):
            fn()
    monkeypatch.setattr(port_multihost, "_active", True)
    with pytest.raises(NotImplementedError, match="item 7"):
        port_multihost.stripe_order([0, 1, 2])
    with pytest.raises(NotImplementedError):
        port_multihost.process_index()
