"""Shared by the gateway-tier and metadata-server twins
(``tests/test_torch_{rgw,rgw_zone,s3_serving,dr_drill,multimds}.py``).

A scenario is a function of a package namespace (``REF`` or ``PORT``)
that drives one reference test's operations and returns a record: the
values the reference test asserts on, with exceptions recorded by name.
``twin`` runs a scenario once in each package on the same seeded inputs
and returns both records, each with the full RADOS state of every
``ClusterSim`` the scenario built through ``make_sim`` (every object's
bytes and its client-side record).  Where the code draws from
``secrets`` or reads the wall clock, both runs get the same seeded
stand-in: ``secrets.token_hex`` / ``token_urlsafe`` and the ``time``
that ``rgw/gateway.py`` and ``fs/mds.py`` read are replaced for the run.
The reference runs as it is, unless a scenario whose MDS ranks both
allocate inode numbers asks for the port's repair of that allocation
(ROADMAP C10) to be patched into it.
Nothing in either package is edited.
"""
import dataclasses
import random
import secrets
import time
import types

import ceph_tpu_torch


def _pkg(name):
    if name == "ref":
        from ceph_tpu.client import rados, remote, remote_ioctx
        from ceph_tpu.cluster import (dr_drill, monitor, osdmap, simulator,
                                      striper)
        from ceph_tpu.common import faults
        from ceph_tpu.fs import journaler, mds, mdsmap, multimds
        from ceph_tpu.msg import scheduler
        from ceph_tpu.placement import builder, crush_map
        from ceph_tpu.rgw import (auth_s3, gateway, http_frontend, serving,
                                  swift_frontend, sync, users, zone)
        from ceph_tpu.tools import vstart
    else:
        from ceph_tpu_torch.client import rados, remote, remote_ioctx
        from ceph_tpu_torch.cluster import (dr_drill, monitor, osdmap,
                                            simulator, striper)
        from ceph_tpu_torch.common import faults
        from ceph_tpu_torch.fs import journaler, mds, mdsmap, multimds
        from ceph_tpu_torch.msg import scheduler
        from ceph_tpu_torch.placement import builder, crush_map
        from ceph_tpu_torch.rgw import (auth_s3, gateway, http_frontend,
                                        serving, swift_frontend, sync, users,
                                        zone)
        from ceph_tpu_torch.tools import vstart
    return types.SimpleNamespace(
        name=name, rados=rados, remote=remote, remote_ioctx=remote_ioctx,
        drill=dr_drill, mon=monitor, om=osdmap, sim=simulator,
        striper=striper, faults=faults,
        journaler=journaler, mds=mds, mdsmap=mdsmap, multimds=multimds,
        scheduler=scheduler, builder=builder, cm=crush_map, auth=auth_s3,
        gw=gateway, http=http_frontend, serving=serving,
        swift=swift_frontend, sync=sync, users=users, zone=zone,
        vstart=vstart)


REF, PORT = _pkg("ref"), _pkg("port")

# the sims a scenario built, per package run (``make_sim`` appends)
_built = {"ref": [], "port": []}


def make_sim(pkg, k=2, m=1):
    """tests/test_snaps.py's ``make_sim`` in ``pkg``: 4 hosts x 2 OSDs
    (seed 3, jittered weights), a 3-replica pool "rep" and an EC pool
    "ec" (k, m; the ``jax`` plugin, bitsliced), 16 PGs each."""
    cm, om_mod = pkg.cm, pkg.om
    cmap, root = pkg.builder.build_flat_cluster(
        n_hosts=4, osds_per_host=2, seed=3, weight_jitter=True)
    for op in (cm.RULE_CHOOSELEAF_FIRSTN, cm.RULE_CHOOSELEAF_INDEP):
        cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                     (op, 0, pkg.builder.TYPE_HOST),
                                     (cm.RULE_EMIT, 0, 0)]))
    om = om_mod.OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(om_mod.PGPool(id=1, name="rep", type=om_mod.POOL_REPLICATED,
                              size=3, pg_num=16, crush_rule=0))
    om.add_pool(om_mod.PGPool(id=2, name="ec", type=om_mod.POOL_ERASURE,
                              size=k + m, pg_num=16, crush_rule=1,
                              erasure_code_profile="p"))
    sim = pkg.sim.ClusterSim(om)
    sim.create_ec_profile("p", {"plugin": "jax", "k": str(k), "m": str(m)})
    _built[pkg.name].append(sim)
    return sim


def rados(pkg, sim):
    return pkg.rados.Rados(sim, pkg.mon.Monitor(sim.osdmap)).connect()


def open_ioctx(pkg, sim, pool="rep"):
    return rados(pkg, sim).open_ioctx(pool)


def gateway(pkg, pool="rep"):
    return pkg.gw.RGWGateway(open_ioctx(pkg, make_sim(pkg), pool))


def outcome(fn):
    """("ok", value) or ("raised", exception name, its text)."""
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 — compared by name
        return ("raised", type(e).__name__, str(e))


def sim_state(sim):
    """Every object of every pool: its bytes and its client record."""
    out = {}
    for (pid, name), info in sorted(sim.objects.items()):
        out[f"{pid}/{name}"] = (sim.get(pid, name),
                                dataclasses.asdict(info))
    return out


class Seeded:
    """The seeded stand-in for ``secrets`` and the wall clock: the same
    seed gives the same tokens and the same times in both runs."""

    def __init__(self, seed=0, t0=1_760_000_000.0, step=0.001):
        self.rng = random.Random(seed)
        self.now = t0
        self.step = step

    def token_hex(self, nbytes=None):
        n = 32 if nbytes is None else nbytes
        return self.rng.getrandbits(8 * n).to_bytes(n, "big").hex()

    def token_urlsafe(self, nbytes=None):
        return self.token_hex(nbytes)

    def time(self):
        self.now += self.step
        return self.now

    def clock_module(self):
        """A stand-in ``time`` module: the seeded ``time()``, the rest
        of the real module."""
        ns = types.SimpleNamespace(**{k: getattr(time, k)
                                      for k in dir(time)
                                      if not k.startswith("_")})
        ns.time = self.time
        return ns


def seeded(monkeypatch, pkg, seed=0, t0=None):
    """Patch ``pkg``'s token and clock sources with a fresh ``Seeded``
    (its clock from ``t0``, by default a fixed time)."""
    s = Seeded(seed) if t0 is None else Seeded(seed, t0=t0)
    monkeypatch.setattr(secrets, "token_hex", s.token_hex)
    monkeypatch.setattr(secrets, "token_urlsafe", s.token_urlsafe)
    clock = s.clock_module()
    monkeypatch.setattr(pkg.gw, "time", clock)
    monkeypatch.setattr(pkg.mds, "time", clock)
    return s


def repair_reference_inode_allocation(monkeypatch):
    """ROADMAP C10 repaired in the oracle at the point the port repairs
    it.  The port allocates through ``MDS._alloc_ino``, which re-reads
    the shared InoTable on a ranked MDS
    (``ceph_tpu_torch/fs/mds.py:MDS._alloc_ino``); the reference's
    ``mkdir`` and ``create``, its only two allocations, read the rank's
    own count.  Each of the two gets the same re-read just before it
    runs; nothing else of the reference's ``MDS`` changes."""
    def rereads_the_table(op):
        def allocating(self, path):
            if self.rank is not None:
                try:
                    self._next_ino = max(
                        self._next_ino,
                        int(self.meta.read("mds_inotable").decode()))
                except KeyError:
                    pass
            return op(self, path)
        return allocating

    for name in ("mkdir", "create"):
        monkeypatch.setattr(REF.mds.MDS, name,
                            rereads_the_table(getattr(REF.mds.MDS, name)))


def run_in(pkg, scenario, monkeypatch, seed=0, repaired=False):
    """``scenario(pkg)`` on the CPU with seeded tokens and clock (the
    reference with C10 repaired if ``repaired``); -> (its record, the
    state of every sim it built)."""
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    _built[pkg.name] = []
    with monkeypatch.context() as mp:
        seeded(mp, pkg, seed)
        if pkg is REF and repaired:
            repair_reference_inode_allocation(mp)
        try:
            rec = scenario(pkg)
            state = [sim_state(s) for s in _built[pkg.name]]
        finally:
            for s in _built[pkg.name]:
                s.shutdown()
            _built[pkg.name] = []
            pkg.faults.reset()
            ceph_tpu_torch.set_default_device(prev)
    return rec, state


def twin(scenario, monkeypatch, seed=0, repaired=False):
    """The scenario in both packages: (reference's, port's) record and
    sim states (the reference with C10 repaired if ``repaired``)."""
    return (run_in(REF, scenario, monkeypatch, seed, repaired),
            run_in(PORT, scenario, monkeypatch, seed))


def assert_twin(scenario, monkeypatch, seed=0, repaired=False):
    """The port's record and sim states equal the reference's (C10
    repaired in the reference if ``repaired``); -> the port's record."""
    ref, port = twin(scenario, monkeypatch, seed, repaired)
    assert port[0] == ref[0]
    assert len(port[1]) == len(ref[1])
    for got, want in zip(port[1], ref[1]):
        assert sorted(got) == sorted(want)
        for oid in want:
            assert got[oid] == want[oid], oid
    return port[0]
