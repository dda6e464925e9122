"""The port's upmap balancer and balancer advisor against ceph_tpu's.

``cluster/balancer.py`` (``calc_pg_upmaps``: one ``map_pgs_batch`` sweep
per pool per round through the port's mapper, host logic on the
resulting up sets), ``mgr/balancer_advisor.py`` (``evaluate``: the
dry-run heat x utilization report) and ``mgr/balancer_module.py``.
tests/test_balancer.py's skewed maps are built by the reference and
cross into the port through ``convert.osdmap_state`` /
``osdmap_from_state`` (which carry the upmap tables); both packages then
balance with each round count the reference tests use, and the
``pg_upmap_items``, the result summary and the per-OSD deviations before
and after must be equal.  tests/test_balancer_advisor.py's cases run
``evaluate`` in both packages on the same map and heat rows; the reports
must be equal.  The mon's ``balancer_eval`` over the port's daemons is
held against the reference's ``evaluate`` in
tests/test_torch_process_cluster.py.
"""
import types

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.cluster import balancer as ref_balancer
from ceph_tpu.cluster import osdmap as ref_osdmap
from ceph_tpu.mgr import balancer_advisor as ref_advisor
from ceph_tpu.placement import builder as ref_builder
from ceph_tpu.placement import crush_map as ref_cm
from ceph_tpu_torch import convert
from ceph_tpu_torch.cluster import balancer as port_balancer
from ceph_tpu_torch.mgr import balancer_advisor as port_advisor
from ceph_tpu_torch.mgr import balancer_module as port_module
from ceph_tpu_torch.mgr.module_host import MgrModuleHost

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

ITEM_NONE = ref_cm.ITEM_NONE


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def make_skewed_map(n_hosts=24, osds_per_host=4, pg_num=512, seed=3):
    """tests/test_balancer.py's map, built by the reference."""
    cmap, root = ref_builder.build_flat_cluster(
        n_hosts=n_hosts, osds_per_host=osds_per_host, seed=seed,
        weight_jitter=True)
    cmap.add_rule(ref_cm.Rule(steps=[
        (ref_cm.RULE_TAKE, root, 0),
        (ref_cm.RULE_CHOOSELEAF_FIRSTN, 0, ref_builder.TYPE_HOST),
        (ref_cm.RULE_EMIT, 0, 0)]))
    om = ref_osdmap.OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(ref_osdmap.PGPool(id=1, name="p",
                                  type=ref_osdmap.POOL_REPLICATED, size=3,
                                  pg_num=pg_num, crush_rule=0))
    return om


def to_port(om):
    return convert.osdmap_from_state(convert.osdmap_state(om), device="cpu")


def deviations(bal, om):
    """tests/test_balancer.py's per-OSD deviation from the target."""
    cw = bal.osd_crush_weights(om.crush)
    counts = np.zeros(len(cw))
    for pid in om.pools:
        up, _ = om.map_pgs_batch(pid)
        vals = up[up != ITEM_NONE]
        np.add.at(counts, vals, 1)
    target = cw / cw.sum() * counts.sum()
    return (counts - target).tolist(), counts.tolist()


def _result(res):
    return (res.rounds, res.moves, res.max_deviation_before,
            res.max_deviation_after,
            sorted((k, list(v)) for k, v in res.upmap_items.items()))


def balance(bal, om, calls):
    """Each ``calc_pg_upmaps`` call of ``calls`` in turn; the record of
    what both packages must agree on."""
    out = [deviations(bal, om), om.epoch]
    for kw in calls:
        res = bal.calc_pg_upmaps(om, **kw)
        out += [_result(res), deviations(bal, om), om.epoch,
                sorted((k, list(v)) for k, v in om.pg_upmap_items.items())]
    return out


# tests/test_balancer.py's maps and round counts
CASES = {
    "reduces_deviation": (dict(), [dict(max_deviation=1.0, max_rounds=16,
                                        max_moves_per_round=128)]),
    "failure_domains": (dict(n_hosts=12, osds_per_host=4, pg_num=256),
                        [dict(max_rounds=8, max_moves_per_round=64)]),
    "idempotent": (dict(n_hosts=8, osds_per_host=2, pg_num=128),
                   [dict(max_rounds=12, max_moves_per_round=128),
                    dict(max_rounds=4)]),
    "default_rounds": (dict(), [dict()]),
}


@pytest.fixture(scope="module")
def balanced():
    """{case: (ref record, port record, ref map, port map)}."""
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    out = {}
    try:
        for name, (mk, calls) in CASES.items():
            ref_om = make_skewed_map(**mk)
            port_om = to_port(ref_om)
            out[name] = (balance(ref_balancer, ref_om, calls),
                         balance(port_balancer, port_om, calls),
                         ref_om, port_om)
    finally:
        ceph_tpu_torch.set_default_device(prev)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_calc_pg_upmaps_equals_the_reference(balanced, case):
    ref, port, _ref_om, _port_om = balanced[case]
    assert port[0] == ref[0]                  # deviations before
    assert port == ref


def test_balancer_reduces_deviation(balanced):
    """tests/test_balancer.py's contract on the port's result."""
    port = balanced["reduces_deviation"][1]
    dev0 = np.abs(port[0][0]).max()
    res, dev1 = port[2], np.abs(port[3][0]).max()
    assert res[1] > 0
    assert dev1 < dev0 and dev1 <= max(3.0, 0.4 * dev0)
    assert abs(res[3] - dev1) < 1e-6
    assert port[4] == port[1] + 1             # one epoch bump


def test_upmaps_respect_failure_domains(balanced):
    _ref, _port, _rom, om = balanced["failure_domains"]
    assert om.pg_upmap_items
    anc = port_balancer.osd_ancestors(om.crush, ref_builder.TYPE_HOST)
    up_all, _ = om.map_pgs_batch(1)
    for (pid, pg) in om.pg_upmap_items:
        up, _, _, _ = om.pg_to_up_acting_osds(pid, pg)
        doms = [anc[o] for o in up if o != ITEM_NONE]
        assert len(doms) == len(set(doms)), (pg, doms)
        assert [o for o in up_all[pg] if o != ITEM_NONE] == up


def test_balancer_idempotent_when_balanced(balanced):
    port = balanced["idempotent"][1]
    first, second = port[5], port[9]
    assert len(second) - len(first) <= 8


def test_helpers_and_zero_weight_equal_the_reference():
    om = make_skewed_map(n_hosts=4, osds_per_host=2, pg_num=32)
    pom = to_port(om)
    for bal, m in ((ref_balancer, om), (port_balancer, pom)):
        assert bal.rule_failure_domain(m.crush, 0) == ref_builder.TYPE_HOST
    for fn in ("osd_ancestors", "osd_crush_weights"):
        args = (ref_builder.TYPE_HOST,) if fn == "osd_ancestors" else ()
        want = getattr(ref_balancer, fn)(om.crush, *args)
        got = getattr(port_balancer, fn)(pom.crush, *args)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    anc = port_balancer.osd_ancestors(pom.crush, ref_builder.TYPE_HOST)
    assert anc[0] == anc[1] and anc[0] != anc[2]
    assert np.array_equal(port_balancer.osd_ancestors(pom.crush, 0),
                          np.arange(pom.crush.max_devices))
    om.osd_weight[:] = 0
    pom.osd_weight[:] = 0
    ref = ref_balancer.calc_pg_upmaps(om)
    got = port_balancer.calc_pg_upmaps(pom)
    assert _result(got) == _result(ref) and got.moves == 0


def test_balancer_module_optimizes_the_hosts_map():
    """``BalancerModule.optimize`` runs ``calc_pg_upmaps`` on the map
    its host serves, as the reference's does."""
    ref_om = make_skewed_map(n_hosts=8, osds_per_host=2, pg_num=128)
    pom = to_port(ref_om)
    cs = skewed_cs(ref_om)
    host = MgrModuleHost(types.SimpleNamespace(osdmap=pom))
    port_module.register(host)
    mod = host.enable("balancer")
    assert mod.eval(cs, max_moves=4) == \
        ref_advisor.evaluate(ref_om, cs, max_moves=4)
    res = mod.optimize(max_rounds=4)
    ref = ref_balancer.calc_pg_upmaps(ref_om, max_rounds=4)
    assert mod.mode == "upmap" and mod.last_result is res
    assert _result(res) == _result(ref)
    host.tick()                        # serve_tick: one more optimize
    assert mod.last_result is not res


# ------------------------------------------------------------ advisor ---

class FakeCS:
    """The two ClusterStats surfaces the advisor reads."""

    def __init__(self, heat_rows, df_rows):
        self._heat = heat_rows
        self._df = df_rows

    def pg_heat(self, pool=None, top=None):
        rows = [r for r in self._heat
                if pool is None or r["pool"] == pool]
        return rows[:top] if top else rows

    def osd_df(self):
        return self._df


def make_map(n_hosts=4, osds_per_host=2, pg_num=16, seed=3):
    """tests/test_balancer_advisor.py's map, built by the reference."""
    return make_skewed_map(n_hosts=n_hosts, osds_per_host=osds_per_host,
                           pg_num=pg_num, seed=seed)


def skewed_cs(om, hot_osd=0, pool=1, base=1.0, hot=80.0):
    p = om.pools[pool]
    rows = []
    for pg in range(p.pg_num):
        up, _, _, _ = om.pg_to_up_acting_osds(pool, pg)
        h = hot if hot_osd in up else base
        rows.append({"pgid": f"{pool}.{pg}", "pool": pool, "heat": h,
                     "wr_ops": h, "rd_ops": 0.0,
                     "wr_bytes": 0.0, "rd_bytes": 0.0})
    df = [{"daemon": f"osd.{o}", "utilization": 0.1 + 0.01 * o}
          for o in range(om.max_osd)]
    return FakeCS(rows, df)


def frozen(om):
    return (om.epoch, dict(om.pg_upmap), dict(om.pg_upmap_items))


def advisor_cases(adv, om, cs, other_pool):
    """Every report tests/test_balancer_advisor.py asks for, with the
    map left as it was after each."""
    before = frozen(om)
    out = [adv.evaluate(om, cs, max_moves=8)]
    out += [frozen(om) == before, adv.evaluate(om, cs, max_moves=1),
            adv.evaluate(om, cs, max_moves=0),
            adv.evaluate(om, cs, pool=1),
            adv.evaluate(om, cs, pool=other_pool),
            adv.evaluate(om, FakeCS([], [{"daemon": f"osd.{o}",
                                          "utilization": 0.0}
                                         for o in range(om.max_osd)]))]
    for p in out[0]["proposals"]:
        pid, pg = (int(x) for x in p["pgid"].split("."))
        om.pg_upmap_items[(pid, pg)] = [(p["from"], p["to"])]
    out.append(adv.evaluate(om, cs, max_moves=8))
    return out


@pytest.fixture(scope="module")
def advised():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    try:
        om = make_map()
        om.add_pool(ref_osdmap.PGPool(id=2, name="other",
                                      type=ref_osdmap.POOL_REPLICATED,
                                      size=3, pg_num=8, crush_rule=0))
        pom = to_port(om)
        cs = skewed_cs(om)
        return (advisor_cases(ref_advisor, om, cs, 2),
                advisor_cases(port_advisor, pom, cs, 2), pom)
    finally:
        ceph_tpu_torch.set_default_device(prev)


def test_imbalance_score_equals_the_reference():
    cases = [({0: 10.0, 1: 5.0, 2: 5.0}, {0: 0.5, 1: 0.25, 2: 0.25}),
             ({}, {0: 0.5}), ({0: 0.0, 1: 0.0}, {0: 0.5, 1: 0.5}),
             ({0: 12.0, 1: 8.0}, {0: 0.5, 1: 0.5}),
             ({0: 19.0, 1: 1.0}, {0: 0.5, 1: 0.5}),
             ({0: 3.25, 1: 7.5, 2: 0.125}, {0: 0.2, 1: 0.5, 2: 0.3})]
    got = [port_advisor.imbalance_score(l, s) for l, s in cases]
    assert got == [ref_advisor.imbalance_score(l, s) for l, s in cases]
    assert got[:3] == [0.0, 0.0, 0.0] and 0 < got[3] < got[4]


def test_advisor_reports_equal_the_reference(advised):
    ref, port, _pom = advised
    assert port == ref


def test_advisor_holds_the_reference_contract(advised):
    _ref, out, om = advised
    rep = out[0]
    assert out[1] is True
    assert rep["score_before"] > 0 and rep["proposals"]
    assert rep["score_after"] < rep["score_before"]
    assert rep["moves"] == len(rep["proposals"])
    dom = port_balancer.osd_ancestors(
        om.crush, port_balancer.rule_failure_domain(om.crush, 0))
    for p in rep["proposals"]:
        assert p["from"] != p["to"] and p["heat"] > 0
        pid, pg = (int(x) for x in p["pgid"].split("."))
        om_up = [o for o in _up_without_upmap(om, pid, pg)]
        assert p["from"] in om_up and p["to"] not in om_up
        moved = [p["to"] if o == p["from"] else o for o in om_up]
        doms = [int(dom[o]) for o in moved]
        assert len(doms) == len(set(doms))
    assert len(out[2]["proposals"]) <= 1
    assert out[3]["proposals"] == [] and \
        out[3]["score_after"] == out[3]["score_before"]
    assert out[4]["pgs_considered"] == 16 and out[5]["pgs_considered"] == 0
    assert out[6]["proposals"] == [] and out[6]["score_before"] == 0.0
    assert not {p["pgid"] for p in rep["proposals"]} & \
        {p["pgid"] for p in out[7]["proposals"]}


def _up_without_upmap(om, pid, pg):
    items = om.pg_upmap_items.pop((pid, pg), None)
    try:
        return om.pg_to_up_acting_osds(pid, pg)[0]
    finally:
        if items is not None:
            om.pg_upmap_items[(pid, pg)] = items
