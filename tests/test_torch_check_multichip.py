"""The port's check_multichip against ceph_tpu's.

``ceph_tpu_torch/tools/check_multichip.py`` is the twin of
``scripts/check_multichip.py`` (run by tests/test_data_plane.py
::test_check_multichip_smoke): the sharded cluster step over 8 cells of
one device held to the unsharded one.  Here both run with ``--quick``
(the ``cluster_sharded`` section at this size is held to the reference
by tests/test_torch_data_plane.py
::test_cluster_sharded_section_equals_the_reference), the port's on 8
cells of the CPU, the reference's on the suite's 8 forced host devices,
and their deterministic facts must be equal: the recovery stats of every
sim and the per-cell put stripes of the sharded step.

Both runs count into their package's ``perf("dataplane")``, which an
earlier test file in the same process may have filled (a 2 x 4 plane
leaves its ``r<i>c<j>.*`` keys at 0 after ``reset()``): each package's
group is emptied for the comparison (``torch_check.fresh_perf_group``),
and a test here leaves that state first and compares all the same.
"""
import sys

import torch

from ceph_tpu.cluster.simulator import ClusterSim as RefClusterSim
from ceph_tpu.common.perf_counters import perf as ref_perf
from ceph_tpu_torch.cluster.simulator import ClusterSim as PortClusterSim
from ceph_tpu_torch.common.perf_counters import perf as port_perf
from ceph_tpu_torch.tools import check_multichip
from torch_check import fresh_perf_group, reference_smoke

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def observed(monkeypatch, sim_cls, perf):
    """Records what every ``recover_all`` of ``sim_cls`` returns and the
    ``dataplane`` counters at every ``shutdown``, while the run lasts."""
    seen = {"rec": [], "dataplane": []}
    recover_all, shutdown = sim_cls.recover_all, sim_cls.shutdown

    def rec(self, *a, **k):
        out = recover_all(self, *a, **k)
        seen["rec"].append(out)
        return out

    def down(self, *a, **k):
        seen["dataplane"].append(perf("dataplane").dump())
        return shutdown(self, *a, **k)
    monkeypatch.setattr(sim_cls, "recover_all", rec)
    monkeypatch.setattr(sim_cls, "shutdown", down)
    return seen


def put_stripes(dump):
    return {k: v for k, v in dump.items() if k.endswith(".put_stripes")}


def test_check_multichip_smoke(monkeypatch, capsys):
    """::test_check_multichip_smoke, with --quick, and its facts held to
    the reference's"""
    for perf in (port_perf, ref_perf):
        fresh_perf_group(monkeypatch, perf, "dataplane")
    port = observed(monkeypatch, PortClusterSim, port_perf)
    assert check_multichip.main(["--device", "cpu", "--quick"]) == 0
    assert capsys.readouterr().out.startswith(
        "OK: sharded data plane verified on 8 cells of cpu")
    ref = observed(monkeypatch, RefClusterSim, ref_perf)
    monkeypatch.setattr(sys, "argv", ["check_multichip.py", "--quick"])
    assert reference_smoke("multichip").main() == 0
    # three sims each: the step unsharded, sharded, the dispatched_mesh put
    assert len(port["rec"]) == len(ref["rec"]) == 2
    assert port["rec"] == ref["rec"]
    assert port["rec"][0]["shards_rebuilt"] > 0
    assert len(port["dataplane"]) == len(ref["dataplane"]) == 3
    sharded = put_stripes(port["dataplane"][1])
    assert sorted(sharded) == [f"shard{i}.put_stripes" for i in range(8)]
    assert all(sharded.values())
    assert sharded == put_stripes(ref["dataplane"][1])


def leave_2d_plane_keys(perf):
    """What a 2 x 4 plane run leaves in a package's ``dataplane`` group
    after ``reset()`` (tests/test_torch_data_plane.py runs one in each
    package): its per-cell keys, at 0."""
    group = perf("dataplane")
    for r in range(2):
        for c in range(4):
            group.inc(f"r{r}c{c}.put_stripes")
            group.inc(f"r{r}c{c}.put_bytes")
    group.reset()


def test_check_multichip_smoke_after_a_2d_plane_run(monkeypatch, capsys):
    """The comparison holds in a process whose ``dataplane`` groups an
    earlier 2 x 4 plane run filled, as ``--dist loadfile`` gives it when
    tests/test_torch_data_plane.py ran earlier in the same worker; the
    earlier run's keys come back afterwards."""
    saved = {}
    for name, perf in (("port", port_perf), ("ref", ref_perf)):
        group = perf("dataplane")
        monkeypatch.setattr(group, "_types", dict(group._types))
        monkeypatch.setattr(group, "_vals", dict(group._vals))
        leave_2d_plane_keys(perf)
        saved[name] = group.dump()
    with monkeypatch.context() as m:
        test_check_multichip_smoke(m, capsys)
    assert port_perf("dataplane").dump() == saved["port"]
    assert ref_perf("dataplane").dump() == saved["ref"]


def test_check_multichip_fails_when_the_plane_diverges(monkeypatch, capsys):
    """The check is falsifiable: a sharded step whose recovery differs
    from the unsharded one's fails with the reference's message."""
    drive = check_multichip.drive

    def skewed(shard, device=None):
        datas, gets, rec, up = drive(shard, device)
        return datas, gets, (dict(rec, shards_rebuilt=-1) if shard
                             else rec), up
    monkeypatch.setattr(check_multichip, "drive", skewed)
    assert check_multichip.main(["--device", "cpu", "--quick"]) == 1
    assert "FAIL: recovery stats diverged" in capsys.readouterr().err

