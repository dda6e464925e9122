"""The port's cephadm against the reference's.

Twins of ``tests/test_cephadm.py``.  One module fixture deploys a cluster
a package from the same spec (3 mons, 2 hosts x 2 OSDs, a 3-replica pool), one
cluster at a time, reads its status through the CLI (the port's with
``--device cpu``), and takes it through one rolling upgrade to "2.0" under a
client workload before it stops; the tests read its record.  The upgrade
cycles the mons first, one at a time, then every OSD, each
health-gated.  What is deterministic is compared between the packages:
the status before and after, the order of the restarts and the versions.
The acked writes are timing, so each package's are read back from its
own cluster.
"""
import contextlib
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.client.remote import RemoteCluster as RefRemote
from ceph_tpu.tools import cephadm as ref_cephadm
from ceph_tpu_torch.client.remote import RemoteCluster
from ceph_tpu_torch.tools import cephadm

# One intra-op thread per test process (the suite runs under several
# xdist workers).
torch.set_num_threads(1)


def _spec(mod):
    return mod.ClusterSpec(
        name="t", version="1.0", mons=3,
        hosts=[{"name": f"h{i}", "osds": 2} for i in range(2)],
        pools=[{"id": 1, "name": "rep", "type": 1, "size": 3,
                "pg_num": 8, "crush_rule": 0}])


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _upgrade_under_io(adm, remote):
    stop = threading.Event()
    acked, errors = {}, []

    def workload():
        rc = None
        rng = np.random.default_rng(9)
        i = 0
        while not stop.is_set():
            if rc is None:
                try:
                    rc = remote(adm.dir)
                except IOError:
                    time.sleep(0.2)      # a mon may be mid-cycle
                    continue
            name = f"w{i}"
            data = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
            try:
                rc.put(1, name, data)
                acked[name] = data
            except IOError:
                pass                     # unacked writes carry no promise
            except Exception as e:       # anything else is a test bug
                errors.append(e)
                return
            i += 1
            time.sleep(0.05)
        if rc is not None:
            rc.close()

    t = threading.Thread(target=workload)
    t.start()
    try:
        res = adm.upgrade("2.0", timeout=120)
    finally:
        stop.set()
        t.join(timeout=30)
    rc = remote(adm.dir)
    try:
        lost = [n for n, data in acked.items() if rc.get(1, n) != data]
    finally:
        rc.close()
    return {"result": res, "status": adm.status(), "errors": errors,
            "acked": len(acked), "lost": lost,
            "health_ok": adm.health_ok()}


def _deploy(name, base):
    """The package's cluster deployed from the spec, and its status as
    its CLI prints it (the port's with ``--device cpu``)."""
    d = str(base / name)
    if name == "ref":
        adm = ref_cephadm.CephAdm.deploy(_spec(ref_cephadm), d, timeout=90)
        return adm, json.loads(_cli(ref_cephadm.main, ["status", d]))
    adm = cephadm.CephAdm.deploy(_spec(cephadm), d, timeout=90)
    return adm, json.loads(_cli(cephadm.main,
                                ["--device", "cpu", "status", d]))


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    """Per package, one cluster at a time: deploy, status, the spec read
    back, then the rolling upgrade under IO; the cluster is stopped
    before the next package's starts."""
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    base = tmp_path_factory.mktemp("cephadm")
    out = {}
    try:
        for name, remote in (("ref", RefRemote), ("port", RemoteCluster)):
            adm, status = _deploy(name, base)
            try:
                out[name] = {"status": status, "spec": vars(adm.spec()),
                             "n_osds": adm.spec().n_osds,
                             "osds_per_host": adm.spec().osds_per_host,
                             "upgrade": _upgrade_under_io(adm, remote)}
            finally:
                adm.stop()
    finally:
        ceph_tpu_torch.set_default_device(prev)
    return out


def test_spec_driven_deploy_and_status(record):
    ref, port = record["ref"], record["port"]
    assert port["status"] == ref["status"]
    st = port["status"]
    assert st["health_ok"] and st["n_up"] == 4
    assert st["spec"]["version"] == "1.0"
    assert st["versions"] == {f"osd.{i}": "1.0" for i in range(4)}
    assert port["n_osds"] == 4 and port["osds_per_host"] == 2
    assert port["spec"] == ref["spec"]


def test_rolling_upgrade_under_io(record):
    ref, port = record["ref"]["upgrade"], record["port"]["upgrade"]
    for rec in (ref, port):
        assert not rec["errors"], rec["errors"]
        assert rec["acked"] > 0 and rec["lost"] == []
        assert rec["health_ok"] and rec["status"]["health_ok"]
    assert port["result"] == ref["result"]
    assert port["status"] == ref["status"]
    assert set(port["result"]["restarted"]) >= {f"osd.{i}" for i in
                                                 range(4)}
    assert all(v == "2.0" for v in port["status"]["versions"].values())
    assert port["status"]["spec"]["version"] == "2.0"


def test_multi_mon_rolling_restart(record):
    """Mons cycle first and one at a time; the quorum survives every
    single-mon outage."""
    for name in ("ref", "port"):
        rec = record[name]["upgrade"]
        assert rec["result"]["restarted"][:3] == ["mon.0", "mon.1", "mon.2"]
        assert [r for r in rec["result"]["restarted"]
                if r.startswith("mon")] == [f"mon.{r}" for r in range(3)]
        assert rec["health_ok"]
