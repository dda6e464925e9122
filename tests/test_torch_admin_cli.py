"""The port's ``rados`` CLI against the reference's, over one live process
cluster of the port; and ROADMAP C11, the CLI's erasure-code profile.

Twins of the ``rados`` half of ``tests/test_admin_cli.py``.  One cluster
of the port (``tools/vstart.py``: a mon and 11 OSD daemons on the CPU,
one a host) serves the file: a 3-replica pool ``rep`` and an RS(8,3)
pool ``rs83``.  Each command runs through the reference's ``rados`` and
then through the port's (``--device cpu``) on the same cluster; their
exit codes and output must be equal.  The two clients speak one wire
protocol to the same daemons.  Writes are retried until every copy
acks, as the process-cluster twins do (ROADMAP C5); reads run once.

C11: ``rados`` builds its ``RemoteCluster`` with no ``ec_profiles``
(``ceph_tpu/tools/rados_cli.py:38``), and the client's ``codec_for``
then falls back to RS(4,2) for any erasure-coded pool
(``ceph_tpu/client/remote.py:504-509``).  So ``rados put`` on the RS(8,3)
pool writes 4 + 2 shards, and a client given the pool's real profile
cannot read the object back.  The port keeps the reference's answer;
``test_c11_rados_put_on_an_rs83_pool_writes_rs42_shards`` pins it.
"""
import io
import re
import time

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.tools import rados_cli as ref_rados
from ceph_tpu_torch.tools import rados_cli
from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir
from tests.torch_twin import outcome

# One intra-op thread per test process (the suite runs under several
# xdist workers).
torch.set_num_threads(1)

N_OSDS = 11
RS83 = {"plugin": "jax", "k": "8", "m": "3"}
POOLS = [{"id": 1, "name": "rep", "type": 1, "size": 3, "pg_num": 8,
          "crush_rule": 0},
         {"id": 2, "name": "rs83", "type": 3, "size": 11, "pg_num": 4,
          "crush_rule": 1, "erasure_code_profile": "rs83"}]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("radosc") / "cluster")
    build_cluster_dir(d, n_osds=N_OSDS, osds_per_host=1, fsync=False,
                      pools=POOLS)
    v = Vstart(d)
    v.start(N_OSDS, hb_interval=0.25)
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    try:
        yield d
    finally:
        ceph_tpu_torch.set_default_device(prev)
        v.stop()


def run(main, d, pool, *words, data_in=None, port=False):
    out = io.StringIO()
    argv = ["--dir", d, "-p", pool, *words]
    if port:
        argv += ["--device", "cpu"]
    rc = main(argv, out=out, data_in=data_in)
    return rc, out.getvalue()


def both(d, pool, *words, data_in=None):
    return (run(ref_rados.main, d, pool, *words, data_in=data_in),
            run(rados_cli.main, d, pool, *words, data_in=data_in,
                port=True))


def put_acked(main, d, pool, name, data, acks, port=False, tries=12):
    """``rados put`` until every copy acks (a loaded host can make the
    mon mark a live daemon down for a heartbeat, ROADMAP C5)."""
    for _ in range(tries):
        try:
            got = run(main, d, pool, "put", name, "-", data_in=data,
                      port=port)
            if got[1].endswith(f"({acks} acks)\n"):
                return got
        except (OSError, IOError):
            pass
        time.sleep(0.5)
    raise AssertionError(f"{name}: {acks} acks never came")


def test_rados_put_get_ls_rm(cluster):
    payload = b"cli-payload" * 100
    recs = []
    for main, port in ((ref_rados.main, False), (rados_cli.main, True)):
        rec = [put_acked(main, cluster, "rep", "obj1", payload, 3, port)]
        rec.append(run(main, cluster, "rep", "get", "obj1", "-", port=port))
        rec.append(run(main, cluster, "rep", "ls", port=port))
        rec.append(run(main, cluster, "rep", "rm", "obj1", port=port))
        rec.append(run(main, cluster, "rep", "ls", port=port))
        recs.append(rec)
    assert recs[1] == recs[0]
    put, get, ls, rm, ls2 = recs[1]
    assert put == (0, f"wrote {len(payload)} bytes (3 acks)\n")
    assert get[0] == 0 and get[1].encode("latin-1") == payload
    assert "obj1" in ls[1].splitlines()
    assert rm == (0, "removed obj1 (3 acks)\n")
    assert "obj1" not in ls2[1].splitlines()


def test_rados_put_and_get_through_files(cluster, tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(bytes(range(256)) * 40)
    for main, port in ((ref_rados.main, False), (rados_cli.main, True)):
        dst = tmp_path / f"out-{port}.bin"
        for _ in range(12):
            rc, txt = run(main, cluster, "rep", "put", "fileobj", str(src),
                          port=port)
            if txt.endswith("(3 acks)\n"):
                break
            time.sleep(0.5)
        assert (rc, txt) == (0, "wrote 10240 bytes (3 acks)\n")
        assert run(main, cluster, "rep", "get", "fileobj", str(dst),
                   port=port) == (0, "")
        assert dst.read_bytes() == src.read_bytes()


def test_rados_bench_writes_one_mib_objects(cluster):
    rc, txt = run(rados_cli.main, cluster, "rep", "bench", "0.5", port=True)
    assert rc == 0
    m = re.fullmatch(r"(\d+) writes x 1 MiB in ([\d.]+)s = ([\d.]+) MiB/s\n",
                     txt)
    assert m and int(m.group(1)) >= 1
    listed = run(rados_cli.main, cluster, "rep", "ls", port=True)[1]
    assert {f"bench_{i}" for i in range(int(m.group(1)))} <= \
        set(listed.splitlines())


@pytest.mark.parametrize("words", [["get", "x"], ["put", "x"], ["rm"],
                                   ["frobnicate"]])
def test_rados_refuses_bad_commands(cluster, words):
    for main, port in ((ref_rados.main, False), (rados_cli.main, True)):
        with pytest.raises(SystemExit):
            run(main, cluster, "rep", *words, port=port)


def test_rados_unknown_pool(cluster):
    got = []
    for main, port in ((ref_rados.main, False), (rados_cli.main, True)):
        with pytest.raises(SystemExit) as e:
            run(main, cluster, "nopool", "ls", port=port)
        got.append(str(e.value))
    assert got[0] == got[1] == "rados: no pool 'nopool'"


def test_c11_rados_put_on_an_rs83_pool_writes_rs42_shards(cluster):
    """C11's smallest input: ``rados put`` of one object on the RS(8,3)
    pool, then a read through a client given the pool's real profile.
    Both packages' ``rados`` write 6 shards (RS(4,2), the fallback), not
    11; both read it back themselves; a client with the RS(8,3) profile
    does not get the bytes back.  The port keeps the reference's
    answer."""
    from ceph_tpu.client.remote import RemoteCluster as RefRemote
    from ceph_tpu_torch.client.remote import RemoteCluster
    payload = bytes(range(251)) * 97
    recs = []
    for main, port, remote in ((ref_rados.main, False, RefRemote),
                               (rados_cli.main, True, RemoteCluster)):
        name = f"c11-{int(port)}"
        rec = [put_acked(main, cluster, "rs83", name, payload, 6, port)]
        got = run(main, cluster, "rs83", "get", name, "-", port=port)
        rec.append((got[0], got[1].encode("latin-1") == payload))
        rc = remote(cluster, ec_profiles={"rs83": dict(RS83)})
        try:
            res = outcome(lambda: rc.get(2, name))
        finally:
            rc.close()
        rec.append(res[0] == "ok" and res[1] == payload)
        recs.append(rec)
    assert recs[0][0] == (0, f"wrote {len(payload)} bytes (6 acks)\n")
    assert recs[0][1:] == [(0, True), False]
    assert recs[1] == recs[0]
