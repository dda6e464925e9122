"""The port's offline store tools against the reference's:
ceph-kvstore-tool, ceph-monstore-tool and ceph-objectstore-tool.

Twins of ``tests/test_store_tools.py`` and
``tests/test_durable.py::test_objectstore_tool_surgery``.  Each scenario
runs once in each package, on stores that package built, and records
every command's exit code and output; the records must be equal.  The
stores are host code (no device work), so the tools take no ``--device``.
One more case runs the port's tools on stores the reference built: the
on-disk formats are one.
"""
import contextlib
import importlib
import io
import json
import types

import pytest

import ceph_tpu_torch
from tests import torch_twin


def pkg(name):
    root = "ceph_tpu" if name == "ref" else "ceph_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return types.SimpleNamespace(
        name=name, kv=mod("cluster.kv"), wal_kv=mod("cluster.wal_kv"),
        filestore=mod("cluster.filestore"),
        objectstore=mod("cluster.objectstore"),
        monitor=mod("cluster.monitor"),
        kvtool=mod("tools.kvstore_tool"), montool=mod("tools.monstore_tool"),
        ostool=mod("tools.objectstore_tool"))


REF, PORT = pkg("ref"), pkg("port")


def run(main, *args, data_in=None):
    out = io.StringIO()
    if data_in is not None:
        rc = main(list(args), out=out, data_in=data_in)
    else:
        rc = main(list(args), out=out)
    return rc, out.getvalue()


def kv_scenario(p, path):
    db = p.wal_kv.WalDB(path, fsync=False)
    db.submit(p.kv.WriteBatch().set("a", "k1", b"v1").set("b", "k2",
                                                            b"word"))
    db.close()
    main = p.kvtool.main
    rec = [run(main, path, "list"), run(main, path, "list", "a"),
           run(main, path, "get", "b", "k2"),
           run(main, path, "set", "c", "k3", "-", data_in=b"new"),
           run(main, path, "get", "c", "k3"),
           run(main, path, "rm", "a", "k1"),
           run(main, path, "get", "a", "k1"),
           run(main, path, "rm", "a", "k1"),
           run(main, path, "stats"), run(main, path, "compact"),
           run(main, path, "stats")]
    db2 = p.wal_kv.WalDB(path, fsync=False)
    rec.append((db2.get("c", "k3"), db2.get("a", "k1")))
    db2.close()
    return rec


def test_kvstore_tool_crud_and_stats(tmp_path):
    ref = kv_scenario(REF, str(tmp_path / "ref"))
    port = kv_scenario(PORT, str(tmp_path / "port"))
    assert port == ref
    assert port[2] == (0, "word") and port[-1] == (b"new", None)


def mon_scenario(p, path):
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    try:
        sim = torch_twin.make_sim(torch_twin.REF if p is REF
                                  else torch_twin.PORT)
        try:
            db = p.wal_kv.WalDB(path, fsync=False)
            mon = p.monitor.Monitor(sim.osdmap, db=db)
            for _ in range(3):
                inc = mon.next_incremental()
                inc.new_weight[0] = 0x8000
                assert mon.commit_incremental(inc)
            db.close()
        finally:
            sim.shutdown()
    finally:
        ceph_tpu_torch.set_default_device(prev)
    main = p.montool.main
    return [run(main, path, w) for w in ("summary", "dump-keys",
                                         "get-osdmap", "dump-paxos",
                                         "dump-config")] + \
        [run(main, path, "get-osdmap", "2"),
         run(main, path, "get-osdmap", "99")]


def test_monstore_tool_on_a_real_mon_store(tmp_path):
    ref = mon_scenario(REF, str(tmp_path / "ref"))
    port = mon_scenario(PORT, str(tmp_path / "port"))
    assert port == ref
    assert "osdmap epochs: 3" in port[0][1]
    assert json.loads(port[2][1])["new_weight"]["0"] == 0x8000
    assert port[-1][0] == 1


def build_store(p, path):
    fs = p.filestore.FileStore(path, fsync=False)
    txn = p.objectstore.Transaction()
    txn.write((3, 1), "2:blob", 0, b"surgical payload " * 50)
    txn.setattr((3, 1), "2:blob", "ver", b"7")
    txn.omap_set((3, 1), "2:blob", "snap", b"2")
    txn.write_full((3, 2), "2:other", b"x" * 300)
    fs.apply_transaction(txn)
    fs.close()


def os_run(p, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = p.ostool.main(list(argv))
    return rc, out.getvalue()


def objectstore_scenario(p, a, b, exp):
    build_store(p, a)
    p.filestore.FileStore(b, fsync=False).close()    # empty target store
    rec = [os_run(p, "--store", a, "list-pgs"),
           os_run(p, "--store", a, "list"),
           os_run(p, "--store", a, "list", "--pg", "3.1"),
           os_run(p, "--store", a, "info", "--pg", "3.1", "--oid", "2:blob"),
           os_run(p, "--store", a, "export", "--pg", "3.1", "--oid",
                  "2:blob", "--file", exp),
           os_run(p, "--store", b, "import", "--pg", "3.1", "--oid",
                  "2:blob", "--file", exp)]
    with open(exp) as f:
        rec.append(json.load(f))
    fb = p.filestore.FileStore(b, fsync=False)
    rec.append((fb.read((3, 1), "2:blob"), fb.getattr((3, 1), "2:blob", "ver"),
                fb.omap_get((3, 1), "2:blob", "snap")))
    fb.close()
    rec += [os_run(p, "--store", a, "remove", "--pg", "3.1", "--oid",
                   "2:blob"),
            os_run(p, "--store", a, "list"),
            os_run(p, "--store", a, "fsck"),
            os_run(p, "--store", a, "gc")]
    return rec


def test_objectstore_tool_surgery(tmp_path):
    recs = {}
    for p in (REF, PORT):
        d = tmp_path / p.name
        d.mkdir()
        recs[p.name] = objectstore_scenario(
            p, str(d / "osd_a"), str(d / "osd_b"), str(d / "obj.json"))
    assert recs["port"] == recs["ref"]
    port = recs["port"]
    info = json.loads(port[3][1])
    assert info["size"] == 850 and info["n_xattrs"] == 1 \
        and info["n_omap"] == 1
    assert port[7][0] == b"surgical payload " * 50
    assert json.loads(port[10][1])["bad_objects"] == []


@pytest.mark.parametrize("op", [["info"], ["export", "--pg", "3.1"],
                                ["remove", "--oid", "x"]])
def test_objectstore_tool_refuses_missing_arguments(tmp_path, op):
    for p in (REF, PORT):
        with pytest.raises(SystemExit):
            os_run(p, "--store", str(tmp_path / p.name), *op)


def test_port_tools_read_stores_the_reference_built(tmp_path):
    kv = str(tmp_path / "kv")
    db = REF.wal_kv.WalDB(kv, fsync=False)
    db.submit(REF.kv.WriteBatch().set("p", "key", b"value"))
    db.close()
    assert run(PORT.kvtool.main, kv, "get", "p", "key") == \
        run(REF.kvtool.main, kv, "get", "p", "key") == (0, "value")
    store = str(tmp_path / "osd")
    build_store(REF, store)
    for argv in (["list"], ["info", "--pg", "3.2", "--oid", "2:other"],
                 ["fsck"]):
        assert os_run(PORT, "--store", store, *argv) == \
            os_run(REF, "--store", store, *argv)
