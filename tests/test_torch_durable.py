"""The port's durable tier (FileStore and the CrashDev harness) against
ceph_tpu's.

``cluster/filestore.py`` and ``cluster/crashdev.py`` are host-only
copies.  Each scenario runs the same operations, from the same seeds,
through both packages, each in its own directory, and the results must
be equal: the bytes read back, the exceptions raised, the ``fsck``
verdicts, the files each store leaves on disk, the recorder's op
stream, and the crash-image reports of ``CrashHarness`` from the same
``random.Random(seed)``.  Mirrors the FileStore cases of
tests/test_durable.py and tests/test_crashdev.py.
"""
import os
import random
import types

import numpy as np
import pytest
import torch

from ceph_tpu.cluster import blockdev as ref_blockdev
from ceph_tpu.cluster import bluestore as ref_bluestore
from ceph_tpu.cluster import crashdev as ref_crashdev
from ceph_tpu.cluster import filestore as ref_filestore
from ceph_tpu.cluster import objectstore as ref_objectstore
from ceph_tpu.cluster import wal_kv as ref_wal_kv
from ceph_tpu.common import faults as ref_faults
from ceph_tpu_torch.cluster import blockdev as port_blockdev
from ceph_tpu_torch.cluster import bluestore as port_bluestore
from ceph_tpu_torch.cluster import crashdev as port_crashdev
from ceph_tpu_torch.cluster import filestore as port_filestore
from ceph_tpu_torch.cluster import objectstore as port_objectstore
from ceph_tpu_torch.cluster import wal_kv as port_wal_kv
from ceph_tpu_torch.common import faults as port_faults

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

C = (1, 0)

REF = types.SimpleNamespace(
    name="ref", fs=ref_filestore, os=ref_objectstore, bd=ref_blockdev,
    cd=ref_crashdev, wal=ref_wal_kv, bs=ref_bluestore, faults=ref_faults)
PORT = types.SimpleNamespace(
    name="port", fs=port_filestore, os=port_objectstore, bd=port_blockdev,
    cd=port_crashdev, wal=port_wal_kv, bs=port_bluestore,
    faults=port_faults)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _outcome(fn):
    """``fn()``'s value, or the name of the exception it raised."""
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 — compared by name
        return ("raised", type(e).__name__)


def _both(scenario, tmp_path):
    """Run ``scenario(pkg, root)`` for both packages; return (ref, port)."""
    return tuple(scenario(pkg, str(tmp_path / pkg.name))
                 for pkg in (REF, PORT))


# --------------------------------------------------------- FileStore ---

def fs_roundtrip(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False)
    txn = pkg.os.Transaction()
    txn.write(C, "obj1", 0, b"hello world")
    txn.setattr(C, "obj1", "ver", b"1")
    txn.omap_set(C, "obj1", "snap", b"0")
    fs.apply_transaction(txn)
    fs.close()
    fs2 = pkg.fs.FileStore(root, fsync=False)
    out = [fs2.read(C, "obj1"), fs2.getattr(C, "obj1", "ver"),
           fs2.omap_get(C, "obj1", "snap"), fs2.list_objects(C),
           fs2.list_collections(), fs2.fsck()]
    fs2.close()
    return out, _tree(root)


def fs_overlay(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False)
    rng = np.random.default_rng(3)
    fs.apply_transaction(pkg.os.Transaction().write((1, 1), "o", 0,
                                                    bytes(1000)))
    for _ in range(30):
        off = int(rng.integers(0, 900))
        ln = int(rng.integers(1, 100))
        data = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
        fs.apply_transaction(pkg.os.Transaction().write((1, 1), "o",
                                                        off, data))
    out = [fs.read((1, 1), "o"), len(fs._get_meta((1, 1), "o").extents),
           fs.read((1, 1), "o", 100, 50), fs.fsck()]
    fs.close()
    return out, _tree(root)


def fs_truncate_remove(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False)
    c, T = (2, 3), pkg.os.Transaction
    out = []
    fs.apply_transaction(T().write(c, "o", 0, b"x" * 100))
    fs.apply_transaction(T().truncate(c, "o", 40))
    out.append(fs.read(c, "o"))
    fs.apply_transaction(T().truncate(c, "o", 60))
    out.append(fs.read(c, "o"))
    fs.apply_transaction(T().write_full(c, "o", b"new"))
    out.append(fs.read(c, "o"))
    fs.apply_transaction(T().remove(c, "o"))
    out.append(fs.exists(c, "o"))
    out.append(_outcome(lambda: fs.read(c, "o")))
    fs.close()
    return out, _tree(root)


def fs_rollback(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False)
    T = pkg.os.Transaction
    fs.apply_transaction(T().write(C, "keep", 0, b"base"))
    txn = T()
    txn.write(C, "keep", 0, b"MUTATED")
    txn.truncate(C, "missing", 10)       # invalid: no such object
    out = [_outcome(lambda: fs.apply_transaction(txn)),
           fs.read(C, "keep")]
    fs.close()
    return out, _tree(root)


def fs_corruption(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False)
    fs.apply_transaction(pkg.os.Transaction().write(C, "o", 0, b"A" * 256))
    fs.corrupt(C, "o", offset=17)
    out = [_outcome(lambda: fs.read(C, "o")), fs.fsck()]
    fs.close()
    return out, _tree(root)


def fs_same_txn_rows(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False)
    T = pkg.os.Transaction
    txn = T()
    txn.write(C, "o", 0, b"x")
    txn.setattr(C, "o", "k", b"phantom")
    txn.omap_set(C, "o", "mk", b"phantom2")
    txn.remove(C, "o")
    fs.apply_transaction(txn)
    out = [fs.exists(C, "o"), fs.kv.get("xattr", "1.0/o\x00k"),
           fs.kv.get("omap", "1.0/o\x00mk")]
    fs.apply_transaction(T().write(C, "o", 0, b"fresh"))
    out.append(_outcome(lambda: fs.getattr(C, "o", "k")))
    txn = T()
    txn.write(C, "t", 0, b"B" * 100)
    txn.truncate(C, "t", 50)
    fs.apply_transaction(txn)
    out.append(fs.read(C, "t"))
    fs.apply_transaction(T().truncate(C, "t", 100))
    out.append(fs.read(C, "t"))
    fs.close()
    return out, _tree(root)


def fs_gc(pkg, root):
    fs = pkg.fs.FileStore(root, fsync=False, gc_min_bytes=1 << 16)
    rng = np.random.default_rng(8)
    final = {}
    for i in range(200):
        oid = f"o{i % 5}"
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        fs.apply_transaction(pkg.os.Transaction().write_full(C, oid, data))
        final[oid] = data
    out = [os.path.getsize(fs._data_path) <= fs.gc_factor * 5 * 4096 +
           (1 << 16), fs.fsck(),
           [fs.read(C, o) == d for o, d in sorted(final.items())]]
    fs.close()
    fs2 = pkg.fs.FileStore(root, fsync=False)     # remount with fsck
    out.append([fs2.read(C, o) == d for o, d in sorted(final.items())])
    fs2.close()
    return out, _tree(root)


def fs_recorder(pkg, root):
    """FileStore's appends and gc cross the blockdev recorder."""
    os.makedirs(root)
    rec = pkg.bd.attach(root)
    try:
        fs = pkg.fs.FileStore(os.path.join(root, "fs"), fsync=True)
        fs.apply_transaction(pkg.os.Transaction().write_full(C, "o",
                                                             b"F" * 3000))
        fs.close()
    finally:
        pkg.bd.detach(rec)
    stream = [(r[0], os.path.relpath(r[1], root) if len(r) > 1 and
               isinstance(r[1], str) else None) for r in rec.log]
    return stream, _tree(root)


@pytest.mark.parametrize("scenario", [
    fs_roundtrip, fs_overlay, fs_truncate_remove, fs_rollback,
    fs_corruption, fs_same_txn_rows, fs_gc, fs_recorder],
    ids=lambda f: f.__name__)
def test_filestore_equals_reference(scenario, tmp_path):
    ref, port = _both(scenario, tmp_path)
    assert port[0] == ref[0]
    assert port[1] == ref[1], "the stores' files differ on disk"


def test_filestore_scenarios_hold_the_reference_contract(tmp_path):
    """The port's answers are the right ones, not only the same ones."""
    out, _ = fs_roundtrip(PORT, str(tmp_path / "a"))
    assert out == [b"hello world", b"1", b"0", ["obj1"], [C], []]
    out, _ = fs_truncate_remove(PORT, str(tmp_path / "b"))
    assert out == [b"x" * 40, b"x" * 40 + b"\0" * 20, b"new", False,
                   ("raised", "ObjectStoreError")]
    out, _ = fs_corruption(PORT, str(tmp_path / "c"))
    assert out == [("raised", "ChecksumError"), [(C, "o")]]
    out, _ = fs_gc(PORT, str(tmp_path / "d"))
    assert out[0], "the data log outgrew its live bytes: gc never ran"
    assert out[1] == [] and all(out[2]) and all(out[3])


def test_port_daemon_picks_the_port_filestore():
    """The daemon's ``objectstore: filestore`` choice resolves to the
    port's class (``cluster/daemon.py`` imports it lazily)."""
    import inspect
    from ceph_tpu_torch.cluster import daemon
    src = inspect.getsource(daemon.OSDDaemon)
    assert "from .filestore import FileStore" in src
    assert port_filestore.FileStore is not ref_filestore.FileStore


# ---------------------------------------------------------- CrashDev ---

def cd_recorder(pkg, root):
    os.makedirs(root)
    rec = pkg.bd.attach(root)
    try:
        dev = pkg.bd.BlockDevice(os.path.join(root, "f"), size=4096)
        dev.pwrite(b"hello", 0)
        dev.fsync()
        dev.append(b"tail")
        dev.close()
        pkg.bd.replace(os.path.join(root, "f"), os.path.join(root, "g"))
    finally:
        pkg.bd.detach(rec)
    cd = pkg.cd
    return [[r[0] for r in rec.log],
            [cd.pending_writes(rec.log, n) for n in range(len(rec.log) + 1)],
            cd.crash_points(rec.log)], _tree(root)


def cd_materialize(pkg, root):
    src = os.path.join(root, "src")
    rec = pkg.bd.attach(src)
    try:
        os.makedirs(src)
        dev = pkg.bd.BlockDevice(os.path.join(src, "f"))
        dev.append(b"AAAA")
        dev.fsync()
        dev.append(b"BBBB")
        dev.append(b"CCCC")
        dev.close()
    finally:
        pkg.bd.detach(rec)
    log = rec.snapshot()
    pend = pkg.cd.pending_writes(log, len(log))
    out = [pend]
    for name, kw in (("full", {}), ("drop", {"drop": [pend[0]]}),
                     ("tear", {"tear": (pend[1], 2)}),
                     ("seal", {"drop": [1]})):
        pkg.cd.materialize(log, len(log), os.path.join(root, name), **kw)
        out.append(open(os.path.join(root, name, "f"), "rb").read())
    return out, _tree(root)


def _report(rep):
    return {k: v for k, v in rep.items() if not k.endswith("_s")}


def cd_enumerate(pkg, root):
    h = pkg.cd.CrashHarness(os.path.join(root, "run"), seed=0, n_txns=16)
    log = h.run_workload()
    rep = h.enumerate_and_check(os.path.join(root, "imgs"), seeds=(0, 1, 2),
                                images_per_seed=12, barrier_stride=3)
    return [[r[0] for r in log], _report(rep)], None


def cd_double_crash(pkg, root):
    h = pkg.cd.CrashHarness(os.path.join(root, "run"), seed=3, n_txns=12)
    h.run_workload()
    rep = h.enumerate_and_check(os.path.join(root, "imgs"), seeds=(3,),
                                images_per_seed=8, barrier_stride=4,
                                double_crash_every=2)
    return _report(rep), None


def cd_broken_ordering(pkg, root):
    out = []
    for kv_fsync in (False, True):
        h = pkg.cd.CrashHarness(os.path.join(root, f"run{kv_fsync}"),
                                seed=1, n_txns=12, kv_fsync=kv_fsync,
                                compact_bytes=1 << 20)
        h.run_workload()
        img, upto = h.lost_tail_image(os.path.join(root, f"imgs{kv_fsync}"))
        out.append([upto, h.check_image(img, upto)])
    return out, None


def cd_tear_wal_tail(pkg, root):
    db = pkg.wal.WalDB(os.path.join(root, "kv"), fsync=True)
    for i in range(4):
        db.set("p", f"k{i}", b"v" * 64)
    db.close()
    wal = os.path.join(root, "kv", "wal.log")
    r1, r2 = random.Random(7), random.Random(7)
    out = [pkg.cd.tear_wal_tail(root, r1)]
    with open(wal, "ab") as f:
        f.write(b"\x31\x4c\x41\x57" + b"partial-record-fragment")
    out.append(pkg.cd.tear_wal_tail(root, r2))
    out.append(r1.random() == r2.random())
    db2 = pkg.wal.WalDB(os.path.join(root, "kv"), fsync=True)
    out.append(db2.get("p", "k3"))
    db2.close()
    return out, _tree(root)


def cd_torn_and_lost_write(pkg, root):
    """The device.torn_write and device.lost_write faultpoints."""
    T, f = pkg.os.Transaction, pkg.faults
    kw = dict(fsync=True, min_alloc=512, device_bytes=1 << 20,
              fsck_on_mount=False)
    st = pkg.bs.BlueStore(os.path.join(root, "s"), **kw)
    st.apply_transaction(T().write_full(C, "safe", b"S" * 2000))
    f.arm("device.torn_write", mode="nth", n=1, exit=False, keep=100)
    try:
        torn = _outcome(lambda: st.apply_transaction(
            T().write_full(C, "doomed", b"D" * 2000)))
    finally:
        f.disarm("device.torn_write")
    markers = bool(pkg.bd.power_loss_markers(os.path.join(root, "s")))
    st.close()
    st2 = pkg.bs.BlueStore(os.path.join(root, "s"), **kw)
    out = [torn, markers, st2.fsck(), st2.read(C, "safe"),
           st2.exists(C, "doomed")]
    f.arm("device.lost_write", mode="nth", n=1)
    try:
        st2.apply_transaction(T().write_full(C, "ghost", b"G" * 1000))
    finally:
        f.disarm("device.lost_write")
    out += [_outcome(lambda: st2.read(C, "ghost")), st2.fsck(repair=True),
            st2.fsck(), st2.exists(C, "ghost")]
    st2.close()
    return out, None


@pytest.mark.parametrize("scenario", [
    cd_recorder, cd_materialize, cd_enumerate, cd_double_crash,
    cd_broken_ordering, cd_tear_wal_tail, cd_torn_and_lost_write],
    ids=lambda f: f.__name__)
def test_crashdev_equals_reference(scenario, tmp_path):
    ref, port = _both(scenario, tmp_path)
    assert port[0] == ref[0]
    assert port[1] == ref[1], "the images' files differ on disk"


def test_crashdev_holds_the_reference_contract(tmp_path):
    """The port's harness catches the broken ordering and passes the
    correct one (the falsifiability pair of tests/test_crashdev.py),
    and its seeded sweep finds no violation."""
    (broken, correct), _ = cd_broken_ordering(PORT, str(tmp_path / "a"))
    assert broken[1] and any("acked" in p for p in broken[1])
    assert correct[1] == []
    (ops, rep), _ = cd_enumerate(PORT, str(tmp_path / "b"))
    assert ops.count("rename") >= 2
    assert rep["violations"] == [] and rep["seeded"] >= 36
    out, _ = cd_torn_and_lost_write(PORT, str(tmp_path / "c"))
    assert out[0] == ("raised", "PowerLoss") and out[1]
    assert out[2:5] == [[], b"S" * 2000, False]
    assert out[5][0] == "raised"
    assert out[6] == [(C, "ghost")] and out[7] == [] and not out[8]
