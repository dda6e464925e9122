"""The port's metadata servers against ceph_tpu's.

``fs/mds.py`` (the journaled directory tree, file I/O striped by a
``FileLayout``, locks, capabilities and leases), ``fs/mdsmap.py`` and
``fs/multimds.py`` (ranks, subtree authority, migration, the balancer,
cross-rank renames and read replicas).  Each scenario is the twin of a
reference test in tests/test_multimds.py or the CephFS part of
tests/test_fs_rgw.py (named in its docstring), run in both packages over
tests/test_snaps.py's sim with the same seeded clock
(``tests/torch_twin.py``): the record and every object of the sim (the
dirfrags, the journals, the inode table and the file data) must be
equal.  CephFS also runs with Ceph's default layout (4 MiB objects)
over the erasure-coded pool with an OSD lost, and over the port's vstart
daemons (tests/test_wire_gateways.py::test_cephfs_over_daemons).
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from tests.torch_twin import (PORT, REF, assert_twin, make_sim, outcome,
                              rados, run_in)

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def pools(p, data_pool="rep"):
    r = rados(p, make_sim(p))
    return r.open_ioctx("rep"), r.open_ioctx(data_pool)


# ------------------------------------------------------- single MDS --

def journaler_append_replay_trim(p):
    """tests/test_fs_rgw.py::test_journaler_append_replay_trim"""
    io, _ = pools(p)
    j = p.journaler.Journaler(io, "t1", object_bytes=128)
    seqs = [j.append(f"entry-{i}".encode() * 4) for i in range(20)]
    j2 = p.journaler.Journaler(io, "t1", object_bytes=128)
    got = list(j2.replay())
    removed = j2.trim_to(15)
    return [seqs, got, j2.active, removed, list(j2.replay())]


def mds_tree_and_file_io(p):
    """tests/test_fs_rgw.py::test_mds_tree_and_file_io"""
    meta, data = pools(p)
    fs = p.mds.CephFSClient(p.mds.MDS(meta, data))
    fs.mkdir("/home")
    fs.mkdir("/home/alice")
    fs.write("/home/alice/hello.txt", b"hello metadata world")
    out = [fs.read("/home/alice/hello.txt"), fs.listdir("/home"),
           fs.listdir("/home/alice"), fs.stat("/home/alice/hello.txt")]
    big = bytes(np.random.default_rng(4).integers(0, 256, 200_000,
                                                  dtype=np.uint8))
    fs.write("/home/alice/big.bin", big)
    out.append(fs.read("/home/alice/big.bin") == big)
    fs.write("/home/alice/big.bin", b"SPLICE", offset=65530)
    out.append(fs.read("/home/alice/big.bin", 65520, 30))
    fs.mkdir("/archive")
    fs.rename("/home/alice/hello.txt", "/archive/greeting.txt")
    out += [fs.listdir("/archive"), fs.read("/archive/greeting.txt"),
            outcome(lambda: fs.rmdir("/home/alice"))[:2]]
    fs.unlink("/home/alice/big.bin")
    fs.rmdir("/home/alice")
    fs.flush()
    return out + [fs.listdir("/home")]


def mds_journal_replay(p):
    """tests/test_fs_rgw.py::test_mds_journal_replay_recovers_tree"""
    meta, data = pools(p)
    fs = p.mds.CephFSClient(p.mds.MDS(meta, data))
    fs.mkdir("/proj")
    fs.write("/proj/a.txt", b"A")
    fs.write("/proj/b.txt", b"B")
    fs.rename("/proj/a.txt", "/proj/c.txt")
    fs.flush()
    sim = meta._rados._sim
    for (pid, name) in list(sim.objects):
        if pid == meta.pool_id and name.startswith("dirfrag."):
            sim.delete(pid, name)
    fs2 = p.mds.CephFSClient(p.mds.MDS(meta, data))
    return [fs2.listdir("/"), fs2.listdir("/proj"), fs2.read("/proj/c.txt"),
            fs2.stat("/proj/c.txt")]


def mds_file_locks(p):
    """tests/test_fs_rgw.py::test_mds_file_locks"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    fs = p.mds.CephFSClient(mds)
    fs.mkdir("/lk")
    fs.write("/lk/f", b"locked data")
    out = [mds.setlk("/lk/f", "clientA", exclusive=True),
           mds.setlk("/lk/f", "clientB", exclusive=True),
           mds.setlk("/lk/f", "clientB", exclusive=False),
           mds.setlk("/lk/f", "clientA", exclusive=True)]
    mds.unlock("/lk/f", "clientA")
    out += [mds.setlk("/lk/f", "r1", exclusive=False),
            mds.setlk("/lk/f", "r2", exclusive=False),
            mds.setlk("/lk/f", "w", exclusive=True), mds.getlk("/lk/f")]
    fs.write("/lk/g", b"second")
    out += [mds.setlk("/lk/g", "r1", exclusive=False),
            mds.release_owner("r1")]
    mds.unlock("/lk/f", "r2")
    out.append(mds.setlk("/lk/f", "w", exclusive=True))
    fs.flush()
    return out


def mds_locks_die_with_inode(p):
    """tests/test_fs_rgw.py::test_mds_locks_die_with_inode"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    fs = p.mds.CephFSClient(mds)
    fs.mkdir("/lk2")
    fs.write("/lk2/gone", b"x")
    out = [mds.setlk("/lk2/gone", "A", exclusive=True)]
    ino = mds._lookup("/lk2/gone")["ino"]
    fs.unlink("/lk2/gone")
    return out + [ino, ino in mds._locks, mds.release_owner("A")]


def caps_two_client_coherence(p):
    """tests/test_fs_rgw.py::test_caps_two_client_coherence"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    a = p.mds.CephFSClient(mds, "client.a")
    b = p.mds.CephFSClient(mds, "client.b")
    a.write("/shared.txt", b"from-A-buffered")
    out = [mds.caps_of("/shared.txt"), mds.read_file("/shared.txt"),
           b.read("/shared.txt"), mds.caps_of("/shared.txt")]
    a.write("/shared.txt", b"SYNC", offset=0)
    return out + [b.read("/shared.txt")]


def caps_writer_revokes_reader_cache(p):
    """tests/test_fs_rgw.py::test_caps_writer_revokes_reader_cache"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    a = p.mds.CephFSClient(mds, "client.a")
    b = p.mds.CephFSClient(mds, "client.b")
    a.write("/f.txt", b"v1")
    a.flush()
    a.mds.release_caps("client.a", "/f.txt")
    out = [b.read("/f.txt"), mds.caps_of("/f.txt")]
    a.write("/f.txt", b"v2")
    a.flush()
    return out + [mds.caps_of("/f.txt"), b.read("/f.txt")]


def caps_lease_expiry_evicts(p):
    """tests/test_fs_rgw.py::test_caps_lease_expiry_evicts"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    a = p.mds.CephFSClient(mds, "client.a")
    a.write("/leased.txt", b"mine")
    a.flush()
    out = [mds.setlk("/leased.txt", "client.a")]
    t0 = 1000.0
    mds.renew_session("client.a", now=t0)
    out += [mds.evict_expired(now=t0 + mds.LEASE_TTL / 2),
            mds.caps_of("/leased.txt"),
            mds.evict_expired(now=t0 + mds.LEASE_TTL + 1),
            mds.caps_of("/leased.txt"), mds.getlk("/leased.txt"),
            outcome(lambda: mds.acquire_caps("client.a", "/leased.txt", "r",
                                             now=t0 + mds.LEASE_TTL + 1))
            [:2]]
    mds.open_session("client.a", now=t0 + mds.LEASE_TTL + 2)
    return out + [mds.acquire_caps("client.a", "/leased.txt", "r",
                                   now=t0 + mds.LEASE_TTL + 2)]


def caps_evicted_client_reconnects_cold(p):
    """tests/test_fs_rgw.py::test_caps_evicted_client_reconnects_cold"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    a = p.mds.CephFSClient(mds, "client.a")
    b = p.mds.CephFSClient(mds, "client.b")
    a.write("/e.txt", b"v1")
    a.flush()
    out = [a.read("/e.txt")]
    t = 10_000.0
    mds.renew_session("client.b", now=t)
    mds._sessions["client.a"]["renewed"] = t - mds.LEASE_TTL - 1
    out.append(mds.evict_expired(now=t))
    b.write("/e.txt", b"v2")
    b.flush()
    mds.release_caps("client.b", "/e.txt")
    return out + [a.read("/e.txt")]


def single_mds_unaffected(p):
    """tests/test_multimds.py::test_single_mds_unaffected"""
    meta, data = pools(p)
    mds = p.mds.MDS(meta, data)
    fs = p.mds.CephFSClient(mds)
    fs.mkdir("/solo")
    fs.write("/solo/f", b"x")
    return [fs.read("/solo/f"), mds.journal.name]


# -------------------------------------------------------- multi MDS --

def mdsmap_longest_prefix_auth(p):
    """tests/test_multimds.py::test_mdsmap_longest_prefix_auth"""
    meta, _ = pools(p)
    m = p.mdsmap.MDSMap(meta, n_ranks=3)
    m.set_auth("/a", 1)
    m.set_auth("/a/deep", 2)
    out = [m.auth_rank(x) for x in ("/", "/b/x", "/a", "/a/file",
                                    "/a/deep", "/a/deep/er/still")]
    m2 = p.mdsmap.MDSMap(meta, n_ranks=3)
    return out + [m.epoch, m2.epoch, m2.auth_rank("/a/deep/x"),
                  outcome(lambda: m.set_auth("/a", 99))[:2]]


def wrong_rank_forwards(p):
    """tests/test_multimds.py::test_wrong_rank_forwards"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/left")
    c.migrate("/left", 1)
    fwd = outcome(lambda: c.ranks[0].mkdir("/left/sub"))
    try:
        c.ranks[0].mkdir("/left/sub2")
    except p.mds.ForwardError as e:
        rank = e.rank
    c.mkdir("/left/sub")
    out = [fwd[:2], rank, c.listdir("/left")]
    c.ranks[1].mkdir("/left/sub2")
    return out + [sorted(c.listdir("/left")), c.subtree_map()]


def migration_flushes_caps(p):
    """tests/test_multimds.py::test_migration_moves_authority_and_flushes_caps"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/proj")
    c.create("/proj/f")
    c.write_file("/proj/f", b"hello world")
    flushed = []
    c.open_session("alice", flush_cb=lambda ino, why:
                   flushed.append((ino, why)))
    out = [c.acquire_caps("alice", "/proj/f", "rwc")]
    c.migrate("/proj", 1)
    out += [flushed, c.caps_of("/proj/f"), c.subtree_map(),
            c.read_file("/proj/f"), c.acquire_caps("alice", "/proj/f", "r")]
    c.write_file("/proj/f", b"HELLO WORLD")
    return out + [c.read_file("/proj/f")]


def migration_survives_restart(p):
    """tests/test_multimds.py::test_migration_survives_restart"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/stay")
    c.mkdir("/move")
    c.create("/move/f")
    c.write_file("/move/f", b"payload")
    c.migrate("/move", 1)
    c2 = p.multimds.MDSCluster(meta, data, n_ranks=2)
    out = [c2.subtree_map(), c2.mdsmap.auth_rank("/stay"),
           c2.read_file("/move/f"),
           outcome(lambda: c2.ranks[0].create("/move/g"))[:2]]
    c2.create("/move/g")
    return out + [sorted(c2.listdir("/move"))]


def cross_rank_rename(p):
    """tests/test_multimds.py::test_cross_rank_rename"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/a")
    c.mkdir("/b")
    c.migrate("/b", 1)
    c.create("/a/f")
    c.write_file("/a/f", b"crossing")
    c.rename("/a/f", "/b/f")
    out = [c.listdir("/a"), c.listdir("/b"), c.read_file("/b/f"),
           c.stat("/b/f")]
    c.create("/a/g")
    c.create("/b/g")
    return out + [outcome(lambda: c.rename("/a/g", "/b/g"))[:2],
                  c.listdir("/a")]


def two_clients_across_ranks(p):
    """tests/test_multimds.py::test_two_clients_coherent_across_ranks"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/shared")
    c.migrate("/shared", 1)
    a = p.mds.CephFSClient(c, client_id="a")
    b = p.mds.CephFSClient(c, client_id="b")
    c.create("/shared/f")
    a.write("/shared/f", b"from-a")
    out = [b.read("/shared/f")]
    b.write("/shared/f", b"from-b")
    return out + [a.read("/shared/f")]


def cross_rank_rename_drops_locks(p):
    """tests/test_multimds.py::test_cross_rank_rename_drops_locks"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/a")
    c.mkdir("/b")
    c.migrate("/b", 1)
    c.create("/a/f")
    out = [c.setlk("/a/f", owner="alice", exclusive=True)]
    c.rename("/a/f", "/b/f")
    out += [c.getlk("/b/f"), c.setlk("/b/f", owner="bob", exclusive=True)]
    ino = c.stat("/b/f")["ino"]
    return out + [ino, ino in c.ranks[0]._locks]


def balancer_moves_hot_subtree(p):
    """tests/test_multimds.py::test_balancer_moves_hot_subtree"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/hot")
    c.mkdir("/cold")
    c.create("/hot/f")
    for _ in range(60):
        c.read_file("/hot/f")
    c.listdir("/cold")
    bal = p.multimds.MDBalancer(c, min_requests=16)
    out = [bal.rank_loads(), bal.rebalance(), c.subtree_map(),
           c.read_file("/hot/f"), bal.rebalance(), dict(c.load)]
    return out


def replica_read_no_forward(p):
    """tests/test_multimds.py::test_cross_rank_replica_read_no_forward"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2, lease_s=5.0)
    c.mdsmap.set_auth("/a", 0)
    c.mkdir("/a")
    c.create("/a/f")
    c.write_file("/a/f", b"version-one")
    out = [dict(c.replica_stats), c.stat_via(1, "/a/f", now=100.0),
           dict(c.replica_stats), c.read_file_via(1, "/a/f", now=101.0),
           dict(c.replica_stats)]
    c.write_file("/a/f", b"version-TWO!")
    out += [dict(c.replica_stats), c.read_file_via(1, "/a/f", now=102.0),
            c.stat_via(1, "/a/f", now=162.0), dict(c.replica_stats)]
    return out


def replica_invalidation_on_namespace_ops(p):
    """tests/test_multimds.py::test_replica_invalidation_on_namespace_ops"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2, lease_s=30.0)
    c.mdsmap.set_auth("/a", 0)
    c.mkdir("/a")
    c.create("/a/doomed")
    c.write_file("/a/doomed", b"bye")
    out = [c.stat_via(1, "/a/doomed", now=10.0)]
    c.unlink("/a/doomed")
    out.append(outcome(lambda: c.stat_via(1, "/a/doomed", now=11.0))[:2])
    c.create("/a/old")
    c.stat_via(1, "/a/old", now=12.0)
    c.rename("/a/old", "/a/new")
    return out + [outcome(lambda: c.stat_via(1, "/a/old", now=13.0))[:2],
                  c.stat_via(1, "/a/new", now=14.0), dict(c.replica_stats)]


def dir_rename_revokes_child_replicas(p):
    """tests/test_multimds.py::test_dir_rename_revokes_child_replicas"""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2, lease_s=30.0)
    c.mdsmap.set_auth("/a", 0)
    c.mkdir("/a")
    c.mkdir("/a/d")
    c.create("/a/d/f")
    c.write_file("/a/d/f", b"inner")
    out = [c.stat_via(1, "/a/d/f", now=1.0)]
    c.rename("/a/d", "/a/e")
    return out + [outcome(lambda: c.stat_via(1, "/a/d/f", now=2.0))[:2],
                  c.stat_via(1, "/a/e/f", now=3.0)]


def default_layout_on_ec_pool(p):
    """The CephFS leg of the card's smoke at a small size: two ranks,
    metadata on the 3-replica pool and data on the erasure-coded pool
    (k=2, m=1, bitsliced) in Ceph's default layout (4 MiB objects and
    stripe unit), small files under several directories and a file of
    three objects, a rename across ranks, the balancer, an OSD lost and
    every file read again, and a rank restarted from its journal."""
    sim = make_sim(p)
    mon = p.mon.Monitor(sim.osdmap)
    r = p.rados.Rados(sim, mon).connect()
    meta, data = r.open_ioctx("rep"), r.open_ioctx("ec")
    layout = p.striper.FileLayout()
    c = p.multimds.MDSCluster(meta, data, n_ranks=2, layout=layout)
    rng = np.random.default_rng(11)
    files = {}
    for d in range(4):
        c.mkdir(f"/d{d}")
        for i in range(6):
            path = f"/d{d}/f{i}"
            files[path] = rng.integers(0, 256, int(rng.integers(1, 9000)),
                                       dtype=np.uint8).tobytes()
            c.create(path)
            c.write_file(path, files[path])
    files["/d0/big"] = rng.integers(0, 256, (8 << 20) + 12345,
                                    dtype=np.uint8).tobytes()
    c.create("/d0/big")
    c.write_file("/d0/big", files["/d0/big"])
    c.migrate("/d1", 1)
    c.rename("/d0/f0", "/d1/moved")
    files["/d1/moved"] = files.pop("/d0/f0")
    for _ in range(40):
        c.read_file("/d2/f1")
    moved = p.multimds.MDBalancer(c, min_requests=16).rebalance()
    out = [moved, c.subtree_map(),
           [c.read_file(f) == v for f, v in sorted(files.items())]]
    victim = sim.pg_up(sim.osdmap.pools[2], sim.object_pg(
        sim.osdmap.pools[2], f"{c.stat('/d0/big')['ino']:016x}.00000000"))[0]
    sim.fail_osd(victim)
    for reporter in range(len(sim.osds)):
        if reporter != victim and mon.report_failure(victim, reporter):
            break
    out.append([c.read_file(f) == v for f, v in sorted(files.items())])
    c2 = p.multimds.MDSCluster(meta, data, n_ranks=2, layout=layout)
    return out + [c2.subtree_map(), sorted(c2.listdir("/d1")),
                  [c2.read_file(f) == v for f, v in sorted(files.items())],
                  c2.stat("/d0/big")]


SCENARIOS = [journaler_append_replay_trim, mds_tree_and_file_io,
             mds_journal_replay, mds_file_locks, mds_locks_die_with_inode,
             caps_two_client_coherence, caps_writer_revokes_reader_cache,
             caps_lease_expiry_evicts, caps_evicted_client_reconnects_cold,
             single_mds_unaffected, mdsmap_longest_prefix_auth,
             wrong_rank_forwards, migration_flushes_caps,
             migration_survives_restart, cross_rank_rename,
             two_clients_across_ranks, cross_rank_rename_drops_locks,
             balancer_moves_hot_subtree, replica_read_no_forward,
             replica_invalidation_on_namespace_ops,
             dir_rename_revokes_child_replicas, default_layout_on_ec_pool]


# The scenarios whose two ranks both allocate inode numbers: the
# reference's ranks hand out one number twice there (ROADMAP C10), so
# it runs with the port's repair patched in.  Every other scenario runs
# the reference as it is.
BOTH_RANKS_ALLOCATE = (wrong_rank_forwards, cross_rank_rename,
                       two_clients_across_ranks)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_cephfs_equals_the_reference(scenario, monkeypatch):
    assert_twin(scenario, monkeypatch,
                repaired=scenario in BOTH_RANKS_ALLOCATE)


def test_cephfs_holds_the_reference_contract(monkeypatch):
    rec, _ = run_in(PORT, mds_tree_and_file_io, monkeypatch)
    assert rec[0] == b"hello metadata world" and rec[1] == ["alice"]
    assert rec[3]["size"] == 20 and rec[4] is True
    assert rec[5] == rec[5][:10] + b"SPLICE" + rec[5][16:]
    assert rec[7] == b"hello metadata world" and rec[-1] == []
    rec, _ = run_in(PORT, mds_journal_replay, monkeypatch)
    assert "proj" in rec[0] and rec[1] == ["b.txt", "c.txt"] and \
        rec[2] == b"A"
    rec, _ = run_in(PORT, wrong_rank_forwards, monkeypatch)
    assert rec[0] == ("raised", "ForwardError") and rec[1] == 1
    assert rec[3] == ["sub", "sub2"]
    rec, _ = run_in(PORT, balancer_moves_hot_subtree, monkeypatch)
    assert rec[0][0] > 60 and ("/hot", 1) in rec[1] and rec[4] == []
    rec, _ = run_in(PORT, replica_read_no_forward, monkeypatch)
    s0, s1, s2, s3, s4 = rec[0], rec[2], rec[4], rec[5], rec[8]
    assert s1["discovers"] == s0["discovers"] + 1
    assert s2["hits"] >= s0["hits"] + 1 and rec[3] == b"version-one"
    assert s3["invalidations"] >= s0["invalidations"] + 1
    assert rec[6] == b"version-TWO!" and s4["discovers"] == \
        s0["discovers"] + 3 and s4["expires"] == s3["expires"] + 1
    rec, _ = run_in(PORT, default_layout_on_ec_pool, monkeypatch)
    assert all(rec[2]) and all(rec[3]) and all(rec[6])
    assert rec[1]["/d1"] == 1 and "moved" in rec[5]


def test_cephfs_over_daemons(tmp_path):
    """tests/test_wire_gateways.py::test_cephfs_over_daemons in the
    port: journaled metadata and striped file I/O against four OSD
    daemons (each asked for the CPU); a fresh MDS over the same pools
    replays the journal."""
    d = str(tmp_path / "cluster")
    PORT.vstart.build_cluster_dir(d, n_osds=4, osds_per_host=2, fsync=False)
    v = PORT.vstart.Vstart(d)
    v.start(4, hb_interval=0.25)
    try:
        rc = PORT.remote.RemoteCluster(d)
        meta = PORT.remote_ioctx.RemoteIoCtx(rc, "rep")
        data = PORT.remote_ioctx.RemoteIoCtx(rc, "rep")
        fs = PORT.mds.CephFSClient(PORT.mds.MDS(meta, data))
        fs.mkdir("/docs")
        fs.write("/docs/readme.md", b"# served by OSD processes\n")
        assert fs.read("/docs/readme.md") == b"# served by OSD processes\n"
        assert fs.listdir("/docs") == ["readme.md"]
        fs.flush()
        fs2 = PORT.mds.CephFSClient(PORT.mds.MDS(meta, data))
        assert fs2.read("/docs/readme.md") == \
            b"# served by OSD processes\n"
        fs2.rename("/docs/readme.md", "/docs/README.md")
        assert fs2.listdir("/docs") == ["README.md"]
        rc.close()
    finally:
        v.stop()


def ranks_allocate_distinct_inodes(p):
    """Both ranks create files after the cluster starts: the reference's
    rank 1 counts from the InoTable it read at start and hands out rank
    0's numbers again, so the two files share their data objects; the
    port's ranks re-read the shared table and never collide (ROADMAP
    C10)."""
    meta, data = pools(p)
    c = p.multimds.MDSCluster(meta, data, n_ranks=2)
    c.mkdir("/a")
    c.mkdir("/b")
    c.migrate("/b", 1)
    c.create("/a/x")
    c.write_file("/a/x", b"rank zero's file")
    for i in range(3):
        c.create(f"/b/y{i}")
        c.write_file(f"/b/y{i}", b"rank one's file %d" % i)
    paths = ["/a", "/b", "/a/x"] + [f"/b/y{i}" for i in range(3)]
    return [[c.stat(q)["ino"] for q in paths], c.read_file("/a/x"),
            [c.read_file(f"/b/y{i}") for i in range(3)]]


def test_ranks_allocate_distinct_inodes(monkeypatch):
    ref, _ = run_in(REF, ranks_allocate_distinct_inodes, monkeypatch,
                    repaired=False)
    assert len(set(ref[0])) < 6 and ref[1] != b"rank zero's file"
    port = assert_twin(ranks_allocate_distinct_inodes, monkeypatch,
                       repaired=True)
    assert len(set(port[0])) == 6 and port[1] == b"rank zero's file"
    assert port[2] == [b"rank one's file %d" % i for i in range(3)]
