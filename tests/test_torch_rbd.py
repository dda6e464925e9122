"""The port's block tier against ceph_tpu's.

``client/rbd.py`` (images striped over RADOS objects: create, list,
remove, I/O across object boundaries, resize, snapshots, protect, clone,
flatten, header watch), ``fs/journaler.py`` (append, replay, trim),
``client/rbd_mirror.py`` (journal-first images replayed onto a second
cluster) and ``client/neorados.py`` (the asyncio client).  Each scenario
of tests/test_kv_rbd.py, tests/test_rbd_cli.py (its image and snapshot
family through ``RBD``/``Image``), tests/test_fs_rgw.py's journaler,
tests/test_mirror_s3.py's rbd-mirror and tests/test_neorados_dashboard.py
runs in both packages over a ClusterSim, the port's on the CPU, and
records every read, size, snapshot list, journal position and exception
name: the records must be equal.  The image cases run on the erasure-coded
pool (bitsliced, the port's K1 path) and on the replicated one.  The
neorados flow also runs over the port's vstart daemons; its record must
equal the reference's over the sim.
"""
import asyncio
import types

import numpy as np
import pytest
import torch

import ceph_tpu_torch

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def _pkg(name):
    if name == "ref":
        from ceph_tpu.client import neorados, rados, rbd, rbd_mirror
        from ceph_tpu.cluster import monitor, osdmap, simulator
        from ceph_tpu.fs import journaler
        from ceph_tpu.placement import builder, crush_map
    else:
        from ceph_tpu_torch.client import neorados, rados, rbd, rbd_mirror
        from ceph_tpu_torch.cluster import monitor, osdmap, simulator
        from ceph_tpu_torch.fs import journaler
        from ceph_tpu_torch.placement import builder, crush_map
    return types.SimpleNamespace(
        name=name, neorados=neorados, rados=rados, rbd=rbd,
        mirror=rbd_mirror, mon=monitor, om=osdmap, sim=simulator,
        journaler=journaler, builder=builder, cm=crush_map)


REF, PORT = _pkg("ref"), _pkg("port")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def make_sim(pkg, small=True):
    """tests/test_snaps.py's make_sim (``small``: 4 hosts x 2 OSDs, k=2
    m=1, 16 PGs) or tests/test_simulator.py's (8 hosts x 3 OSDs, k=4
    m=2, 32 PGs)."""
    om_mod, cm = pkg.om, pkg.cm
    hosts, per, seed, pg_num, k, m = (4, 2, 3, 16, 2, 1) if small else \
        (8, 3, 0, 32, 4, 2)
    cmap, root = pkg.builder.build_flat_cluster(n_hosts=hosts,
                                                osds_per_host=per, seed=seed)
    for op in (cm.RULE_CHOOSELEAF_FIRSTN, cm.RULE_CHOOSELEAF_INDEP):
        cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                     (op, 0, pkg.builder.TYPE_HOST),
                                     (cm.RULE_EMIT, 0, 0)]))
    om = om_mod.OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(om_mod.PGPool(id=1, name="rep", type=om_mod.POOL_REPLICATED,
                              size=3, pg_num=pg_num, crush_rule=0))
    om.add_pool(om_mod.PGPool(id=2, name="ec", type=om_mod.POOL_ERASURE,
                              size=k + m, pg_num=pg_num, crush_rule=1,
                              erasure_code_profile="p"))
    sim = pkg.sim.ClusterSim(om)
    sim.create_ec_profile("p", {"plugin": "jax", "k": str(k), "m": str(m)})
    return sim


def open_ioctx(pkg, sim, pool):
    return pkg.rados.Rados(sim, pkg.mon.Monitor(sim.osdmap)).connect() \
        .open_ioctx(pool)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 — compared by name
        return ("raised", type(e).__name__)


# ------------------------------------------------------------------ rbd ---

def rbd_create_list_remove(pkg, io):
    rbd, Image = pkg.rbd.RBD(io), pkg.rbd.Image
    rbd.create("img1", size=1 << 20, order=16)
    rbd.create("img2", size=1 << 18, order=16)
    out = [rbd.list(), _outcome(lambda: rbd.create("img1", size=1))]
    rbd.remove("img2")
    out += [rbd.list(), _outcome(lambda: rbd.remove("img2")),
            _outcome(lambda: Image(io, "img2")),
            sorted(io.list_objects())]
    return out


def rbd_io_across_object_boundaries(pkg, io):
    pkg.rbd.RBD(io).create("disk", size=1 << 20, order=16)
    img = pkg.rbd.Image(io, "disk")
    blob = np.random.default_rng(3).integers(0, 256, size=200_000) \
        .astype(np.uint8).tobytes()
    off = (1 << 16) - 777
    out = [img.write(off, blob), img.read(off, len(blob)),
           img.read(0, 100)]
    img.write(off + 1000, b"PATCH")
    out += [img.read(off, len(blob)),
            _outcome(lambda: img.write((1 << 20) - 2, b"toolong")),
            img.read((1 << 20) - 100, 500), img._written_objects()]
    return out


def rbd_resize(pkg, io):
    pkg.rbd.RBD(io).create("vol", size=1 << 18, order=16)
    img = pkg.rbd.Image(io, "vol")
    img.write(0, b"head")
    img.write((1 << 18) - 8, b"tail-end")
    img.resize(1 << 16)
    img2 = pkg.rbd.Image(io, "vol")
    out = [img.size(), img2.size(), img2.read(0, 4)]
    img2.resize(1 << 18)
    out += [img2.read((1 << 18) - 8, 8), img2._written_objects()]
    return out


def rbd_prefix_overlap_and_unaligned_shrink(pkg, io):
    rbd, Image = pkg.rbd.RBD(io), pkg.rbd.Image
    rbd.create("a", size=1 << 18, order=16)
    rbd.create("a.b", size=1 << 18, order=16)
    Image(io, "a.b").write(0, b"dotted")
    rbd.remove("a")
    out = [Image(io, "a.b").read(0, 6)]
    rbd.create("v", size=1 << 18, order=16)
    img = Image(io, "v")
    img.write(1 << 16, b"X" * 5000)
    img.resize((1 << 16) + 100)
    img.resize(1 << 18)
    out += [img.read((1 << 16) + 100, 200), img.read(1 << 16, 100),
            rbd.list()]
    return out


def rbd_snap_and_clone_family(pkg, io):
    """tests/test_rbd_cli.py's lifecycle and snapshot/clone family,
    through ``RBD``/``Image`` (the CLI's own calls)."""
    rbd, Image = pkg.rbd.RBD(io), pkg.rbd.Image
    out = []
    rec = out.append
    rbd.create("disk", size=1 << 22)
    rec(rbd.list())
    rec(_outcome(lambda: rbd.create("disk", size=1024)))
    d = Image(io, "disk")
    rec((d.size(), d.parent))
    d.resize(1 << 23)
    rec(Image(io, "disk").size())
    rbd.remove("disk")
    rec(rbd.list())
    rbd.create("base", size=1 << 22)
    Image(io, "base").write(0, b"golden-bytes")
    rec(Image(io, "base").snap_create("gold"))
    rec(Image(io, "base").snap_list())
    Image(io, "base").write(0, b"BROKEN-BYTES")
    rec(Image(io, "base", snapshot="gold").read(0, 12))
    Image(io, "base").snap_rollback("gold")
    rec(Image(io, "base").read(0, 12))
    Image(io, "base").protect_snap("gold")
    rbd.clone("base", "gold", "child")
    rec(Image(io, "base").snaps["gold"].get("children"))
    Image(io, "base").snap_create("other")
    Image(io, "base").protect_snap("other")
    rbd.clone("base", "other", "child2")
    rec({s: r.get("children") for s, r in Image(io, "base").snaps.items()})
    Image(io, "child2").flatten()
    Image(io, "base").unprotect_snap("other")
    Image(io, "base").snap_remove("other")
    rec(Image(io, "child").read(0, 12))
    rec(_outcome(lambda: Image(io, "base").snap_remove("gold")))
    child = Image(io, "child")
    child.write(5, b"-CHILD-")
    rec((child.read(0, 16), Image(io, "base").read(0, 16)))
    child.flatten()
    rec(Image(io, "child").parent)
    Image(io, "base").unprotect_snap("gold")
    Image(io, "base").snap_remove("gold")
    rec((Image(io, "base").snap_list(), Image(io, "child").read(0, 16),
         Image(io, "child2").read(0, 12), rbd.list()))
    rec(_outcome(lambda: Image(io, "base").snap_create("gold")))
    rec(_outcome(lambda: Image(io, "base", snapshot="nope")))
    return out


def rbd_watch_header(pkg, io):
    """Header watchers hear resizes and snapshots from any handle."""
    pkg.rbd.RBD(io).create("w", size=1 << 18, order=16)
    img = pkg.rbd.Image(io, "w")
    seen = []
    wid = img.watch_header(lambda *a: seen.append(a[-1]))
    other = pkg.rbd.Image(io, "w")
    other.resize(1 << 19)
    other.snap_create("s")
    img.refresh()
    out = [seen, img.size(), img.snap_list()]
    img.unwatch_header(wid)
    other.resize(1 << 17)
    out += [len(seen), pkg.rbd.Image(io, "w").size()]
    return out


RBD_SCENARIOS = [rbd_create_list_remove, rbd_io_across_object_boundaries,
                 rbd_resize, rbd_prefix_overlap_and_unaligned_shrink,
                 rbd_snap_and_clone_family, rbd_watch_header]


def run_on(pkg, scenario, pool, small):
    sim = make_sim(pkg, small=small)
    try:
        return scenario(pkg, open_ioctx(pkg, sim, pool))
    finally:
        sim.shutdown()


@pytest.mark.parametrize("pool", ["ec", "rep"])
@pytest.mark.parametrize("scenario", RBD_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_rbd_equals_the_reference(scenario, pool):
    # tests/test_kv_rbd.py runs on test_simulator's sim, the rest on
    # test_snaps'
    small = scenario not in RBD_SCENARIOS[:4]
    assert run_on(PORT, scenario, pool, small) == \
        run_on(REF, scenario, pool, small)


def test_rbd_holds_the_reference_contract():
    out = run_on(PORT, rbd_create_list_remove, "ec", False)
    assert out[0] == ["img1", "img2"]
    assert out[1] == ("raised", "ImageExists") and out[2] == ["img1"]
    assert out[3] == ("raised", "ImageNotFound") == out[4]
    out = run_on(PORT, rbd_io_across_object_boundaries, "ec", False)
    blob = np.random.default_rng(3).integers(0, 256, size=200_000) \
        .astype(np.uint8).tobytes()
    want = bytearray(blob)
    want[1000:1005] = b"PATCH"
    assert out[1] == blob and out[2] == b"\0" * 100
    assert out[3] == bytes(want) and out[4] == ("raised", "ValueError")
    out = run_on(PORT, rbd_resize, "ec", False)
    assert out[:3] == [1 << 16, 1 << 16, b"head"] and out[3] == b"\0" * 8
    out = run_on(PORT, rbd_prefix_overlap_and_unaligned_shrink, "ec", False)
    assert out[:3] == [b"dotted", b"\0" * 200, b"X" * 100]
    out = run_on(PORT, rbd_snap_and_clone_family, "rep", True)
    assert out[0] == ["disk"] and out[1] == ("raised", "ImageExists")
    assert out[2] == (1 << 22, None) and out[3] == 1 << 23
    assert out[4] == [] and out[6] == ["gold"]
    assert out[7] == b"golden-bytes" and out[8] == b"golden-bytes"
    assert out[9] == ["child"]
    assert out[10] == {"gold": ["child"], "other": ["child2"]}
    assert out[11] == b"golden-bytes"
    assert out[12] == ("raised", "ValueError")
    assert out[13] == (b"golde-CHILD-\0\0\0\0", b"golden-bytes\0\0\0\0")
    assert out[14] is None
    out = run_on(PORT, rbd_watch_header, "ec", True)
    assert out[0] and out[1] == 1 << 19 and out[2] == ["s"]


def test_ec_pool_snapshot_read_after_partial_write_pins_the_reference():
    """A defect both packages share (ROADMAP C): on an erasure-coded pool
    a partial write (``ClusterSim.write``'s RMW path) replaces the
    object's ObjectInfo and drops its SnapSet, so a read at an earlier
    snapshot returns the head.  The COW clone object itself holds the
    snapshot's bytes.  Pinned equal to the reference; the replicated
    pool answers right."""
    def case(pkg, pool):
        sim = make_sim(pkg)
        try:
            io = open_ioctx(pkg, sim, pool)
            io.write_full("o", b"A" * 100)
            sid = io.snap_create("s1")
            io.write("o", b"B" * 10, offset=0)
            return [io.read("o", snap=sid)[:12], io.read("o")[:12],
                    sim.get(io.pool_id, f"o@{sid}")[:12]]
        finally:
            sim.shutdown()
    ec = case(PORT, "ec")
    assert ec == case(REF, "ec")
    assert ec == [b"B" * 10 + b"AA", b"B" * 10 + b"AA", b"A" * 12]
    assert case(PORT, "rep") == [b"A" * 12, b"B" * 10 + b"AA", b"A" * 12]


# ------------------------------------------------------------- journaler --

def journaler(pkg, io):
    """tests/test_fs_rgw.py's journal: append, reopen and replay, trim;
    then a torn tail ends the replay."""
    J = pkg.journaler.Journaler
    j = J(io, "t1", object_bytes=128)
    seqs = [j.append(f"entry-{i}".encode() * 4) for i in range(20)]
    j2 = J(io, "t1", object_bytes=128)
    got = list(j2.replay())
    out = [seqs, got, (j2.first, j2.active, j2.seq)]
    out += [j2.trim_to(15), [s for s, _ in j2.replay()],
            (j2.first, j2.active, j2.seq), sorted(io.list_objects())]
    last = j2._obj_oid(j2.active)
    blob = io.read(last)
    io.write_full(last, blob[:-3])
    out += [[s for s, _ in J(io, "t1", object_bytes=128).replay()],
            j2.append(b"after-tear"), j2.trim_to(0)]
    return out


@pytest.mark.parametrize("pool", ["ec", "rep"])
def test_journaler_equals_the_reference(pool):
    port = run_on(PORT, journaler, pool, True)
    assert port == run_on(REF, journaler, pool, True)
    assert port[0] == list(range(20)) and [s for s, _ in port[1]] == \
        list(range(20))
    assert port[1][7][1] == b"entry-7" * 4 and port[2][1] > 0
    assert port[3] > 0 and port[4][-1] == 19 and 15 in port[4]


# ------------------------------------------------------------ rbd-mirror --

def rbd_mirror(pkg, pool):
    """tests/test_mirror_s3.py's journal replication between two
    clusters."""
    sim_a, sim_b = make_sim(pkg), make_sim(pkg)
    try:
        io_a, io_b = open_ioctx(pkg, sim_a, pool), \
            open_ioctx(pkg, sim_b, pool)
        pkg.rbd.RBD(io_a).create("vol", size=1 << 18, order=16)
        prim = pkg.mirror.JournaledImage(io_a, "vol")
        rng = np.random.default_rng(9)
        prim.write(0, rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
        prim.write(1 << 16, b"second object " * 100)
        rep = pkg.mirror.MirrorReplayer(io_a, io_b, "vol", peer="site-b")
        out = [rep.committed_position(), rep.replay()]
        sec = pkg.rbd.Image(io_b, "vol")
        out += [sec.read(0, 5000), prim.read(0, 5000) == sec.read(0, 5000),
                sec.read(1 << 16, 1400), rep.replay(),
                rep.committed_position()]
        prim.write(100, b"delta")
        prim.resize(1 << 19)
        prim.snap_create("m1")
        out.append(rep.replay())
        sec.refresh()
        out += [sec.size(), sec.read(100, 5), sec.snap_list(),
                rep.committed_position(), prim.journal.seq,
                (prim.journal.first, prim.journal.active)]
        out += [rep.trim_committed(), rep.replay(),
                pkg.mirror.MirrorReplayer(io_a, io_b, "vol",
                                          peer="site-b").replay(),
                sec.read(0, 1 << 19) == prim.read(0, 1 << 19),
                sorted(io_a.list_objects()), sorted(io_b.list_objects())]
        return out
    finally:
        sim_a.shutdown()
        sim_b.shutdown()


@pytest.mark.parametrize("pool", ["ec", "rep"])
def test_rbd_mirror_equals_the_reference(pool):
    port = rbd_mirror(PORT, pool)
    assert port == rbd_mirror(REF, pool)
    assert port[0] == -1 and port[1] >= 2 and port[3] and port[5] == 0
    assert port[7] == 3 and port[8] == 1 << 19 and port[9] == b"delta"
    assert port[10] == ["m1"] and port[15:17] == [0, 0] and port[17]


# -------------------------------------------------------------- neorados --

async def neorados_flow(ar, pool="rep", n=16, size=64):
    """tests/test_neorados_dashboard.py's flow: concurrent writes then
    reads, stat, listing, remove; a missing read by exception name."""
    io = await ar.open_ioctx(pool)
    await io.write_full("a", b"alpha")
    await asyncio.gather(*[io.write_full(f"o{i}", bytes([i]) * size)
                           for i in range(n)])
    datas = await asyncio.gather(*[io.read(f"o{i}") for i in range(n)])
    out = [list(datas), await io.read("a"), (await io.stat("a")).size,
           sorted(await io.list_objects())]
    await io.write("a", b"ph", offset=1)
    out.append(await io.read("a", 3, 1))
    await io.remove("a")
    try:
        await io.read("a")
        out.append("read after remove")
    except Exception as e:          # noqa: BLE001 — compared by name
        out.append(type(e).__name__)
    io.close()
    return out


def neorados_over_sim(pkg):
    sim = make_sim(pkg)
    try:
        rados = pkg.rados.Rados(sim, pkg.mon.Monitor(sim.osdmap)).connect()

        async def flow():
            async with pkg.neorados.AsyncRados(rados) as ar:
                return await neorados_flow(ar)
        return asyncio.run(flow())
    finally:
        sim.shutdown()


def test_neorados_over_the_sim_equals_the_reference():
    port = neorados_over_sim(PORT)
    assert port == neorados_over_sim(REF)
    assert port[0] == [bytes([i]) * 64 for i in range(16)]
    assert port[1:3] == [b"alpha", 5] and "o7" in port[3]
    assert port[4] == b"phh" and port[5] == "ObjectNotFound"


def test_neorados_wraps_the_ioctxs_async_submission():
    """Data verbs ride the ioctx's ``aio_*`` completions; a foreign
    ioctx without them runs on the executor, and an ioctx that owns
    its executor shuts it down on close."""
    calls = []

    class Foreign:
        def write_full(self, oid, data):
            calls.append(("write_full", oid))

        def read(self, oid, length=None, offset=0, snap=None):
            calls.append(("read", oid))
            return b"r"

    async def flow():
        io = PORT.neorados.AsyncIoCtx(Foreign())
        await io.write_full("x", b"1")
        got = await io.read("x")
        io.close()
        return got, io._pool._shutdown
    assert asyncio.run(flow()) == (b"r", True)
    assert calls == [("write_full", "x"), ("read", "x")]


@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    """A 4-OSD port vstart cluster (each daemon asked for the CPU) and
    a RemoteCluster on the CPU, shared by the module."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    d = str(tmp_path_factory.mktemp("neorados") / "cluster")
    build_cluster_dir(d, n_osds=4, osds_per_host=2, fsync=False)
    v = Vstart(d)
    v.start(4, hb_interval=0.25)
    try:
        rc = RemoteCluster(d)
        yield rc
        rc.close()
    finally:
        v.stop()
        ceph_tpu_torch.set_default_device(prev)


def test_neorados_over_daemons_equals_the_reference_over_the_sim(
        port_cluster):
    """The same awaitable flow against the port's process cluster (its
    ``RemoteIoCtx``) answers as the reference's AsyncRados over its sim."""
    async def flow():
        async with PORT.neorados.AsyncRados(port_cluster) as ar:
            return await neorados_flow(ar)
    port = asyncio.run(flow())
    assert port == neorados_over_sim(REF)


def test_neorados_over_daemons_many_concurrent_writes(port_cluster):
    """tests/test_neorados_dashboard.py's daemon case: eight 256-byte
    writes gathered at once, then eight reads."""
    async def flow():
        async with PORT.neorados.AsyncRados(port_cluster) as ar:
            io = await ar.open_ioctx("rep")
            await asyncio.gather(*[io.write_full(f"w{i}", bytes([i]) * 256)
                                   for i in range(8)])
            return await asyncio.gather(*[io.read(f"w{i}")
                                          for i in range(8)])
    assert asyncio.run(flow()) == [bytes([i]) * 256 for i in range(8)]


def test_fs_namespace_exports_the_references_names():
    """The port's ``fs`` package exports what the reference's does, and
    each name is the port's own class, defined in ``ceph_tpu_torch.fs``."""
    import ceph_tpu.fs as ref_fs
    import ceph_tpu_torch.fs as port_fs

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}
    assert public(port_fs) == public(ref_fs)
    for name in public(port_fs):
        obj = getattr(port_fs, name)
        if isinstance(obj, type):
            assert obj.__module__.startswith("ceph_tpu_torch.fs."), name
            assert obj is not getattr(ref_fs, name)
    assert port_fs.Journaler is PORT.journaler.Journaler
