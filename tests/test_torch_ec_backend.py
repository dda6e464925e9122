"""The EC pool data path, end to end: the port against ceph_tpu.

Both packages get the same small in-memory ShardIO (one DeviceShardCache
per OSD; PG p keeps shard j on OSD (p + j) % N_OSDS, standing in for
CRUSH until placement is ported), the same objects (mixed sizes, two
ingest batches, stripe_unit 64 B to 4 KiB, k4m2 and k8m3) and the same
OSD failures.  Put (encode_to_writes + submit), degraded reads
(read_many_words, assemble_object_words, decode_signature_groups), reads
from state carried over with ceph_tpu_torch.convert, and a per-stripe
rebuild built as the simulator builds it (cluster/simulator.py:2212-2231)
must be bit-identical between the packages and equal to the payload.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.cluster import device_store as ref_store
from ceph_tpu.cluster import ec_backend as ref_backend
from ceph_tpu.ec import instance as ref_instance
from ceph_tpu.ops import xor_kernel as ref_xor
from ceph_tpu_torch import convert
from ceph_tpu_torch.cluster import device_store as port_store
from ceph_tpu_torch.cluster import ec_backend as port_backend
from ceph_tpu_torch.ec import instance
from ceph_tpu_torch.ops import gf, gf2, xor_kernel

N_OSDS = 12
POOL = 3
CASES = [(4, 2, 64), (4, 2, 4096), (8, 3, 256), (8, 3, 4096)]


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


class _CacheIO:
    """ShardIO over per-OSD DeviceShardCaches (either package's)."""

    def __init__(self, caches, n):
        self.caches = caches
        self.n = n
        self.attrs = {}
        self.durable = {}
        self.down = set()

    def up_set(self, pg):
        return [(pg + j) % N_OSDS for j in range(self.n)]

    def fanout(self, writes):
        done = []
        for w in writes:
            if w.target in self.down:
                continue
            key = (POOL, w.pg, w.name, w.shard)
            self.caches[w.target].put(key, w.ref, None)
            self.attrs[(w.pg, w.name, w.shard)] = w.attrs
            self.durable[(w.pg, w.name, w.shard)] = w.bytes_fn()
            done.append(w)
        return done

    def purge_shard(self, pg, shard, name, keep_target):
        for o, c in self.caches.items():
            if o != keep_target:
                c.evict((POOL, pg, name, shard))

    def get_shard_ref(self, pg, shard, name):
        osd = self.up_set(pg)[shard]
        if osd in self.down:
            return None
        return self.caches[osd].get((POOL, pg, name, shard), None)

    def get_shard_bytes(self, pg, shard, name):
        if self.up_set(pg)[shard] in self.down:
            return None
        return self.durable.get((pg, name, shard))

    def getattr(self, pg, name, shard, key):
        if self.up_set(pg)[shard] in self.down:
            return None
        return self.attrs.get((pg, name, shard), {}).get(key)

    def kill(self, osd):
        self.down.add(osd)
        self.caches[osd].clear()


class PortIO(_CacheIO, port_backend.ShardIO):
    pass


class RefIO(_CacheIO, ref_backend.ShardIO):
    pass


def profile(k, m):
    return {"k": str(k), "m": str(m), "technique": "cauchy_good",
            "layout": "bitsliced"}


def make_objects(k, su, seed):
    """Two ingest batches of mixed-size objects: [(names, payloads)]."""
    rng = np.random.default_rng(seed)
    stripe = k * max(32, su)
    out = []
    for b, n_obj in enumerate((4, 2)):
        sizes = rng.integers(1, 3 * stripe, size=n_obj)
        names = [f"b{b}o{i}" for i in range(n_obj)]
        out.append((names, [rng.integers(0, 256, size=int(s),
                                         dtype=np.uint8).tobytes()
                            for s in sizes]))
    return out


def put(pkg, k, m, su, seed=7):
    """Build one package's pool, put every object; returns (io, backend,
    writes, {name: (pg, geom, padded payload)})."""
    if pkg == "port":
        codec = instance().factory("jax", profile(k, m), device="cpu")
        io = PortIO({o: port_store.DeviceShardCache(o)
                     for o in range(N_OSDS)}, k + m)
        be = port_backend.ECBackend(codec, io)
        Geom = port_backend.ObjectGeom
    else:
        codec = ref_instance().factory("jax", profile(k, m))
        io = RefIO({o: ref_store.DeviceShardCache(o)
                    for o in range(N_OSDS)}, k + m)
        be = ref_backend.ECBackend(codec, io)
        Geom = ref_backend.ObjectGeom
    objs, writes = {}, []
    for names, blobs in make_objects(k, su, seed):
        S, U = be.batch_geometry([len(b) for b in blobs], su)
        geom = Geom(max(len(b) for b in blobs), S, U)
        padded = [b + bytes(S * k * U - len(b)) for b in blobs]
        pg_of = {nm: (i * 5 + len(names)) % N_OSDS
                 for i, nm in enumerate(names)}
        ws = be.encode_to_writes(pg_of, names, b"".join(padded), geom,
                                 sizes={nm: len(b)
                                        for nm, b in zip(names, blobs)})
        acked = be.submit(ws)
        assert sorted(acked) == sorted(names)
        writes.extend(ws)
        for nm, p in zip(names, padded):
            objs[nm] = (pg_of[nm], geom, p)
    return io, be, writes, objs


def random_buf(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape,
                        dtype=np.int64).astype(np.int32)


def words_of(padded, geom, k):
    return np.frombuffer(padded, dtype=np.int32).reshape(geom.S, k, geom.W)


def kill_sets(k, m):
    """No failure, and m failures (OSDs 0..m-2 and k), which cost the
    objects' PGs different mixes of data and parity shards."""
    return [[], list(range(m - 1)) + [k]]


@pytest.mark.parametrize("k,m,su", CASES)
def test_put_writes_equal_reference(k, m, su):
    _, _, pw, _ = put("port", k, m, su)
    _, _, rw, _ = put("ref", k, m, su)
    assert len(pw) == len(rw)
    for a, b in zip(pw, rw):
        assert (a.pg, a.shard, a.target, a.name, a.attrs) == \
            (b.pg, b.shard, b.target, b.name, b.attrs)
        assert a.bytes_fn() == b.bytes_fn()
        assert a.ref.size == b.ref.size
        assert np.array_equal(np.asarray(a.ref, dtype=np.int32),
                              np.asarray(b.ref, dtype=np.int32))


@pytest.mark.parametrize("k,m,su", CASES)
def test_degraded_reads_equal_reference_and_payload(k, m, su):
    for kill in kill_sets(k, m):
        pio, pbe, _, objs = put("port", k, m, su)
        rio, rbe, _, _ = put("ref", k, m, su)
        for osd in kill:
            pio.kill(osd)
            rio.kill(osd)
        names = sorted(objs)
        items = [(objs[nm][0], nm, objs[nm][1]) for nm in names]
        got = pbe.read_many_words(items)
        want = rbe.read_many_words(items)
        for nm, g, w in zip(names, got, want):
            pg, geom, padded = objs[nm]
            truth = words_of(padded, geom, k)
            assert np.array_equal(g.numpy(), np.asarray(w, np.int32)), nm
            assert np.array_equal(g.numpy(), truth), (nm, kill)
            one = pbe.assemble_object_words(pbe.gather_refs(pg, nm), geom)
            assert np.array_equal(one.numpy(), truth), (nm, kill)
            one_ref = rbe.assemble_object_words(rbe.gather_refs(pg, nm),
                                                geom)
            assert np.array_equal(np.asarray(one_ref, np.int32), truth)


@pytest.mark.parametrize("k,m,su", CASES)
def test_decode_signature_groups_equal_reference(k, m, su):
    pio, pbe, _, objs = put("port", k, m, su)
    rio, rbe, _, _ = put("ref", k, m, su)
    for osd in kill_sets(k, m)[1]:
        pio.kill(osd)
        rio.kill(osd)
    pjobs, rjobs, truths = [], [], []
    for nm in sorted(objs):
        pg, geom, padded = objs[nm]
        prefs, rrefs = pbe.gather_refs(pg, nm), rbe.gather_refs(pg, nm)
        plan, missing = pbe.plan(list(prefs))
        assert (plan, missing) == rbe.plan(list(rrefs))
        pjobs.append((plan, port_store.assemble_refs(
            [prefs[c] for c in plan], geom.S, geom.W), missing))
        rjobs.append((plan, ref_store.assemble_refs(
            [rrefs[c] for c in plan], geom.S, geom.W), missing))
        truths.append(words_of(padded, geom, k)[:, missing])
    assert any(j[2] for j in pjobs)
    for g, w, t in zip(pbe.decode_signature_groups(pjobs),
                       rbe.decode_signature_groups(rjobs), truths):
        assert np.array_equal(g.numpy(), np.asarray(w, np.int32))
        assert np.array_equal(g.numpy(), t)


@pytest.mark.parametrize("k,m,su", CASES)
def test_reads_from_converted_reference_state(k, m, su):
    """The reference package stages the objects; its shards cross to
    the port as NumPy and the port serves the degraded reads."""
    rio, _, _, objs = put("ref", k, m, su)
    caches = {}
    for osd, cache in rio.caches.items():
        entries = {key: (np.asarray(e.arr.materialize(), dtype=np.int32),
                         e.csum) for key, e in cache._entries.items()}
        caches[osd] = convert.shard_cache_from_numpy(entries, "cpu",
                                                     owner=osd)
        back = convert.shard_cache_to_numpy(caches[osd])
        assert sorted(back) == sorted(entries)
        for key, (words, csum) in entries.items():
            assert np.array_equal(back[key][0], words)
            assert back[key][1] == csum
    pio = PortIO(caches, k + m)
    pio.attrs = dict(rio.attrs)
    pbe = port_backend.ECBackend(
        instance().factory("jax", profile(k, m), device="cpu"), pio)
    for osd in kill_sets(k, m)[1]:
        pio.kill(osd)
    names = sorted(objs)
    got = pbe.read_many_words([(objs[nm][0], nm, objs[nm][1])
                               for nm in names])
    for nm, g in zip(names, got):
        pg, geom, padded = objs[nm]
        assert np.array_equal(g.numpy(), words_of(padded, geom, k)), nm


def rebuild_inputs(store, be, io, objs, n, m, zeros):
    """(names, lost shards, full [T, n, W] stack with lost columns
    zeroed, per-stripe full-width masks [T, 8m, 8n]) of every object of
    the widest geometry that lost a shard — simulator.py:2212-2231."""
    geom = max((g for _, g, _ in objs.values()), key=lambda g: g.S * g.U)
    names, lost_of, blocks, tabs = [], {}, [], []
    for nm in sorted(objs):
        pg, g, _ = objs[nm]
        refs = be.gather_refs(pg, nm)
        lost = [c for c in range(n) if c not in refs]
        if (g.S, g.U) != (geom.S, geom.U) or not lost:
            continue
        names.append(nm)
        lost_of[nm] = lost
        R, used = be.codec.decode_matrix(sorted(refs), lost)
        small = gf.gf8_bitmatrix(R)
        big = np.zeros((8 * m, 8 * n), dtype=np.uint8)
        for jj, c in enumerate(used):
            big[:8 * len(lost), 8 * c:8 * c + 8] = \
                small[:, 8 * jj:8 * jj + 8]
        tabs.extend([gf2.bitmatrix_masks(big)] * g.S)
        blocks.append(store.assemble_object(
            [refs.get(c) for c in range(n)], zeros((g.S, len(lost), g.W)),
            g.S, g.W))
    return names, lost_of, blocks, np.stack(tabs), geom


@pytest.mark.parametrize("k,m,su", CASES)
def test_per_stripe_rebuild_equals_lost_shards(k, m, su):
    n = k + m
    pio, pbe, writes, objs = put("port", k, m, su)
    rio, rbe, _, _ = put("ref", k, m, su)
    for osd in kill_sets(k, m)[1]:
        pio.kill(osd)
        rio.kill(osd)
    names, lost_of, pblocks, masks, geom = rebuild_inputs(
        port_store, pbe, pio, objs, n, m,
        lambda s: torch.zeros(s, dtype=torch.int32))
    _, _, rblocks, rmasks, _ = rebuild_inputs(
        ref_store, rbe, rio, objs, n, m,
        lambda s: np.zeros(s, dtype=np.int32))
    assert names and np.array_equal(masks, rmasks)
    T, W = len(names) * geom.S, geom.W
    full = torch.cat(pblocks).reshape(T, 8 * n, W // 8)
    got = xor_kernel.xor_matmul_w32(torch.from_numpy(masks), full)
    got = got.reshape(T, m, W).numpy()
    rfull = np.concatenate([np.asarray(b, np.int32) for b in rblocks])
    want = np.asarray(ref_xor.xor_matmul_w32(
        rmasks, rfull.reshape(T, 8 * n, W // 8)), np.int32).reshape(T, m, W)
    assert np.array_equal(got, want)
    durable = {(w.name, w.shard): w.bytes_fn() for w in writes}
    for j, nm in enumerate(names):
        for r, c in enumerate(lost_of[nm]):
            lost = np.frombuffer(durable[(nm, c)], dtype=np.int32)
            assert np.array_equal(
                got[j * geom.S:(j + 1) * geom.S, r].reshape(-1), lost), \
                (nm, c)


def test_staging_helpers_equal_reference():
    """assemble_windows, materialize_bulk and the DeviceShardCache
    bookkeeping (dirty entries, checksum invalidation, eviction) agree
    with the reference package on the same inputs."""
    import jax.numpy as jnp
    rng = np.random.default_rng(21)
    bufs = [random_buf(rng, (12, 3, 16)), random_buf(rng, (12, 2, 16))]
    cols = [(0, 0), (0, 2), (1, 1)]
    starts = [0, 4, 9]
    got = port_store.assemble_windows(
        [(torch.from_numpy(bufs[b]), c) for b, c in cols], starts, 3)
    want = ref_store.assemble_windows(
        [(jnp.asarray(bufs[b]), c) for b, c in cols], starts, 3)
    assert np.array_equal(got.numpy(), np.asarray(want, np.int32))

    pbuf, rbuf = torch.from_numpy(bufs[0]), jnp.asarray(bufs[0])
    prefs = [port_store.ShardRef(pbuf, 1, axis=1, s0=2, s1=5),
             port_store.ShardRef(pbuf.reshape(3, -1), 2)]
    rrefs = [ref_store.ShardRef(rbuf, 1, axis=1, s0=2, s1=5),
             ref_store.ShardRef(rbuf.reshape(3, -1), 2)]
    for a, b in zip(port_store.materialize_bulk(prefs),
                    ref_store.materialize_bulk(rrefs)):
        assert np.array_equal(a, np.asarray(b, np.int32))

    caches = (port_store.DeviceShardCache(0), ref_store.DeviceShardCache(0))
    for cache, refs in zip(caches, (prefs, rrefs)):
        cache.put((1, 0, "a", 0), refs[0], None)       # dirty
        cache.put((1, 0, "a", 1), refs[1], 77)         # clean, csum 77
        cache.put((1, 0, "b", 0), refs[0], 5)
        assert cache.dirty_get((1, 0, "a", 0)) is refs[0]
        assert cache.get((1, 0, "a", 0), None) is refs[0]
        assert cache.get((1, 0, "a", 1), 77) is refs[1]
        assert cache.get((1, 0, "a", 1), 78) is None   # stale: evicted
        assert not cache.has((1, 0, "a", 1))
        cache.evict_object(1, 0, "b")
        assert [k for k, _ in cache.dirty_items()] == [(1, 0, "a", 0)]
    assert caches[0].stats() == caches[1].stats()

