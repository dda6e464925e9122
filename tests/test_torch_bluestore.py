"""The port's durable store (cluster/bluestore.py and its block device,
KV and WAL, host-only copies) against ceph_tpu.

Each scenario runs the same transactions on the port's BlueStore and on
the reference's, side by side, and holds the two to the same read-back,
the same stat and the same per-block blob csums (exact).  The trusted
csums of the wire tier are the focus: bytes that arrive with verified
sub-crcs are stored under exactly those csums, without a store scan,
and wrong ones fail the next read.
"""
import os

import pytest
import torch

from ceph_tpu.cluster.bluestore import BlueStore as RefBlueStore
from ceph_tpu.cluster.objectstore import Transaction as RefTransaction
from ceph_tpu.common import crcutil as ref_crcutil
from ceph_tpu_torch.cluster.bluestore import BlueStore
from ceph_tpu_torch.cluster.objectstore import (ChecksumError,
                                                ObjectStoreError,
                                                Transaction)
from ceph_tpu_torch.common import crcutil
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.native_bridge import AllocatorError

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

C = (1, 0)


def mk(tmp_path, name="bs", cls=BlueStore, **kw):
    kw.setdefault("device_bytes", 1 << 22)          # 4 MiB
    kw.setdefault("min_alloc", 512)
    kw.setdefault("fsync", False)
    return cls(str(tmp_path / name), **kw)


class Pair:
    """The port's store and the reference's, fed the same ops."""

    def __init__(self, tmp_path, **kw):
        self.port = mk(tmp_path, "port", BlueStore, **kw)
        self.ref = mk(tmp_path, "ref", RefBlueStore, **kw)

    def apply(self, build):
        """``build(Transaction)`` -> a transaction; applied to both."""
        self.port.apply_transaction(build(Transaction()))
        self.ref.apply_transaction(build(RefTransaction()))

    def blob_csums(self, oid):
        p = [list(b.csums) for b in self.port._get(C, oid).blobs]
        r = [list(b.csums) for b in self.ref._get(C, oid).blobs]
        return p, r

    def check(self, oid, want=None):
        got = self.port.read(C, oid)
        assert got == self.ref.read(C, oid)
        if want is not None:
            assert got == want
        p, r = self.blob_csums(oid)
        assert p == r
        assert self.port.stat(C, oid) == self.ref.stat(C, oid)

    def close(self):
        self.port.close()
        self.ref.close()


def _scans():
    return perf("wire.zero").dump()


# ---------------------------------------------------------- trusted csums --

def test_bluestore_uses_trusted_csums_falsifiably(tmp_path):
    """Right csums: write + read round-trip with ZERO store scans, under
    exactly the blob csums the reference stores.  WRONG csums: recorded
    verbatim, and the next read fails the checksum."""
    pair = Pair(tmp_path, device_bytes=64 << 20, min_alloc=4096)
    data = os.urandom(3 * 4096 + 100)
    cs = crcutil.Csums.scan(data, site="test")
    rcs = ref_crcutil.Csums.scan(data, site="test")
    s0 = _scans()
    pair.port.apply_transaction(Transaction().write_full(
        C, "good", data, csums=cs, copy=False))
    s1 = _scans()
    assert s1.get("scan_store_bytes", 0) == s0.get("scan_store_bytes", 0)
    assert s1.get("trusted_csum_bytes", 0) - \
        s0.get("trusted_csum_bytes", 0) == len(data)
    pair.ref.apply_transaction(RefTransaction().write_full(
        C, "good", data, csums=rcs, copy=False))
    pair.check("good", data)
    assert pair.blob_csums("good")[0] == [list(cs.subs)]
    bad = crcutil.Csums(4096, [c ^ 0xDEAD for c in cs.subs], len(data))
    pair.port.apply_transaction(Transaction().write_full(
        C, "bad", data, csums=bad, copy=False))
    with pytest.raises(ChecksumError):
        pair.port.read(C, "bad")
    # geometry mismatch (wrong block size) falls back to the scan
    odd = crcutil.Csums(1024, [0], 1024)
    s0 = _scans()
    pair.port.apply_transaction(Transaction().write_full(
        C, "odd", data, csums=odd, copy=False))
    assert _scans().get("scan_store_bytes", 0) - \
        s0.get("scan_store_bytes", 0) == len(data)
    pair.ref.apply_transaction(RefTransaction().write_full(C, "odd", data))
    pair.check("odd", data)
    pair.close()


def test_read_with_csums_hands_back_the_trusted_subs(tmp_path):
    pair = Pair(tmp_path, device_bytes=64 << 20, min_alloc=4096)
    data = os.urandom(5 * 4096 + 1)
    cs = crcutil.Csums.scan(data, site="test")
    pair.port.apply_transaction(Transaction().write_full(
        C, "o", data, csums=cs, copy=False))
    pair.ref.apply_transaction(RefTransaction().write_full(
        C, "o", data, csums=ref_crcutil.Csums.scan(data, site="test"),
        copy=False))
    got, gcs = pair.port.read_with_csums(C, "o")
    want, wcs = pair.ref.read_with_csums(C, "o")
    assert got == want == data
    assert (gcs.block, gcs.subs, gcs.length, gcs.combined) == \
        (wcs.block, wcs.subs, wcs.length, wcs.combined)
    # a deferred overwrite keeps the shape and re-derives the csums; a
    # copy-on-write one adds an extent and hands back none (both packages)
    pair.apply(lambda t: t.write(C, "o", 10, b"zz"))
    got, gcs = pair.port.read_with_csums(C, "o")
    want, wcs = pair.ref.read_with_csums(C, "o")
    assert got == want and gcs.subs == wcs.subs
    assert gcs.combined == crcutil.Csums.scan(got, site="test").combined
    pair.apply(lambda t: t.write(C, "o", 4096, b"q" * 8192))
    assert pair.port.read_with_csums(C, "o")[1] is None
    assert pair.ref.read_with_csums(C, "o")[1] is None
    pair.check("o")
    pair.close()


def test_rewrite_without_csums_drops_stale_trusted(tmp_path):
    st = mk(tmp_path, device_bytes=64 << 20, min_alloc=4096)
    a = os.urandom(2 * 4096)
    b = os.urandom(2 * 4096)
    txn = Transaction()
    txn.write_full(C, "o", a, csums=crcutil.Csums.scan(a, site="test"),
                   copy=False)
    txn.write_full(C, "o", b)
    st.apply_transaction(txn)
    assert st.read(C, "o") == b
    st.close()


def test_deferred_merge_skips_fully_covered_blocks(tmp_path):
    st = mk(tmp_path, device_bytes=64 << 20, min_alloc=4096)
    base = os.urandom(3 * 4096)
    st.apply_transaction(Transaction().write_full(C, "o", base))
    st.corrupt(C, "o", offset=4096 + 10)
    new_block = os.urandom(4096)
    st.apply_transaction(Transaction().write(C, "o", 4096, new_block))
    assert st.read(C, "o") == base[:4096] + new_block + base[2 * 4096:]
    st.corrupt(C, "o", offset=10)
    with pytest.raises(ChecksumError):
        st.apply_transaction(Transaction().write(C, "o", 100, b"z" * 50))
    st.close()


# ------------------------------------------------------------ core store --

def test_roundtrip_attrs_and_remount(tmp_path):
    pair = Pair(tmp_path)
    data = os.urandom(3000)
    pair.apply(lambda t: t.write_full(C, "o", data)
               .setattr(C, "o", "k", b"v").omap_set(C, "o", "m", b"w"))
    pair.check("o", data)
    bs = pair.port
    assert bs.read(C, "o", 100, 50) == data[100:150]
    assert bs.getattr(C, "o", "k") == b"v"
    assert bs.omap_get(C, "o", "m") == b"w"
    assert bs.list_objects(C) == ["o"] and bs.list_collections() == [C]
    pair.close()
    bs2 = mk(tmp_path, "port")
    assert bs2.read(C, "o") == data
    assert bs2.fsck() == []
    bs2.close()


def test_partial_write_hole_and_overwrite(tmp_path):
    pair = Pair(tmp_path)
    pair.apply(lambda t: t.write(C, "o", 2048, b"B" * 512))
    assert pair.port.read(C, "o", 0, 2048) == b"\0" * 2048
    pair.apply(lambda t: t.write(C, "o", 1800, b"C" * 600))
    pair.check("o", b"\0" * 1800 + b"C" * 600 + b"B" * 160)
    assert pair.port.fsck() == []
    pair.close()


def test_deferred_small_overwrite_survives_remount(tmp_path):
    pair = Pair(tmp_path)
    base = os.urandom(4096)
    pair.apply(lambda t: t.write_full(C, "o", base))
    before = pair.port.deferred_applied
    pair.apply(lambda t: t.write(C, "o", 700, b"XYZ"))
    assert pair.port.deferred_applied > before
    want = base[:700] + b"XYZ" + base[703:]
    pair.check("o", want)
    pair.close()
    bs2 = mk(tmp_path, "port")
    assert bs2.read(C, "o") == want and bs2.fsck() == []
    bs2.close()


def test_truncate_remove_reclaim(tmp_path):
    pair = Pair(tmp_path)
    free0 = pair.port.alloc.free_blocks
    pair.apply(lambda t: t.write_full(C, "a", b"x" * 8192)
               .write_full(C, "b", b"y" * 8192))
    assert pair.port.alloc.free_blocks == free0 - 32
    pair.apply(lambda t: t.truncate(C, "a", 1024))
    pair.check("a", b"x" * 1024)
    pair.apply(lambda t: t.remove(C, "b"))
    assert not pair.port.exists(C, "b")
    pair.apply(lambda t: t.truncate(C, "a", 2048))
    pair.check("a", b"x" * 1024 + b"\0" * 1024)
    assert pair.port.alloc.free_blocks == pair.ref.alloc.free_blocks
    pair.close()


def test_txn_rollback_and_enospc(tmp_path):
    bs = mk(tmp_path)
    free0 = bs.alloc.free_blocks
    with pytest.raises(ObjectStoreError):
        bs.apply_transaction(Transaction().write_full(C, "o", b"z" * 4096)
                             .truncate(C, "missing", 0))
    assert bs.alloc.free_blocks == free0 and not bs.exists(C, "o")
    bs.close()
    small = mk(tmp_path, "small", device_bytes=1 << 16)
    with pytest.raises(AllocatorError):
        small.apply_transaction(
            Transaction().write_full(C, "big", b"q" * (1 << 17)))
    small.apply_transaction(Transaction().write_full(C, "ok", b"fits"))
    assert small.read(C, "ok") == b"fits"
    small.close()


@pytest.mark.parametrize("algo", ["zlib", "lzma"])
def test_compression_roundtrip(tmp_path, algo):
    pair = Pair(tmp_path, compression=algo, compress_min=1024)
    data = b"A" * 65536
    pair.apply(lambda t: t.write_full(C, "o", data))
    pair.check("o", data)
    assert pair.port.stat(C, "o")["stored"] < 65536 // 4
    rnd = os.urandom(8192)
    pair.apply(lambda t: t.write_full(C, "r", rnd))
    pair.check("r", rnd)
    assert pair.port.stat(C, "r")["stored"] == 8192
    pair.close()
    bs2 = mk(tmp_path, "port")
    assert bs2.read(C, "o") == data and bs2.fsck() == []
    bs2.close()


def test_corruption_detected(tmp_path):
    bs = mk(tmp_path)
    bs.apply_transaction(Transaction().write_full(C, "o", b"p" * 4096))
    bs.corrupt(C, "o", offset=1000)
    with pytest.raises(ChecksumError):
        bs.read(C, "o")
    assert bs.read(C, "o", 0, 512) == b"p" * 512
    assert bs.fsck() == [(C, "o")]
    bs.close()
    with pytest.raises(ObjectStoreError):
        mk(tmp_path)


def test_fragmentation_compaction(tmp_path):
    pair = Pair(tmp_path, compact_extents=8, deferred_max=0)
    base = os.urandom(16384)
    pair.apply(lambda t: t.write_full(C, "o", base))
    want = bytearray(base)
    for i in range(20):
        off = (i * 700) % 15000
        pair.apply(lambda t: t.write(C, "o", off, bytes([i]) * 64))
        want[off:off + 64] = bytes([i]) * 64
    pair.check("o", bytes(want))
    assert pair.port.stat(C, "o")["extents"] <= 9
    assert pair.port.fsck() == []
    pair.close()
