"""BlueStore — block-device extent ObjectStore backend (L5).

The role of the reference's flagship store (src/os/bluestore/
BlueStore.cc — raw-device extents + RocksDB metadata + allocators +
per-block checksums + inline compression + deferred small writes),
re-designed around this repo's own seams rather than ported:

  * the "raw device" is one fixed-size ``block`` file carved into
    ``min_alloc``-sized blocks; free space is tracked by the native
    bitmap allocator (native/allocator_native.cpp — the
    BitmapAllocator role, src/os/bluestore/BitmapAllocator.h);
  * object metadata (onode: size + blob/extent map), xattrs and omap
    rows live in WalDB (the RocksDB role) and commit as ONE batch per
    transaction — the atomic commit point;
  * new data is written copy-on-write into freshly allocated blocks
    and fsynced BEFORE the KV commit, so a torn transaction can never
    clobber committed bytes; freed blocks are released only AFTER the
    commit (same reasoning, in-process);
  * every blob carries a crc32 per ``min_alloc`` stored block —
    partial reads verify only the blocks they touch and raise
    ChecksumError (EIO) on mismatch, BlueStore's csum-on-read stance;
  * blobs at/above ``compress_min`` are compressed through the
    compressor plugin registry (common/compressor.py) when it actually
    saves space — stored_len < raw_len is recorded in the blob header
    (the role of bluestore_compression_mode=aggressive);
  * small overwrites that land inside one existing uncompressed blob
    take the DEFERRED path (src/os/bluestore/BlueStore.cc deferred
    writes): the merged block bytes ride the KV commit batch and are
    applied to the device in place afterwards; mount() replays any
    deferred rows left by a crash (idempotent pwrites), so the KV
    batch remains the single durability point;
  * there is NO persisted freelist: mount() rebuilds the allocator
    bitmap from the committed onodes (the post-Pacific BlueStore "NCB"
    stance), and double-allocation across onodes is detected while
    marking — that is fsck's allocation check.

Crash model (kill -9 anywhere): a transaction is visible iff its KV
batch committed; COW data for uncommitted transactions sits in blocks
the rebuilt allocator still considers free.  See
tests/test_bluestore.py for the kill -9 storm.
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..common import crcutil
from ..common.compressor import compressors
from ..common.perf_counters import perf as _perf
from ..native_bridge import AllocatorError, BitmapAllocator
from .blockdev import BlockDevice
from .kv import WriteBatch, rm_object_rows
from .objectstore import (ChecksumError, Coll, ObjectStoreError,
                          OP_OMAP_RM, OP_OMAP_SET, OP_REMOVE, OP_SETATTR,
                          OP_TOUCH, OP_TRUNCATE, OP_WRITE, OP_WRITE_FULL,
                          Transaction)
from .wal_kv import WalDB

_BLOB_HDR = struct.Struct("<BBIIHI")     # flags, comp_id, raw_len,
                                         #   stored_len, n_runs, n_csums
_RUN = struct.Struct("<QI")              # start_block, n_blocks
_EXT = struct.Struct("<QIII")            # obj_off, length, blob_idx,
                                         #   blob_off (into RAW stream)
_DEF = struct.Struct("<QI")              # dev_byte_off, payload_len

FLAG_COMPRESSED = 1
ONDISK_FORMAT = 2               # blob headers carry a compressor id

# per-blob compressor ids (persisted in the blob header, so a remount
# never has to GUESS which algorithm wrote a blob — the reference
# records the compressor per blob too, bluestore_blob_t::COMP types)
_COMP_IDS = {"": 0, "zlib": 1, "lzma": 2, "bz2": 3, "zstd": 4}
_COMP_NAMES = {v: k for k, v in _COMP_IDS.items()}


@dataclass
class Blob:
    """A stored region: stored_len bytes across `runs` device blocks,
    raw_len logical bytes after decompression, one crc32 per stored
    min_alloc block (the bluestore_blob_t + csum array role)."""
    flags: int = 0
    raw_len: int = 0
    stored_len: int = 0
    runs: List[Tuple[int, int]] = field(default_factory=list)
    csums: List[int] = field(default_factory=list)
    comp: str = ""                  # compressor that wrote this blob

    @property
    def compressed(self) -> bool:
        return bool(self.flags & FLAG_COMPRESSED)

    def n_blocks(self) -> int:
        return sum(n for _, n in self.runs)


@dataclass
class Onode:
    """Per-object metadata: logical size + extent map over blobs (the
    bluestore onode_t/extent_map role).  Extents are sorted by
    obj_off and never overlap (writes punch before inserting)."""
    size: int = 0
    blobs: List[Blob] = field(default_factory=list)
    # (obj_off, length, blob_idx, blob_off)
    extents: List[Tuple[int, int, int, int]] = field(default_factory=list)

    def encode(self) -> bytes:
        out = [struct.pack("<QI", self.size, len(self.blobs))]
        for b in self.blobs:
            out.append(_BLOB_HDR.pack(b.flags, _COMP_IDS[b.comp],
                                      b.raw_len, b.stored_len,
                                      len(b.runs), len(b.csums)))
            out += [_RUN.pack(*r) for r in b.runs]
            out.append(struct.pack(f"<{len(b.csums)}I", *b.csums))
        out.append(struct.pack("<I", len(self.extents)))
        out += [_EXT.pack(*e) for e in self.extents]
        return b"".join(out)

    @classmethod
    def decode(cls, blob: bytes) -> "Onode":
        size, n_blobs = struct.unpack_from("<QI", blob, 0)
        off = 12
        blobs = []
        for _ in range(n_blobs):
            flags, comp_id, raw_len, stored_len, n_runs, n_csums = \
                _BLOB_HDR.unpack_from(blob, off)
            off += _BLOB_HDR.size
            runs = []
            for _ in range(n_runs):
                runs.append(_RUN.unpack_from(blob, off))
                off += _RUN.size
            csums = list(struct.unpack_from(f"<{n_csums}I", blob, off))
            off += 4 * n_csums
            comp = _COMP_NAMES.get(comp_id)
            if comp is None:
                # fsck catches ObjectStoreError and reports the object
                # as bad; a bare KeyError would escape it
                raise ObjectStoreError(
                    f"unknown compressor id {comp_id}")
            blobs.append(Blob(flags, raw_len, stored_len, runs, csums,
                              comp))
        (n_ext,) = struct.unpack_from("<I", blob, off)
        off += 4
        extents = []
        for _ in range(n_ext):
            extents.append(_EXT.unpack_from(blob, off))
            off += _EXT.size
        return cls(size=size, blobs=blobs, extents=extents)


def _collkey(coll: Coll) -> str:
    return f"{coll[0]}.{coll[1]}"


def _objkey(coll: Coll, oid: str) -> str:
    return f"{_collkey(coll)}/{oid}"


def _split_objkey(key: str) -> Tuple[Coll, str]:
    ck, oid = key.split("/", 1)
    p, g = ck.split(".", 1)
    return (int(p), int(g)), oid


class BlueStore:
    """Durable block-device ObjectStore (block file + WalDB metadata)."""

    def __init__(self, path: str, *, device_bytes: int = 1 << 28,
                 min_alloc: int = 4096, fsync: bool = True,
                 compression: Optional[str] = None,
                 compress_min: int = 4096,
                 deferred_max: Optional[int] = None,
                 compact_extents: int = 64,
                 fsck_on_mount: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(path, exist_ok=True)
        self.kv = WalDB(os.path.join(path, "kv"), fsync=fsync)
        # superblock: geometry is fixed at mkfs; remounts use the stored
        # values (passing different ones is a config error, not a
        # resize).  A format version gates incompatible onode layouts
        # (the ondisk_format/compat_ondisk_format role) — misdecoding
        # an old store must be a clear refusal, not garbage extents.
        sb = self.kv.get("meta", "superblock")
        if sb is None:
            self.device_bytes = int(device_bytes)
            self.min_alloc = int(min_alloc)
            self.kv.set("meta", "superblock", struct.pack(
                "<QII", self.device_bytes, self.min_alloc,
                ONDISK_FORMAT))
        elif len(sb) == 12:          # v1: no version field, old blobs
            raise ObjectStoreError(
                "incompatible on-disk format v1 (pre-versioned blob "
                f"headers); this build reads format {ONDISK_FORMAT}")
        else:
            self.device_bytes, self.min_alloc, fmt = \
                struct.unpack("<QII", sb)
            if fmt != ONDISK_FORMAT:
                raise ObjectStoreError(
                    f"incompatible on-disk format {fmt} "
                    f"(this build reads {ONDISK_FORMAT})")
        if self.device_bytes % self.min_alloc:
            raise ObjectStoreError("device size not block-aligned")
        self.n_blocks = self.device_bytes // self.min_alloc
        self.compress_min = compress_min
        self.compact_extents = compact_extents
        self.deferred_max = (self.min_alloc if deferred_max is None
                             else deferred_max)
        if compression and compression not in _COMP_IDS:
            # fail at mkfs/mount, not mid-commit in Onode.encode (a
            # KeyError there would strike after blocks were allocated)
            raise ValueError(
                f"unsupported BlueStore compressor {compression!r}; "
                f"choose from {sorted(k for k in _COMP_IDS if k)}")
        self._comp = (compressors().factory(compression)
                      if compression else None)
        self._comp_name = compression
        dev_path = os.path.join(path, "block")
        # the block device behind the barrier API: every data byte
        # this store persists is visible to the crash-state recorder
        # (cluster/blockdev.py), and the device.* power-loss
        # faultpoints fire inside it
        self._dev = BlockDevice(dev_path, size=self.device_bytes)
        self._lock = threading.RLock()
        self._pc = _perf("bluestore")
        self.txns_applied = 0
        self.deferred_applied = 0
        # cold-restart observability: the KV mount already replayed
        # its WAL — surface records/bytes/duration as perf counters
        # (the recovery-trajectory datapoint bench_crash_recovery reads)
        rs = self.kv.replay_stats
        self._pc.inc("wal_replay_entries", int(rs["records"]))
        self._pc.inc("wal_replay_bytes", int(rs["bytes"]))
        self._pc.set("wal_replay_last_s", round(rs["seconds"], 6))
        self.alloc = BitmapAllocator(self.n_blocks)
        try:
            self._rebuild_allocations()
            self._replay_deferred()
            bad = self.fsck() if fsck_on_mount else []
        except Exception:
            self.close()        # no fd leak on a failed mount
            raise
        if bad:
            self.close()
            raise ObjectStoreError(f"fsck on mount: bad objects {bad}")

    # ------------------------------------------------------------- mount --
    def _rebuild_allocations(self) -> None:
        """NCB freelist rebuild: mark every committed blob's runs; an
        overlap here is on-disk corruption."""
        for key, blob in self.kv.iterate("onode"):
            onode = Onode.decode(blob)
            for b in onode.blobs:
                for start, n in b.runs:
                    try:
                        self.alloc.mark(start, n)
                    except AllocatorError as e:
                        raise ObjectStoreError(
                            f"mount: {key}: double-allocated blocks "
                            f"[{start},+{n}): {e}") from e

    def _replay_deferred(self) -> None:
        """Re-apply deferred writes whose in-place pwrite may not have
        happened before a crash (idempotent), then drop the rows."""
        t0 = time.perf_counter()
        rows = list(self.kv.iterate("deferred"))
        self.deferred_replayed = len(rows)
        self.deferred_replay_bytes = 0
        self.deferred_replay_s = 0.0
        if not rows:
            return
        batch = WriteBatch()
        for key, payload in rows:
            dev_off, ln = _DEF.unpack_from(payload, 0)
            data = payload[_DEF.size:_DEF.size + ln]
            self._dev.pwrite(data, dev_off)
            self.deferred_replay_bytes += ln
            batch.rm("deferred", key)
        if self.fsync:
            self._dev.fsync()
        self.kv.submit(batch)
        self.deferred_replay_s = time.perf_counter() - t0
        self._pc.inc("deferred_replay_entries", len(rows))
        self._pc.inc("deferred_replay_bytes",
                     self.deferred_replay_bytes)
        self._pc.set("deferred_replay_last_s",
                     round(self.deferred_replay_s, 6))

    # ------------------------------------------------------------ helpers --
    def _onode(self, coll: Coll, oid: str) -> Optional[Onode]:
        blob = self.kv.get("onode", _objkey(coll, oid))
        return Onode.decode(blob) if blob is not None else None

    def _blob_block_list(self, blob: Blob) -> List[int]:
        blocks: List[int] = []
        for start, n in blob.runs:
            blocks.extend(range(start, start + n))
        return blocks

    def _read_stored(self, blob: Blob, s0: int, s1: int,
                     check: bool = True) -> bytes:
        """Read stored bytes [s0, s1) of a blob, verifying the crc of
        every touched stored block."""
        if s1 > blob.stored_len:
            raise ObjectStoreError("stored read past blob end")
        c0 = s0 // self.min_alloc
        c1 = (s1 + self.min_alloc - 1) // self.min_alloc
        blocks = self._blob_block_list(blob)
        parts = []
        # ONE device read per contiguous device run (crc verification
        # stays per-block on the slices) — the read-side twin of
        # _make_blob's batched writes
        ci = c0
        while ci < c1:
            cj = ci + 1
            while cj < c1 and blocks[cj] == blocks[cj - 1] + 1:
                cj += 1
            want = min((cj - ci) * self.min_alloc,
                       blob.stored_len - ci * self.min_alloc)
            buf = self._dev.pread(want, blocks[ci] * self.min_alloc)
            if len(buf) != want:
                raise ChecksumError(
                    f"blob blocks {ci}..{cj} @dev {blocks[ci]}: "
                    f"short device read (EIO)")
            mv = memoryview(buf)
            for k in range(ci, cj):
                lo = (k - ci) * self.min_alloc
                chunk = mv[lo:lo + self.min_alloc]
                if check and zlib.crc32(chunk) != blob.csums[k]:
                    raise ChecksumError(
                        f"blob block {k} @dev {blocks[k]}: data "
                        f"fails checksum (EIO)")
            parts.append(buf)
            ci = cj
        joined = b"".join(parts)
        lo = s0 - c0 * self.min_alloc
        return joined[lo:lo + (s1 - s0)]

    def _read_raw(self, blob: Blob, r0: int, r1: int) -> bytes:
        """Read RAW (decompressed) bytes [r0, r1) of a blob."""
        if blob.compressed:
            stored = self._read_stored(blob, 0, blob.stored_len)
            # the blob header names its own compressor — remount args
            # never matter for readback
            raw = compressors().factory(blob.comp or "zlib") \
                .decompress(stored)
            if len(raw) != blob.raw_len:
                raise ChecksumError("decompressed length mismatch (EIO)")
            return raw[r0:r1]
        return self._read_stored(blob, r0, r1)

    @staticmethod
    def _punch(onode: Onode, off: int, length: int) -> None:
        """Remove [off, off+length) from the extent map, splitting
        extents that straddle the boundary.  Blobs stay (possibly
        partially referenced); _reap_blobs drops unreferenced ones."""
        end = off + length
        out: List[Tuple[int, int, int, int]] = []
        for e_off, e_len, bi, b_off in onode.extents:
            e_end = e_off + e_len
            if e_end <= off or e_off >= end:
                out.append((e_off, e_len, bi, b_off))
                continue
            if e_off < off:                    # keep head
                out.append((e_off, off - e_off, bi, b_off))
            if e_end > end:                    # keep tail
                cut = end - e_off
                out.append((end, e_end - end, bi, b_off + cut))
        out.sort()
        onode.extents = out

    @staticmethod
    def _reap_blobs(onode: Onode) -> List[Tuple[int, int]]:
        """Drop blobs no extent references; returns their runs (to be
        released AFTER commit) and renumbers extent blob indices."""
        referenced = {bi for _, _, bi, _ in onode.extents}
        freed: List[Tuple[int, int]] = []
        remap: Dict[int, int] = {}
        kept: List[Blob] = []
        for i, b in enumerate(onode.blobs):
            if i in referenced:
                remap[i] = len(kept)
                kept.append(b)
            else:
                freed.extend(b.runs)
        onode.blobs = kept
        onode.extents = [(o, ln, remap[bi], bo)
                         for o, ln, bi, bo in onode.extents]
        return freed

    def _make_blob(self, data, trusted=None
                   ) -> Tuple[Blob, List[Tuple[int, bytes]]]:
        """Build a blob for `data`: maybe compress, allocate blocks,
        return (blob, [(dev_byte_off, payload)]) pending device writes.
        Allocator state IS mutated — the caller must release on txn
        failure.

        ``trusted`` (common/crcutil.Csums over exactly these bytes)
        is the one-pass integrity handoff: the wire's verify scan
        already computed per-min_alloc sub-crcs for this payload, so
        the store ADOPTS them as blob csums instead of running its
        own third pass.  Only applies when the bytes are stored
        verbatim (no compression win) and the block geometries match;
        any mismatch falls back to the local scan."""
        raw_len = len(data)
        stored = data
        flags = 0
        comp_name = ""
        if (self._comp is not None and raw_len >= self.compress_min):
            c = self._comp.compress(data)
            # only keep a win that saves at least one block
            if (len(c) + self.min_alloc - 1) // self.min_alloc < \
                    (raw_len + self.min_alloc - 1) // self.min_alloc:
                stored = c
                flags = FLAG_COMPRESSED
                comp_name = self._comp_name or ""
        n_blocks = (len(stored) + self.min_alloc - 1) // self.min_alloc
        runs = [(int(s), int(n))
                for s, n in self.alloc.allocate(n_blocks)]
        mv = crcutil.as_u8(stored)
        if trusted is not None and not flags and \
                trusted.block == self.min_alloc and \
                trusted.length == len(stored):
            csums = list(trusted.subs)
            crcutil.note_trusted(len(stored))
        else:
            csums = []
            for b in range(n_blocks):
                csums.append(zlib.crc32(
                    mv[b * self.min_alloc:
                       min((b + 1) * self.min_alloc, len(stored))]))
            crcutil.note_scan(len(stored), "store")
        writes: List[Tuple[int, bytes]] = []
        ci = 0
        zero_copy = crcutil.flag("wire_zero_copy")
        # ONE device write per contiguous run (not per block): the
        # checksum granularity stays min_alloc, the syscall count
        # drops from stored_len/min_alloc to len(runs) — this is the
        # difference between ~256 pwrites and ~1 for a 1 MiB shard.
        # The run payloads are VIEWS over the caller's buffer (the
        # wire frame), so the bytes go receive buffer -> page cache
        # with no intermediate materialization.
        for start, n in runs:
            lo = ci * self.min_alloc
            hi = min(lo + n * self.min_alloc, len(stored))
            if zero_copy:
                writes.append((start * self.min_alloc, mv[lo:hi]))
            else:
                crcutil.note_copy(hi - lo, "make_blob")
                writes.append((start * self.min_alloc,
                               bytes(mv[lo:hi])))  # noqa: CTL130 —
                # the counted legacy path the bench prices
            ci += n
        return Blob(flags, raw_len, len(stored), runs, csums,
                    comp_name), writes

    # ------------------------------------------------------------- write --
    def apply_transaction(self, txn: Transaction) -> None:
        with self._lock:
            self._apply_locked(txn)

    def _apply_locked(self, txn: Transaction) -> None:
        txn_csums = getattr(txn, "csums", None) or {}
        staged: Dict[Tuple[Coll, str], Optional[Onode]] = {}
        xattrs: Dict[Tuple[Coll, str, str], Optional[bytes]] = {}
        omaps: Dict[Tuple[Coll, str, str], Optional[bytes]] = {}
        pending: List[Tuple[int, bytes]] = []     # COW device writes
        # deferred in-place updates, keyed per staged object so a
        # same-txn remove drops them: (dev_byte_off, payload)
        deferred: Dict[Tuple[Coll, str], List[Tuple[int, bytes]]] = {}
        newly_allocated: List[Tuple[int, int]] = []
        to_release: List[Tuple[int, int]] = []

        def stage(coll: Coll, oid: str, create: bool) -> Optional[Onode]:
            key = (coll, oid)
            if key not in staged:
                cur = self._onode(coll, oid)
                if cur is None:
                    staged[key] = Onode() if create else None
                else:
                    staged[key] = Onode(cur.size,
                                        [Blob(b.flags, b.raw_len,
                                              b.stored_len, list(b.runs),
                                              list(b.csums), b.comp)
                                         for b in cur.blobs],
                                        list(cur.extents))
            elif staged[key] is None and create:
                staged[key] = Onode()
            return staged[key]

        def rm_obj_rows(coll: Coll, oid: str) -> None:
            ok = _objkey(coll, oid) + "\x00"
            for prefix, sink in (("xattr", xattrs), ("omap", omaps)):
                for k, _ in self.kv.iterate(prefix, start=ok):
                    if not k.startswith(ok):
                        break
                    sink[(coll, oid, k[len(ok):])] = None
            for sink in (xattrs, omaps):
                for (c2, o2, k2) in list(sink):
                    if (c2, o2) == (coll, oid):
                        sink[(c2, o2, k2)] = None

        fresh_blobs: set = set()              # id(blob) created this txn

        def maybe_compact(o: Onode, key) -> None:
            """Extent-map defragmentation (the BlueStore blob-gc role):
            once an object's map outgrows ``compact_extents``, rewrite
            it as one blob.  Only safe when every referenced byte is
            committed on the device (no fresh blobs, no pending
            deferred merges for this object)."""
            if len(o.extents) < self.compact_extents or \
                    key in deferred or \
                    any(id(o.blobs[bi]) in fresh_blobs
                        for _, _, bi, _ in o.extents):
                return
            content = self._read_onode(o, 0, o.size)
            for b in o.blobs:
                to_release.extend(b.runs)
            o.blobs = []
            o.extents = []
            if content:
                new_blob(o, content, 0)

        def new_blob(o: Onode, data, obj_off: int,
                     trusted=None) -> None:
            blob, writes = self._make_blob(data, trusted=trusted)
            fresh_blobs.add(id(blob))
            newly_allocated.extend(blob.runs)
            pending.extend(writes)
            self._punch(o, obj_off, len(data))
            o.blobs.append(blob)
            o.extents.append((obj_off, len(data), len(o.blobs) - 1, 0))
            o.extents.sort()
            to_release.extend(self._reap_blobs(o))

        def try_deferred(o: Onode, key, obj_off: int,
                         data: bytes) -> bool:
            """Small overwrite fully inside ONE uncompressed extent →
            merge into the affected stored blocks in place; payload
            rides the KV batch (the BlueStore deferred-write path)."""
            if len(data) > self.deferred_max:
                return False
            for e_off, e_len, bi, b_off in o.extents:
                if not (e_off <= obj_off and
                        obj_off + len(data) <= e_off + e_len):
                    continue
                blob = o.blobs[bi]
                if blob.compressed or id(blob) in fresh_blobs:
                    # fresh blobs' COW bytes are not on the device yet
                    # — read-merge would see garbage; take the COW path
                    return False
                s0 = b_off + (obj_off - e_off)      # stored offset
                s1 = s0 + len(data)
                c0 = s0 // self.min_alloc
                c1 = (s1 + self.min_alloc - 1) // self.min_alloc
                lo = c0 * self.min_alloc
                blocks = self._blob_block_list(blob)
                prior = deferred.get(key, [])
                # read-merge per touched stored block: a prior same-txn
                # deferred payload for the block IS its current content
                # (the device is stale until post-commit apply);
                # otherwise read the device and verify its crc.  A
                # block the write FULLY covers is never read at all —
                # the old double-verify re-crc'd device bytes that the
                # merge was about to overwrite wholesale (the
                # read-back-re-scan class one-pass integrity retires): its
                # content below is placeholder zeros the overwrite
                # replaces byte-for-byte.
                cur = bytearray()
                for ci in range(c0, c1):
                    bs = blocks[ci] * self.min_alloc
                    blk_end = min((ci + 1) * self.min_alloc,
                                  blob.stored_len)
                    hit = next((p for off2, p in reversed(prior)
                                if off2 == bs), None)
                    if hit is not None:
                        chunk = hit
                    elif s0 <= ci * self.min_alloc and s1 >= blk_end:
                        chunk = bytes(blk_end - ci * self.min_alloc)
                    else:
                        chunk = self._read_stored(
                            blob, ci * self.min_alloc, blk_end)
                    cur.extend(chunk)
                cur[s0 - lo:s1 - lo] = data
                # per-block csum refresh + device payloads
                dq = deferred.setdefault(key, [])
                for ci in range(c0, c1):
                    blo = (ci - c0) * self.min_alloc
                    chunk = bytes(cur[blo:blo + self.min_alloc])
                    blob.csums[ci] = zlib.crc32(chunk)
                    dq.append((blocks[ci] * self.min_alloc, chunk))
                return True
            return False

        try:
            for op in txn.ops:
                kind = op[0]
                if kind == OP_TOUCH:
                    _, coll, oid = op
                    stage(coll, oid, create=True)
                elif kind == OP_WRITE_FULL:
                    _, coll, oid, data = op
                    o = stage(coll, oid, create=True)
                    # drop the whole extent map, then write one blob
                    for b in o.blobs:
                        to_release.extend(b.runs)
                    o.blobs = []
                    o.extents = []
                    o.size = len(data)
                    if len(data):
                        new_blob(o, data, 0,
                                 trusted=txn_csums.get((coll, oid)))
                    deferred.pop((coll, oid), None)
                elif kind == OP_WRITE:
                    _, coll, oid, offset, data = op
                    o = stage(coll, oid, create=True)
                    o.size = max(o.size, offset + len(data))
                    if not data:
                        continue
                    if not try_deferred(o, (coll, oid), offset,
                                        bytes(data)):
                        maybe_compact(o, (coll, oid))
                        new_blob(o, bytes(data), offset)
                elif kind == OP_TRUNCATE:
                    _, coll, oid, size = op
                    o = stage(coll, oid, create=False)
                    if o is None:
                        raise ObjectStoreError(
                            f"truncate: no object {oid}")
                    if size < o.size:
                        self._punch(o, size, o.size - size)
                        to_release.extend(self._reap_blobs(o))
                    o.size = size
                elif kind == OP_REMOVE:
                    _, coll, oid = op
                    o = stage(coll, oid, create=False)
                    if o is None:
                        raise ObjectStoreError(f"remove: no object {oid}")
                    for b in o.blobs:
                        to_release.extend(b.runs)
                    staged[(coll, oid)] = None
                    deferred.pop((coll, oid), None)
                    rm_obj_rows(coll, oid)
                elif kind == OP_SETATTR:
                    _, coll, oid, key, value = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(f"setattr: no object {oid}")
                    xattrs[(coll, oid, key)] = value
                elif kind == OP_OMAP_SET:
                    _, coll, oid, key, value = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(
                            f"omap_set: no object {oid}")
                    omaps[(coll, oid, key)] = value
                elif kind == OP_OMAP_RM:
                    _, coll, oid, key = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(f"omap_rm: no object {oid}")
                    if omaps.get((coll, oid, key), b"") is None or (
                            (coll, oid, key) not in omaps and
                            self.kv.get(
                                "omap",
                                _objkey(coll, oid) + "\x00" + key)
                            is None):
                        raise ObjectStoreError(f"omap_rm: no key {key}")
                    omaps[(coll, oid, key)] = None
                else:
                    raise ObjectStoreError(f"unknown txn op {kind!r}")
        except Exception:
            # roll back this txn's allocations; nothing hit the KV
            for start, n in newly_allocated:
                self.alloc.release(start, n)
            raise

        # ---- COW data to the device FIRST (commit point is the KV) ----
        for dev_off, payload in pending:
            self._dev.pwrite(payload, dev_off)
        if pending and self.fsync:
            self._dev.fsync()

        batch = WriteBatch()
        def_rows: List[Tuple[str, int, bytes]] = []
        seq = self.txns_applied
        for (coll, oid), onode in staged.items():
            key = _objkey(coll, oid)
            if onode is None:
                batch.rm("onode", key)
            else:
                batch.set("onode", key, onode.encode())
        for (coll, oid, key), val in xattrs.items():
            row = _objkey(coll, oid) + "\x00" + key
            if val is None:
                batch.rm("xattr", row)
            else:
                batch.set("xattr", row, val)
        for (coll, oid, key), val in omaps.items():
            row = _objkey(coll, oid) + "\x00" + key
            if val is None:
                batch.rm("omap", row)
            else:
                batch.set("omap", row, val)
        for key, writes in deferred.items():
            if staged.get(key) is None:
                continue                      # object died this txn
            for i, (dev_off, payload) in enumerate(writes):
                row = f"{seq:016d}.{len(def_rows):04d}"
                batch.set("deferred", row,
                          _DEF.pack(dev_off, len(payload)) + payload)
                def_rows.append((row, dev_off, payload))
        self.kv.submit(batch)                 # ← the atomic commit point
        self.txns_applied += 1

        # ---- post-commit: deferred in-place applies, then cleanup ----
        if def_rows:
            clear = WriteBatch()
            for row, dev_off, payload in def_rows:
                self._dev.pwrite(payload, dev_off)
                clear.rm("deferred", row)
            # the rows may only be durably dropped once the in-place
            # bytes are ON the device — same order as _replay_deferred
            # (clearing first would lose the write on power cut)
            if self.fsync:
                self._dev.fsync()
            self.deferred_applied += len(def_rows)
            self.kv.submit(clear)
        for start, n in to_release:
            self.alloc.release(start, n)

    # -------------------------------------------------------------- read --
    # Reads hold the store lock: the post-commit deferred apply (and
    # allocator release) must not interleave with a reader that already
    # fetched the NEW onode but would see the OLD device bytes — that
    # window would surface as a spurious EIO on committed data.
    def _get(self, coll: Coll, oid: str) -> Onode:
        o = self._onode(coll, oid)
        if o is None:
            raise ObjectStoreError(f"no object {oid} in {coll}")
        return o

    def exists(self, coll: Coll, oid: str) -> bool:
        return self.kv.get("onode", _objkey(coll, oid)) is not None

    def _read_onode(self, o: Onode, offset: int, end: int) -> bytes:
        if end <= offset:
            return b""
        out = bytearray(end - offset)         # holes read as zeros
        for e_off, e_len, bi, b_off in o.extents:
            lo = max(e_off, offset)
            hi = min(e_off + e_len, end)
            if hi <= lo:
                continue
            raw = self._read_raw(o.blobs[bi], b_off + (lo - e_off),
                                 b_off + (hi - e_off))
            out[lo - offset:hi - offset] = raw
        return bytes(out)

    def read(self, coll: Coll, oid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        with self._lock:
            o = self._get(coll, oid)
            end = (o.size if length is None
                   else min(offset + length, o.size))
            return self._read_onode(o, offset, end)

    def read_with_csums(self, coll: Coll, oid: str):
        """Full-object read PLUS the store-trusted sub-crcs:
        -> (data, crcutil.Csums | None).

        The reply-direction half of the one-pass handoff (RingReply):
        csum-on-read just verified every stored block against the
        blob csum array, so those csums are TRUSTED for the bytes
        being returned — the daemon's reply path folds them into the
        frame crc / ring doorbell via crc32_combine and sends with
        ZERO additional scans.  Only the simple write_full shape
        qualifies (one uncompressed blob storing the logical bytes
        verbatim, one extent covering [0, size)): overwrite histories
        and compressed blobs return csums None, and the sender runs
        its one counted scan exactly as before."""
        with self._lock:
            o = self._get(coll, oid)
            data = self._read_onode(o, 0, o.size)
            cs = None
            if len(o.blobs) == 1 and len(o.extents) == 1 and \
                    not o.blobs[0].compressed:
                b = o.blobs[0]
                e_off, e_len, _bi, b_off = o.extents[0]
                if (e_off == 0 and b_off == 0 and e_len == o.size
                        and b.raw_len == o.size
                        and b.stored_len == o.size
                        and len(b.csums) ==
                        (o.size + self.min_alloc - 1)
                        // self.min_alloc):
                    cs = crcutil.Csums(self.min_alloc,
                                       list(b.csums), o.size)
            return data, cs

    def stat(self, coll: Coll, oid: str) -> Dict[str, int]:
        with self._lock:
            o = self._get(coll, oid)
            # 'csum' is a CONTENT digest (crc over the logical bytes),
            # not a layout digest — replicas with different extent
            # histories must agree, that is what scrub compares
            return {"size": o.size,
                    "csum": zlib.crc32(self._read_onode(o, 0, o.size)),
                    "allocated": sum(b.n_blocks() for b in o.blobs)
                    * self.min_alloc,
                    "stored": sum(b.stored_len for b in o.blobs),
                    "extents": len(o.extents)}

    def getattr(self, coll: Coll, oid: str, key: str) -> bytes:
        with self._lock:
            v = self.kv.get("xattr", _objkey(coll, oid) + "\x00" + key)
            if v is None:
                self._get(coll, oid)   # object-missing error first
                raise KeyError(key)
            return v

    def omap_get(self, coll: Coll, oid: str, key: str) -> bytes:
        with self._lock:
            v = self.kv.get("omap", _objkey(coll, oid) + "\x00" + key)
            if v is None:
                self._get(coll, oid)
                raise KeyError(key)
            return v

    def omap_list(self, coll: Coll, oid: str,
                  start: str = "") -> List[Tuple[str, bytes]]:
        """All omap rows of an object from ``start`` (sorted) — the
        ObjectMap::get_iterator role (PG logs live here)."""
        with self._lock:
            ok = _objkey(coll, oid) + "\x00"
            out = []
            for k, v in self.kv.iterate("omap", start=ok + start):
                if not k.startswith(ok):
                    break
                out.append((k[len(ok):], v))
            return out

    def list_objects(self, coll: Coll) -> List[str]:
        ck = _collkey(coll) + "/"
        out = []
        for k, _ in self.kv.iterate("onode", start=ck):
            if not k.startswith(ck):
                break
            out.append(k[len(ck):])
        return sorted(out)

    def list_collections(self) -> List[Coll]:
        seen = set()
        for k, _ in self.kv.iterate("onode"):
            seen.add(_split_objkey(k)[0])
        return sorted(seen)

    def verify(self, coll: Coll, oid: str) -> bool:
        with self._lock:
            try:
                o = self._onode(coll, oid)
                if o is None:
                    return False
                for b in o.blobs:
                    self._read_stored(b, 0, b.stored_len)
                return True
            except (ChecksumError, ObjectStoreError):
                return False

    # ------------------------------------------------------------- fsck --
    def fsck(self, repair: bool = False) -> List[Tuple[Coll, str]]:
        """Walk every onode: csum-verify all stored bytes, bounds-check
        extents, and rebuild the allocation bitmap to detect
        double-allocated blocks (the BlueStore fsck roles).

        ``repair=True`` QUARANTINES each inconsistent object instead
        of just listing it: its onode + xattr/omap rows are dropped in
        one KV batch, so the object reads as missing and scrub /
        peering recovery re-replicate it from healthy copies (the
        fsck --repair stance: a locally-damaged replica must not keep
        serving EIO when the cluster holds good bytes).  Device blocks
        stay allocated until the next mount's NCB rebuild — leaking
        space is safe, releasing blocks a double-allocated twin still
        references is not.  Counted on perf counters
        ``bluestore.fsck_errors`` / ``bluestore.fsck_repaired``."""
        with self._lock:
            return self._fsck_locked(repair)

    def _fsck_locked(self, repair: bool = False
                     ) -> List[Tuple[Coll, str]]:
        bad = []
        shadow = BitmapAllocator(self.n_blocks)
        for key, raw in self.kv.iterate("onode"):
            coll, oid = _split_objkey(key)
            ok = True
            try:
                o = Onode.decode(raw)
                for b in o.blobs:
                    for start, n in b.runs:
                        shadow.mark(start, n)
                    want = ((b.stored_len + self.min_alloc - 1)
                            // self.min_alloc)
                    if b.n_blocks() < want or len(b.csums) != want:
                        raise ObjectStoreError("blob geometry")
                    self._read_stored(b, 0, b.stored_len)
                for e_off, e_len, bi, b_off in o.extents:
                    blob = o.blobs[bi]
                    if b_off + e_len > blob.raw_len or \
                            e_off + e_len > o.size:
                        raise ObjectStoreError("extent bounds")
            except (ChecksumError, ObjectStoreError, AllocatorError,
                    struct.error, IndexError):
                ok = False
            if not ok:
                bad.append((coll, oid))
        if bad:
            self._pc.inc("fsck_errors", len(bad))
        if repair and bad:
            batch = WriteBatch()
            for coll, oid in bad:
                rm_object_rows(self.kv, batch, "onode",
                               _objkey(coll, oid))
            self.kv.submit(batch)
            self._pc.inc("fsck_repaired", len(bad))
        return bad

    def close(self) -> None:
        with self._lock:
            self.kv.close()
            self._dev.close()

    # --------------------------------------------------------- test hook --
    def corrupt(self, coll: Coll, oid: str, offset: int = 0) -> None:
        """Flip a stored device byte under `offset` WITHOUT updating
        the blob csum (EIO injection)."""
        with self._lock:
            self._corrupt_locked(coll, oid, offset)

    def _corrupt_locked(self, coll: Coll, oid: str, offset: int) -> None:
        o = self._get(coll, oid)
        for e_off, e_len, bi, b_off in o.extents:
            if not (e_off <= offset < e_off + e_len):
                continue
            blob = o.blobs[bi]
            s = b_off + (offset - e_off) if not blob.compressed else 0
            blocks = self._blob_block_list(blob)
            dev_off = blocks[s // self.min_alloc] * self.min_alloc + \
                (s % self.min_alloc)
            cur = self._dev.pread(1, dev_off)
            self._dev.pwrite(bytes([cur[0] ^ 0xFF]), dev_off)
            return
        raise ObjectStoreError(f"corrupt: no extent at {offset}")
