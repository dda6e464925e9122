"""FileStore — durable log-structured ObjectStore backend (L5).

The persistence tier: same
Transaction contract as cluster/objectstore.py's MemStore, but nothing
lives only in RAM:

  * object DATA is appended to ``data.log`` as CRC32-framed extents
    (never overwritten in place — log-structured, the BlueStore
    deferred/extent role, src/os/bluestore/BlueStore.cc);
  * object METADATA (logical size + extent list), xattrs and omap rows
    are one WalDB write batch per transaction (cluster/wal_kv.py — the
    RocksDBStore role), committed AFTER the data log is flushed, so the
    KV batch is the atomic commit point;
  * mount() rebuilds from disk alone; ``fsck()`` verifies every
    extent's bounds and checksum (fsck-on-mount is the constructor
    default); orphan data-log space (crashes, overwrites, removes) is
    reclaimed by generation GC — ``gc_data_log`` rewrites live objects
    into a fresh log and flips extents + generation pointer in one
    atomic KV batch (auto-triggered when the log outgrows live data by
    ``gc_factor``).

Crash model (kill -9 anywhere):
  - crash before data fsync  -> txn absent, store = pre-txn state
  - crash after data, before KV commit -> txn absent, orphan extents
    (space only, invisible to reads; fsck counts them)
  - crash after KV commit    -> txn fully present
A transaction is never partially visible (single-batch commit).

Reads overlay an object's extents in log order (latest wins per byte),
verifying each extent CRC — BlueStore's csum-on-read EIO stance.
Objects whose extent chains grow past ``compact_extents`` are rewritten
as a single extent during the next apply (object-level compaction).
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import blockdev
from .kv import WriteBatch, rm_object_rows
from .objectstore import (ChecksumError, Coll, ObjectStoreError,
                          OP_OMAP_RM, OP_OMAP_SET, OP_REMOVE, OP_SETATTR,
                          OP_TOUCH, OP_TRUNCATE, OP_WRITE, OP_WRITE_FULL,
                          Transaction)
from .wal_kv import WalDB

# obj_off, vlen (valid overlay bytes), log_off, crc, plen (payload
# bytes in the log, what the crc covers; vlen <= plen after truncation)
_EXT = struct.Struct("<QIQII")


@dataclass
class _Meta:
    size: int = 0
    extents: List[Tuple[int, int, int, int, int]] = field(
        default_factory=list)

    def encode(self) -> bytes:
        out = [struct.pack("<QI", self.size, len(self.extents))]
        out += [_EXT.pack(*e) for e in self.extents]
        return b"".join(out)

    @classmethod
    def decode(cls, blob: bytes) -> "_Meta":
        size, n = struct.unpack_from("<QI", blob, 0)
        off = 12
        ext = []
        for _ in range(n):
            ext.append(_EXT.unpack_from(blob, off))
            off += _EXT.size
        return cls(size=size, extents=ext)


def _collkey(coll: Coll) -> str:
    return f"{coll[0]}.{coll[1]}"


def _objkey(coll: Coll, oid: str) -> str:
    return f"{_collkey(coll)}/{oid}"


class FileStore:
    """Durable ObjectStore on a directory (data.log + WalDB metadata)."""

    def __init__(self, path: str, *, fsync: bool = True,
                 compact_extents: int = 16, fsck_on_mount: bool = True,
                 gc_factor: int = 4, gc_min_bytes: int = 1 << 22):
        self.path = path
        self.fsync = fsync
        self.compact_extents = compact_extents
        self.gc_factor = gc_factor
        self.gc_min_bytes = gc_min_bytes
        os.makedirs(path, exist_ok=True)
        self.kv = WalDB(os.path.join(path, "kv"), fsync=fsync)
        # the live data log is generation-named; the current generation
        # lives in the KV so a GC flips extents AND generation in one
        # atomic batch (see gc_data_log)
        gen_blob = self.kv.get("meta", "data_gen")
        self._gen = int(gen_blob) if gen_blob else 0
        # migrate pre-generation stores: their extents reference the
        # bytes now living in data.0.log
        legacy = os.path.join(path, "data.log")
        if self._gen == 0 and os.path.exists(legacy) and \
                not os.path.exists(self._gen_path(0)):
            blockdev.replace(legacy, self._gen_path(0))
        self._data_path = self._gen_path(self._gen)
        # append log behind the BlockDevice barrier API (reads share
        # the same device handle — no separate read fd)
        self._data = blockdev.BlockDevice(self._data_path)
        self._lock = threading.RLock()
        self.txns_applied = 0
        self._drop_stale_generations()
        if fsck_on_mount:
            try:
                bad = self.fsck()
            except Exception:
                self.close()
                raise
            if bad:
                self.close()
                raise ObjectStoreError(
                    f"fsck on mount: bad objects {bad}")

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.path, f"data.{gen}.log")

    def _drop_stale_generations(self) -> None:
        """Crash leftovers: a half-written next-gen log whose KV flip
        never committed, or a previous-gen log already superseded."""
        for name in os.listdir(self.path):
            if name == f"data.{self._gen}.log" or \
                    not (name.startswith("data.") and
                         name.endswith(".log")):
                continue
            gen_part = name[len("data."):-len(".log")]
            if not gen_part.isdigit():
                continue               # never touch non-generation files
            blockdev.unlink(os.path.join(self.path, name))

    # ---------------------------------------------------------- data log --
    def _append_data(self, payloads: List[bytes]) -> List[Tuple[int, int]]:
        """Append payloads; returns (log_off, crc) per payload.  The
        caller holds the lock; fsync happens once per transaction."""
        spans = []
        for p in payloads:
            off = self._data.append(p)
            spans.append((off, zlib.crc32(p)))
        if self.fsync:
            self._data.fsync()
        return spans

    def _read_extent(self, log_off: int, ln: int, crc: int) -> bytes:
        buf = self._data.pread(ln, log_off)
        if len(buf) != ln or zlib.crc32(buf) != crc:
            raise ChecksumError(
                f"extent @{log_off}+{ln}: data fails checksum (EIO)")
        return buf

    # -------------------------------------------------------------- meta --
    def _meta(self, coll: Coll, oid: str) -> Optional[_Meta]:
        blob = self.kv.get("obj", _objkey(coll, oid))
        return _Meta.decode(blob) if blob is not None else None

    # ------------------------------------------------------------- write --
    def apply_transaction(self, txn: Transaction) -> None:
        """Stage all ops, then: data append + fsync, then ONE KV batch."""
        with self._lock:
            staged: Dict[Tuple[Coll, str], Optional[_Meta]] = {}
            xattrs: Dict[Tuple[Coll, str, str], Optional[bytes]] = {}
            omaps: Dict[Tuple[Coll, str, str], Optional[bytes]] = {}
            touched_colls: List[Coll] = []
            payloads: List[bytes] = []          # pending data-log appends

            def stage(coll: Coll, oid: str, create: bool) -> Optional[_Meta]:
                key = (coll, oid)
                if key not in staged:
                    cur = self._meta(coll, oid)
                    if cur is None:
                        staged[key] = _Meta() if create else None
                        if create:
                            touched_colls.append(coll)
                    else:
                        staged[key] = _Meta(cur.size, list(cur.extents))
                elif staged[key] is None and create:
                    staged[key] = _Meta()
                    touched_colls.append(coll)
                return staged[key]

            def rm_obj_rows(coll: Coll, oid: str) -> None:
                ok = _objkey(coll, oid) + "\x00"
                for prefix in ("xattr", "omap"):
                    for k, _ in self.kv.iterate(prefix, start=ok):
                        if not k.startswith(ok):
                            break
                        (xattrs if prefix == "xattr" else omaps)[
                            (coll, oid, k[len(ok):])] = None
                # rows staged EARLIER IN THIS TXN die with the object too
                for staged_rows in (xattrs, omaps):
                    for (c2, o2, key2) in list(staged_rows):
                        if (c2, o2) == (coll, oid):
                            staged_rows[(c2, o2, key2)] = None

            for op in txn.ops:
                kind = op[0]
                if kind == OP_TOUCH:
                    _, coll, oid = op
                    stage(coll, oid, create=True)
                elif kind in (OP_WRITE, OP_WRITE_FULL):
                    if kind == OP_WRITE:
                        _, coll, oid, offset, data = op
                    else:
                        _, coll, oid, data = op
                        offset = 0
                    o = stage(coll, oid, create=True)
                    if kind == OP_WRITE_FULL:
                        o.extents = []
                        o.size = len(data)
                    else:
                        o.size = max(o.size, offset + len(data))
                    if len(data):
                        # placeholder extent (log_off = -1-payload_idx)
                        # so later same-txn ops (truncate clips,
                        # write_full resets) see this write; patched to
                        # the real log offset after the append below
                        o.extents.append((offset, len(data),
                                          -1 - len(payloads), 0,
                                          len(data)))
                        payloads.append(bytes(data))
                elif kind == OP_TRUNCATE:
                    _, coll, oid, size = op
                    o = stage(coll, oid, create=False)
                    if o is None:
                        raise ObjectStoreError(f"truncate: no object {oid}")
                    if size < o.size:
                        # shrink: clip overlay lengths so a later regrow
                        # reads zeros, not resurrected bytes
                        clipped = []
                        for obj_off, vlen, log_off, crc, plen in o.extents:
                            if obj_off >= size:
                                continue
                            vlen = min(vlen, size - obj_off)
                            clipped.append((obj_off, vlen, log_off, crc,
                                            plen))
                        o.extents = clipped
                    o.size = size
                elif kind == OP_REMOVE:
                    _, coll, oid = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(f"remove: no object {oid}")
                    staged[(coll, oid)] = None
                    rm_obj_rows(coll, oid)
                elif kind == OP_SETATTR:
                    _, coll, oid, key, value = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(f"setattr: no object {oid}")
                    xattrs[(coll, oid, key)] = bytes(value)
                elif kind == OP_OMAP_SET:
                    _, coll, oid, key, value = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(f"omap_set: no object {oid}")
                    omaps[(coll, oid, key)] = bytes(value)
                elif kind == OP_OMAP_RM:
                    _, coll, oid, key = op
                    if stage(coll, oid, create=False) is None:
                        raise ObjectStoreError(f"omap_rm: no object {oid}")
                    skey = (coll, oid, key)
                    if skey in omaps:
                        present = omaps[skey] is not None
                    else:
                        present = self.kv.get(
                            "omap",
                            _objkey(coll, oid) + "\x00" + key) is not None
                    if not present:
                        raise ObjectStoreError(f"omap_rm: no key {key}")
                    omaps[skey] = None
                else:
                    raise ObjectStoreError(f"unknown txn op {kind!r}")

            # append all payloads, then patch surviving placeholders
            # (placeholders dropped by remove/write_full/truncate simply
            # leave orphan log bytes, reclaimed by gc)
            spans = self._append_data(payloads) if payloads else []
            for o in staged.values():
                if o is None:
                    continue
                o.extents = [
                    (obj_off, vlen, *spans[-1 - log_off], plen)
                    if log_off < 0 else
                    (obj_off, vlen, log_off, crc, plen)
                    for (obj_off, vlen, log_off, crc, plen) in o.extents]
            batch = WriteBatch()
            for (coll, oid), o in staged.items():
                if o is None:
                    batch.rm("obj", _objkey(coll, oid))
                    continue
                if len(o.extents) > self.compact_extents:
                    data = self._materialize(o)
                    (off, crc), = self._append_data([bytes(data)])
                    o.extents = [(0, o.size, off, crc, o.size)] \
                        if o.size else []
                batch.set("obj", _objkey(coll, oid), o.encode())
            for coll in touched_colls:
                batch.set("coll", _collkey(coll), b"")
            for (coll, oid, key), v in xattrs.items():
                kk = _objkey(coll, oid) + "\x00" + key
                batch.set("xattr", kk, v) if v is not None \
                    else batch.rm("xattr", kk)
            for (coll, oid, key), v in omaps.items():
                kk = _objkey(coll, oid) + "\x00" + key
                batch.set("omap", kk, v) if v is not None \
                    else batch.rm("omap", kk)
            self.kv.submit(batch)               # atomic commit point
            self.txns_applied += 1
            self._maybe_gc()

    # ---------------------------------------------------------------- gc --
    _GC_CHECK_EVERY = 64

    def _maybe_gc(self) -> None:
        """Reclaim orphaned log space when the log outgrows the live
        data by gc_factor.  The live-bytes scan is O(objects), so it
        runs every _GC_CHECK_EVERY transactions, not per commit."""
        size = self._data.tell()
        if size < self.gc_min_bytes or \
                self.txns_applied % self._GC_CHECK_EVERY:
            return
        live = 0
        for _k, blob in self.kv.iterate("obj"):
            live += _Meta.decode(blob).size
        if size > self.gc_factor * max(live, 1):
            self.gc_data_log()

    def gc_data_log(self) -> int:
        """Rewrite every live object contiguously into a NEW generation
        data log; extents and the generation pointer flip in ONE KV
        batch, so a crash at any instruction leaves a consistent store
        (old gen + old extents, or new gen + new extents; stray files
        are dropped on mount).  Returns bytes reclaimed."""
        with self._lock:
            old_size = self._data.tell()
            new_gen = self._gen + 1
            new_path = self._gen_path(new_gen)
            batch = WriteBatch()
            newdev = blockdev.BlockDevice(new_path, fresh=True)
            for k, blob in self.kv.iterate("obj"):
                m = _Meta.decode(blob)
                data = bytes(self._materialize(m))
                off = newdev.append(data)
                m.extents = [(0, m.size, off, zlib.crc32(data),
                              m.size)] if m.size else []
                batch.set("obj", k, m.encode())
            if self.fsync:
                newdev.fsync()
            new_size = newdev.tell()
            batch.set("meta", "data_gen", str(new_gen).encode())
            self.kv.submit(batch)               # the atomic flip
            self._data.close()
            old_path = self._data_path
            self._gen = new_gen
            self._data_path = new_path
            self._data = newdev
            blockdev.unlink(old_path)
            return max(0, old_size - new_size)

    def _materialize(self, meta: _Meta) -> bytearray:
        data = bytearray(meta.size)
        for obj_off, vlen, log_off, crc, plen in meta.extents:
            buf = self._read_extent(log_off, plen, crc)
            end = min(obj_off + vlen, meta.size)
            if end > obj_off:
                data[obj_off:end] = buf[:end - obj_off]
        return data

    # -------------------------------------------------------------- read --
    def _get_meta(self, coll: Coll, oid: str) -> _Meta:
        m = self._meta(coll, oid)
        if m is None:
            raise ObjectStoreError(f"no object {oid} in {coll}")
        return m

    def exists(self, coll: Coll, oid: str) -> bool:
        return self.kv.get("obj", _objkey(coll, oid)) is not None

    def read(self, coll: Coll, oid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        with self._lock:
            m = self._get_meta(coll, oid)
            data = self._materialize(m)
        end = m.size if length is None else offset + length
        return bytes(data[offset:end])

    def stat(self, coll: Coll, oid: str) -> Dict[str, int]:
        with self._lock:
            m = self._get_meta(coll, oid)
            return {"size": m.size,
                    "csum": zlib.crc32(bytes(self._materialize(m)))}

    def getattr(self, coll: Coll, oid: str, key: str) -> bytes:
        v = self.kv.get("xattr", _objkey(coll, oid) + "\x00" + key)
        if v is None:
            self._get_meta(coll, oid)          # object-missing error first
            raise KeyError(key)
        return v

    def omap_get(self, coll: Coll, oid: str, key: str) -> bytes:
        v = self.kv.get("omap", _objkey(coll, oid) + "\x00" + key)
        if v is None:
            self._get_meta(coll, oid)
            raise KeyError(key)
        return v

    def omap_list(self, coll: Coll, oid: str,
                  start: str = "") -> List[Tuple[str, bytes]]:
        """All omap rows of an object from ``start`` (sorted) — the
        ObjectMap::get_iterator role (PG logs live here)."""
        prefix = _objkey(coll, oid) + "\x00"
        out = []
        for k, v in self.kv.iterate("omap", start=prefix + start):
            if not k.startswith(prefix):
                break
            out.append((k[len(prefix):], v))
        return out

    def list_objects(self, coll: Coll) -> List[str]:
        ck = _collkey(coll) + "/"
        out = []
        for k, _ in self.kv.iterate("obj", start=ck):
            if not k.startswith(ck):
                break
            out.append(k[len(ck):])
        return sorted(out)

    def list_collections(self) -> List[Coll]:
        out = []
        for k, _ in self.kv.iterate("coll"):
            pool, pg = k.split(".")
            out.append((int(pool), int(pg)))
        return sorted(out)

    # ------------------------------------------------------------- fsck --
    def fsck(self, repair: bool = False) -> List[Tuple[Coll, str]]:
        """Verify every object's extents (bounds + CRC); also computes
        the orphaned data-log fraction into ``last_fsck_orphan_bytes``.
        ``repair=True`` quarantines inconsistent objects (drops their
        meta + xattr/omap rows in one batch) so recovery re-replicates
        them — same contract as BlueStore.fsck(repair=True)."""
        bad = []
        live = 0
        size = self._data.tell()
        for k, blob in self.kv.iterate("obj"):
            ck, oid = k.split("/", 1)
            pool, pg = ck.split(".")
            coll = (int(pool), int(pg))
            try:
                m = _Meta.decode(blob)
                for obj_off, vlen, log_off, crc, plen in m.extents:
                    if log_off + plen > size:
                        raise ObjectStoreError("extent past data log end")
                    self._read_extent(log_off, plen, crc)
                    live += plen
            except (ObjectStoreError, ChecksumError, struct.error):
                bad.append((coll, oid))
        self.last_fsck_orphan_bytes = max(0, size - live)
        if repair and bad:
            batch = WriteBatch()
            for coll, oid in bad:
                rm_object_rows(self.kv, batch, "obj",
                               _objkey(coll, oid))
            self.kv.submit(batch)
        return bad

    # --------------------------------------------------------- test hook --
    def corrupt(self, coll: Coll, oid: str, offset: int = 0) -> None:
        """Flip a stored byte WITHOUT updating checksums (EIO path)."""
        with self._lock:
            m = self._get_meta(coll, oid)
            if not m.extents:
                raise ObjectStoreError(f"{oid} has no stored extents")
            for obj_off, vlen, log_off, crc, plen in reversed(m.extents):
                if obj_off <= offset < obj_off + vlen:
                    pos = log_off + (offset - obj_off)
                    break
            else:
                pos = m.extents[-1][2]
            b = self._data.pread(1, pos)
            self._data.pwrite(bytes([b[0] ^ 0xFF]), pos)

    def close(self) -> None:
        with self._lock:
            if self.fsync:
                self._data.fsync()
            self._data.close()
            self.kv.close()
