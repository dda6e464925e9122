"""WalDB — durable ordered KV with crash-consistent write batches.

The role of RocksDBStore under the mon store and the object store's
metadata (src/kv/RocksDBStore.cc; src/mon/MonitorDBStore.h sits directly
on this seam).  Same interface as cluster/kv.py's MemDB (WriteBatch
submit / get / iterate / prefix scans), plus:

  * every submitted batch is appended to a write-ahead log as one
    length-prefixed, CRC32-protected record BEFORE mutating the
    in-memory index — the RocksDB WAL contract (batch atomicity +
    prefix durability);
  * mount() replays the WAL over the newest snapshot, discarding any
    torn tail (a partial append from a crash mid-write);
  * when the WAL exceeds ``compact_bytes``, the full state is written
    to a new snapshot (temp file + fsync + atomic rename, then a
    MANIFEST pointer flip) and the WAL restarts — the memtable-flush /
    compaction role.

Crash model: kill -9 at ANY instruction leaves the store mountable with
exactly the batches whose WAL record was fully written, in order (see
tests/test_durable.py's torn-write and kill -9 tests).

Record encoding (little-endian):
  WAL record:   u32 magic | u64 seq | u32 len | u32 crc | payload
  payload:      u32 n_ops | n x (u8 op | u16 plen | u16 klen | u32 vlen
                                 | prefix | key | value)
  snapshot:     u64 last_seq | records in the same framing (op=set)
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from . import blockdev
from .kv import MemDB, WriteBatch

_MAGIC = 0x57414C31                      # "WAL1"
_HDR = struct.Struct("<IQII")            # magic, seq, len, crc
_OPH = struct.Struct("<BHHI")            # op, plen, klen, vlen
_OPS = {"set": 1, "rm": 2, "rm_prefix": 3}
_OPS_R = {v: k for k, v in _OPS.items()}


def _encode_batch(ops) -> bytes:
    out = [struct.pack("<I", len(ops))]
    for op, prefix, key, value in ops:
        p = prefix.encode()
        k = key.encode()
        v = value if value is not None else b""
        out.append(_OPH.pack(_OPS[op], len(p), len(k), len(v)))
        out.append(p)
        out.append(k)
        out.append(v)
    return b"".join(out)


def _decode_batch(payload: bytes) -> List[Tuple]:
    (n,) = struct.unpack_from("<I", payload, 0)
    off = 4
    ops = []
    for _ in range(n):
        opc, plen, klen, vlen = _OPH.unpack_from(payload, off)
        off += _OPH.size
        prefix = payload[off:off + plen].decode(); off += plen
        key = payload[off:off + klen].decode(); off += klen
        value = payload[off:off + vlen]; off += vlen
        op = _OPS_R[opc]
        ops.append((op, prefix, key, value if op == "set" else None))
    return ops


class WalDB(MemDB):
    """MemDB index + write-ahead durability on a directory."""

    def __init__(self, path: str, *, fsync: bool = True,
                 compact_bytes: int = 64 << 20):
        super().__init__()
        self.path = path
        self.fsync = fsync
        self.compact_bytes = compact_bytes
        self._wlock = threading.Lock()
        self._seq = 0
        # cold-restart observability: what the last mount's WAL
        # replay cost (records/bytes applied, seconds) — the
        # bluestore.wal_replay_* perf counters read this
        self.replay_stats = {"records": 0, "bytes": 0, "seconds": 0.0}
        os.makedirs(path, exist_ok=True)
        self._mount()

    # ------------------------------------------------------------- mount --
    def _manifest_path(self) -> str:
        return os.path.join(self.path, "MANIFEST")

    def _wal_path(self) -> str:
        return os.path.join(self.path, "wal.log")

    def _mount(self) -> None:
        snap_id = 0
        mf = self._manifest_path()
        if os.path.exists(mf):
            try:
                snap_id = int(open(mf).read().strip() or "0")
            except ValueError:
                snap_id = 0
        if snap_id:
            self._load_snapshot(
                os.path.join(self.path, f"snap.{snap_id}"))
        self._replay_wal()
        # reopen the WAL for appends (preserving any replayed tail)
        # through the BlockDevice barrier API — every byte this store
        # persists must be visible to the crash-state recorder
        self._wal = blockdev.BlockDevice(self._wal_path())

    def _load_snapshot(self, path: str) -> None:
        with open(path, "rb") as f:
            blob = f.read()
        (self._seq,) = struct.unpack_from("<Q", blob, 0)
        off = 8
        crc_stored, ln = struct.unpack_from("<II", blob, off)
        off += 8
        payload = blob[off:off + ln]
        if len(payload) != ln or zlib.crc32(payload) != crc_stored:
            raise IOError(f"snapshot {path} corrupt")
        batch = WriteBatch()
        batch.ops = _decode_batch(payload)
        MemDB.submit(self, batch)

    def _replay_wal(self) -> None:
        path = self._wal_path()
        if not os.path.exists(path):
            return
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            blob = f.read()
        off = 0
        good_end = 0
        replayed = 0
        while off + _HDR.size <= len(blob):
            magic, seq, ln, crc = _HDR.unpack_from(blob, off)
            if magic != _MAGIC:
                break
            payload = blob[off + _HDR.size:off + _HDR.size + ln]
            if len(payload) != ln or zlib.crc32(payload) != crc:
                break                     # torn tail: discard
            if seq > self._seq:          # records <= snapshot seq skip
                batch = WriteBatch()
                batch.ops = _decode_batch(payload)
                MemDB.submit(self, batch)
                self._seq = seq
                replayed += 1
            off += _HDR.size + ln
            good_end = off
        if good_end < len(blob):
            # truncate the torn tail so future appends are clean
            dev = blockdev.BlockDevice(path)
            dev.truncate(good_end)
            dev.close()
        self.replay_stats = {"records": replayed, "bytes": good_end,
                             "seconds": time.perf_counter() - t0}

    # ------------------------------------------------------------- write --
    def submit(self, batch: WriteBatch) -> None:
        payload = _encode_batch(batch.ops)
        with self._wlock:
            self._seq += 1
            rec = _HDR.pack(_MAGIC, self._seq, len(payload),
                            zlib.crc32(payload)) + payload
            # the durability order IS the contract CrashDev proves:
            # WAL record on media and fsynced BEFORE the in-memory
            # index mutates (= before any caller can observe the
            # batch as committed)
            self._wal.append(rec)
            if self.fsync:
                self._wal.fsync()
            MemDB.submit(self, batch)
            if self._wal.tell() >= self.compact_bytes:
                self._compact_locked()

    def sync(self) -> None:
        with self._wlock:
            self._wal.fsync()

    # ----------------------------------------------------------- compact --
    def _compact_locked(self) -> None:
        """Snapshot full state, flip MANIFEST, restart the WAL."""
        snap_id = self._seq
        ops = [("set", p, k, self._data[(p, k)]) for p, k in self._keys]
        payload = _encode_batch(ops)
        tmp = os.path.join(self.path, "snap.tmp")
        # write-tmp / fsync / atomic-rename: the snapshot's bytes are
        # on media BEFORE any name points at them (the idiom that
        # makes blockdev's ordered-rename crash model sound)
        dev = blockdev.BlockDevice(tmp, fresh=True)
        dev.append(struct.pack("<Q", self._seq))
        dev.append(struct.pack("<II", zlib.crc32(payload),
                               len(payload)))
        dev.append(payload)
        dev.fsync()
        dev.close()
        final = os.path.join(self.path, f"snap.{snap_id}")
        blockdev.replace(tmp, final)
        mtmp = self._manifest_path() + ".tmp"
        dev = blockdev.BlockDevice(mtmp, fresh=True)
        dev.append(str(snap_id).encode())
        dev.fsync()
        dev.close()
        blockdev.replace(mtmp, self._manifest_path())
        # WAL restart: records up to _seq are in the snapshot
        self._wal.close()
        self._wal = blockdev.BlockDevice(self._wal_path(), fresh=True)
        # drop superseded snapshots
        for name in os.listdir(self.path):
            if name.startswith("snap.") and name != f"snap.{snap_id}" \
                    and name != "snap.tmp":
                blockdev.unlink(os.path.join(self.path, name))

    def compact(self) -> None:
        with self._wlock:
            self._compact_locked()

    def close(self) -> None:
        with self._wlock:
            if self._wal and not self._wal.closed:
                if self.fsync:
                    self._wal.fsync()
                self._wal.close()
