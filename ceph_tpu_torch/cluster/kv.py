"""KeyValueDB — the ordered-KV abstraction (src/kv/ role).

The reference wraps RocksDB behind `KeyValueDB` (src/kv/KeyValueDB.h,
RocksDBStore.cc; memdb for tests): prefixed keyspaces, atomic write
batches, ordered iteration and prefix scans.  The mon store
(MonitorDBStore) and BlueStore's metadata both sit on this seam.  Here:
a sorted in-memory implementation with the same contract — enough to
back the monitor's durable state and to keep the seam real for a future
native backend.
"""
from __future__ import annotations

import bisect
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple


class WriteBatch:
    """Atomic mutation set (KeyValueDB::Transaction role)."""

    def __init__(self):
        self.ops: List[Tuple[str, str, str, Optional[bytes]]] = []

    def set(self, prefix: str, key: str, value: bytes) -> "WriteBatch":
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rm(self, prefix: str, key: str) -> "WriteBatch":
        self.ops.append(("rm", prefix, key, None))
        return self

    def rm_prefix(self, prefix: str) -> "WriteBatch":
        self.ops.append(("rm_prefix", prefix, "", None))
        return self


def rm_object_rows(db: "MemDB", batch: WriteBatch, main_prefix: str,
                   objkey: str) -> None:
    """Queue removal of one object's main metadata row plus every
    ``objkey + "\\x00" + key`` xattr/omap row — the quarantine/remove
    row shape BlueStore and FileStore share (their KV layouts agree
    on the ``<objkey>\\0<key>`` scheme, so the scan lives once)."""
    batch.rm(main_prefix, objkey)
    start = objkey + "\x00"
    for prefix in ("xattr", "omap"):
        for k, _ in db.iterate(prefix, start=start):
            if not k.startswith(start):
                break
            batch.rm(prefix, k)


class MemDB:
    """Sorted dict KeyValueDB (src/kv/memdb role)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._data: Dict[Tuple[str, str], bytes] = {}
        self._keys: List[Tuple[str, str]] = []     # sorted
        self.batches_applied = 0

    # ------------------------------------------------------------- write --
    def submit(self, batch: WriteBatch) -> None:
        with self._lock:
            for op, prefix, key, value in batch.ops:
                if op == "set":
                    k = (prefix, key)
                    if k not in self._data:
                        bisect.insort(self._keys, k)
                    self._data[k] = value
                elif op == "rm":
                    k = (prefix, key)
                    if k in self._data:
                        del self._data[k]
                        i = bisect.bisect_left(self._keys, k)
                        del self._keys[i]
                elif op == "rm_prefix":
                    doomed = [k for k in self._keys if k[0] == prefix]
                    for k in doomed:
                        del self._data[k]
                    self._keys = [k for k in self._keys
                                  if k[0] != prefix]
            self.batches_applied += 1

    def set(self, prefix: str, key: str, value: bytes) -> None:
        self.submit(WriteBatch().set(prefix, key, value))

    # -------------------------------------------------------------- read --
    def get(self, prefix: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get((prefix, key))

    def exists(self, prefix: str, key: str) -> bool:
        return self.get(prefix, key) is not None

    def iterate(self, prefix: str, start: str = ""
                ) -> Iterator[Tuple[str, bytes]]:
        """Ordered iteration within a prefix from `start` (the
        KeyValueDB iterator contract)."""
        with self._lock:
            i = bisect.bisect_left(self._keys, (prefix, start))
            snapshot = []
            while i < len(self._keys) and self._keys[i][0] == prefix:
                k = self._keys[i]
                snapshot.append((k[1], self._data[k]))
                i += 1
        return iter(snapshot)

    def keys(self, prefix: str) -> List[str]:
        return [k for k, _ in self.iterate(prefix)]

    def state_digest(self) -> int:
        """crc32 over the full sorted (prefix, key, value) state —
        cheap whole-store equality for crash-consistency checks (two
        replay orders converged iff their digests match).  Length
        framing keeps adjacent fields from aliasing."""
        with self._lock:
            h = 0
            for k in self._keys:
                v = self._data[k]
                p = k[0].encode()
                key = k[1].encode()
                h = zlib.crc32(struct.pack("<III", len(p), len(key),
                                           len(v)), h)
                h = zlib.crc32(p + key + v, h)
            return h
