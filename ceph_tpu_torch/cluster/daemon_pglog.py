"""Durable per-PG op log for OSD daemons (the process-tier PGLog).

Daemons run the repo's own PGLog/peering
machinery, not an ad-hoc list/pull/push.  This module binds
cluster/pglog.PGLog to a FileStore: entries and last_complete live in
the omap of a per-PG meta object, and every shard write appends its
log entry IN THE SAME TRANSACTION — an object version and its log
record cannot diverge across a SIGKILL (the reference writes the pg
log and the op in one ObjectStore transaction too,
src/osd/PrimaryLogPG.cc prepare_transaction + PGLog write).

Row layout (omap of object "meta:pglog" in the PG's collection):
    e:{epoch:010d}.{seq:010d} -> json {"obj":…, "op":…}
    last_complete             -> "epoch.seq"
Versions are (epoch, seq) eversion_t pairs, compared as tuples.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .objectstore import Transaction
from .pglog import OP_DELETE, OP_MODIFY, LogEntry, PGLog, Version, ZERO

META_OID = "meta:pglog"


def _vkey(v: Version) -> str:
    return f"e:{v[0]:010d}.{v[1]:010d}"


def _venc(v: Version) -> bytes:
    return f"{v[0]}.{v[1]}".encode()


def _vdec(b: bytes) -> Version:
    e, s = bytes(b).decode().split(".")
    return (int(e), int(s))


class DurablePGLog:
    """One PG's log on one OSD daemon's FileStore."""

    def __init__(self, store, coll: Tuple[int, int],
                 max_entries: int = 3000):
        self.store = store
        self.coll = coll
        self.log = PGLog(max_entries=max_entries)
        self.last_complete: Version = ZERO
        self._load()

    # ----------------------------------------------------------- loading --
    def _load(self) -> None:
        if not self.store.exists(self.coll, META_OID):
            return
        for key, val in self.store.omap_list(self.coll, META_OID):
            if key.startswith("e:"):
                d = json.loads(bytes(val).decode())
                ep, seq = key[2:].split(".")
                v = (int(ep), int(seq))
                self.log.entries.append(LogEntry(v, d["obj"],
                                                 d.get("op",
                                                       OP_MODIFY)))
            elif key == "last_complete":
                self.last_complete = _vdec(val)
            elif key == "tail":
                self.log.tail = _vdec(val)
        self.log.entries.sort(key=lambda e: e.version)
        if self.log.entries:
            self.log.head = self.log.entries[-1].version
            self.log._seq = self.log.head[1]

    # ----------------------------------------------------------- writing --
    def _ensure_meta(self, txn: Transaction) -> None:
        if not self.store.exists(self.coll, META_OID):
            txn.touch(self.coll, META_OID)

    def append_txn(self, txn: Transaction, version: Version, obj: str,
                   op: int = OP_MODIFY,
                   advance_lc: bool = True) -> None:
        """Record one op into the caller's transaction and mirror it
        in memory once the caller applies the txn (callers MUST apply
        the txn; we update memory eagerly because apply_transaction
        either fully commits or raises, and on raise the daemon drops
        the connection/op anyway)."""
        self._ensure_meta(txn)
        txn.omap_set(self.coll, META_OID, _vkey(version),
                     json.dumps({"obj": obj, "op": op}).encode())
        e = LogEntry(version, obj, op)
        self.log.entries.append(e)
        self.log.head = version
        self.log._seq = max(self.log._seq, version[1])
        if advance_lc:
            self.last_complete = version
            txn.omap_set(self.coll, META_OID, "last_complete",
                         _venc(version))
        # bounded log: trim rows beyond the cap in the same txn
        while len(self.log.entries) > self.log.max_entries:
            dropped = self.log.entries.pop(0)
            self.log.tail = dropped.version
            txn.omap_rm(self.coll, META_OID, _vkey(dropped.version))
            txn.omap_set(self.coll, META_OID, "tail",
                         _venc(self.log.tail))

    def set_last_complete_txn(self, txn: Transaction,
                              version: Version) -> None:
        self._ensure_meta(txn)
        self.last_complete = version
        txn.omap_set(self.coll, META_OID, "last_complete",
                     _venc(version))

    def merge_tail_txn(self, txn: Transaction,
                       entries: List[Tuple[Version, str, int]],
                       head: Version) -> None:
        """Adopt the authority's log tail (PGLog::merge_log role):
        used by log_sync after delta/backfill recovery."""
        self._ensure_meta(txn)
        known = {e.version for e in self.log.entries}
        for v, obj, op in entries:
            v = (int(v[0]), int(v[1]))
            if v in known:
                continue
            txn.omap_set(self.coll, META_OID, _vkey(v),
                         json.dumps({"obj": obj, "op": op}).encode())
            self.log.entries.append(LogEntry(v, obj, op))
        self.log.entries.sort(key=lambda e: e.version)
        if self.log.entries:
            self.log.head = max(self.log.head,
                                self.log.entries[-1].version)
            self.log._seq = max(self.log._seq, self.log.head[1])
        self.set_last_complete_txn(txn, head)

    # ------------------------------------------------------------ queries --
    def next_version(self, epoch: int) -> Version:
        """Primary-side version assignment: strictly after head."""
        h = self.log.head
        if epoch > h[0]:
            return (epoch, 1)
        return (h[0], h[1] + 1)

    def info(self) -> Dict:
        return {"head": list(self.log.head),
                "last_complete": list(self.last_complete),
                "tail": list(self.log.tail),
                "n_entries": len(self.log.entries)}

    def entries_after(self, version: Version
                      ) -> List[Tuple[Version, str, int]]:
        return [(e.version, e.obj, e.op)
                for e in self.log.entries_after(version)]

    def covers(self, version: Version) -> bool:
        return self.log.covers(version)
