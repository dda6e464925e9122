"""ObjectStore — the local persistence interface (L5).

Role of src/os/ObjectStore.h + Transaction.h (the transaction-based
store contract every backend implements) with the memstore backend
(src/os/memstore/) and BlueStore's data-integrity stance (per-object
checksums verified on read, the role of BlueStore's per-block crc32c;
fsck() walks everything).

Semantics kept from the reference contract:
  * all mutations travel in a Transaction (an op list), applied
    atomically — on any op failure the whole txn rolls back;
  * objects live in collections (one per PG: the `coll_t` role);
  * touch/write/truncate/remove/setattr/omap ops;
  * reads verify the stored checksum and raise on mismatch (BlueStore
    returns EIO on csum failure rather than serving bad bytes).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Coll = Tuple[int, int]           # (pool, pg) — coll_t


class ObjectStoreError(IOError):
    pass


class ChecksumError(ObjectStoreError):
    pass


# transaction op codes (Transaction.h OP_* subset)
OP_TOUCH = "touch"
OP_WRITE = "write"
OP_WRITE_FULL = "write_full"
OP_TRUNCATE = "truncate"
OP_REMOVE = "remove"
OP_SETATTR = "setattr"
OP_OMAP_SET = "omap_set"
OP_OMAP_RM = "omap_rm"


class Transaction:
    """Recorded op list (ObjectStore::Transaction): build host-side,
    apply atomically."""

    def __init__(self):
        self.ops: List[Tuple] = []
        # trusted per-block csums riding ALONGSIDE the op list (a
        # side table keyed (coll, oid), so stores that know nothing
        # about checksums keep unpacking the same op tuples): the
        # wire's one-pass verify scan hands its sub-crcs here and
        # BlueStore._make_blob adopts them instead of re-scanning
        self.csums: dict = {}

    def touch(self, coll: Coll, oid: str) -> "Transaction":
        self.ops.append((OP_TOUCH, coll, oid))
        return self

    def write(self, coll: Coll, oid: str, offset: int,
              data: bytes) -> "Transaction":
        self.ops.append((OP_WRITE, coll, oid, offset, bytes(data)))
        return self

    def write_full(self, coll: Coll, oid: str,
                   data: bytes, csums=None,
                   copy: bool = True) -> "Transaction":
        """``copy=False`` keeps ``data`` as the caller's buffer view
        (zero-copy wire path — the view must stay immutable until the
        transaction applies); the default snapshot stays for callers
        handing in mutable buffers.  ``csums`` (common/crcutil.Csums
        over exactly these bytes) marks them pre-verified."""
        if copy and not isinstance(data, bytes):
            data = bytes(data)
        self.ops.append((OP_WRITE_FULL, coll, oid, data))
        if csums is not None:
            self.csums[(coll, oid)] = csums
        else:
            # a later uncsummed rewrite of the same oid must not
            # adopt an earlier write's now-stale trusted csums (the
            # store would commit valid bytes under wrong checksums
            # and EIO every future read)
            self.csums.pop((coll, oid), None)
        return self

    def truncate(self, coll: Coll, oid: str, size: int) -> "Transaction":
        self.ops.append((OP_TRUNCATE, coll, oid, size))
        return self

    def remove(self, coll: Coll, oid: str) -> "Transaction":
        self.ops.append((OP_REMOVE, coll, oid))
        return self

    def setattr(self, coll: Coll, oid: str, key: str,
                value: bytes) -> "Transaction":
        self.ops.append((OP_SETATTR, coll, oid, key, bytes(value)))
        return self

    def omap_set(self, coll: Coll, oid: str, key: str,
                 value: bytes) -> "Transaction":
        self.ops.append((OP_OMAP_SET, coll, oid, key, bytes(value)))
        return self

    def omap_rm(self, coll: Coll, oid: str, key: str) -> "Transaction":
        self.ops.append((OP_OMAP_RM, coll, oid, key))
        return self

    def __len__(self) -> int:
        return len(self.ops)


@dataclass
class _Obj:
    data: bytearray = field(default_factory=bytearray)
    csum: int = 0
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    omap: Dict[str, bytes] = field(default_factory=dict)
    # verified-since-last-external-mutation flag: writes recompute the
    # csum (trivially verified); only corrupt()/fsck force a re-check,
    # so the read hot path skips an O(size) crc per shard read
    verified: bool = True

    def recsum(self) -> None:
        self.csum = zlib.crc32(bytes(self.data))
        self.verified = True

    def check(self) -> bool:
        self.verified = zlib.crc32(bytes(self.data)) == self.csum
        return self.verified


class MemStore:
    """In-memory ObjectStore backend with verified checksums."""

    def __init__(self):
        self._colls: Dict[Coll, Dict[str, _Obj]] = {}
        self.txns_applied = 0

    # ------------------------------------------------------------- write --
    def apply_transaction(self, txn: Transaction) -> None:
        """Atomic: validate + stage against copies, then commit."""
        touched: Dict[Tuple[Coll, str], Optional[_Obj]] = {}

        def stage(coll: Coll, oid: str, create: bool,
                  keep_data: bool = True) -> Optional[_Obj]:
            """Copy-on-write staging; keep_data=False skips copying the
            payload bytes (write_full replaces them anyway — the
            simulator's hottest path would otherwise pay an O(size)
            deepcopy per overwrite)."""
            key = (coll, oid)
            if key not in touched:
                cur = self._colls.get(coll, {}).get(oid)
                if cur is None:
                    touched[key] = _Obj() if create else None
                else:
                    touched[key] = _Obj(
                        data=bytearray(cur.data) if keep_data
                        else bytearray(),
                        csum=cur.csum if keep_data else 0,
                        xattrs=dict(cur.xattrs),
                        omap=dict(cur.omap),
                        verified=cur.verified if keep_data else True)
            elif touched[key] is None and create:
                touched[key] = _Obj()
            return touched[key]

        for op in txn.ops:
            kind = op[0]
            if kind == OP_TOUCH:
                _, coll, oid = op
                stage(coll, oid, create=True)
            elif kind == OP_WRITE:
                _, coll, oid, offset, data = op
                o = stage(coll, oid, create=True)
                if len(o.data) < offset + len(data):
                    o.data.extend(b"\0" * (offset + len(data) -
                                           len(o.data)))
                o.data[offset:offset + len(data)] = data
                o.recsum()
            elif kind == OP_WRITE_FULL:
                _, coll, oid, data = op
                o = stage(coll, oid, create=True, keep_data=False)
                o.data = bytearray(data)
                o.recsum()
            elif kind == OP_TRUNCATE:
                _, coll, oid, size = op
                o = stage(coll, oid, create=False)
                if o is None:
                    raise ObjectStoreError(f"truncate: no object {oid}")
                if len(o.data) < size:
                    o.data.extend(b"\0" * (size - len(o.data)))
                else:
                    del o.data[size:]
                o.recsum()
            elif kind == OP_REMOVE:
                _, coll, oid = op
                if stage(coll, oid, create=False,
                         keep_data=False) is None:
                    raise ObjectStoreError(f"remove: no object {oid}")
                touched[(coll, oid)] = None
            elif kind == OP_SETATTR:
                _, coll, oid, key, value = op
                o = stage(coll, oid, create=False)
                if o is None:
                    raise ObjectStoreError(f"setattr: no object {oid}")
                o.xattrs[key] = value
            elif kind == OP_OMAP_SET:
                _, coll, oid, key, value = op
                o = stage(coll, oid, create=False)
                if o is None:
                    raise ObjectStoreError(f"omap_set: no object {oid}")
                o.omap[key] = value
            elif kind == OP_OMAP_RM:
                _, coll, oid, key = op
                o = stage(coll, oid, create=False)
                if o is None or key not in o.omap:
                    raise ObjectStoreError(f"omap_rm: no key {key}")
                del o.omap[key]
            else:
                raise ObjectStoreError(f"unknown txn op {kind!r}")
        # commit: only after every op validated
        for (coll, oid), obj in touched.items():
            c = self._colls.setdefault(coll, {})
            if obj is None:
                c.pop(oid, None)
            else:
                c[oid] = obj
        self.txns_applied += 1

    # -------------------------------------------------------------- read --
    def _get(self, coll: Coll, oid: str) -> _Obj:
        o = self._colls.get(coll, {}).get(oid)
        if o is None:
            raise ObjectStoreError(f"no object {oid} in {coll}")
        return o

    def exists(self, coll: Coll, oid: str) -> bool:
        return oid in self._colls.get(coll, {})

    def verify(self, coll: Coll, oid: str) -> bool:
        """Presence + integrity without copying payload bytes: True iff
        the object exists and its (lazily re-checked) checksum holds."""
        o = self._colls.get(coll, {}).get(oid)
        return o is not None and (o.verified or o.check())

    def read(self, coll: Coll, oid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        o = self._get(coll, oid)
        if not o.verified and not o.check():
            raise ChecksumError(
                f"{oid}: stored data fails checksum (EIO)")
        end = len(o.data) if length is None else offset + length
        return bytes(o.data[offset:end])

    def stat(self, coll: Coll, oid: str) -> Dict[str, int]:
        o = self._get(coll, oid)
        return {"size": len(o.data), "csum": o.csum}

    def getattr(self, coll: Coll, oid: str, key: str) -> bytes:
        return self._get(coll, oid).xattrs[key]

    def omap_get(self, coll: Coll, oid: str, key: str) -> bytes:
        return self._get(coll, oid).omap[key]

    def omap_list(self, coll: Coll, oid: str,
                  start: str = "") -> List[Tuple[str, bytes]]:
        """All omap rows of an object from ``start`` (sorted) — the
        ObjectMap::get_iterator role (PG logs live here)."""
        o = self._get(coll, oid)
        return [(k, o.omap[k]) for k in sorted(o.omap) if k >= start]

    def list_objects(self, coll: Coll) -> List[str]:
        return sorted(self._colls.get(coll, {}))

    def list_collections(self) -> List[Coll]:
        return sorted(self._colls)

    # ------------------------------------------------------------- fsck --
    def fsck(self, repair: bool = False) -> List[Tuple[Coll, str]]:
        """Verify every object's checksum (BlueStore fsck role).
        ``repair=True`` quarantines failing objects (drops them) so
        recovery re-replicates from healthy copies — the same
        contract the durable backends implement."""
        bad = []
        for coll, objs in self._colls.items():
            for oid, o in objs.items():
                if not o.check():
                    bad.append((coll, oid))
        if repair:
            for coll, oid in bad:
                self._colls.get(coll, {}).pop(oid, None)
        return bad

    # --------------------------------------------------------- test hook --
    def corrupt(self, coll: Coll, oid: str, offset: int = 0) -> None:
        """Flip a byte WITHOUT updating the checksum (EIO injection)."""
        o = self._get(coll, oid)
        if not o.data:
            o.data.extend(b"\0")
        o.data[offset] ^= 0xFF
        o.verified = False        # force the next read to re-check
