"""Journaler — append-only journal over RADOS objects.

The src/journal/ role (Journaler/ObjectRecorder/JournalMetadata, used
by rbd-mirror and, in spirit, the MDS's MDLog): an ordered stream of
entries recorded into a chain of fixed-capacity journal objects, with
a small header object tracking the active chain and trim position.
Entries are length-prefixed and CRC-protected; replay walks the chain
in order and stops at a torn tail; trim drops whole objects behind the
commit position.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Iterator, Tuple

_ENT = struct.Struct("<IIQ")      # len, crc, seq


class Journaler:
    def __init__(self, ioctx, name: str, object_bytes: int = 1 << 16):
        self.ioctx = ioctx
        self.name = name
        self.object_bytes = object_bytes
        self._load_header()

    # ------------------------------------------------------------ header --
    def _header_oid(self) -> str:
        return f"journal.{self.name}.header"

    def _obj_oid(self, idx: int) -> str:
        return f"journal.{self.name}.{idx:08x}"

    def _load_header(self) -> None:
        try:
            h = json.loads(self.ioctx.read(self._header_oid()).decode())
        except Exception:
            h = {"first": 0, "active": 0, "seq": 0}
        self.first = h["first"]          # oldest live journal object
        self.active = h["active"]        # object being appended
        self.seq = h["seq"]              # next entry sequence number

    def _save_header(self) -> None:
        self.ioctx.write_full(self._header_oid(), json.dumps(
            {"first": self.first, "active": self.active,
             "seq": self.seq}).encode())

    # ------------------------------------------------------------- append --
    def append(self, payload: bytes) -> int:
        """Record one entry; returns its sequence number.  The entry is
        durable in the journal object BEFORE the header advances."""
        try:
            cur = self.ioctx.read(self._obj_oid(self.active))
        except Exception:
            cur = b""
        if len(cur) + _ENT.size + len(payload) > self.object_bytes and cur:
            self.active += 1
            cur = b""
        seq = self.seq
        rec = _ENT.pack(len(payload), zlib.crc32(payload), seq) + payload
        self.ioctx.write_full(self._obj_oid(self.active), cur + rec)
        self.seq = seq + 1
        self._save_header()
        return seq

    # ------------------------------------------------------------- replay --
    def replay(self) -> Iterator[Tuple[int, bytes]]:
        """Yield (seq, payload) in order from the trim position; torn
        or corrupt tails end the replay (crash semantics)."""
        idx = self.first
        while True:
            try:
                blob = self.ioctx.read(self._obj_oid(idx))
            except Exception:
                return
            off = 0
            while off + _ENT.size <= len(blob):
                ln, crc, seq = _ENT.unpack_from(blob, off)
                payload = blob[off + _ENT.size:off + _ENT.size + ln]
                if len(payload) != ln or zlib.crc32(payload) != crc:
                    return                      # torn tail
                yield seq, payload
                off += _ENT.size + ln
            idx += 1

    # --------------------------------------------------------------- trim --
    def trim_to(self, seq: int) -> int:
        """Drop whole journal objects whose every entry is < seq
        (committed); returns objects removed."""
        removed = 0
        idx = self.first
        while idx < self.active:
            try:
                blob = self.ioctx.read(self._obj_oid(idx))
            except Exception:
                break
            last = -1
            off = 0
            while off + _ENT.size <= len(blob):
                ln, _crc, s = _ENT.unpack_from(blob, off)
                last = s
                off += _ENT.size + ln
            if last >= seq:
                break
            self.ioctx.remove(self._obj_oid(idx))
            idx += 1
            removed += 1
        self.first = idx
        self._save_header()
        return removed
