"""RadosStriper — striped single-object API over librados.

The libradosstriper role (src/libradosstriper/RadosStriperImpl.cc): a
logical "striped object" whose bytes are spread round-robin across
many RADOS objects by the file layout, presented through a plain
write/read/stat/truncate/remove surface.  The reference stores the
striper geometry and logical size as xattrs of the first stripe
object (striper.layout.*, striper.size) so any client can reopen the
striped object without out-of-band metadata; this librados slice
exposes object data (not raw xattrs), so the same role is played by a
sidecar metadata object ("<soid>.striper") holding size + layout.

Re-uses cluster/striper.py's extent math (the Striper::file_to_extents
role shared with RBD and the MDS file layout).
"""
from __future__ import annotations

import json
from typing import Optional, Set

from ..cluster.striper import FileLayout, file_to_extents


class StripedObjectError(IOError):
    pass


class RadosStriper:
    """Striped-object facade over one IoCtx."""

    def __init__(self, ioctx, layout: Optional[FileLayout] = None):
        self.ioctx = ioctx
        self.layout = layout or FileLayout(
            stripe_unit=1 << 16, stripe_count=4, object_size=1 << 18)

    # ----------------------------------------------------------- layout --
    def _oid(self, soid: str, objno: int) -> str:
        return f"{soid}.{objno:016x}"

    def _meta_oid(self, soid: str) -> str:
        return f"{soid}.striper"

    def _meta(self, soid: str) -> dict:
        # Only absence (ObjectNotFound is a KeyError) means "no striped
        # object"; a transient IOError must propagate, or exists() would
        # answer False and write() would silently reinitialize an
        # existing object's geometry.
        try:
            raw = bytes(self.ioctx.read(self._meta_oid(soid)))
        except KeyError:
            raise StripedObjectError(
                f"no striped object {soid!r}") from None
        return json.loads(raw.decode())

    def _read_size(self, soid: str) -> int:
        return self._meta(soid)["size"]

    def _write_meta(self, soid: str, size: int) -> None:
        lay = self.layout
        self.ioctx.write_full(self._meta_oid(soid), json.dumps(
            {"size": size, "stripe_unit": lay.stripe_unit,
             "stripe_count": lay.stripe_count,
             "object_size": lay.object_size}).encode())

    def open_layout(self, soid: str) -> FileLayout:
        """Recover the geometry a striped object was written with."""
        m = self._meta(soid)
        return FileLayout(m["stripe_unit"], m["stripe_count"],
                          m["object_size"])

    # -------------------------------------------------------------- api --
    def exists(self, soid: str) -> bool:
        try:
            self._read_size(soid)
            return True
        except StripedObjectError:
            return False

    def write(self, soid: str, data: bytes, offset: int = 0) -> int:
        if self.exists(soid):
            self.layout = self.open_layout(soid)
            size = self._read_size(soid)
        else:
            size = 0
        for objno, ooff, olen, pos in self._extents(offset, len(data)):
            oid = self._oid(soid, objno)
            try:
                cur = bytearray(self.ioctx.read(oid))
            except KeyError:        # absent stripe object: fresh write
                cur = bytearray()
            if len(cur) < ooff + olen:
                cur.extend(b"\0" * (ooff + olen - len(cur)))
            cur[ooff:ooff + olen] = data[pos:pos + olen]
            self.ioctx.write_full(oid, bytes(cur))
        self._write_meta(soid, max(size, offset + len(data)))
        return len(data)

    def _extents(self, offset: int, length: int):
        pos = 0
        for objno, ooff, olen in file_to_extents(self.layout, offset,
                                                 length):
            yield objno, ooff, olen, pos
            pos += olen

    def read(self, soid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        size = self._read_size(soid)
        self.layout = self.open_layout(soid)
        if length is None:
            length = max(0, size - offset)
        length = min(length, max(0, size - offset))
        out = bytearray(length)
        for objno, ooff, olen, pos in self._extents(offset, length):
            try:
                piece = self.ioctx.read(self._oid(soid, objno))
            except KeyError:
                piece = b""       # absent object = sparse hole; an
            #                       IOError propagates (not zeros)
            chunk = bytes(piece)[ooff:ooff + olen]
            out[pos:pos + len(chunk)] = chunk
        return bytes(out)

    def stat(self, soid: str) -> dict:
        size = self._read_size(soid)
        lay = self.open_layout(soid)
        return {"size": size, "stripe_unit": lay.stripe_unit,
                "stripe_count": lay.stripe_count,
                "object_size": lay.object_size}

    def _objnos(self, size: int) -> Set[int]:
        """Stripe objects a `size`-byte object can touch.  NOT simply
        ceil(size/object_size): round-robin striping spreads early
        bytes across a whole object SET, so small sizes still touch
        stripe_count objects."""
        return {objno for objno, _, _ in
                file_to_extents(self.layout, 0, size)}

    def _obj_valid_len(self, size: int, objno: int) -> int:
        """Bytes of stripe object `objno` that lie below `size`."""
        valid = 0
        for off_objno, ooff, olen in file_to_extents(
                self.layout, 0, size):
            if off_objno == objno:
                valid = max(valid, ooff + olen)
        return min(valid, self.layout.object_size)

    def truncate(self, soid: str, size: int) -> None:
        cur = self._read_size(soid)
        self.layout = self.open_layout(soid)
        if size < cur:
            keep = self._objnos(size)
            for objno in self._objnos(cur) - keep:
                try:
                    self.ioctx.remove(self._oid(soid, objno))
                except KeyError:
                    pass
            # clip every surviving object so a regrow reads zeros
            for objno in keep:
                blen = self._obj_valid_len(size, objno)
                oid = self._oid(soid, objno)
                try:
                    data = bytes(self.ioctx.read(oid))
                except KeyError:
                    continue
                if len(data) > blen:
                    self.ioctx.write_full(oid, data[:blen])
        self._write_meta(soid, size)

    def remove(self, soid: str) -> None:
        size = self._read_size(soid)
        self.layout = self.open_layout(soid)
        for objno in self._objnos(size):
            try:
                self.ioctx.remove(self._oid(soid, objno))
            except KeyError:
                pass
        self.ioctx.remove(self._meta_oid(soid))
