"""RBD-style block images — striped virtual block devices over objects.

Role of src/librbd/ (block images striped across RADOS objects: image
metadata in a header object, data in `<prefix>.<objectno>` objects,
random-offset read/write, resize) built on the striper math
(FileLayout/file_to_extents — the same layout librbd's default
striping v1 uses: stripe_unit == object_size, stripe_count == 1,
order=22 -> 4 MiB objects) and the IoCtx client surface.

Kept behaviors: create/open/remove/list, size/resize (shrink discards
whole objects past the boundary), offset read/write crossing object
boundaries, sparse reads of never-written ranges as zeros.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

from ..cluster.striper import FileLayout, file_to_extents
from .rados import IoCtx, ObjectNotFound

_DIR_OID = "rbd_directory"


class ImageExists(ValueError):
    pass


class ImageNotFound(KeyError):
    pass


@dataclass
class ImageInfo:
    name: str
    size: int
    order: int                   # object size = 1 << order
    object_prefix: str

    @property
    def layout(self) -> FileLayout:
        osize = 1 << self.order
        return FileLayout(stripe_unit=osize, stripe_count=1,
                          object_size=osize)


class RBD:
    """Image directory ops (librbd `RBD` class)."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    def _dir(self) -> dict:
        try:
            return json.loads(self.ioctx.read(_DIR_OID).decode())
        except ObjectNotFound:
            return {}

    def _write_dir(self, d: dict) -> None:
        self.ioctx.write_full(_DIR_OID, json.dumps(d).encode())

    def create(self, name: str, size: int, order: int = 22) -> None:
        d = self._dir()
        if name in d:
            raise ImageExists(name)
        info = {"size": size, "order": order,
                "object_prefix": f"rbd_data.{name}"}
        d[name] = info
        self.ioctx.write_full(f"rbd_header.{name}",
                              json.dumps(info).encode())
        self._write_dir(d)

    def list(self) -> List[str]:
        return sorted(self._dir())

    def remove(self, name: str) -> None:
        d = self._dir()
        if name not in d:
            raise ImageNotFound(name)
        img = Image(self.ioctx, name)
        if img.children():
            raise ValueError(f"image {name} has clone children")
        if img.parent is not None:
            # detach from the parent snap's children list so the
            # parent can later be unprotected/removed
            try:
                parent = Image(self.ioctx, img.parent["image"])
                rec = parent.snaps.get(img.parent["snap"])
                if rec and name in rec.get("children", []):
                    rec["children"].remove(name)
                    parent._save_header()
            except ImageNotFound:
                pass
        for objno in img._written_objects():
            try:
                self.ioctx.remove(img._oid(objno))
            except ObjectNotFound:
                pass
        self.ioctx.remove(f"rbd_header.{name}")
        del d[name]
        self._write_dir(d)

    def clone(self, parent_name: str, parent_snap: str,
              child_name: str) -> None:
        """Layering (librbd clone): the child starts as a sparse image
        whose reads fall through to the parent's PROTECTED snapshot;
        writes copy-up the touched object first (librbd
        CopyupRequest role)."""
        parent = Image(self.ioctx, parent_name)
        if parent.parent is not None:
            raise ValueError(
                f"{parent_name} is itself an unflattened clone — "
                "flatten it before cloning from it (chains unsupported)")
        rec = parent.snaps.get(parent_snap)
        if rec is None:
            raise KeyError(f"{parent_name} has no snap {parent_snap!r}")
        if not rec.get("protected"):
            raise ValueError(
                f"snap {parent_snap!r} is not protected (librbd "
                "requires protect before clone)")
        d = self._dir()
        if child_name in d:
            raise ImageExists(child_name)
        info = {"size": rec["size"], "order": parent.info.order,
                "object_prefix": f"rbd_data.{child_name}",
                # parent spec carries everything reads need (librbd
                # parent_spec): no per-read parent header fetches, and
                # overlap shrinks with child resizes
                "parent": {"image": parent_name, "snap": parent_snap,
                           "snap_id": rec["id"], "size": rec["size"],
                           "object_prefix": parent.info.object_prefix,
                           "overlap": rec["size"]}}
        d[child_name] = {"size": rec["size"],
                         "order": parent.info.order,
                         "object_prefix": info["object_prefix"]}
        self.ioctx.write_full(f"rbd_header.{child_name}",
                              json.dumps(info).encode())
        self._write_dir(d)
        parent.snaps[parent_snap].setdefault("children", []).append(
            child_name)
        parent._save_header()


class Image:
    """One open image (librbd `Image`); ``snapshot`` opens it read-only
    at a named snap (librbd open-at-snap)."""

    def __init__(self, ioctx: IoCtx, name: str,
                 snapshot: Optional[str] = None):
        self.ioctx = ioctx
        self.name = name
        try:
            raw = ioctx.read(f"rbd_header.{name}")
        except ObjectNotFound:
            raise ImageNotFound(name) from None
        meta = json.loads(raw.decode())
        self.info = ImageInfo(name=name, size=meta["size"],
                              order=meta["order"],
                              object_prefix=meta["object_prefix"])
        self.snaps: dict = meta.get("snaps", {})
        self.parent: Optional[dict] = meta.get("parent")
        self.snap_id: Optional[int] = None
        if snapshot is not None:
            if snapshot not in self.snaps:
                raise KeyError(f"image {name} has no snap {snapshot!r}")
            self.snap_id = self.snaps[snapshot]["id"]
            self.info.size = self.snaps[snapshot]["size"]

    # ------------------------------------------------------------ layout --
    def _oid(self, objno: int) -> str:
        return f"{self.info.object_prefix}.{objno:016x}"

    def _written_objects(self) -> List[int]:
        prefix = self.info.object_prefix + "."
        out = []
        for oid in self.ioctx.list_objects():
            if not oid.startswith(prefix):
                continue
            suffix = oid[len(prefix):]
            # another image's name may extend this prefix ('a' vs
            # 'a.b'): only exact 16-hex-digit suffixes are ours
            if len(suffix) == 16:
                try:
                    out.append(int(suffix, 16))
                except ValueError:
                    pass
        return sorted(out)

    def size(self) -> int:
        return self.info.size

    def _save_header(self) -> None:
        blob = {"size": self.info.size,
                "order": self.info.order,
                "object_prefix": self.info.object_prefix,
                "snaps": self.snaps}
        if self.parent is not None:
            blob["parent"] = self.parent
        self.ioctx.write_full(f"rbd_header.{self.name}",
                              json.dumps(blob).encode())
        # header watchers learn about metadata changes (librbd's
        # ImageWatcher header_update notifications)
        self.ioctx.notify(f"rbd_header.{self.name}", b"header_update")

    # ---------------------------------------------------------- snapshots --
    def snap_create(self, snap_name: str) -> int:
        """Image snapshot: a pool snap + a header record, so data
        objects COW lazily on the next write (librbd snap_create).

        Header mutators refresh first: another handle may have added
        clone linkage (children/protected) since this one opened, and
        a blind save would lose it (librbd serializes this through the
        exclusive lock + watch/notify; refresh-before-mutate is the
        single-writer equivalent)."""
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        if snap_name in self.snaps:
            raise ValueError(f"snap {snap_name!r} exists")
        sid = self.ioctx.snap_create(
            f"rbd.{self.name}@{snap_name}")
        self.snaps[snap_name] = {"id": sid, "size": self.info.size}
        self._save_header()
        return sid

    def snap_list(self) -> List[str]:
        return sorted(self.snaps)

    def snap_rollback(self, snap_name: str) -> None:
        """Roll every data object in the SNAPPED extent range back to
        the snap state and restore the snapped size (librbd
        snap_rollback) — including objects deleted since the snap
        (e.g. by a shrink), whose clones the cluster still holds."""
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        if snap_name not in self.snaps:
            raise KeyError(snap_name)
        rec = self.snaps[snap_name]
        sid = rec["id"]
        osize = 1 << self.info.order
        snap_objs = -(-rec["size"] // osize)
        covered = set(range(snap_objs)) | set(self._written_objects())
        for objno in sorted(covered):
            oid = self._oid(objno)
            try:
                self.ioctx.snap_rollback_id(oid, sid)
            except KeyError:
                # no state at the snap: rolls back to absent
                try:
                    self.ioctx.remove(oid)
                except ObjectNotFound:
                    pass
        self.info.size = rec["size"]
        self._save_header()

    def snap_remove(self, snap_name: str) -> None:
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        if snap_name not in self.snaps:
            raise KeyError(snap_name)
        rec = self.snaps[snap_name]
        if rec.get("protected"):
            raise ValueError(
                f"snap {snap_name!r} is protected (unprotect first)")
        if rec.get("children"):
            raise ValueError(
                f"snap {snap_name!r} has clone children")
        rec = self.snaps.pop(snap_name)
        self.ioctx._rados._sim.snap_remove(self.ioctx.pool_id,
                                           rec["id"])
        self._save_header()

    # -------------------------------------------------------------- watch --
    def watch_header(self, callback) -> int:
        """Watch the header object (ImageWatcher role): fires on
        resize/snap operations from ANY handle of this image."""
        return self.ioctx.watch(f"rbd_header.{self.name}", callback)

    def unwatch_header(self, watch_id: int) -> None:
        self.ioctx.unwatch(f"rbd_header.{self.name}", watch_id)

    def refresh(self) -> None:
        """Re-read the header (what a watcher callback triggers)."""
        meta = json.loads(
            self.ioctx.read(f"rbd_header.{self.name}").decode())
        self.info.size = meta["size"]
        self.snaps = meta.get("snaps", {})
        self.parent = meta.get("parent")

    # ---------------------------------------------------------- layering --
    def _parent_object(self, objno: int) -> Optional[bytes]:
        """The parent snapshot's bytes for one of OUR objects, clipped
        to the parent OVERLAP (shrunk by child resizes, so regrown
        ranges read zeros, not resurrected parent data)."""
        if self.parent is None:
            return None
        overlap = self.parent.get("overlap", self.parent["size"])
        osize = 1 << self.info.order
        start = objno * osize
        if start >= overlap:
            return None
        prefix = self.parent.get(
            "object_prefix", f"rbd_data.{self.parent['image']}")
        oid = f"{prefix}.{objno:016x}"
        try:
            data = self.ioctx.read(oid, snap=self.parent["snap_id"])
        except ObjectNotFound:
            return None
        return data[:max(0, overlap - start)]

    def _copy_up(self, objno: int) -> None:
        """Before a partial write to an object the child doesn't have,
        materialize the parent's bytes (CopyupRequest role)."""
        oid = self._oid(objno)
        try:
            self.ioctx.read(oid, length=0)
            return                       # child already has the object
        except ObjectNotFound:
            pass
        pdata = self._parent_object(objno)
        if pdata:
            self.ioctx.write_full(oid, pdata)

    def children(self) -> List[str]:
        out = []
        for rec in self.snaps.values():
            out.extend(rec.get("children", []))
        return sorted(out)

    def protect_snap(self, snap_name: str) -> None:
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        self.snaps[snap_name]["protected"] = True
        self._save_header()

    def unprotect_snap(self, snap_name: str) -> None:
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        rec = self.snaps[snap_name]
        if rec.get("children"):
            raise ValueError(
                f"snap {snap_name!r} has clone children")
        rec["protected"] = False
        self._save_header()

    def flatten(self) -> None:
        """Copy every parent-backed object into the child and detach
        (librbd flatten): the parent can then be unprotected.  Refused
        while the clone has snapshots of its own — those snaps were
        taken over parent-backed objects and would read zeros once the
        parent detaches (librbd keeps the parent linked per-snap; this
        slice requires snapshot-free flatten instead)."""
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        if self.parent is None:
            return
        if self.snaps:
            raise ValueError(
                "flatten with clone snapshots is unsupported: remove "
                f"snaps {sorted(self.snaps)} first")
        osize = 1 << self.info.order
        for objno in range(-(-self.parent["size"] // osize)):
            self._copy_up(objno)
        parent = Image(self.ioctx, self.parent["image"])
        rec = parent.snaps.get(self.parent["snap"])
        if rec and self.name in rec.get("children", []):
            rec["children"].remove(self.name)
            parent._save_header()
        self.parent = None
        self._save_header()

    # --------------------------------------------------------------- i/o --
    def write(self, offset: int, data: bytes) -> int:
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        if offset + len(data) > self.info.size:
            raise ValueError("write past image size")
        pos = 0
        osize = 1 << self.info.order
        for objno, ooff, olen in file_to_extents(
                self.info.layout, offset, len(data)):
            # full-object writes need no copy-up (librbd skips copyup
            # when the write covers the whole object)
            if self.parent is not None and not (ooff == 0 and
                                                olen >= osize):
                self._copy_up(objno)
            self.ioctx.write(self._oid(objno), data[pos:pos + olen],
                             offset=ooff)
            pos += olen
        return len(data)

    def read(self, offset: int, length: int) -> bytes:
        if offset + length > self.info.size:
            length = max(0, self.info.size - offset)
        out = bytearray(length)
        pos = 0
        for objno, ooff, olen in file_to_extents(
                self.info.layout, offset, length):
            try:
                piece = self.ioctx.read(self._oid(objno), length=olen,
                                        offset=ooff, snap=self.snap_id)
            except ObjectNotFound:
                # clones fall through to the parent snapshot; plain
                # images read sparse zeros
                pdata = self._parent_object(objno)
                piece = pdata[ooff:ooff + olen] if pdata else b""
            out[pos:pos + len(piece)] = piece
            pos += olen
        return bytes(out)

    def resize(self, new_size: int) -> None:
        """Grow is metadata-only; shrink discards objects wholly past
        the boundary AND zero-truncates the boundary object (librbd
        trim semantics — stale bytes must not reappear after a later
        grow).  For clones the parent overlap shrinks with the image,
        so regrown ranges never resurrect parent bytes."""
        if self.snap_id is not None:
            raise IOError("image opened at a snapshot is read-only")
        self.refresh()
        if new_size < self.info.size and self.parent is not None:
            self.parent["overlap"] = min(
                self.parent.get("overlap", self.parent["size"]),
                new_size)
        if new_size < self.info.size:
            osize = 1 << self.info.order
            first_dead = -(-new_size // osize)
            for objno in self._written_objects():
                if objno >= first_dead:
                    try:
                        self.ioctx.remove(self._oid(objno))
                    except ObjectNotFound:
                        pass
            cut = new_size % osize
            if cut:
                bno = new_size // osize
                try:
                    cur = self.ioctx.read(self._oid(bno))
                except ObjectNotFound:
                    cur = b""
                if len(cur) > cut:
                    self.ioctx.write_full(self._oid(bno), cur[:cut])
        self.info.size = new_size
        self._save_header()
