"""rbd-mirror slice — journal-based image replication.

The src/journal/ consumer role (rbd-mirror daemon + librbd journaling
feature): a PRIMARY image with journaling enabled records every
mutation into an image journal BEFORE applying it; a replayer on the
peer side consumes the journal from its committed position and applies
the entries to the secondary image, which converges to a
point-in-time-consistent copy.  Positions are tracked per peer (the
journal client registration role), so replay is incremental and
restart-safe.

    prim = JournaledImage(ioctx_a, "vol")      # journaling feature on
    prim.write(0, b"...")                      # journal-first
    rep = MirrorReplayer(ioctx_a, ioctx_b, "vol", peer="site-b")
    rep.replay()                               # secondary catches up

Entries are JSON (data base64) in ceph_tpu_torch.fs.Journaler objects named
``rbd_journal.<image>`` in the PRIMARY's pool.
"""
from __future__ import annotations

import base64
import json
from typing import Optional

from ..fs.journaler import Journaler
from .rbd import RBD, Image, ImageNotFound


class JournaledImage(Image):
    """Image with the journaling feature: mutations are recorded to
    the image journal before they land (librbd journal-first order,
    the basis of crash-consistent mirroring)."""

    def __init__(self, ioctx, name: str):
        super().__init__(ioctx, name)
        self.journal = Journaler(ioctx, f"rbd_journal.{name}")

    def write(self, offset: int, data: bytes) -> int:
        self.journal.append(json.dumps({
            "op": "write", "offset": offset,
            "data": base64.b64encode(data).decode()}).encode())
        return super().write(offset, data)

    def resize(self, new_size: int) -> None:
        self.journal.append(json.dumps({
            "op": "resize", "size": new_size}).encode())
        super().resize(new_size)

    def snap_create(self, snap_name: str) -> int:
        sid = super().snap_create(snap_name)
        self.journal.append(json.dumps({
            "op": "snap_create", "name": snap_name}).encode())
        return sid


class MirrorReplayer:
    """Peer-side journal replayer (rbd-mirror ImageReplayer role)."""

    def __init__(self, src_ioctx, dst_ioctx, image: str,
                 peer: str = "peer"):
        self.src = src_ioctx
        self.dst = dst_ioctx
        self.image = image
        self.peer = peer
        self.journal = Journaler(src_ioctx, f"rbd_journal.{image}")

    # ------------------------------------------------------- positions --
    def _pos_oid(self) -> str:
        return f"rbd_mirror.{self.image}.{self.peer}"

    def committed_position(self) -> int:
        try:
            return int(self.src.read(self._pos_oid()).decode())
        except (KeyError, ValueError):
            # genuinely absent (fresh peer) or corrupt marker: replay
            # from the start.  A TRANSIENT read error now propagates —
            # treating it as "no position" forced a full re-sync and
            # re-applied every logged delete (the _read_index bug
            # class, CTL603)
            return -1

    def _commit(self, seq: int) -> None:
        self.src.write_full(self._pos_oid(), str(seq).encode())

    # ----------------------------------------------------------- replay --
    def _open_or_create_secondary(self) -> Image:
        try:
            return Image(self.dst, self.image)
        except ImageNotFound:
            src_img = Image(self.src, self.image)
            RBD(self.dst).create(self.image, size=src_img.size(),
                                 order=src_img.info.order)
            return Image(self.dst, self.image)

    def replay(self) -> int:
        """Apply journal entries past the committed position to the
        secondary; returns entries applied.  Idempotent/incremental."""
        img = self._open_or_create_secondary()
        pos = self.committed_position()
        applied = 0
        for seq, payload in self.journal.replay():
            if seq <= pos:
                continue
            ent = json.loads(payload.decode())
            op = ent["op"]
            if op == "write":
                data = base64.b64decode(ent["data"])
                end = ent["offset"] + len(data)
                if end > img.size():
                    img.resize(end)
                img.write(ent["offset"], data)
            elif op == "resize":
                img.resize(ent["size"])
            elif op == "snap_create":
                if ent["name"] not in img.snaps:
                    img.snap_create(ent["name"])
            self._commit(seq)
            pos = seq
            applied += 1
        return applied

    def trim_committed(self) -> int:
        """Expire journal objects every peer has consumed (journal
        trim-to-minimum-commit role; single-peer form)."""
        pos = self.committed_position()
        return self.journal.trim_to(pos + 1) if pos >= 0 else 0
