"""Striping math: byte streams → objects (the long-sequence sharding).

Pure index arithmetic re-creating file_layout_t and Striper::file_to_extents
(reference: src/include/fs_types.h:127-148, src/osdc/Striper.h:26-31): a
logical byte stream is round-robined in ``stripe_unit`` blocks across
``stripe_count`` objects, rolling to a new object set every
``object_size`` bytes per object.  Within an EC pool each object is then
further split into k sub-chunks by the codec (stripe_info_t,
src/osd/ECUtil.h:28-60) — giving the device batch layout
[num_stripes, k, chunk_bytes].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass(frozen=True)
class FileLayout:
    stripe_unit: int = 1 << 22
    stripe_count: int = 1
    object_size: int = 1 << 22

    def __post_init__(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0 or \
                self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of stripe_unit")

    @property
    def stripes_per_object(self) -> int:
        return self.object_size // self.stripe_unit


def file_to_extents(layout: FileLayout, offset: int, length: int
                    ) -> List[Tuple[int, int, int]]:
    """[(objectno, offset_in_object, length), ...] covering
    [offset, offset+length), in stream order."""
    out: List[Tuple[int, int, int]] = []
    su, sc = layout.stripe_unit, layout.stripe_count
    spo = layout.stripes_per_object
    cur = offset
    end = offset + length
    while cur < end:
        blockno = cur // su
        stripeno = blockno // sc
        stripepos = blockno % sc
        objectsetno = stripeno // spo
        objectno = objectsetno * sc + stripepos
        block_start = (stripeno % spo) * su
        block_off = cur % su
        x_offset = block_start + block_off
        x_len = min(end - cur, su - block_off)
        out.append((objectno, x_offset, x_len))
        cur += x_len
    return out


def extents_to_objects(layout: FileLayout, data: bytes, offset: int = 0
                       ) -> Dict[int, Dict[int, bytes]]:
    """Split a write into per-object fragments {objectno: {off: bytes}}."""
    frags: Dict[int, Dict[int, bytes]] = {}
    pos = 0
    for objno, ooff, olen in file_to_extents(layout, offset, len(data)):
        frags.setdefault(objno, {})[ooff] = data[pos:pos + olen]
        pos += olen
    return frags


def read_from_objects(layout: FileLayout, objects: Dict[int, bytes],
                      offset: int, length: int) -> bytes:
    """Inverse of extents_to_objects for already-assembled object payloads
    (missing bytes read as zeros, matching sparse object semantics)."""
    out = bytearray(length)
    pos = 0
    for objno, ooff, olen in file_to_extents(layout, offset, length):
        payload = objects.get(objno, b"")
        piece = payload[ooff:ooff + olen]
        out[pos:pos + len(piece)] = piece
        pos += olen
    return bytes(out)
