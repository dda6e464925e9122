"""Device-resident EC shard staging — the HBM tier of the objectstore.

Port of ``ceph_tpu/cluster/device_store.py``.  With ``layout=bitsliced``
a shard's at-rest bytes ARE the int32 plane words kernel K1 consumes
(chunk bytes [L] viewed as [8, L/8] plane regions, 32 GF(2) lanes per
word, ops/gf2.py).  This module keeps those words resident on the card
so the EC data plane — encode on ingest, degraded-read decode, recovery
rebuild — runs device-to-device, the reference property that ECBackend
shard stores hold chunks in the layout its codecs consume (jerasure
packet layout, src/erasure-code/jerasure/ErasureCodeJerasure.cc:162,274;
shard store src/osd/ECBackend.cc:934,1015).

The durable objectstore stays the source of truth for durability; this
cache is the staging tier with two flush modes (eager write-through with
checksum validation on read, or staged: dirty entries are authoritative
until flushed).  The ``assemble_*`` helpers are plain tensor indexing,
``torch.stack`` and ``torch.cat``: PyTorch runs eagerly, so there is no
compiled-program cache to key.

Keys are the simulator's ShardKey (pool, pg, object, shard).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..common import faults
from ..common.perf_counters import perf as _perf

ShardKey = Tuple[int, int, str, int]

faults.declare("device.staging_drop",
               "evict a CLEAN staged HBM entry at read time (forced "
               "re-upload from the durable bytes) — models HBM "
               "pressure/invalidation racing the read path; dirty "
               "entries are never dropped (they are the only copy)")

# bytes read back from a card by ``to_host``: a module count, kept out
# of the perf registry so the port's perf dumps carry the reference's keys
readback_bytes = 0

# process-wide HBM staging occupancy (summed across every cache in the
# process), exported as perf("hbm") gauges
_hbm_entries = 0
_hbm_bytes = 0


def _hbm_account(d_entries: int, d_bytes: int) -> None:
    global _hbm_entries, _hbm_bytes
    _hbm_entries = max(0, _hbm_entries + d_entries)
    _hbm_bytes = max(0, _hbm_bytes + d_bytes)
    pc = _perf("hbm")
    pc.set("staged_entries", _hbm_entries)
    pc.set("staged_bytes", _hbm_bytes)


@dataclass(frozen=True)
class ShardRef:
    """A staged shard = one row/column of a shared device buffer.

    An object's k+m shard files are views of the buffers the encode
    dispatch already produced: data shards are columns of the client's
    [S, k, W] stripe view, parity shards are columns of the [S, m, W]
    encode output, rebuilt shards are columns of a decode output, so
    staging costs no device work.

    axis=0: ``buf[idx]`` is the shard file ([n, L] row buffer).
    axis=1: ``buf[s0:s1, idx]`` flattened is the shard file ([S, n, W]
    stripewise buffer; ``s0/s1`` select one object's stripe range out of
    a batched multi-object buffer, None = the whole leading axis).
    """
    buf: torch.Tensor      # int32 plane words (uint8 for byte wrappers)
    idx: int
    axis: int = 0
    s0: int = 0
    s1: Optional[int] = None

    def _rows(self) -> int:
        end = self.buf.shape[0] if self.s1 is None else self.s1
        return int(end - self.s0)

    @property
    def size(self) -> int:
        """Shard payload size in BYTES."""
        itemsize = self.buf.element_size()
        if self.axis == 0:
            return int(self.buf.shape[-1]) * itemsize
        return self._rows() * int(self.buf.shape[2]) * itemsize

    def materialize(self) -> torch.Tensor:
        """The shard as its own flat device tensor."""
        if self.axis == 0:
            return self.buf[self.idx]
        return self.buf[self.s0:self.s0 + self._rows(),
                        self.idx].reshape(-1)

    def __array__(self, dtype=None, copy=None):
        a = to_host(self.materialize())
        return a.astype(dtype) if dtype is not None else a


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array: one explicit device->host copy, its bytes
    counted in ``readback_bytes`` when they leave a card."""
    global readback_bytes
    if t.device.type != "cpu":
        readback_bytes += t.numel() * t.element_size()
    return t.cpu().numpy()


def as_ref(arr: torch.Tensor) -> ShardRef:
    """Wrap a bare [L] device tensor as a single-row ref."""
    return ShardRef(arr.reshape(1, -1), 0)


def materialize_bulk(refs) -> List[np.ndarray]:
    """Host arrays for many refs with ONE device->host copy per DISTINCT
    buffer: refs sharing a packed buffer (an encode output's parity
    columns, a put batch's stripe view) copy back together and slice
    host-side."""
    host = {}
    for r in refs:
        if id(r.buf) not in host:
            host[id(r.buf)] = to_host(r.buf)
    out = []
    for r in refs:
        b = host[id(r.buf)]
        if r.axis == 0:
            out.append(np.ascontiguousarray(b[r.idx]))
        else:
            out.append(np.ascontiguousarray(
                b[r.s0:r.s0 + r._rows(), r.idx]).reshape(-1))
    return out


@dataclass
class _Entry:
    arr: ShardRef          # plane words (row of a packed buffer)
    csum: Optional[int]    # objectstore crc at staging time; None=dirty
    nbytes: int


# ------------------------------------------------------------ layout ops --

def _col(ref: ShardRef, S: int, U: int) -> torch.Tensor:
    """One shard as [S, U]: row refs reshape their row, column refs
    index the stripewise buffer directly (a view, no copy)."""
    if ref.axis == 0:
        return ref.buf.reshape(-1, S, U)[ref.idx]
    return ref.buf[ref.s0:ref.s0 + ref._rows(), ref.idx]


def _stack_cols(refs_by_col, dec, S: int, U: int) -> torch.Tensor:
    """[S, n, U] of one object: present columns from their refs, missing
    (None) columns from decode output ``dec`` ([S, n_missing, U]) in
    order."""
    cols, di = [], 0
    for ref in refs_by_col:
        if ref is None:
            cols.append(dec[:, di])
            di += 1
        else:
            cols.append(_col(ref, S, U))
    return torch.stack(cols, dim=1)


def assemble_refs(refs, S: int, U: int) -> torch.Tensor:
    """[S, n, U] device stack of n shard refs (the gather half of
    handle_sub_read_reply, src/osd/ECBackend.cc:1183)."""
    return torch.stack([_col(r, S, U) for r in refs], dim=1)


def assemble_object(refs_by_col, dec, S: int, U: int) -> torch.Tensor:
    """Object stripe view [S, k, U] on the device: column c reads its
    shard ref, missing columns read decode output dec[:, j]."""
    return _stack_cols(refs_by_col, dec, S, U)


def assemble_windows(col_bufs, starts, S: int) -> torch.Tensor:
    """[G*S, n_cols, W] stack of G same-geometry objects whose column j
    lives in ``col_bufs[j]`` = (stripewise buffer [rows, n, W], column
    index), each object's window starting at ``starts[g]``."""
    dev = col_bufs[0][0].device
    st = torch.as_tensor(np.asarray(starts, dtype=np.int64), device=dev)
    idx = (st[:, None] + torch.arange(S, device=dev)[None]).reshape(-1)
    return torch.stack([buf[idx, int(col)] for buf, col in col_bufs], dim=1)


def assemble_objects_dec(refs_per_object, dec, S: int,
                         U: int) -> torch.Tensor:
    """[G*S, k, U] device stack of G same-signature DEGRADED objects:
    each object's missing columns (None refs) read its stripe slice of
    the group decode output ``dec`` ([G*S, n_missing, U])."""
    return torch.cat([_stack_cols(refs, dec[g * S:(g + 1) * S], S, U)
                      for g, refs in enumerate(refs_per_object)])


def assemble_many(refs_per_object, S: int, U: int) -> torch.Tensor:
    """[N*S, k, U] batched stripe view of N same-geometry objects (the
    read half of the batched client surface).  ``refs_per_object`` is a
    list of per-object column-ref lists with no missing columns."""
    return torch.cat([assemble_refs(refs, S, U) for refs in refs_per_object])


class DeviceShardCache:
    """Per-OSD device staging of shard plane words.  ``owner`` is the
    hosting OSD's id (None for a client-side cache)."""

    def __init__(self, owner: Optional[int] = None):
        self.owner = owner
        self._entries: Dict[ShardKey, _Entry] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    # ------------------------------------------------------------ writes --
    def put(self, key: ShardKey, ref: ShardRef,
            csum: Optional[int]) -> None:
        """Stage a shard ref; ``csum=None`` marks it dirty (staged
        flush mode — the device copy is authoritative until flush)."""
        prev = self._entries.get(key)
        self._entries[key] = _Entry(ref, csum, int(ref.size))
        _hbm_account(0 if prev is not None else 1,
                     int(ref.size) - (prev.nbytes if prev else 0))
        from ..parallel import data_plane
        if data_plane.enabled():
            dp = data_plane.plane()
            if dp is not None:
                # affinity: the hosting OSD when known, else the EC
                # shard index (client-side staging)
                dp.account_staged(
                    self.owner if self.owner is not None else key[3],
                    int(ref.size))

    def evict(self, key: ShardKey) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self.invalidations += 1
            _hbm_account(-1, -e.nbytes)

    def evict_object(self, pool_id: int, pg: int, name: str) -> None:
        """Drop every staged shard of one object (overwrite/delete
        invalidation: dirty entries are served unconditionally, so a
        stale dirty entry would resurrect overwritten data)."""
        for k in [k for k in self._entries
                  if k[0] == pool_id and k[1] == pg and k[2] == name]:
            self.evict(k)

    def clear(self) -> None:
        if self._entries:
            _hbm_account(-len(self._entries),
                         -sum(e.nbytes for e in self._entries.values()))
        self._entries.clear()

    # ------------------------------------------------------------- reads --
    def has(self, key: ShardKey) -> bool:
        return key in self._entries

    def items(self) -> List[Tuple[ShardKey, ShardRef, Optional[int]]]:
        """Every staged entry as (key, ref, csum)."""
        return [(k, e.arr, e.csum) for k, e in self._entries.items()]

    def dirty_get(self, key: ShardKey):
        """The staged ref IF the entry is dirty (the device copy is the
        authoritative one awaiting flush); else None."""
        e = self._entries.get(key)
        return e.arr if e is not None and e.csum is None else None

    def get(self, key: ShardKey, store_csum: Optional[int]):
        """Return the staged ref, validating against the durable tier's
        current checksum.  Dirty entries are authoritative and served
        unconditionally; a csum mismatch (external mutation of the bytes
        underneath) drops the stale staging."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        if e.csum is not None and \
                faults.fire("device.staging_drop") is not None:
            # clean entries only: a dirty entry is the authoritative
            # copy awaiting flush and must never be injected away
            self.evict(key)
            self.misses += 1
            return None
        if e.csum is not None and e.csum != store_csum:
            self.evict(key)
            self.misses += 1
            return None
        self.hits += 1
        return e.arr

    def dirty_items(self) -> Iterable[Tuple[ShardKey, object]]:
        return [(k, e.arr) for k, e in self._entries.items()
                if e.csum is None]

    def mark_clean(self, key: ShardKey, csum: int) -> None:
        e = self._entries.get(key)
        if e is not None:
            e.csum = csum

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "bytes": sum(e.nbytes for e in self._entries.values()),
                "hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations}
