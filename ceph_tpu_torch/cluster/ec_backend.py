"""ECBackend — the PGBackend seam, shared by both cluster tiers.

Port of ``ceph_tpu/cluster/ec_backend.py`` on torch tensors: plane words
are int32 tensors on the codec's device, and every encode or decode is
one call of kernel K1 (ops/xor_kernel.py) through the codec.

The reference instantiates ONE abstract IO backend per PG and picks
Replicated vs EC by pool type (PGBackend::build_pg_backend,
src/osd/PGBackend.cc:571); ECBackend then owns the stripe math, the
encode-on-write / decode-on-degraded-read pipelines and recovery
reconstruction (src/osd/ECBackend.cc:934,1015,757), calling the codec
through the plugin registry.  Here the same seam is split along the
device boundary:

  * ``ECBackend`` (this class) is the data-plane ENGINE: batched
    word-domain encode dispatches, shard-ref construction (zero-copy
    columns of the encode buffers, cluster/device_store.py),
    minimum_to_decode planning, signature-GROUPED decode (all objects
    that lost the same shard set decode in ONE kernel call — the
    ISA-L table-cache idea lifted to whole dispatch batches,
    src/erasure-code/isa/ErasureCodeIsaTableCache.h:35), and degraded
    assembly.
  * ``ShardIO`` is the transport half: WHERE shard bytes/refs live
    and how sub-ops reach them.  The simulator implements it as
    ``SimShardIO`` (cluster/simulator.py) and the wire client as
    ``WireShardIO`` (client/remote.py).
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..placement.crush_map import ITEM_NONE

ShardKey = Tuple[int, int, str, int]     # (pool, pg, name, shard)


class SubWrite:
    """One shard sub-op of an EC write (the MOSDECSubOpWrite payload,
    src/osd/ECBackend.cc:1976): destination + the shard's durable
    bytes (lazy) + its zero-copy device ref + object metadata."""

    __slots__ = ("pg", "shard", "target", "name", "ref", "bytes_fn",
                 "attrs")

    def __init__(self, pg, shard, target, name, ref, bytes_fn, attrs):
        self.pg = pg
        self.shard = shard
        self.target = target
        self.name = name
        self.ref = ref                  # ShardRef (device plane words)
        self.bytes_fn = bytes_fn        # () -> bytes | None (durable)
        self.attrs = attrs


class ShardIO(abc.ABC):
    """Transport seam: sub-op delivery + shard retrieval for one pool."""

    @abc.abstractmethod
    def up_set(self, pg: int) -> List[int]:
        """Acting/up OSDs of a PG, positional by shard id."""

    @abc.abstractmethod
    def fanout(self, writes: Sequence[SubWrite]) -> List[SubWrite]:
        """Deliver sub-writes concurrently; return the COMMITTED ones
        (the gather half of issue_repop: the caller decides whether
        the commit set satisfies the write contract)."""

    @abc.abstractmethod
    def purge_shard(self, pg: int, shard: int, name: str,
                    keep_target: Optional[int]) -> None:
        """Remove stale copies of a shard everywhere but its new home
        (a failed/re-homed sub-write must not leave an older version
        servable)."""

    @abc.abstractmethod
    def get_shard_ref(self, pg: int, shard: int, name: str):
        """The shard as a device ShardRef (device staging hit or upload),
        or None when this transport/holder cannot serve it."""

    @abc.abstractmethod
    def get_shard_bytes(self, pg: int, shard: int,
                        name: str) -> Optional[bytes]:
        """The shard's durable bytes, or None when absent."""

    @abc.abstractmethod
    def getattr(self, pg: int, name: str, shard: int,
                key: str) -> Optional[bytes]:
        """One shard attr (object_info metadata travels as attrs)."""


class ObjectGeom:
    """Stripe geometry of one stored object (stripe_info_t role,
    src/osd/ECUtil.h:28-60): S stripes of k chunks of U bytes."""

    __slots__ = ("size", "S", "U")

    def __init__(self, size: int, S: int, U: int):
        self.size = int(size)
        self.S = int(S)
        self.U = int(U)

    @property
    def W(self) -> int:
        return self.U // 4

    def attrs(self) -> Dict[str, bytes]:
        return {"size": str(self.size).encode(),
                "S": str(self.S).encode(),
                "U": str(self.U).encode()}


class ECBackend:
    """The EC data-plane engine over a ShardIO transport."""

    def __init__(self, codec, shard_io: ShardIO):
        self.codec = codec
        self.io = shard_io
        self.k = codec.get_data_chunk_count()
        self.n = codec.get_chunk_count()
        self.m = self.n - self.k

    # ------------------------------------------------------------ layout --
    def words_supported(self) -> bool:
        return hasattr(self.codec, "encode_words_device") and \
            getattr(self.codec, "layout", None) == "bitsliced"

    def to_words(self, payload, S: int, U: int) -> torch.Tensor:
        """Payload (host bytes/array or device u8/i32) -> [S, k, W]
        int32 plane words, the at-rest domain.  Host payloads are copied
        to the codec's device; a uint8 tensor is viewed, not copied, when
        it is contiguous."""
        W = U // 4
        if isinstance(payload, (bytes, bytearray, memoryview)):
            payload = np.frombuffer(payload, dtype=np.uint8)
        if isinstance(payload, np.ndarray):
            host = np.ascontiguousarray(payload).view(np.int32)
            return torch.tensor(host.reshape(S, self.k, W),
                                device=self.codec.device)
        if payload.dtype == torch.int32:
            return payload.reshape(S, self.k, W)
        return payload.contiguous().view(torch.int32).reshape(S, self.k, W)

    def batch_geometry(self, lengths: Sequence[int],
                       stripe_unit: int) -> Tuple[int, int]:
        """Common (S, U) for a same-batch object set: every object
        pads to S stripes of k chunks of U bytes.  U is clamped to
        >= 32 so chunks stay 32-byte aligned for the bitsliced plane
        view (the SIMD_ALIGN role, ErasureCode.cc:42)."""
        U = max(32, int(stripe_unit))
        stripe = self.k * U
        S = max(1, -(-max(lengths) // stripe))
        return S, U

    # ------------------------------------------------------- write path --
    def encode_to_writes(self, pg_of: Dict[str, int],
                         names: Sequence[str], payload,
                         geom: ObjectGeom,
                         durable: bool = True,
                         sizes: Optional[Dict[str, int]] = None,
                         d_host=None) -> List[SubWrite]:
        """ONE encode dispatch for N same-geometry objects
        ([N*S, k, W] payload), then per-object/per-shard SubWrites
        whose refs are zero-copy columns of the payload/parity
        buffers.  ``durable=False`` defers byte materialization
        (staged/WAL flush mode — device refs are authoritative until
        flushed).  ``d_host`` lets a caller that already holds the
        payload host-side skip the data readback."""
        from .device_store import ShardRef, to_host
        from ..parallel.data_plane import plane as _data_plane
        S, U, W = geom.S, geom.U, geom.W
        N = len(names)
        d = self.to_words(payload, N * S, U)
        par = self.codec.encode_words_device(d)
        p_host = None
        if durable:
            if d_host is None:
                d_host = to_host(d)
            p_host = to_host(par)
        dp = _data_plane()
        writes: List[SubWrite] = []
        for i, name in enumerate(names):
            attrs = geom.attrs()
            if sizes is not None and name in sizes:
                attrs["size"] = str(int(sizes[name])).encode()
            pg = pg_of[name]
            up = self.io.up_set(pg)
            s0, s1 = i * S, (i + 1) * S
            for shard in range(self.n):
                tgt = up[shard] if shard < len(up) else ITEM_NONE
                if dp is not None and tgt != ITEM_NONE:
                    # fan-out accounting by OSD-shard -> cell affinity
                    dp.account_subwrite(tgt)
                ref = (ShardRef(d, shard, axis=1, s0=s0, s1=s1)
                       if shard < self.k else
                       ShardRef(par, shard - self.k, axis=1,
                                s0=s0, s1=s1))

                def mk_bytes(i=i, shard=shard):
                    if not durable:
                        return None
                    h, c = (d_host, shard) if shard < self.k else \
                        (p_host, shard - self.k)
                    return np.ascontiguousarray(
                        h[i * S:(i + 1) * S, c]).tobytes()

                writes.append(SubWrite(pg, shard, tgt, name, ref,
                                       mk_bytes, attrs))
        return writes

    def submit_loose(self, writes: Sequence[SubWrite]
                     ) -> Dict[str, Dict[int, int]]:
        """Fan out; purge homeless slots; return {name: {shard:
        target}} of what committed, with NO completeness verdict —
        the simulator tier's degraded-write semantics (callers log
        the placed set and recovery heals the gap)."""
        homeless = [w for w in writes if w.target == ITEM_NONE]
        live = [w for w in writes if w.target != ITEM_NONE]
        for w in homeless:
            self.io.purge_shard(w.pg, w.shard, w.name, None)
        committed = self.io.fanout(live)
        acked: Dict[str, Dict[int, int]] = {}
        for w in committed:
            acked.setdefault(w.name, {})[w.shard] = w.target
        return acked

    def submit(self, writes: Sequence[SubWrite]
               ) -> Dict[str, Dict[int, int]]:
        """submit_loose + the gather-all-commits verdict per object:
        every MAPPED shard must commit AND >= k overall, else the
        object's write FAILED (the r3 EC write gate;
        src/osd/ECBackend.cc:1150).  Raises IOError naming the
        incomplete objects."""
        acked = self.submit_loose(writes)
        failed: List[str] = []
        by_name: Dict[str, List[SubWrite]] = {}
        for w in writes:
            by_name.setdefault(w.name, []).append(w)
        for name, ws in by_name.items():
            got = acked.get(name, {})
            mapped = [w for w in ws if w.target != ITEM_NONE]
            if len(got) < len(mapped) or len(got) < self.k:
                failed.append(name)
        if failed:
            for name in failed:
                acked.pop(name, None)
            raise IOError(
                f"EC write incomplete for {failed} "
                f"(gather-all-commits contract)")
        return acked

    # -------------------------------------------------------- read path --
    def read_geom(self, pg: int, name: str) -> Optional[ObjectGeom]:
        """Object geometry from shard attrs (any holder).  Single-
        stripe legacy objects (no S/U attrs) report S=1 with U derived
        at assembly time."""
        for shard in range(self.n):
            raw = self.io.getattr(pg, name, shard, "size")
            if raw is None:
                continue
            size = int(raw)
            s_raw = self.io.getattr(pg, name, shard, "S")
            u_raw = self.io.getattr(pg, name, shard, "U")
            if s_raw is not None and u_raw is not None:
                return ObjectGeom(size, int(s_raw), int(u_raw))
            return ObjectGeom(size, 1, 0)     # legacy single-stripe
        return None

    def plan(self, have: Sequence[int]) -> Tuple[List[int], List[int]]:
        """(read_plan, missing_data) via the codec's
        minimum_to_decode (src/osd/ECBackend.cc:1631)."""
        have_set = set(have)
        missing = [c for c in range(self.k) if c not in have_set]
        if not missing:
            return sorted(have_set & set(range(self.k))), []
        plan = sorted(self.codec.minimum_to_decode(set(range(self.k)),
                                                   have_set))
        return plan, missing

    def gather_refs(self, pg: int, name: str
                    ) -> Dict[int, object]:
        refs = {}
        for shard in range(self.n):
            r = self.io.get_shard_ref(pg, shard, name)
            if r is not None:
                refs[shard] = r
        return refs

    def assemble_object_words(self, refs: Dict[int, object],
                              geom: ObjectGeom):
        """[S, k, W] device words of one object, decoding missing data
        columns (the handle_sub_read_reply -> ECUtil::decode flow,
        src/osd/ECBackend.cc:1183)."""
        from .device_store import assemble_object, assemble_refs
        if len(refs) < self.k:
            raise IOError(f"unrecoverable: only shards {sorted(refs)}")
        try:
            plan, missing = self.plan(list(refs))
        except Exception:
            raise IOError(
                f"unrecoverable: only shards {sorted(refs)}") from None
        dec = None
        if missing:
            sub = assemble_refs([refs[c] for c in plan],
                                geom.S, geom.W)
            dec = self.codec.decode_words_device(plan, sub, missing)
        return assemble_object([refs.get(c) for c in range(self.k)],
                               dec, geom.S, geom.W)

    def read_many_words(self, items):
        """Batched word-domain read: ``items`` is [(pg, name,
        ObjectGeom)]; returns each object's [S, k, W] device words,
        item-order.  Healthy same-geometry objects assemble in ONE
        dispatch (assemble_many); degraded objects decode + stitch in
        signature-GROUPED dispatches — the bench_recovery batching on
        the serving path (VERDICT r4 next #6), shared by both tiers
        through the ShardIO seam."""
        from .device_store import assemble_many, assemble_objects_dec
        out: List[Optional[object]] = [None] * len(items)
        healthy: Dict = {}
        degraded: Dict = {}
        for idx, (pg, name, geom) in enumerate(items):
            refs = {c: r for c, r in self.gather_refs(pg, name).items()
                    if r.size >= geom.S * geom.U}
            if all(c in refs for c in range(self.k)):
                healthy.setdefault((geom.S, geom.W), []).append(
                    (idx, [refs[c] for c in range(self.k)]))
                continue
            if len(refs) < self.k:
                raise IOError(f"{name}: unrecoverable "
                              f"(only shards {sorted(refs)})")
            plan, missing = self.plan(list(refs))
            degraded.setdefault(
                (tuple(plan), tuple(missing), geom.S, geom.W),
                []).append((idx, refs))
        for (S, W), its in healthy.items():
            stacked = assemble_many([r for _, r in its], S, W)
            for j, (idx, _) in enumerate(its):
                out[idx] = stacked[j * S:(j + 1) * S]
        for (plan, missing, S, W), its in degraded.items():
            plan, missing = list(plan), list(missing)
            stacked = assemble_many(
                [[refs[c] for c in plan] for _, refs in its], S, W)
            dec = self.codec.decode_words_device(plan, stacked,
                                                 missing)
            stitched = assemble_objects_dec(
                [[refs.get(c) for c in range(self.k)]
                 for _, refs in its], dec, S, W)
            for j, (idx, _) in enumerate(its):
                out[idx] = stitched[j * S:(j + 1) * S]
        return out

    # ------------------------------------------- signature-grouped decode --
    def decode_signature_groups(
            self, jobs: Sequence[Tuple[List[int], object, List[int]]]):
        """Batch-decode many objects in FEW dispatches: jobs with the
        same (available-plan, erased) signature and word width stack
        into one kernel call ([sum_S, n_avail, W]); the per-job slices
        come back out.  jobs: (plan, words [S, n_avail, W], erased).
        Returns a list of [S, n_erased, W] device arrays, job-order.

        This is the read-side analog of the batched write dispatch,
        and exactly what bench_recovery does for the rebuild sweep —
        applied to the serving path (VERDICT r4 weak #4 / next #6)."""
        out: List[Optional[object]] = [None] * len(jobs)
        groups: Dict[Tuple, List[int]] = {}
        for idx, (plan, words, erased) in enumerate(jobs):
            sig = (tuple(plan), tuple(erased), int(words.shape[-1]))
            groups.setdefault(sig, []).append(idx)
        for (plan, erased, W), idxs in groups.items():
            if not erased:
                for i in idxs:
                    out[i] = jobs[i][1][..., :0, :]
                continue
            stack = torch.cat([jobs[i][1] for i in idxs]) \
                if len(idxs) > 1 else jobs[idxs[0]][1]
            dec = self.codec.decode_words_device(list(plan), stack,
                                                 list(erased))
            off = 0
            for i in idxs:
                S = jobs[i][1].shape[0]
                out[i] = dec[off:off + S]
                off += S
        return out
