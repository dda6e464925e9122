"""RGW slice — S3-shaped object gateway over RADOS.

The thin S3-object slice VERDICT r2 asked for (missing #8): the
src/rgw/ roles reduced to the storage shape rather than the 191k-LoC
HTTP/multisite stack:

  * a bucket's KEY INDEX lives in N SHARD objects keyed by key-hash
    (the bucket-index-shard role, src/rgw/driver/rados
    rgw_bucket_index_... / cls_rgw over omap): each shard holds the
    ordered key -> {size, etag, mtime} entries whose keys hash to it,
    updated after the data object lands (index consistency: a crash
    between data and index leaves an orphan data object, never a
    dangling index entry).  Legacy buckets (num_shards == 1, gen 0)
    keep the original one-object-per-bucket oid, so pre-shard pools
    read unchanged.  One hot bucket no longer serializes every
    writer on a single index object: per-request ops touch ONLY the
    key's shard, under a per-(bucket, shard) RMW lock;
  * LISTING is a shard-merge: every shard is read once and the
    results merge-sorted — identical output for every shard count;
  * online ``reshard`` copies the merged entries into a new
    generation of shard objects and commits the layout in the bucket
    directory record (the RGWBucketReshard role);
  * object DATA is one RADOS object per S3 key under the bucket's
    data prefix ("rgw_data.<bucket>_<key>");
  * S3 list semantics: lexicographic, prefix + marker + max_keys with
    truncation flag, and delimiter-based common prefixes;
  * ETag = MD5 hex of the payload (S3 compatibility contract).

No HTTP frontend here — the gateway API is the seam a REST layer
would call (the RGWOp layer's interface).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..common import faults
from ..common.backoff import ExpBackoff

_BUCKETS_OID = "rgw.buckets"

# Declared next to its fire site (Bucket._log_op): the seeded
# lost-replication fault the DR drill's falsifiability leg arms — the
# data/index write lands but the bilog entry is silently dropped, so
# multisite sync never learns about the op.  A gate that stays green
# with this armed proves nothing.
faults.declare(
    "rgw.bilog_lost_entry",
    "drop one bucket-index-log append (the data/index write lands, "
    "the bilog entry never does) — the lost-replication seed the DR "
    "convergence gate must turn red on; ctx: bucket, key, shard")


class RGWError(IOError):
    pass


def _read_json(ioctx, oid: str, default, what: str):
    """Read+decode one JSON metadata object (bucket index, bucket
    directory, GC log) with the failure taxonomy these objects NEED:

      * object absent -> ``default`` (a fresh bucket/log);
      * TRANSIENT IOError (degraded EC read mid-recovery, injected
        EIO, connection cut) -> bounded retry with ExpBackoff, then
        RAISE.  The old ``except Exception: return {}`` here was a
        lost-object bug under load, not a flake: one transient read
        error made a full bucket index read as EMPTY — spurious
        NoSuchKey on a GET, and the next index WRITE would rebuild
        from {} and silently orphan every existing object;
      * corrupt JSON -> raise (serving {} for a damaged index is the
        same data loss with less evidence).
    """
    # stable digest, NOT hash(): str hashing is salted per process
    # and would make retry jitter irreproducible across runs
    backoff = ExpBackoff(base=0.02, cap=0.25,
                         seed=zlib.crc32(oid.encode()) & 0xffff)
    last: Optional[Exception] = None
    for attempt in range(4):
        try:
            return json.loads(ioctx.read(oid).decode())
        except KeyError:
            # ObjectNotFound subclasses KeyError in both client tiers:
            # genuinely absent metadata means a fresh bucket/log
            return default
        except (IOError, OSError) as e:
            last = e
            if attempt < 3:
                backoff.sleep(attempt)
    raise RGWError(f"{what} {oid!r} unreadable after retries: {last}")


# -------------------------------------------------- sync bookkeeping --
# The marker/zone object schema is shared between the gateway (drain
# gating on trim/retire/delete) and rgw/sync.py (the agents that own
# the markers), so it lives here next to the bilog naming it governs.

def zones_oid(bucket: str) -> str:
    return f"rgw.zones.{bucket}"


def sync_state_oid(bucket: str, zone: str) -> str:
    return f"rgw.sync.{bucket}.{zone}"


def read_sync_state(ioctx, bucket: str, zone: str):
    """One zone's persisted sync cursor: {"gen": g, "shards":
    {"<shard>": last_applied_seq}}.  Absent -> None (never synced);
    the pre-generation format (a bare int: shard 0's position) reads
    as a gen-0 single-shard cursor, so old pools resume, not restart.
    Transient read errors retry/raise via _read_json — fabricating
    "never synced" from a flake would re-replay a whole generation."""
    raw = _read_json(ioctx, sync_state_oid(bucket, zone), None,
                     "sync state")
    if raw is None:
        return None
    if isinstance(raw, (int, float)):
        return {"gen": 0, "shards": {"0": int(raw)}}
    return {"gen": int(raw.get("gen", 0)),
            "shards": {str(k): int(v)
                       for k, v in raw.get("shards", {}).items()}}


def zone_drained_past(state, gen: int, ends: List[int]) -> bool:
    """Has this zone consumed EVERY entry of bilog generation ``gen``
    (per-shard end seqs ``ends``)?  A later generation implies the
    cutover already drained this one; an earlier one (or no state at
    all) means entries this zone has not replicated still live here."""
    if state is None:
        return False
    zgen = int(state.get("gen", 0))
    if zgen != gen:
        return zgen > gen
    shards = state.get("shards", {})
    return all(int(shards.get(str(s), -1)) >= e
               for s, e in enumerate(ends))


class Bucket:
    # how long a handle trusts its cached shard layout before
    # re-reading the bucket directory record: the window in which a
    # CROSS-PROCESS ``reshard`` is invisible to a live writer (gens
    # make a stale write land in an unreferenced old-gen object — an
    # orphan, never a corrupted new-gen shard).  In-process handles
    # of one gateway share the reshard lock and never race at all.
    _LAYOUT_TTL_S = 1.0

    def __init__(self, gw: "RGWGateway", name: str,
                 layout: Optional[Dict[str, int]] = None):
        self.gw = gw
        self.name = name
        self._bilogs: Dict[int, object] = {}
        self._layout_cache = dict(layout) if layout else None
        self._layout_ts = time.monotonic() if layout else 0.0

    # ------------------------------------------------------------ layout --
    def _layout(self) -> Dict[str, int]:
        """{"num_shards": N, "index_gen": g} from the bucket
        directory record, TTL-cached (an online reshard bumps the
        gen; other handles pick the new layout up within the TTL)."""
        now = time.monotonic()
        if self._layout_cache is None or \
                now - self._layout_ts > self._LAYOUT_TTL_S:
            return self._refresh_layout()
        return self._layout_cache

    def _refresh_layout(self) -> Dict[str, int]:
        """Drop the TTL cache and re-read the bucket record NOW —
        the ECANCELED-refresh a real RGW client does when an index
        op lands on a resharded-away generation."""
        ent = self.gw._read_buckets().get(self.name) or {}
        self._layout_cache = {
            "num_shards": int(ent.get("num_shards", 1)),
            "index_gen": int(ent.get("index_gen", 0))}
        self._layout_ts = time.monotonic()
        return self._layout_cache

    def num_shards(self) -> int:
        return self._layout()["num_shards"]

    def _shard_for_key(self, key: str,
                       layout: Optional[Dict[str, int]] = None
                       ) -> int:
        # stable digest, NOT hash(): shard placement must agree
        # across processes and runs (str hashing is salted)
        lo = layout or self._layout()
        return zlib.crc32(key.encode()) % lo["num_shards"]

    def bilog_for_shard(self, shard: int, gen: Optional[int] = None):
        """Per-(generation, shard) bucket index log (the RGW
        bilog-per-shard role, generation-split like cls_rgw's
        bilog layout after reshard): every put/delete lands in its
        key's shard log OF THE CURRENT GENERATION.  A reshard starts
        a fresh set of logs (new gen) instead of interleaving two
        shard mappings in one stream — the old generation's logs stay
        put, end-marked, until every peer zone drains them.
        Generation 0 keeps the legacy un-suffixed/`.N` names so
        pre-generation pools replay unchanged."""
        if gen is None:
            gen = self._layout()["index_gen"]
        j = self._bilogs.get((gen, shard))
        if j is None:
            from ..fs.journaler import Journaler
            if gen == 0:
                suffix = "" if shard == 0 else f".{shard}"
            else:
                suffix = f".g{gen}.{shard}"
            j = self._bilogs[(gen, shard)] = Journaler(
                self.gw.ioctx, f"rgw.bilog.{self.name}{suffix}")
        return j

    @property
    def bilog(self):
        """Generation 0's shard-0 bilog — the whole log for legacy
        single-shard buckets (kept for pre-generation callers;
        rgw/sync.py walks every (gen, shard) log itself)."""
        return self.bilog_for_shard(0, gen=0)

    def _log_op(self, op: str, key: str, shard: int,
                gen: Optional[int] = None, **extra) -> None:
        """Append one bilog entry: {op, key, mtime} plus per-op extras
        (etag/size on puts; origin on sync applies, so the reverse
        agent can suppress the echo instead of ping-ponging writes).
        ``gen`` pins the log to the caller's layout snapshot — the
        shard NUMBER and the log GENERATION must come from the same
        layout or a TTL refresh mid-op could cross the streams."""
        if faults.fire("rgw.bilog_lost_entry", bucket=self.name,
                       key=key, shard=shard) is not None:
            return                     # the entry is silently LOST
        # reload the journal header first: another live handle of this
        # bucket may have appended since ours cached its sequence — a
        # stale seq would duplicate and sync would drop the entry
        j = self.bilog_for_shard(shard, gen=gen)
        j._load_header()
        ent = {"op": op, "key": key, "mtime": time.time()}
        ent.update(extra)
        j.append(json.dumps(ent).encode())

    # ------------------------------------------------------------- index --
    @contextlib.contextmanager
    def _current_shard(self, key: str):
        """``key``'s shard lock, held under a layout that no reshard of
        this gateway has superseded: a writer that took its snapshot
        before ``reshard_bucket`` and then waited on the old shard's
        lock refreshes the layout and takes the new shard's lock, so
        its index entry lands in the new generation.  (The reference's
        writer keeps the stale snapshot; its entry goes to the removed
        old-generation object and the acked write drops out of the
        index.)  -> (layout, shard)."""
        while True:
            lo = dict(self._layout())
            shard = self._shard_for_key(key, lo)
            with self.gw._index_lock(self.name, shard):
                if self.gw._index_gens.get(self.name, 0) <= \
                        lo["index_gen"]:
                    yield lo, shard
                    return
            self._refresh_layout()

    def _index_shard_oid(self, shard: int,
                         layout: Optional[Dict[str, int]] = None
                         ) -> str:
        lo = layout or self._layout()
        if lo["num_shards"] == 1 and lo["index_gen"] == 0:
            # legacy single-object layout: pre-shard pools unchanged
            return f"rgw.index.{self.name}"
        return f"rgw.index.{self.name}.g{lo['index_gen']}.{shard}"

    def _read_index_shard(self, shard: int,
                          layout: Optional[Dict[str, int]] = None
                          ) -> Dict[str, dict]:
        return _read_json(self.gw.ioctx,
                          self._index_shard_oid(shard, layout), {},
                          f"bucket index shard {shard}")

    def _write_index_shard(self, shard: int, idx: Dict[str, dict],
                           layout: Optional[Dict[str, int]] = None
                           ) -> None:
        self.gw.ioctx.write_full(self._index_shard_oid(shard, layout),
                                 json.dumps(idx).encode())

    def _read_index(self) -> Dict[str, dict]:
        """The WHOLE index, merged across shards — the listing /
        reshard / admin surface, never a per-request path (lint
        CTL901 polices exactly that)."""
        lo = dict(self._layout())
        merged: Dict[str, dict] = {}
        for s in range(lo["num_shards"]):
            merged.update(self._read_index_shard(s, layout=lo))
        return merged

    def shard_entry_counts(self) -> List[int]:
        """Per-shard entry counts (`radosgw-admin bucket limit
        check`'s fill view)."""
        lo = dict(self._layout())
        return [len(self._read_index_shard(s, layout=lo))
                for s in range(lo["num_shards"])]

    # -------------------------------------------------------------- data --
    def _read_data(self, oid: str, what: str) -> bytes:
        """Data-object read with the bounded poll-budget retry the
        metadata reads already had (_read_json's taxonomy): the
        degraded-read window right after an OSD SIGKILL surfaces as
        TRANSIENT IOErrors while the map catches up — retry through
        it, then raise.  Genuine absence (KeyError) propagates: an
        indexed key whose data object is gone is an inconsistency
        the caller must see, not retry."""
        backoff = ExpBackoff(base=0.05, cap=0.5,
                             seed=zlib.crc32(oid.encode()) & 0xffff)
        last: Optional[Exception] = None
        for attempt in range(5):
            try:
                return self.gw.ioctx.read(oid)
            except KeyError:
                raise
            except (IOError, OSError) as e:
                last = e
                if attempt < 4:
                    backoff.sleep(attempt)
        raise RGWError(f"{what} {oid!r} unreadable after retries: "
                       f"{last}")

    def _data_oid(self, key: str, gen: str = "") -> str:
        # '/' is forbidden in bucket names (create_bucket validates),
        # so this join is collision-free across (bucket, key) pairs.
        # ``gen`` is the per-write generation token: data oids are
        # UNIQUE per object version, so a superseded version's oid can
        # sit in the deferred-GC log while the SAME KEY is rewritten —
        # GC can never reclaim live data (the RGW tail-object
        # generation role).
        return f"rgw_data.{self.name}/{key}.{gen}" if gen \
            else f"rgw_data.{self.name}/{key}"

    # --------------------------------------------------------------- ops --
    def put_object(self, key: str, data: bytes,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        """-> ETag.  Data object first, index entry second.  Only the
        KEY'S shard is read-modify-written, under that shard's lock —
        writers to a hot bucket serialize per shard, not per bucket."""
        import secrets as _secrets
        etag = hashlib.md5(data).hexdigest()
        gen = _secrets.token_hex(4)
        # ONE layout snapshot for the whole op: the shard NUMBER and
        # the oid GENERATION must come from the same layout, or a
        # TTL refresh mid-op could write the key into the wrong
        # new-gen shard (a stale snapshot only ever writes a dead
        # old-gen oid — an orphan, never corruption)
        # bilog entry FIRST (the prepare-before-index-transaction
        # order): a crash between log and index leaves an entry whose
        # replay finds no object and skips — never a visible object
        # that multisite would silently miss
        with self._current_shard(key) as (lo, shard):
            self._log_op("put", key, shard, gen=lo["index_gen"],
                         etag=etag, size=len(data))
            self.gw.ioctx.write_full(self._data_oid(key, gen), data)
            idx = self._read_index_shard(shard, layout=lo)
            old = idx.get(key)
            idx[key] = {"size": len(data), "etag": etag, "gen": gen,
                        "mtime": time.time(), "meta": metadata or {}}
            self._write_index_shard(shard, idx, layout=lo)
        # the superseded version (plain or multipart) -> deferred GC
        if old:
            self.gw.gc_enqueue(self._version_oids(key, old))
        return etag

    def apply_put(self, key: str, data: bytes,
                  metadata: Optional[Dict[str, str]], mtime: float,
                  origin: str) -> Optional[str]:
        """Sync-agent apply of a replicated put — put_object with the
        three cross-zone differences: the index entry keeps the
        SOURCE's mtime (last-writer-wins across zones compares source
        timestamps, not apply times), the bilog entry carries the
        ORIGIN zone (the reverse-direction agent suppresses the echo
        instead of ping-ponging the write back), and a strictly NEWER
        local entry wins (the post-failover overwrite case).  Returns
        the ETag, or None when the local entry won."""
        import secrets as _secrets
        etag = hashlib.md5(data).hexdigest()
        gen = _secrets.token_hex(4)
        with self._current_shard(key) as (lo, shard):
            idx = self._read_index_shard(shard, layout=lo)
            old = idx.get(key)
            if old and float(old.get("mtime", 0.0)) > mtime:
                return None            # local write is newer: keep it
            self._log_op("put", key, shard, gen=lo["index_gen"],
                         etag=etag, size=len(data), mtime=mtime,
                         origin=origin)
            self.gw.ioctx.write_full(self._data_oid(key, gen), data)
            idx[key] = {"size": len(data), "etag": etag, "gen": gen,
                        "mtime": mtime, "meta": metadata or {}}
            self._write_index_shard(shard, idx, layout=lo)
        if old:
            self.gw.gc_enqueue(self._version_oids(key, old))
        return etag

    def apply_delete(self, key: str, mtime: float,
                     origin: str) -> bool:
        """Sync-agent apply of a replicated delete (same LWW/origin
        contract as apply_put).  Returns False when there was nothing
        to delete or a newer local entry won."""
        with self._current_shard(key) as (lo, shard):
            idx = self._read_index_shard(shard, layout=lo)
            ent = idx.get(key)
            if ent is None or float(ent.get("mtime", 0.0)) > mtime:
                return False
            self._log_op("delete", key, shard, gen=lo["index_gen"],
                         mtime=mtime, origin=origin)
            del idx[key]
            self._write_index_shard(shard, idx, layout=lo)
        mp = ent.get("mp")
        if mp:
            self.gw.gc_enqueue(self._version_oids(key, ent))
            return True
        try:
            self.gw.ioctx.remove(self._data_oid(key,
                                                ent.get("gen", "")))
        except Exception:
            pass
        return True

    def _version_oids(self, key: str, ent: dict) -> List[str]:
        """Every data oid one index-entry version owns."""
        mp = ent.get("mp")
        if mp:
            return [self._mp_part_oid(mp["uid"], p["n"])
                    for p in mp["parts"]]
        return [self._data_oid(key, ent.get("gen", ""))]

    def get_object(self, key: str) -> Tuple[bytes, dict]:
        lo = dict(self._layout())
        ent = self._read_index_shard(
            self._shard_for_key(key, lo), layout=lo).get(key)
        if ent is None:
            # a miss through a TTL-stale handle reads a resharded-away
            # generation's (removed) index shard — refresh and retry
            # once before declaring absence, like the reference
            # client's ECANCELED + layout-refresh loop
            lo2 = dict(self._refresh_layout())
            if lo2 != lo:
                ent = self._read_index_shard(
                    self._shard_for_key(key, lo2),
                    layout=lo2).get(key)
        if ent is None:
            raise RGWError(f"NoSuchKey: {key}")
        mp = ent.get("mp")
        if mp:
            # multipart manifest: the object is striped across its
            # part objects (the RGW manifest role — completion never
            # copies bytes, rgw_op.h:1210 CompleteMultipart)
            chunks = []
            for p in mp["parts"]:
                raw = self._read_data(
                    self._mp_part_oid(mp["uid"], p["n"]),
                    "multipart part")
                chunks.append(raw[:p["size"]])
            return b"".join(chunks), ent
        data = self._read_data(
            self._data_oid(key, ent.get("gen", "")),
            "object data")[:ent["size"]]
        return data, ent

    def head_object(self, key: str) -> dict:
        lo = dict(self._layout())
        ent = self._read_index_shard(
            self._shard_for_key(key, lo), layout=lo).get(key)
        if ent is None:
            lo2 = dict(self._refresh_layout())
            if lo2 != lo:
                ent = self._read_index_shard(
                    self._shard_for_key(key, lo2),
                    layout=lo2).get(key)
        if ent is None:
            raise RGWError(f"NoSuchKey: {key}")
        return dict(ent)

    def delete_object(self, key: str) -> None:
        with self._current_shard(key) as (lo, shard):
            idx = self._read_index_shard(shard, layout=lo)
            if key not in idx:
                raise RGWError(f"NoSuchKey: {key}")
            ent = idx[key]
            # index entry first, then data: a crash leaves an orphan
            # data object (GC-able), never a dangling index entry
            self._log_op("delete", key, shard,   # log-ahead, like put
                         gen=lo["index_gen"])
            del idx[key]
            self._write_index_shard(shard, idx, layout=lo)
        mp = ent.get("mp")
        if mp:
            # multipart tails go through the DEFERRED-delete GC log
            # (rgw_gc.cc role): the delete acks now, space reclaims
            # on the next gc_process pass
            self.gw.gc_enqueue(self._version_oids(key, ent))
            return
        try:
            self.gw.ioctx.remove(self._data_oid(key,
                                                ent.get("gen", "")))
        except Exception:
            pass

    # --------------------------------------------------------- multipart --
    # Reference: InitMultipart / UploadPart / CompleteMultipart ops
    # (src/rgw/rgw_op.h:1210-1212).  Parts are RADOS objects; completion
    # writes a MANIFEST into the index (striped mapping, no byte copy).

    def _mp_meta_oid(self, uid: str) -> str:
        return f"rgw.mp.{self.name}/{uid}"

    def _mp_part_oid(self, uid: str, n: int) -> str:
        return f"rgw_mp.{self.name}/{uid}.{n}"

    def _read_mp(self, uid: str) -> dict:
        meta = _read_json(self.gw.ioctx, self._mp_meta_oid(uid),
                          None, "multipart meta")
        if meta is None:
            raise RGWError(f"NoSuchUpload: {uid}")
        return meta

    def initiate_multipart(self, key: str) -> str:
        import secrets as _secrets
        uid = _secrets.token_hex(8)
        self.gw.ioctx.write_full(
            self._mp_meta_oid(uid),
            json.dumps({"key": key, "parts": {},
                        "started": time.time()}).encode())
        return uid

    def upload_part(self, uid: str, part_number: int,
                    data: bytes) -> str:
        if part_number < 1 or part_number > 10000:
            raise RGWError(f"InvalidPart: number {part_number}")
        etag = hashlib.md5(data).hexdigest()
        self.gw.ioctx.write_full(self._mp_part_oid(uid, part_number),
                                 data)
        with self.gw._mp_lock:     # concurrent parts: RMW must not
            meta = self._read_mp(uid)          # lose registrations
            meta["parts"][str(part_number)] = {"size": len(data),
                                               "etag": etag}
            self.gw.ioctx.write_full(self._mp_meta_oid(uid),
                                     json.dumps(meta).encode())
        return etag

    def complete_multipart(self, uid: str,
                           part_numbers: List[int]) -> str:
        """Stitch the listed parts (ascending) into the object as a
        manifest; superseded/unlisted parts go to GC.  ETag follows
        the S3 multipart convention: md5(part-md5s) + '-N'."""
        meta = self._read_mp(uid)
        key = meta["key"]
        nums = [int(x) for x in part_numbers]
        if len(set(nums)) != len(nums):
            raise RGWError("InvalidPart: duplicate part numbers")
        parts = []
        digest = hashlib.md5()
        size = 0
        for n in sorted(nums):
            p = meta["parts"].get(str(n))
            if p is None:
                raise RGWError(f"InvalidPart: {n} was never uploaded")
            parts.append({"n": n, "size": p["size"],
                          "etag": p["etag"]})
            digest.update(bytes.fromhex(p["etag"]))
            size += p["size"]
        if not parts:
            raise RGWError("InvalidPart: empty part list")
        etag = f"{digest.hexdigest()}-{len(parts)}"
        with self._current_shard(key) as (lo, shard):
            self._log_op("put", key, shard, gen=lo["index_gen"],
                         etag=etag, size=size)
            idx = self._read_index_shard(shard, layout=lo)
            old = idx.get(key)
            idx[key] = {"size": size, "etag": etag,
                        "mtime": time.time(), "meta": {},
                        "mp": {"uid": uid, "parts": parts}}
            self._write_index_shard(shard, idx, layout=lo)
        # unlisted parts + any overwritten previous object -> GC
        listed = {p["n"] for p in parts}
        orphans = [self._mp_part_oid(uid, int(n))
                   for n in meta["parts"] if int(n) not in listed]
        if old:
            orphans += self._version_oids(key, old)
        if orphans:
            self.gw.gc_enqueue(orphans)
        try:
            self.gw.ioctx.remove(self._mp_meta_oid(uid))
        except Exception:
            pass
        return etag

    def abort_multipart(self, uid: str) -> int:
        """Abandon an upload: every uploaded part becomes a deferred
        GC entry (AbortMultipart -> rgw_gc.cc defer_gc shape)."""
        meta = self._read_mp(uid)
        oids = [self._mp_part_oid(uid, int(n)) for n in meta["parts"]]
        self.gw.gc_enqueue(oids)
        try:
            self.gw.ioctx.remove(self._mp_meta_oid(uid))
        except Exception:
            pass
        return len(oids)

    def list_objects(self, prefix: str = "", marker: str = "",
                     max_keys: int = 1000, delimiter: str = ""
                     ) -> Dict[str, object]:
        """S3 ListObjects semantics: sorted keys after ``marker``
        matching ``prefix``; with ``delimiter``, roll common prefixes."""
        idx = self._read_index()
        keys = sorted(k for k in idx
                      if k.startswith(prefix) and k > marker)
        contents: List[dict] = []
        common: List[str] = []
        last_seen = ""           # S3 NextMarker = last key RETURNED
        for k in keys:
            if delimiter:
                rest = k[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter, 1)[0] + delimiter
                    if cp not in common:
                        if len(contents) + len(common) >= max_keys:
                            return {"contents": contents,
                                    "common_prefixes": common,
                                    "is_truncated": True,
                                    "next_marker": last_seen}
                        common.append(cp)
                    last_seen = k
                    continue
            if len(contents) + len(common) >= max_keys:
                return {"contents": contents, "common_prefixes": common,
                        "is_truncated": True, "next_marker": last_seen}
            contents.append({"key": k, **idx[k]})
            last_seen = k
        return {"contents": contents, "common_prefixes": common,
                "is_truncated": False, "next_marker": ""}


_GC_OID = "rgw.gc"


class RGWGateway:
    """Bucket directory + per-bucket handles (the RGWRados role)."""

    def __init__(self, ioctx):
        self.ioctx = ioctx
        # serialize the shared-object read-modify-writes across the
        # frontend's request threads (gc log + per-upload multipart
        # meta; cross-PROCESS gateways would shard these like the
        # reference's gc/bucket-index objects)
        self._gc_lock = threading.Lock()
        self._mp_lock = threading.Lock()
        # per-(bucket, shard) index RMW locks: writers to ONE bucket
        # serialize per SHARD, so an N-shard hot bucket admits N
        # concurrent index writers (the whole point of sharding) —
        # and a reshard excludes every writer by taking all of them.
        # Pruned on delete_bucket so bucket churn cannot grow the
        # table forever
        self._index_locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._index_locks_guard = threading.Lock()
        # bucket -> the index generation this gateway's last reshard
        # committed (writers holding an older layout retry on it)
        self._index_gens: Dict[str, int] = {}

    def _index_lock(self, bucket: str, shard: int):
        with self._index_locks_guard:
            lk = self._index_locks.get((bucket, shard))
            if lk is None:
                lk = self._index_locks[(bucket, shard)] = \
                    threading.Lock()
            return lk

    def _drop_index_locks(self, bucket: str) -> None:
        with self._index_locks_guard:
            for key in [k for k in self._index_locks
                        if k[0] == bucket]:
                del self._index_locks[key]
            self._index_gens.pop(bucket, None)

    # ------------------------------------------------------------------ GC --
    # Deferred-delete log (src/rgw/rgw_gc.cc): deletions of tail/part
    # objects enqueue here and reclaim on the next gc_process() pass,
    # so client-visible deletes never wait on data removal and orphan
    # cleanup is centralized.

    def _read_gc(self) -> List[dict]:
        # same taxonomy as the bucket index: a transient read error
        # treated as "empty log" would let the next gc_enqueue
        # OVERWRITE pending entries — leaked data objects
        return _read_json(self.ioctx, _GC_OID, [], "gc log")

    def gc_enqueue(self, oids: List[str],
                   delay: float = 0.0) -> None:
        with self._gc_lock:
            entries = self._read_gc()
            due = time.time() + delay
            entries.extend({"oid": o, "due": due} for o in oids)
            self.ioctx.write_full(_GC_OID,
                                  json.dumps(entries).encode())

    def gc_list(self) -> List[dict]:
        return self._read_gc()

    def gc_process(self, now: Optional[float] = None) -> int:
        """Remove every due entry's object; returns objects removed.
        Entries whose object is already gone still clear (idempotent
        across a crash mid-pass)."""
        now = time.time() if now is None else now
        with self._gc_lock:
            entries = self._read_gc()
            keep, removed = [], 0
            for e in entries:
                if e["due"] > now:
                    keep.append(e)
                    continue
                try:
                    self.ioctx.remove(e["oid"])
                    removed += 1
                except Exception:
                    pass      # already gone: entry still clears
            self.ioctx.write_full(_GC_OID, json.dumps(keep).encode())
        return removed

    def _read_buckets(self) -> Dict[str, dict]:
        return _read_json(self.ioctx, _BUCKETS_OID, {},
                          "bucket directory")

    def _write_buckets(self, d: Dict[str, dict]) -> None:
        self.ioctx.write_full(_BUCKETS_OID, json.dumps(d).encode())

    def create_bucket(self, name: str,
                      num_shards: int = 1) -> Bucket:
        if not name or "/" in name:
            raise RGWError(f"InvalidBucketName: {name!r}")
        if num_shards < 1:
            raise RGWError(f"InvalidArgument: num_shards "
                           f"{num_shards}")
        d = self._read_buckets()
        if name in d:
            raise RGWError(f"BucketAlreadyExists: {name}")
        # max_shards tracks the LARGEST layout this bucket ever had:
        # per-shard bilogs are keyed by shard number and survive a
        # shrink reshard, so deletion must sweep up to the high-water
        # mark, not the current count
        d[name] = {"created": time.time(),
                   "num_shards": int(num_shards), "index_gen": 0,
                   "max_shards": int(num_shards)}
        self._write_buckets(d)
        return Bucket(self, name,
                      layout={"num_shards": int(num_shards),
                              "index_gen": 0})

    def bucket(self, name: str) -> Bucket:
        ent = self._read_buckets().get(name)
        if ent is None:
            raise RGWError(f"NoSuchBucket: {name}")
        return Bucket(self, name, layout={
            "num_shards": int(ent.get("num_shards", 1)),
            "index_gen": int(ent.get("index_gen", 0))})

    def reshard_bucket(self, name: str,
                       num_shards: int) -> Dict[str, int]:
        """Online bucket reshard (the RGWBucketReshard role): copy
        the merged entries into a NEW generation of shard objects,
        commit the layout in the bucket directory, then drop the old
        generation.  In-process writers are excluded by holding every
        old-shard lock for the copy; cross-process handles land on
        the new layout within the layout TTL (their in-window writes
        go to unreferenced old-gen objects — orphans for GC, never
        corrupted new-gen shards)."""
        if num_shards < 1:
            raise RGWError(f"InvalidArgument: num_shards "
                           f"{num_shards}")
        d = self._read_buckets()
        ent = d.get(name)
        if ent is None:
            raise RGWError(f"NoSuchBucket: {name}")
        old_layout = {"num_shards": int(ent.get("num_shards", 1)),
                      "index_gen": int(ent.get("index_gen", 0))}
        b = Bucket(self, name, layout=old_layout)
        locks = [self._index_lock(name, s)
                 for s in range(old_layout["num_shards"])]
        for lk in locks:
            lk.acquire()
        try:
            merged = b._read_index()
            new_gen = old_layout["index_gen"] + 1
            new_layout = {"num_shards": int(num_shards),
                          "index_gen": new_gen}
            nb = Bucket(self, name, layout=new_layout)
            shards: List[Dict[str, dict]] = [
                {} for _ in range(num_shards)]
            for key, e in merged.items():
                shards[nb._shard_for_key(key)][key] = e
            for s, idx in enumerate(shards):
                nb._write_index_shard(s, idx)
            # END-MARK the outgoing generation's bilogs: under the
            # shard locks no writer can append, so each log's current
            # tail seq is its final entry.  The cutover record is
            # what lets a sync agent DRAIN the old generation to
            # these ends and switch — instead of a full-sync restart
            ends = []
            for s in range(old_layout["num_shards"]):
                j = b.bilog_for_shard(s, gen=old_layout["index_gen"])
                j._load_header()
                ends.append(j.seq - 1)
            # commit the layout AFTER the new shards exist: a crash
            # mid-copy leaves the old generation authoritative
            d = self._read_buckets()
            prev = d.get(name) or {}
            new_layout["max_shards"] = max(
                int(prev.get("max_shards",
                             old_layout["num_shards"])),
                int(num_shards))
            new_layout["log_gens"] = list(prev.get("log_gens", [])) + [
                {"gen": old_layout["index_gen"],
                 "num_shards": old_layout["num_shards"],
                 "ends": ends}]
            d[name] = dict(prev, **new_layout)
            self._write_buckets(d)
            self._index_gens[name] = new_gen
            # old generation -> gone (absent old-gen reads were never
            # possible: the record now names the new gen)
            for s in range(old_layout["num_shards"]):
                try:
                    self.ioctx.remove(
                        b._index_shard_oid(s, layout=old_layout))
                except Exception:
                    pass
            return {"bucket": name, "entries": len(merged),
                    "old_num_shards": old_layout["num_shards"],
                    "num_shards": int(num_shards),
                    "index_gen": new_gen}
        finally:
            for lk in locks:
                lk.release()

    def bucket_limit_check(self, max_entries_per_shard: int = 1000
                           ) -> List[Dict[str, object]]:
        """`radosgw-admin bucket limit check`: per-bucket per-shard
        entry counts with a fill verdict — OK under the warn line,
        WARN past 90% of ``max_entries_per_shard``, OVER past it (a
        hot shard is the reshard signal)."""
        out: List[Dict[str, object]] = []
        warn_at = 0.9 * max_entries_per_shard
        for name in self.list_buckets():
            counts = self.bucket(name).shard_entry_counts()
            hottest = max(counts) if counts else 0
            status = "OK"
            if hottest > max_entries_per_shard:
                status = "OVER"
            elif hottest >= warn_at:
                status = "WARN"
            out.append({"bucket": name, "num_shards": len(counts),
                        "shard_entries": counts,
                        "max_shard_entries": hottest,
                        "fill_status": status})
        return out

    def list_buckets(self) -> List[str]:
        return sorted(self._read_buckets())

    # --------------------------------------------- bilog retirement --
    # Old-generation bilogs are the ONLY copy of ops a peer zone has
    # not replicated yet: removing one before every registered zone
    # drained past its end markers is the lost-replication bug class.
    # Trim/retire is therefore drain-gated everywhere — the sync
    # agents call retire_drained_bilogs() after their passes, and
    # delete_bucket refuses while undrained entries remain.

    def _remove_bilog(self, b: Bucket, gen: int, shard: int) -> None:
        j = b.bilog_for_shard(shard, gen=gen)
        j._load_header()
        for idx_no in range(j.first, j.active + 1):
            try:
                self.ioctx.remove(j._obj_oid(idx_no))
            except Exception:
                pass
        try:
            self.ioctx.remove(j._header_oid())
        except Exception:
            pass

    def _gen_drained(self, name: str, gen: int, ends: List[int],
                     zones: Optional[List[str]] = None) -> bool:
        """True when every registered peer zone's sync cursor is past
        generation ``gen``'s end markers (no zones -> vacuously
        drained: nothing replicates this bucket)."""
        if zones is None:
            zones = _read_json(self.ioctx, zones_oid(name), [],
                               "zone set")
        return all(zone_drained_past(
            read_sync_state(self.ioctx, name, z), gen, ends)
            for z in zones)

    def retire_drained_bilogs(self, name: str) -> int:
        """Remove retired-generation bilogs every registered zone has
        drained past (and drop them from the bucket record's gen
        history); returns generations retired.  Undrained generations
        stay — they are replayable history, not garbage."""
        d = self._read_buckets()
        ent = d.get(name)
        if ent is None or not ent.get("log_gens"):
            return 0
        zones = _read_json(self.ioctx, zones_oid(name), [],
                           "zone set")
        b = Bucket(self, name,
                   layout={"num_shards": int(ent.get("num_shards", 1)),
                           "index_gen": int(ent.get("index_gen", 0))})
        keep, retired = [], 0
        for h in ent["log_gens"]:
            g = int(h["gen"])
            ends = [int(e) for e in h["ends"]]
            if self._gen_drained(name, g, ends, zones):
                for s in range(int(h["num_shards"])):
                    self._remove_bilog(b, g, s)
                retired += 1
            else:
                keep.append(h)
        if retired:
            d = self._read_buckets()
            cur = d.get(name)
            if cur is not None:
                cur["log_gens"] = keep
                self._write_buckets(d)
        return retired

    def delete_bucket(self, name: str, force: bool = False) -> None:
        d = self._read_buckets()
        if name not in d:
            raise RGWError(f"NoSuchBucket: {name}")
        ent = d[name]
        b = self.bucket(name)
        if b._read_index():
            raise RGWError(f"BucketNotEmpty: {name}")
        cur_gen = int(ent.get("index_gen", 0))
        cur_n = int(ent.get("num_shards", 1))
        zones = _read_json(self.ioctx, zones_oid(name), [],
                           "zone set")
        # every generation's logs, with the ACTIVE one end-marked at
        # its current tails (the bucket is empty, so its remaining
        # entries are the deletes peers still need to replicate)
        gens = [(int(h["gen"]), int(h["num_shards"]),
                 [int(e) for e in h["ends"]])
                for h in ent.get("log_gens", [])]
        cur_ends = []
        for s in range(cur_n):
            j = b.bilog_for_shard(s, gen=cur_gen)
            j._load_header()
            cur_ends.append(j.seq - 1)
        gens.append((cur_gen, cur_n, cur_ends))
        if zones and not force:
            for g, _n, ends in gens:
                if not self._gen_drained(name, g, ends, zones):
                    raise RGWError(
                        f"BucketNotDrained: {name} bilog gen {g} has "
                        f"entries no peer zone has synced yet — pump "
                        f"sync first, or force=True to accept the "
                        f"lost replication")
        for s in range(b.num_shards()):
            try:
                self.ioctx.remove(b._index_shard_oid(s))
            except Exception:
                pass
        for g, n, _ends in gens:
            for s in range(n):
                self._remove_bilog(b, g, s)
        # legacy sweep to the HIGH-WATER shard count: pre-generation
        # pools left shrink-reshard bilogs under plain gen-0 names
        max_shards = max(int(ent.get("max_shards", cur_n)), cur_n)
        for s in range(max_shards):
            self._remove_bilog(b, 0, s)
        # sync bookkeeping goes with the bucket (the drain gate above
        # already proved the markers were consumed or force waived)
        for z in zones:
            try:
                self.ioctx.remove(sync_state_oid(name, z))
            except Exception:
                pass
        try:
            self.ioctx.remove(zones_oid(name))
        except Exception:
            pass
        del d[name]
        self._write_buckets(d)
        self._drop_index_locks(name)
