"""Multi-MDS: active ranks, subtree migration, balancer.

The reference runs max_mds active metadata servers, each authoritative
for a set of subtrees; the Migrator moves a subtree's authority
between ranks (src/mds/Migrator.cc export/import state machines,
journaled as EExport/EImport), and the MDBalancer picks what to move
from load measurements (src/mds/MDBalancer.cc).  Clients whose request
lands on the wrong rank are forwarded (MDSRank::forward).

This module re-derives that shape on the repo's seams:

  * every rank is an ``MDS`` with its OWN journal (mdlog.<rank>) over
    the SHARED metadata/data pools — dirfrags are RADOS objects, so a
    migration transfers *authority* (and flushes the subtree's
    cap/lock session state), never dirfrag bytes;
  * the durable subtree-authority table is the MDSMap
    (fs/mdsmap.py); migration = EExport marker on the source journal,
    EImport marker on the destination journal, then the map epoch
    bump — the map write is the commit point, and a crash between the
    markers and the map write leaves authority unchanged (markers are
    diagnostic, ops replay idempotently);
  * ``MDSCluster`` is also the request router: ops go to the subtree
    owner, ForwardError re-routes (bounded retries), cross-rank rename
    is decomposed into an import-then-export dentry pair on the two
    owners (the master/slave rename collapsed to its effect);
  * ``MDBalancer`` counts requests per top-level subtree and migrates
    the hottest subtree off the busiest rank (req-count heuristic —
    the reference balances on a load vector);
  * CROSS-RANK READ CACHING (VERDICT r4 next #8): non-auth ranks hold
    read-only dentry/inode REPLICAS obtained by DISCOVER from the
    auth rank, held under a time-bounded LEASE; the auth rank tracks
    replica holders and revokes (EXPIRE) them on every mutation of
    the entry — src/mds/MDCache.h:624,794 (replica_map / discover),
    the dentry lease shape of Locker.  A read entering a NON-auth
    rank serves from its replica with no forward; file reads need
    only the inode (data objects live in the shared data pool), so a
    replica-holding rank serves whole file reads locally.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

from ..cluster.striper import FileLayout
from .mds import MDS, ForwardError, FSError
from .mdsmap import MDSMap, normalize

_MAX_FORWARDS = 4


class MDSCluster:
    """N active MDS ranks over shared pools + the request router."""

    MUTATING_OPS = frozenset((
        "mkdir", "create", "write_file", "unlink", "rmdir",
        "setlk", "acquire_caps_path"))

    def __init__(self, meta_ioctx, data_ioctx, n_ranks: int = 2,
                 layout: Optional[FileLayout] = None,
                 lease_s: float = 30.0):
        self.mdsmap = MDSMap(meta_ioctx, n_ranks=n_ranks)
        self.ranks: List[MDS] = [
            MDS(meta_ioctx, data_ioctx, layout=layout, rank=r,
                mdsmap=self.mdsmap)
            for r in range(self.mdsmap.n_ranks)]
        # per-top-level-subtree request counts, by rank (balancer input)
        self.load: Dict[str, int] = {}
        # -------- cross-rank read replicas (MDCache replica_map) --------
        self.lease_s = lease_s
        # per-rank: path -> (stat ent, lease expiry)
        self._replicas: List[Dict[str, Tuple[dict, float]]] = [
            {} for _ in range(self.mdsmap.n_ranks)]
        # auth side: path -> set of replica-holder ranks
        self._replica_holders: Dict[str, set] = {}
        self.replica_stats = {"hits": 0, "discovers": 0,
                              "expires": 0, "invalidations": 0}

    # ------------------------------------------- replica cache (reads) --
    def _replica_get(self, rank: int, path: str,
                     now: Optional[float] = None) -> Optional[dict]:
        """A live replica of ``path`` on ``rank``, or None.  Expired
        leases drop (the holder must re-discover — the lease-renewal
        half of the dentry lease protocol)."""
        p = normalize(path)
        hit = self._replicas[rank].get(p)
        if hit is None:
            return None
        ent, expires = hit
        if (now if now is not None else _time.monotonic()) >= expires:
            self._replicas[rank].pop(p, None)
            self._replica_holders.get(p, set()).discard(rank)
            self.replica_stats["expires"] += 1
            return None
        self.replica_stats["hits"] += 1
        return ent

    def _discover(self, rank: int, path: str,
                  now: Optional[float] = None) -> dict:
        """DISCOVER: the non-auth rank asks the subtree owner for a
        read-only replica of the entry; the owner registers the
        holder so mutations can revoke (MDCache.h:624 discover /
        :794 replica tracking)."""
        p = normalize(path)
        ent = self.mds_for(p).stat(p)
        t = now if now is not None else _time.monotonic()
        self._replicas[rank][p] = (ent, t + self.lease_s)
        self._replica_holders.setdefault(p, set()).add(rank)
        self.replica_stats["discovers"] += 1
        return ent

    def invalidate_replicas(self, path: str) -> None:
        """EXPIRE: revoke every rank's replica of the entry (sent by
        the auth rank on mutation, before the client sees the new
        state — here the cluster object IS the mon-grade messenger)."""
        p = normalize(path)
        for holder in self._replica_holders.pop(p, set()):
            if self._replicas[holder].pop(p, None) is not None:
                self.replica_stats["invalidations"] += 1

    def invalidate_replica_subtree(self, path: str) -> None:
        """Revoke replicas of an entry AND everything under it —
        namespace ops on a directory (rename) orphan every child
        path, and a path-keyed revoke of just the directory would
        leave children serving from a tree that no longer exists."""
        p = normalize(path)
        prefix = p if p.endswith("/") else p + "/"
        doomed = [q for q in self._replica_holders
                  if q == p or q.startswith(prefix)]
        for q in doomed:
            self.invalidate_replicas(q)

    def stat_via(self, rank: int, path: str,
                 now: Optional[float] = None) -> dict:
        """stat entering at an arbitrary rank: the auth rank serves
        its own; a non-auth rank serves its REPLICA with no forward,
        discovering one on first touch."""
        p = normalize(path)
        self._count(p)
        if self.mdsmap.auth_rank(p) == rank:
            return self.ranks[rank].stat(p)
        ent = self._replica_get(rank, p, now)
        if ent is None:
            ent = self._discover(rank, p, now)
        return ent

    def read_file_via(self, rank: int, path: str, offset: int = 0,
                      length: Optional[int] = None,
                      now: Optional[float] = None) -> bytes:
        """File read entering at an arbitrary rank: the inode replica
        is all the metadata a read needs (file bytes live in the
        SHARED data pool), so a replica-holding non-auth rank serves
        the whole read locally — zero forwards."""
        p = normalize(path)
        self._count(p)
        if self.mdsmap.auth_rank(p) == rank:
            return self.ranks[rank].read_file(p, offset, length)
        ent = self._replica_get(rank, p, now)
        if ent is None:
            ent = self._discover(rank, p, now)
        if ent.get("type") == "dir":
            raise FSError(f"is a directory: {path}")
        return self.ranks[rank].read_ino(ent, offset, length)

    # ------------------------------------------------------------ routing --
    def mds_for(self, path: str) -> MDS:
        return self.ranks[self.mdsmap.auth_rank(path)]

    def _routed(self, op: str, path: str, *args, **kw):
        """Dispatch op to the subtree owner, following forwards.
        Mutations REVOKE every outstanding read replica of the entry
        (and its parent: namespace ops change the parent's state) —
        the lease-expire half of the replica protocol."""
        self._count(path)
        if op in self.MUTATING_OPS:
            self.invalidate_replicas(path)
            parent = normalize(path).rsplit("/", 1)[0] or "/"
            self.invalidate_replicas(parent)
        rank = self.mdsmap.auth_rank(path)
        for _ in range(_MAX_FORWARDS):
            try:
                return getattr(self.ranks[rank], op)(path, *args, **kw)
            except ForwardError as f:
                rank = f.rank
        raise FSError(f"{op} {path}: forward loop (map churn?)")

    def _count(self, path: str) -> None:
        parts = [p for p in path.split("/") if p]
        key = "/" + parts[0] if parts else "/"
        self.load[key] = self.load.get(key, 0) + 1

    # ---------------------------------------------------------- the API --
    def mkdir(self, path: str) -> int:
        return self._routed("mkdir", path)

    def create(self, path: str) -> int:
        return self._routed("create", path)

    def write_file(self, path: str, data: bytes, offset: int = 0) -> int:
        return self._routed("write_file", path, data, offset)

    def read_file(self, path: str, offset: int = 0,
                  length: Optional[int] = None) -> bytes:
        self._count(path)
        return self.mds_for(path).read_file(path, offset, length)

    def unlink(self, path: str) -> None:
        return self._routed("unlink", path)

    def rmdir(self, path: str) -> None:
        return self._routed("rmdir", path)

    def listdir(self, path: str) -> List[str]:
        self._count(path)
        return self.mds_for(path).listdir(path)

    def stat(self, path: str) -> dict:
        return self.mds_for(path).stat(path)

    def rename(self, src: str, dst: str) -> None:
        s_rank = self.mdsmap.auth_rank(src)
        d_rank = self.mdsmap.auth_rank(dst)
        self._count(src)
        for p in (src, dst):
            self.invalidate_replica_subtree(p)
            self.invalidate_replicas(
                normalize(p).rsplit("/", 1)[0] or "/")
        if s_rank == d_rank:
            return self.ranks[s_rank].rename(src, dst)
        # cross-rank rename (the master/slave rename collapsed): the
        # destination owner imports the dentry first (visible-twice
        # window rather than lost-entry window), then the source owner
        # unlinks its side; both halves journal on their own rank and
        # replay idempotently
        smds, dmds = self.ranks[s_rank], self.ranks[d_rank]
        ent = smds.stat(src)
        sp, sn = smds._resolve(src)
        dp, dn = dmds._resolve(dst)
        if dn in dmds._read_dir(dp):
            raise FSError(f"exists: {dst}")
        for ino in ([ent["ino"]] if ent["type"] != "dir"
                    else smds.subtree_inos(src)):
            smds._flush_and_drop_caps(ino)
            # locks drop with the move too (the inode's lock state
            # lives on its subtree owner, which is changing) — a
            # stranded source-rank entry would both stop excluding and
            # be unreleasable through routing
            smds._locks.pop(ino, None)
        dmds._journal_and_apply({"op": "link_dentry", "parent": dp,
                                 "name": dn, "ent": ent})
        smds._journal_and_apply({"op": "unlink", "parent": sp,
                                 "name": sn})

    # -------------------------------------------- sessions / caps / locks --
    # CephFSClient quacks against this cluster exactly as against one
    # MDS: sessions exist on every rank (a client may touch any
    # subtree), caps/locks live on the subtree owner and are routed.
    def open_session(self, client: str, flush_cb=None,
                     now=None) -> None:
        for m in self.ranks:
            m.open_session(client, flush_cb, now)

    def renew_session(self, client: str, now=None) -> None:
        for m in self.ranks:
            m.renew_session(client, now)

    def evict_expired(self, now=None) -> List[str]:
        evicted: List[str] = []
        for m in self.ranks:
            evicted.extend(m.evict_expired(now))
        return sorted(set(evicted))

    def acquire_caps(self, client: str, path: str, want: str,
                     now=None) -> str:
        return self._routed("acquire_caps_path", path, client, want,
                            now)

    def release_caps(self, client: str, path: str) -> None:
        return self._routed("release_caps_path", path, client)

    def caps_of(self, path: str) -> Dict[str, str]:
        return self.mds_for(path).caps_of(path)

    def setlk(self, path: str, owner: str,
              exclusive: bool = True) -> bool:
        return self._routed("setlk", path, owner, exclusive)

    def getlk(self, path: str) -> Dict[str, bool]:
        return self.mds_for(path).getlk(path)

    def unlock(self, path: str, owner: str) -> None:
        return self.mds_for(path).unlock(path, owner)

    def release_owner(self, owner: str) -> int:
        return sum(m.release_owner(owner) for m in self.ranks)

    # -------------------------------------------------------- migration --
    def migrate(self, path: str, to_rank: int) -> None:
        """Move subtree authority (Migrator export/import).  The MDSMap
        write is the commit point; caps/locks under the subtree are
        flushed and dropped on the source (clients reacquire against
        the new owner — the reconnect shape)."""
        p = normalize(path)
        src_rank = self.mdsmap.auth_rank(p)
        if src_rank == to_rank:
            return
        src, dst = self.ranks[src_rank], self.ranks[to_rank]
        src.export_subtree(p, to_rank)          # journals EExport, flushes
        dst.import_subtree(p, src_rank)         # journals EImport
        self.mdsmap.set_auth(p, to_rank)        # ← commit point
        # balancer bookkeeping follows the subtree to the new rank
        self.load.pop(p, None)

    def subtree_map(self) -> Dict[str, int]:
        """The `ceph mds dump`-style view: subtree → owning rank."""
        return dict(self.mdsmap.subtrees)


class MDBalancer:
    """Move the hottest subtree off the busiest rank (MDBalancer.cc's
    load-driven export, reduced to the request-count heuristic)."""

    def __init__(self, cluster: MDSCluster, min_requests: int = 16):
        self.cluster = cluster
        self.min_requests = min_requests

    def rank_loads(self) -> Dict[int, int]:
        loads = {r: 0 for r in range(len(self.cluster.ranks))}
        for subtree, n in self.cluster.load.items():
            loads[self.cluster.mdsmap.auth_rank(subtree)] += n
        return loads

    def rebalance(self) -> List[Tuple[str, int]]:
        """One balancing pass; returns [(subtree, new_rank)] moved."""
        loads = self.rank_loads()
        if len(loads) < 2:
            return []
        busiest = max(loads, key=lambda r: loads[r])
        coolest = min(loads, key=lambda r: loads[r])
        if loads[busiest] - loads[coolest] < 2 * self.min_requests:
            return []
        # hottest top-level subtree currently owned by the busiest rank
        candidates = sorted(
            ((n, p) for p, n in self.cluster.load.items()
             if p != "/" and
             self.cluster.mdsmap.auth_rank(p) == busiest),
            reverse=True)
        moved = []
        for n, p in candidates:
            if n < self.min_requests:
                break
            # move only if it strictly improves the imbalance (a
            # subtree is the migration granularity — a dominant one
            # still moves, it just must not make things worse)
            before = loads[busiest] - loads[coolest]
            after = abs((loads[coolest] + n) - (loads[busiest] - n))
            if after >= before:
                continue
            self.cluster.migrate(p, coolest)
            moved.append((p, coolest))
            loads[busiest] -= n
            loads[coolest] += n
        return moved
