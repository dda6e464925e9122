"""RemoteIoCtx — the librados IoCtx surface over the wire client.

The convergence piece the feature tiers needed: RGW, CephFS/MDS, the
Journaler, RadosStriper and librbd all program against the IoCtx
contract (client/rados.py), which previously only the in-process
simulator provided.  This adapter serves the same contract from a
REAL daemon cluster through RemoteCluster's authenticated wire ops —
so the S3 gateway, the filesystem and block images run against OSD
processes with no code changes in those layers (the reference's
gateways link the same librados the external clients use).

Mapping:
  read/write_full/remove/stat/list_objects  → get/put/delete/list
  write(offset)                             → client-side read-modify-
                                              write (full-object ops
                                              are the wire contract,
                                              like the EC client path)
  snap_create/lookup + read(snap=)          → the mon-committed pool
                                              snapshots + COW reads
  watch/notify                              → OVER THE WIRE: the
                                              object's primary daemon
                                              keeps the watcher
                                              registry, watchers poll
                                              + ack on a background
                                              thread — notifies reach
                                              watchers in OTHER
                                              processes too
  exec (object classes)                     → runs inside the primary
                                              daemon via exec_cls
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .rados import ObjectNotFound, ObjectStat
from .remote import RemoteCluster, RemoteObjectMissing


class RemoteIoCtx:
    """IoCtx over one pool of a process cluster.

    Concurrency caveat: `write(offset=...)` (and RadosStriper.write on
    top of it) is a CLIENT-side read-modify-write — full get, splice,
    full put — unlike the sim-tier IoCtx, where the OSD applies the
    offset write server-side.  Two concurrent writers to the same
    object from different processes can lose updates; callers that
    share objects across gateways must serialize per object (the
    module docstring's watch/notify gap makes the same process-local
    assumption).
    """

    def __init__(self, rc: RemoteCluster, pool_name: str):
        self._rc = rc
        pid = next((p.id for p in rc.osdmap.pools.values()
                    if p.name == pool_name or str(p.id) == pool_name),
                   None)
        if pid is None:
            raise KeyError(f"no pool {pool_name!r}")
        self.pool_id = pid
        self._watch_lock = threading.Lock()
        self._watches: Dict[Tuple[str, int], Tuple] = {}
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._poll_clients: Dict[int, object] = {}
        # watches marked for proactive re-registration: a messenger
        # session RESET (daemon restarted / evicted our session) means
        # session-scoped daemon state is gone — re-register instead of
        # waiting for a poll to come back "gone" after a notify was
        # already missed.  Registered on the shared rc's callback
        # LIST (several ioctxs share one cluster handle) and removed
        # again in close().
        self._rewatch: set = set()

        def _on_reset(osd: int) -> None:
            with self._watch_lock:
                for (oid, cookie), (prim, pg, _cb) in \
                        self._watches.items():
                    if prim == osd:
                        self._rewatch.add((oid, cookie))

        self._on_reset_cb = _on_reset
        rc.add_session_reset_cb(_on_reset)

    # ------------------------------------------------------------- data --
    def write_full(self, oid: str, data: bytes) -> None:
        # no snapshot: put() gathers every sub-write commit before
        # returning, so the caller's buffer is done being read when
        # control comes back (the zero-copy spine carries it as a
        # view all the way to the frames)
        self._rc.put(self.pool_id, oid, data)

    def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        try:
            cur = bytearray(self._rc.get(self.pool_id, oid))
        except RemoteObjectMissing:
            cur = bytearray()
        # any OTHER IOError propagates: treating a transient read
        # failure as "absent" would splice into zeros and ack a write
        # that silently destroyed the rest of the object
        if len(cur) < offset + len(data):
            cur.extend(b"\0" * (offset + len(data) - len(cur)))
        cur[offset:offset + len(data)] = data
        self._rc.put(self.pool_id, oid, bytes(cur))

    def read(self, oid: str, length: Optional[int] = None,
             offset: int = 0, snap: Optional[int] = None) -> bytes:
        try:
            if snap is not None:
                data = self._rc.get_snap(self.pool_id, oid, snap)
            else:
                data = self._rc.get(self.pool_id, oid)
        except RemoteObjectMissing:
            raise ObjectNotFound(oid) from None
        except KeyError:
            raise ObjectNotFound(f"{oid}@{snap}") from None
        if length is None:
            return data[offset:]
        return data[offset:offset + length]

    # -------------------------------------------------------------- aio --
    # Real async submission (librados aio_*): ops ride the cluster
    # handle's async-objecter completion engine under a per-object
    # key, so overlapping ops on one object execute in submission
    # order while distinct objects run concurrently — same engine,
    # same key-space as RemoteCluster.aio_put, so mixing the two
    # surfaces on one object still serializes correctly.
    def _aio_key(self, oid: str):
        return ("obj", self.pool_id, oid)

    def _bind_tenant(self, fn):
        """Capture the SUBMITTING thread's tenant identity into the
        closure: aio ops execute on engine worker threads, where the
        request thread's thread-local tenant binding (set by the S3
        frontend after SigV4 verification) would otherwise be lost."""
        tenant = self._rc.tenant
        if tenant is None:
            return fn

        def run():
            self._rc.set_tenant(tenant, thread_only=True)
            try:
                return fn()
            finally:
                self._rc.set_tenant(None, thread_only=True)
        return run

    def aio_write_full(self, oid: str, data: bytes):
        buf = bytes(data)  # noqa: CTL130 — deliberate snapshot: the
        # op outlives this call and the caller may reuse its buffer
        # (librados aio semantics made safe instead of documented-UB)
        return self._rc.aio.engine.submit(
            self._bind_tenant(lambda: self.write_full(oid, buf)),
            key=self._aio_key(oid))

    def aio_read(self, oid: str, length: Optional[int] = None,
                 offset: int = 0, snap: Optional[int] = None):
        return self._rc.aio.engine.submit(
            self._bind_tenant(
                lambda: self.read(oid, length, offset, snap)),
            key=self._aio_key(oid))

    def aio_remove(self, oid: str):
        return self._rc.aio.engine.submit(
            self._bind_tenant(lambda: self.remove(oid)),
            key=self._aio_key(oid))

    def _shard0_probe(self, oid: str, cmd: str):
        """No-payload probe against the acting set (authoritative
        after peering); non-members are swept only when the acting set
        is degraded or unreachable — a routine ENOENT must not cost
        O(cluster) wire calls."""
        rc = self._rc
        pool = rc.osdmap.pools[self.pool_id]
        pg = rc._pg_for(pool, oid)
        ups = rc._up(pool, pg)
        members = [x for x in ups if x >= 0]
        req = {"cmd": cmd, "coll": [self.pool_id, pg],
               "oid": f"0:{oid}"}
        errors = 0
        answers = 0
        for o in members:
            try:
                r = rc.osd_call(o, req)
            except (OSError, IOError):
                errors += 1
                continue
            answers += 1
            if r is not None:
                return r
        if errors or len(members) < len(ups):
            for o in [x for x in rc.addrs if x not in members]:
                try:
                    r = rc.osd_call(o, req)
                except (OSError, IOError):
                    continue
                answers += 1
                if r is not None:
                    return r
        if answers == 0:
            # nobody ANSWERED: connectivity trouble, not absence —
            # reporting ObjectNotFound here would make layered tiers
            # (bucket index, inodes) treat live data as deleted
            raise IOError(f"{oid}: no OSD reachable for probe")
        return None

    def _exists(self, oid: str) -> bool:
        return self._shard0_probe(oid, "digest_shard") is not None

    def remove(self, oid: str) -> None:
        # the logical namespace is what callers reason about; probe it
        # first so removing a missing object raises like librados
        if not self._exists(oid):
            raise ObjectNotFound(oid)
        self._rc.delete(self.pool_id, oid)

    def stat(self, oid: str) -> ObjectStat:
        pool = self._rc.osdmap.pools[self.pool_id]
        from ..cluster.osdmap import POOL_ERASURE
        if pool.type != POOL_ERASURE:
            # replicated: shard 0 IS the object — size without payload
            st = self._shard0_probe(oid, "stat_shard")
            if st is not None:
                return ObjectStat(size=int(st["size"]), n_stripes=1)
            raise ObjectNotFound(oid)
        # EC: logical size travels as shard metadata (object_info_t) —
        # one no-payload attr probe, never a full decode
        rc = self._rc
        pg = rc._pg_for(pool, oid)
        ups = rc._up(pool, pg)
        answers = 0
        members = [x for x in ups if x >= 0]
        for shard, o in enumerate(ups):
            if o < 0:
                continue
            try:
                sz = rc.osd_call(o, {"cmd": "getattr_shard",
                                     "coll": [self.pool_id, pg],
                                     "oid": f"{shard}:{oid}",
                                     "key": "size"})
            except (OSError, IOError):
                continue
            answers += 1
            if sz is not None:
                # n_stripes matches the write path (full-object = 1),
                # NOT the live shard count — stat must not vary with
                # cluster health
                return ObjectStat(size=int(sz), n_stripes=1)
        if answers == 0:
            raise IOError(f"{oid}: no OSD reachable for stat")
        raise ObjectNotFound(oid)

    def list_objects(self) -> List[str]:
        return self._rc.list_objects(self.pool_id)

    # -------------------------------------------------------- snapshots --
    def snap_create(self, snap_name: str) -> int:
        return self._rc.snap_create(self.pool_id, snap_name)

    def snap_lookup(self, snap_name: str) -> int:
        return self._rc.snap_lookup(self.pool_id, snap_name)

    def snap_rollback_id(self, oid: str, snap_id: int) -> None:
        """Rollback by snap id: restore the object's bytes AT the
        snapshot (client-driven: COW snap read + full-object write);
        KeyError when the object has no state at that snap — matching
        the sim IoCtx contract rbd's roll-back-to-absent path catches."""
        try:
            data = self._rc.get_snap(self.pool_id, oid, snap_id)
        except RemoteObjectMissing:
            raise KeyError(f"{oid}: no state at snap {snap_id}") \
                from None
        self._rc.put(self.pool_id, oid, data)

    # ----------------------------------------------------- watch/notify --
    # Watch/notify rides the WIRE (not a process-local registry):
    # the object's primary DAEMON keeps the
    # watcher registry; this client polls its pending-notification
    # queue on a background thread, invokes callbacks, and acks.
    # Watchers in OTHER processes (a second gateway) see the same
    # notifies — the src/osd/Watch.cc shape on a poll transport.

    def watch(self, oid: str, callback) -> int:
        prim, pg, cookie = self._rc.watch_register(self.pool_id, oid)
        with self._watch_lock:
            self._watches[(oid, cookie)] = (prim, pg, callback)
            stopping = self._watch_stop.is_set()
            t = self._watch_thread
        if stopping and t is not None:
            # an unwatch-of-last just told the old poller to exit; it
            # may not have noticed yet.  Join it OUTSIDE the lock (it
            # takes the lock each loop) before re-arming, or the new
            # watch could be left with a stop-flagged poller that
            # exits immediately — silently unpolled
            t.join(timeout=10)
        with self._watch_lock:
            if self._watch_thread is None or \
                    not self._watch_thread.is_alive():
                self._watch_stop.clear()
                self._watch_thread = threading.Thread(
                    target=self._watch_poller, daemon=True,
                    name="ioctx-watch-poll")
                self._watch_thread.start()
        return cookie

    def unwatch(self, oid: str, watch_id: int) -> None:
        with self._watch_lock:
            ent = self._watches.pop((oid, watch_id), None)
            if not self._watches:
                # last watch gone: the poller exits instead of
                # spinning (and RE-arms on the next watch())
                self._watch_stop.set()
        if ent is not None:
            prim, pg, _ = ent
            try:
                self._rc.osd_call(prim, {
                    "cmd": "watch_unregister",
                    "coll": [self.pool_id, pg], "oid": f"0:{oid}",
                    "cookie": watch_id})
            except (OSError, IOError):
                pass          # daemon gone: the watch died with it

    def close(self) -> None:
        """Stop the watch poller and release its connections (the
        ioctx destructor role).  The wire unregisters run OUTSIDE
        _watch_lock: osd_call can reconnect and run the session-reset
        hooks, and this ioctx's own hook takes _watch_lock — holding
        it across the call would self-deadlock."""
        with self._watch_lock:
            watches = dict(self._watches)
            self._watches.clear()
            self._watch_stop.set()
        self._rc.remove_session_reset_cb(self._on_reset_cb)
        for (oid, cookie), (prim, pg, _) in watches.items():
            try:
                self._rc.osd_call(prim, {
                    "cmd": "watch_unregister",
                    "coll": [self.pool_id, pg],
                    "oid": f"0:{oid}", "cookie": cookie})
            except (OSError, IOError):
                pass

    def _poll_call(self, prim: int, req: dict):
        """Poller-owned wire call on a DEDICATED connection: the main
        thread's notify_wait holds the shared per-OSD connection lock
        for its whole wait, so acks must travel on their own socket."""
        c = self._poll_clients.get(prim)
        if c is None:
            c = self._poll_clients[prim] = \
                self._rc.new_osd_client(prim)
        try:
            return c.call(req)
        except (OSError, IOError):
            self._poll_clients.pop(prim, None)
            try:
                c.close()
            except OSError:
                pass
            raise

    def _reregister(self, oid: str, cookie: int, cb) -> None:
        """Re-establish one watch under a fresh cookie, refreshing the
        map first if placement moved (after a restart/heal the object
        may have a NEW primary — re-registering on the cached one
        would silently watch nothing)."""
        for attempt in range(2):
            try:
                np_, npg = self._rc._watch_primary(self.pool_id, oid)
                nc = int(self._poll_call(np_, {
                    "cmd": "watch_register",
                    "coll": [self.pool_id, npg],
                    "oid": f"0:{oid}"})["cookie"])
            except (OSError, IOError):
                if attempt:
                    return            # next poll tick retries
                try:
                    self._rc.refresh_map()
                except (OSError, IOError):  # noqa: CTL603 — the
                    # poller tick IS the retry loop: giving up here
                    # re-enters on the next poll interval
                    return
                continue
            with self._watch_lock:
                if (oid, cookie) in self._watches:
                    del self._watches[(oid, cookie)]
                    self._watches[(oid, nc)] = (np_, npg, cb)
                    return
            # the watch was unwatched/closed while we re-registered:
            # release the fresh cookie, or the daemon holds a watcher
            # nobody polls and every notify blocks to its timeout
            try:
                self._poll_call(np_, {
                    "cmd": "watch_unregister",
                    "coll": [self.pool_id, npg],
                    "oid": f"0:{oid}", "cookie": nc})
            except (OSError, IOError):
                pass
            return

    def _watch_poller(self, interval: float = 0.05) -> None:
        while not self._watch_stop.is_set():
            with self._watch_lock:
                watches = dict(self._watches)
            if not watches:
                time.sleep(interval)
                continue
            for (oid, cookie), (prim, pg, cb) in watches.items():
                if (oid, cookie) in self._rewatch:
                    # session reset detected on reconnect: daemon-side
                    # watch state is session-scoped and gone — do not
                    # wait for a missed notify to find out
                    self._rewatch.discard((oid, cookie))
                    self._reregister(oid, cookie, cb)
                    continue
                try:
                    r = self._poll_call(prim, {
                        "cmd": "watch_poll",
                        "coll": [self.pool_id, pg],
                        "oid": f"0:{oid}", "cookie": cookie})
                except (OSError, IOError):
                    continue          # primary down: retry next tick
                if r.get("gone"):
                    # daemon restarted and lost the registry:
                    # re-register under a fresh cookie (on the
                    # poller's own connection)
                    self._reregister(oid, cookie, cb)
                    continue
                for nid, payload in r.get("events", []):
                    try:
                        ack = cb(nid, bytes(payload))
                    except Exception:
                        continue      # no ack: notifier times out
                    try:
                        self._poll_call(prim, {
                            "cmd": "notify_ack", "notify_id": nid,
                            "cookie": cookie, "ack": ack})
                    except (OSError, IOError):
                        pass
            time.sleep(interval)
        for c in self._poll_clients.values():
            try:
                c.close()
            except OSError:
                pass
        self._poll_clients.clear()

    def notify(self, oid: str, payload: bytes = b"",
               timeout: float = 3.0) -> dict:
        r = self._rc.notify(self.pool_id, oid, payload,
                            timeout=timeout)
        return {"notify_id": r["notify_id"], "acks": r["acks"]}

    # --------------------------------------------------------- cls exec --
    def exec(self, oid: str, cls: str, method: str,
             inp: bytes = b"") -> bytes:
        """librados exec: run an object-class method inside the
        object's primary OSD daemon."""
        return self._rc.exec_cls(self.pool_id, oid, cls, method, inp)


def open_remote_ioctx(cluster_dir: str, pool_name: str,
                      rc: Optional[RemoteCluster] = None
                      ) -> RemoteIoCtx:
    """Convenience: connect (or reuse) a RemoteCluster and open one
    pool's IoCtx — the Rados.open_ioctx shape for the process tier."""
    return RemoteIoCtx(rc or RemoteCluster(cluster_dir), pool_name)
