"""RemoteCluster — client for the process cluster (librados-over-wire).

Connects to the mon with the client keyring (cephx secret mode), pulls
the cluster map (crush text recompiled through the CrushCompiler — the
same map the daemons trust), computes placement locally with the real
CRUSH pipeline, obtains per-OSD tickets, and performs object I/O
against the OSD daemons:

  * replicated pools: PUT goes to the PRIMARY, which persists locally
    and fans out to its replicas daemon-to-daemon (the
    ReplicatedBackend shape); GET walks the up set.
  * EC pools: the client is the card-attached primary — stripes are
    encoded on device, shards written per OSD; reads gather
    minimum_to_decode shards and decode on device
    (the ECBackend primary role).

Map refreshes on epoch bump; op failures trigger a refresh + retry
(the Objecter resend-on-map-change contract).

Port of ``ceph_tpu/client/remote.py``.  The client's codecs, its
staging cache and every shard it uploads live on the package default
device (``cuda`` unless the CPU is asked for): encode and
decode run kernel K1 there, and a flush's checksums run kernel K3's crc
leg (``ops/crc32_gf2``) while the package default is the card.  Shards
framed for the daemons are host bytes: a staged device shard is read
back once, explicitly, before framing (``device_store.to_host``, its
bytes counted at perf("hbm") ``readback_bytes``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..common import auth as cx
from ..common import tracer as _trace
from ..common.backoff import ExpBackoff
from ..common.op_tracker import tracker as _op_tracker
from ..cluster.daemon import WireClient
from ..cluster.device_store import to_host
from ..cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
from ..ec import instance as ec_registry
from ..ec.interface import ErasureCodeError
from ..ops import hashing
from ..placement.compiler import compile_crushmap
from ..placement.crush_map import ITEM_NONE


class RemoteObjectMissing(IOError):
    """Every reachable target answered and none holds the object — a
    definitive ENOENT, distinct from connectivity trouble so existence
    probes skip the retry sweep (rados ENOENT vs EIO distinction)."""


def _as_buf(arr) -> memoryview:
    """A numpy array's bytes as a flat uint8 memoryview — the
    zero-copy handoff to the scatter-gather wire path (tobytes()
    duplicated every shard before it ever reached the socket)."""
    from ..common import crcutil
    return crcutil.as_u8(np.ascontiguousarray(arr))


def _staged_csums(arrs, refs=None):
    """Per-shard Csums for a batch of host shards (a flush, a durable
    fan-out, recovery pushes, a fetched shard's staging digest),
    computed ONCE per byte:
    on device by kernel K3's crc leg (ops/crc32_gf2.csums_many, one
    dispatch for the batch) when ``wire_device_crc`` is ``on``, or
    ``auto`` while the package default device is the card (asked on
    every call: no cached probe, and a device failure raises) — else
    a single host scan each.  ``refs``: the shards' copies on the card
    where the client holds them (a tensor or a ShardRef; None for one
    it does not), crc'd there instead of uploading the host bytes
    again."""
    from ..common import crcutil
    from ..common.options import config
    from ..ops import crc32_gf2
    mode = str(config().get("wire_device_crc"))
    if mode == "on" or (mode == "auto" and crc32_gf2.device_worthwhile()):
        return crc32_gf2.csums_many(
            [_as_buf(a) for a in arrs],
            tensors=None if refs is None else
            [r if r is None or isinstance(r, torch.Tensor)
             else r.materialize() for r in refs])
    return [crcutil.Csums.scan(_as_buf(a), site="client")
            for a in arrs]


class RemoteCluster:
    def __init__(self, cluster_dir: str, entity: str = "client.admin",
                 ec_profiles: Optional[Dict[str, Dict[str, str]]] = None):
        self.dir = cluster_dir
        self.entity = entity
        # the device of this client's codecs and staged shards: the
        # package default (raises without a card unless the CPU is
        # asked for)
        self.device = resolve_device()
        ring = cx.Keyring.load(os.path.join(cluster_dir,
                                            "keyring.client"))
        self.secret = ring.secret(entity)
        self.mon: Optional[WireClient] = None
        # mon failover ROTATES: a reconnect after a failure must not
        # land on the same (possibly minority-partitioned, lease-
        # stalled) mon forever — start each connect sweep at the rank
        # after the one that just failed
        self._mon_rot = 0
        self._connect_mon()
        # per-OSD messenger sessions: a session id survives RECONNECTS
        # (that is its whole point), and each mutating op draws one seq
        # from it — resends reuse the (sid, seq), the daemon dedups
        self._sessions: Dict[int, Dict] = {}
        self.session_resets = 0          # stale-session resets seen
        # hooks: each called with the osd id when a session RESET is
        # detected on reconnect (daemon lost our state — session-
        # scoped registrations like watches must be re-established).
        # A LIST with explicit unregistration: many ioctxs share one
        # cluster handle, and a closed ioctx must not stay reachable
        # through a permanently-chained closure
        self._session_reset_cbs: List = []
        # socket timeout of the SHARED per-OSD clients: anything that
        # blocks a daemon handler longer (notify_wait) must ride a
        # dedicated connection with a DERIVED timeout, or the timed-out
        # read kills the shared connection under every other caller
        self._osd_timeout = 10.0
        self._osd_clients: Dict[int, WireClient] = {}
        self._aio = None            # lazy AsyncObjecter (wire core)
        self.ec_profiles = ec_profiles or {}
        self._codecs: Dict[int, object] = {}
        self._backends: Dict[int, object] = {}
        self._dev = None            # lazy DeviceShardCache
        self._staged_attrs: Dict = {}
        self._tier_reads: Dict = {}   # client-local warmth counters
        self._admin = None          # opt-in objecter.asok (serve_admin)
        self._admin_path: Optional[str] = None
        import threading
        self._client_lock = threading.Lock()
        # tenant identity for per-tenant QoS (S3 auth -> objecter ->
        # op dispatch): a handle-wide default (one gateway client per
        # tenant, the serving harness shape) plus a thread-local
        # override (one frontend serving many tenants on request
        # threads).  Stamped onto client-class data-path requests by
        # the async objecter; daemons dispatch them under the
        # tenant's own dmClock class.
        self._tenant_default: Optional[str] = None
        self._tenant_tls = threading.local()
        # every retry sweep in this client paces itself here:
        # exponential with deterministic per-entity jitter, so N
        # clients hammering a recovering daemon decorrelate instead
        # of stampeding in lockstep (and seeded runs reproduce)
        import zlib as _zlib
        self._backoff = ExpBackoff(
            base=0.05, cap=1.0, seed=_zlib.crc32(entity.encode()))
        self.refresh_map()

    def serve_admin(self, name: str = "objecter") -> str:
        """Opt-in client admin socket (`<dir>/<name>.asok`): a
        long-running client process (the card's host) exposes its own
        tracked-op and perf-dump surfaces so `ceph daemon objecter
        dump_historic_ops | perf dump` works, matching the reference's
        client asok workflow.  Idempotent for the same name; a second
        call with a different name raises rather than returning a path
        that was never served."""
        from ..common.admin import AdminServer
        path = os.path.join(self.dir, f"{name}.asok")
        if self._admin is not None:
            if path != self._admin_path:
                raise RuntimeError(
                    f"already serving {self._admin_path}")
            return self._admin_path
        srv = AdminServer()
        srv.serve(path)          # a failed bind leaves us retryable
        self._admin = srv
        self._admin_path = path
        return path

    def _tracked(self, optype: str, pool_id: int, name: str, fn):
        """Wrap one top-level client op with an OpTracker record.
        Nested calls (tier routing recursion) ride the parent's
        record instead of opening their own."""
        tr = _op_tracker()
        if tr.current() is not None:
            return fn()
        top = tr.create(optype, service="objecter", pool=pool_id,
                        obj=name)
        error = None
        try:
            # client ROOT span: every wire_submit below nests under
            # it, and the op-id -> trace-id mapping on the tracked op
            # is what `ceph trace <op>` resolves through (slow ops
            # auto-pin this trace via op_tracker.finish).  The
            # tracker's active-op registration stays — sub-op sites
            # (call_async's dispatched_wire mark, nested tier
            # routing) find the op through tr.current()
            with _trace.start_span(f"client.{optype}", pool=pool_id,
                                   obj=name) as span:
                if span.trace_id and top.tracked:
                    top.tags["trace_id"] = span.trace_id
                with tr.track(top):
                    return fn()
        except BaseException as e:
            error = type(e).__name__
            raise
        finally:
            tr.finish(top, error=error)

    # ---------------------------------------------------------------- mon --
    def _mon_socks(self) -> List[str]:
        from ..cluster.daemon import mon_sockets
        return mon_sockets(self.dir)

    def _connect_mon(self) -> None:
        """Any quorum member serves reads and forwards mutations to
        the leader; fail over across the configured mons, starting at
        the rotation point (the mon AFTER the last failure) so a
        stalled minority mon cannot capture every reconnect."""
        last: Optional[Exception] = None
        socks = self._mon_socks()
        for i in range(len(socks)):
            sock = socks[(self._mon_rot + i) % len(socks)]
            mon_ent = os.path.basename(sock)[:-len(".sock")]
            try:
                self.mon = WireClient(sock, self.entity,
                                      secret=self.secret,
                                      peer=mon_ent)
                self._mon_rot = (self._mon_rot + i) % len(socks)
                return
            except (OSError, IOError, cx.AuthError) as e:
                last = e
        raise IOError(f"no mon reachable: {last}")

    def mon_call(self, req: Dict) -> Dict:
        """Bounded mon sweep: a failing/stalled mon (connection error
        OR a retryable IOError reply such as a minority-side lease
        stall) rotates the client to the next quorum member — the
        'bounded stall or redirect, never a stale map' contract."""
        last: Optional[Exception] = None
        for attempt in range(3):
            # snapshot the shared client: a CONCURRENT mon_call that
            # hit its own failure may null/replace self.mon between
            # our check and use (seen as AttributeError under the
            # socket-failure soak)
            mon = self.mon
            if mon is None:
                try:
                    self._connect_mon()
                except (OSError, IOError) as e:
                    last = e
                    self._backoff.sleep(attempt)
                    continue
                mon = self.mon
                if mon is None:
                    continue
            try:
                return mon.call(req)
            except (OSError, IOError) as e:
                last = e
                try:
                    mon.close()
                except OSError:
                    pass
                if self.mon is mon:
                    self.mon = None
                self._mon_rot += 1       # next reconnect: next mon
                if attempt < 2:
                    self._backoff.sleep(attempt)
        raise IOError(f"mon unreachable ({last})")

    def report_plane_perf(self) -> None:
        """Ship this client's process perf dump (the data-plane chip
        counters live HERE — the plane runs client-side) to the mon's
        ClusterStats, tagged with the multihost host label, so
        `ceph -s` / `cluster_stats["mesh"]` show the plane against
        live daemons.  Under the multi-process plane each rank's
        client reports under its own host label and the mgr's
        mesh_rollup sums the (host, chip) cells; single-process it is
        one reporter owning every cell.  Attribution stays the
        AUTHENTICATED wire entity — the label only tags the row."""
        import time as _time
        from ..common.perf_counters import perf as _perf
        from ..parallel.multihost import host_label
        self.mon_call({"cmd": "report_perf",
                       "report": {"perf": _perf().dump_typed(),
                                  "ts": _time.time(),
                                  "host": host_label()}})

    # ---------------------------------------------------------------- map --
    def refresh_map(self) -> None:
        blob = self.mon_call({"cmd": "get_map"})
        cmap = compile_crushmap(blob["crush_text"])
        m = OSDMap(cmap, epoch=blob["epoch"], device=self.device)
        m.mark_all_in_up()
        for i, up in enumerate(blob["osd_up"]):
            m.osd_up[i] = up
        for i, w in enumerate(blob["osd_weight"]):
            m.osd_weight[i] = w
        for p in blob["pools"]:
            m.add_pool(PGPool(**p))
        m.flags = set(blob.get("flags", []))
        self.osdmap = m
        self._up_cache: Dict = {}
        self.addrs = {int(k): v for k, v in blob["addrs"].items()}
        self.pool_snaps = {int(k): v for k, v in
                           blob.get("pool_snaps", {}).items()}

    def _session(self, osd: int) -> Dict:
        """This client's messenger session with one OSD — created
        once, kept across reconnects (caller holds _client_lock or is
        single-threaded through osd_call's seq draw)."""
        st = self._sessions.get(osd)
        if st is None:
            import secrets as _secrets
            st = self._sessions[osd] = {"sid": _secrets.token_hex(8),
                                        "seq": 0}
        return st

    def osd_client(self, osd: int) -> WireClient:
        c = self._osd_clients.get(osd)
        if c is not None:
            return c
        # serialized: concurrent fan-out threads must not race two
        # connects (and the mon ticket round) for the same OSD
        with self._client_lock:
            c = self._osd_clients.get(osd)
            if c is not None:
                return c
            grant = self.mon_call({"cmd": "get_ticket",
                                   "service": f"osd.{osd}"})
            key = cx.open_key_box(self.secret, grant["key_box"])
            c = WireClient(self.addrs[osd], self.entity,
                           ticket=grant["ticket"], session_key=key,
                           timeout=self._osd_timeout,
                           peer=f"osd.{osd}")
            self._osd_clients[osd] = c
        self._hello(osd, c)
        return c

    def _hello(self, osd: int, c: WireClient) -> None:
        """Session resume on a fresh connection, OUTSIDE the client
        lock (it is a wire call): announce (sid, highest seq used);
        the daemon answers whether it still holds our session — a
        resume against an unknown sid is a detected STALE SESSION
        (daemon restarted/evicted): both sides reset, and session-
        scoped state (watches) must be re-established by the owner."""
        with self._client_lock:
            st = self._session(osd)
        try:
            hello = c.call({"cmd": "session_hello",
                            "session": st["sid"], "seq": st["seq"]})
            if not hello.get("known") and st["seq"] > 0:
                self.session_resets += 1
                for cb in list(self._session_reset_cbs):
                    try:
                        cb(osd)
                    except Exception:
                        pass
        except (OSError, IOError):
            pass          # hello is advisory; ops re-hello via retry

    def _stream_conn(self, osd: int) -> WireClient:
        """Authenticated connection factory for the async objecter's
        stream pool: a dedicated connection per stream, with the same
        session-hello reset detection the shared clients perform (a
        stream rebuilt against a restarted daemon must still trigger
        watch re-establishment)."""
        c = self.new_osd_client(osd)
        self._hello(osd, c)
        return c

    @property
    def aio(self):
        """The asynchronous objecter core (cluster/async_objecter.py):
        per-OSD stream pools + completion engine.  Built lazily — a
        client that never touches OSD data paths starts no threads."""
        if self._aio is None:
            with self._client_lock:
                if self._aio is None:
                    from ..cluster.async_objecter import AsyncObjecter
                    self._aio = AsyncObjecter(self)
        return self._aio

    def _next_stamp(self, osd: int) -> Dict:
        """Draw one (session, seq) replay stamp for a logical
        mutating op against ``osd`` — the single place the stamping
        contract (lock discipline, sid scope) lives."""
        with self._client_lock:
            st = self._session(osd)
            st["seq"] += 1
            return {"session": st["sid"], "seq": st["seq"]}

    # ------------------------------------------------------------ tenant --
    def set_tenant(self, tenant: Optional[str],
                   thread_only: bool = False) -> None:
        """Bind a tenant identity (an S3-auth-verified uid) to this
        handle's data-path ops.  ``thread_only`` scopes the binding
        to the calling thread — the S3 frontend sets it per request
        after SigV4 verification, so one shared cluster handle serves
        many tenants without cross-talk."""
        if thread_only:
            self._tenant_tls.tenant = tenant
        else:
            self._tenant_default = tenant

    @property
    def tenant(self) -> Optional[str]:
        t = getattr(self._tenant_tls, "tenant", None)
        return t if t is not None else self._tenant_default

    def add_session_reset_cb(self, cb) -> None:
        self._session_reset_cbs.append(cb)

    def remove_session_reset_cb(self, cb) -> None:
        try:
            self._session_reset_cbs.remove(cb)
        except ValueError:
            pass

    def new_osd_client(self, osd: int,
                       timeout: Optional[float] = None) -> WireClient:
        """A DEDICATED (unshared) authenticated connection to one OSD.
        Long-blocking calls (notify_wait) hold a connection's lock for
        their whole wait, so background pollers must not ride the
        shared per-OSD clients — the ack they need to deliver would
        serialize behind the very wait it unblocks.  ``timeout`` lets
        a caller that KNOWS its server-side wait derive a socket
        timeout that outlives it."""
        grant = self.mon_call({"cmd": "get_ticket",
                               "service": f"osd.{osd}"})
        key = cx.open_key_box(self.secret, grant["key_box"])
        return WireClient(self.addrs[osd], self.entity,
                          ticket=grant["ticket"], session_key=key,
                          timeout=timeout if timeout is not None
                          else self._osd_timeout,
                          peer=f"osd.{osd}")

    def _evict_staging(self, pool_id: int, pg: int, name: str) -> None:
        """Invalidate this client's staged shards + attrs for one
        object (called on every overwrite/delete: a dirty staged
        entry is served unconditionally and flushed later, so leaving
        one behind would resurrect dead data)."""
        if self._dev is not None:
            self._dev.evict_object(pool_id, pg, name)
        for k in [k for k in self._staged_attrs
                  if k[0] == pool_id and k[1] == pg and k[2] == name]:
            self._staged_attrs.pop(k, None)

    def drop_osd_client(self, osd: int) -> None:
        c = self._osd_clients.pop(osd, None)
        if c:
            c.close()

    # mutations that ride the (session, seq) replay contract: the
    # daemon applies each at most once, so the reconnect-retry below
    # (and any caller resending the SAME dict) is a safe replay.
    # Mirrors OSDDaemon._REPLAY_CMDS — the bulk frames joined in
    # CTLint v2
    _REPLAY_CMDS = frozenset((
        "put_shard", "put_object", "delete_shard", "delete_object",
        "setattr_shard", "copy_from", "exec_cls",
        "put_objects", "delete_objects", "delete_shards"))

    def osd_call(self, osd: int, req: Dict):
        """One OSD request — a THIN BLOCKING SHIM over the async
        objecter core (cluster/async_objecter.py), which owns the
        whole contract this call used to implement inline: a single
        same-target retry on a FRESH stream when the connection died
        under the op, and (session, seq) stamping drawn ONCE per
        mutating request so the retry is a REPLAY the daemon applies
        at most once (returning the recorded completion).  Sync and
        async submissions share that one code path; the results are
        byte-identical."""
        return self.aio.call(osd, req)

    # --------------------------------------------------- async client --
    def aio_osd_call(self, osd: int, req: Dict):
        """Async form of osd_call: returns the AioCompletion."""
        return self.aio.call_async(osd, req)

    def aio_put(self, pool_id: int, name: str, data: bytes,
                csums=None):
        """Asynchronous put (librados aio_write_full): the op runs
        its submit -> encode -> fan-out -> gather-commits machine on
        the completion engine; same-object ops execute in submission
        order (the librados write-ordering contract).  ``csums`` as
        in :meth:`put` — precomputed trusted csums keep the client's
        send path scan-free."""
        return self.aio.engine.submit(
            lambda: self.put(pool_id, name, data, csums=csums),
            key=("obj", pool_id, name))

    def aio_get(self, pool_id: int, name: str):
        return self.aio.engine.submit(
            lambda: self.get(pool_id, name),
            key=("obj", pool_id, name))

    def aio_delete(self, pool_id: int, name: str):
        return self.aio.engine.submit(
            lambda: self.delete(pool_id, name),
            key=("obj", pool_id, name))

    # ---------------------------------------------------------- placement --
    def _pg_for(self, pool: PGPool, name: str) -> int:
        """object -> pg (the ceph_stable_mod hash pipeline, same as the
        in-process simulator so placements agree)."""
        ps = hashing.str_hash_rjenkins(name.encode())
        return pool.raw_pg_to_pg(ps)

    def _up(self, pool: PGPool, pg: int) -> List[int]:
        """Memoized per (pool, pg) against the current map epoch —
        the Objecter's cached-target role: batched surfaces hit the
        same PGs every round and must not recompute the scalar CRUSH
        descent each time (refresh_map drops the cache)."""
        key = (pool.id, pg)
        hit = self._up_cache.get(key)
        if hit is not None:
            return hit
        up, _, acting, _ = self.osdmap.pg_to_up_acting_osds(pool.id, pg)
        r = acting or up
        self._up_cache[key] = r
        return r

    def codec_for(self, pool: PGPool):
        codec = self._codecs.get(pool.id)
        if codec is None:
            prof = dict(self.ec_profiles.get(
                pool.erasure_code_profile,
                {"plugin": "jax", "k": "4", "m": "2"}))
            plugin = prof.get("plugin", "jax")
            if plugin == "jax" and "layout" not in prof:
                # cluster default (erasure_code_default_layout):
                # bitsliced — shard bytes at rest ARE the plane words
                # the masked-XOR kernel consumes, on daemons too
                from ..common.options import config
                prof["layout"] = config().get(
                    "erasure_code_default_layout")
            codec = ec_registry().factory(plugin, prof,
                                          device=self.device)
            self._codecs[pool.id] = codec
        return codec

    # ------------------------------------------------- EC backend seam --
    def ec_backend(self, pool_id: int):
        """The shared ECBackend engine (cluster/ec_backend.py) over
        this client's wire transport — the same backend class the
        in-process simulator uses (PGBackend seam,
        src/osd/PGBackend.cc:571)."""
        be = self._backends.get(pool_id)
        if be is None:
            from ..cluster.ec_backend import ECBackend
            pool = self.osdmap.pools[pool_id]
            be = ECBackend(self.codec_for(pool),
                           WireShardIO(self, pool_id))
            self._backends[pool_id] = be
        return be

    @property
    def dev(self):
        """Client-side device staging of shard plane words (the client
        is the card-attached EC primary; shards it wrote or read stay
        device-resident and serve zero-copy)."""
        if self._dev is None:
            from ..cluster.device_store import DeviceShardCache
            self._dev = DeviceShardCache()
        return self._dev

    # ----------------------------------------------------------- snapshots --
    def snap_create(self, pool_id: int, name: str) -> int:
        """Pool snapshot: committed mon state (quorum decree); clones
        appear lazily on the next write per object (pool snap_seq +
        COW, the OSDMonitor prepare_pool_op / make_writeable shape)."""
        r = self.mon_call({"cmd": "pool_snap_create", "pool": pool_id,
                           "name": name})
        self.refresh_map()
        return int(r["snap_seq"])

    def snap_remove(self, pool_id: int, name: str) -> Dict:
        """Remove a pool snapshot by name (rados rmsnap): committed
        mon state like creation; clones already materialized by COW
        stay readable through their object snapsets until trimmed."""
        r = self.mon_call({"cmd": "pool_snap_remove",
                           "pool": pool_id, "name": name})
        self.refresh_map()
        return r

    def snap_ls(self, pool_id: int) -> Dict:
        """List a pool's snapshots (rados lssnap): the mon's
        committed {"seq": int, "snaps": {id: name}} state, read from
        the quorum rather than this client's possibly-stale map."""
        return self.mon_call({"cmd": "pool_snap_ls",
                              "pool": pool_id})

    def snap_lookup(self, pool_id: int, name: str) -> int:
        snaps = self.pool_snaps.get(pool_id, {}).get("snaps", {})
        for sid, nm in snaps.items():
            if nm == name:
                return int(sid)
        raise KeyError(f"no snapshot {name!r} in pool {pool_id}")

    def _snapset_of(self, pool: PGPool, pg: int,
                    name: str) -> Optional[Dict]:
        """The snapset attr from ANY member holding it (replicated:
        every replica stores it; a member without the attr — e.g. one
        restored by data-only recovery — must not mask the others)."""
        coll = [pool.id, pg]
        up = self._up(pool, pg)
        answered = False
        for o in [x for x in up if x != ITEM_NONE]:
            try:
                raw = self.osd_client(o).call(_trace.stamp({
                    "cmd": "getattr_shard", "coll": coll,
                    "oid": f"0:{name}", "key": "snapset"}))
            except (OSError, IOError):
                self.drop_osd_client(o)
                continue
            answered = True
            if raw is not None:
                return json.loads(bytes(raw).decode())
        if not answered:
            raise IOError(f"{name}: no member reachable for snapset")
        return None

    def _store_snapset(self, pool: PGPool, pg: int, name: str,
                       snapset: Dict) -> None:
        """Persist the snapset on EVERY mapped member (replicated:
        all replicas; EC: every shard).  Zero acks is a hard error —
        a silently-lost snapset corrupts later COW rounds."""
        coll = [pool.id, pg]
        up = self._up(pool, pg)
        blob = json.dumps(snapset).encode()
        n_shards = self.codec_for(pool).get_chunk_count() \
            if pool.type == POOL_ERASURE else len(
                [x for x in up if x != ITEM_NONE])
        fan = []
        for shard in range(n_shards):
            if pool.type == POOL_ERASURE:
                tgt = up[shard] if shard < len(up) else ITEM_NONE
                oid = f"{shard}:{name}"
            else:
                tgt = [x for x in up if x != ITEM_NONE][shard]
                oid = f"0:{name}"
            if tgt == ITEM_NONE:
                continue
            # the async chokepoint stamps BOTH the trace context and
            # the (session, seq) replay id (setattr_shard is a
            # mutating cmd: a reconnect retry must not double-apply
            # around a concurrent snapset update), and the fan-out
            # pipelines instead of paying one RTT per shard
            fan.append(self.aio.call_async(tgt, {
                "cmd": "setattr_shard", "coll": coll,
                "oid": oid, "attrs": {"snapset": blob}}))
        acks = 0
        for comp in fan:
            try:
                comp.get_return_value()
                acks += 1
            except (OSError, IOError):
                pass
        if acks == 0:
            raise IOError(f"{name}: snapset not persisted anywhere")

    def _maybe_cow(self, pool: PGPool, pg: int,
                   name: str) -> Optional[Dict]:
        """Copy-on-write before the first overwrite after a snapshot
        (PrimaryLogPG make_writeable role, driven by the card-attached
        client as primary): preserve the head as a clone object.
        Returns the snapset to store after the head write."""
        info = self.pool_snaps.get(pool.id) or {"seq": 0, "snaps": {}}
        seq = int(info["seq"])
        if seq == 0:
            return None       # never-snapped pool: zero write overhead
        ss = self._snapset_of(pool, pg, name)
        if ss is None:
            # no snapset attr: distinguish a brand-new object (born
            # at the current seq) from one written before snapshots
            # existed (implicit write_seq 0 -> COW applies)
            exists = False
            for o in [x for x in self._up(pool, pg)
                      if x != ITEM_NONE]:
                try:
                    exists = self.osd_client(o).call(_trace.stamp({
                        "cmd": "digest_shard", "coll": [pool.id, pg],
                        "oid": f"0:{name}"})) is not None
                    break
                except (OSError, IOError):
                    self.drop_osd_client(o)
            if not exists:
                # a RECREATED object resumes its sidecar snapset (the
                # delete path parked it there): the old clones must
                # ride back onto the new head's attr, or the history
                # orphans.  The object was ABSENT for snaps since the
                # deletion, so no clone is minted for them — absent is
                # exactly what write_seq >= snap reports.
                try:
                    side = json.loads(
                        self.get(pool.id, f"{name}@snapset"))
                    side["write_seq"] = seq
                    return side
                except (RemoteObjectMissing, IOError, ValueError):
                    pass
                return {"write_seq": seq, "clones": []} if seq \
                    else None
            ss = {"write_seq": 0, "clones": []}
        if int(ss.get("write_seq", 0)) >= seq:
            return ss
        covered = [int(s) for s in info["snaps"]
                   if int(ss.get("write_seq", 0)) < int(s) <= seq]
        if covered:
            # idempotency: if a previous COW round already preserved
            # this clone (but the snapset update was lost), do NOT
            # overwrite it with the newer head
            clone = f"{name}@{seq}"
            cpg = self._pg_for(pool, clone)
            exists = False
            for o in [x for x in self._up(pool, cpg)
                      if x != ITEM_NONE]:
                try:
                    exists = self.osd_client(o).call(_trace.stamp({
                        "cmd": "digest_shard",
                        "coll": [pool.id, cpg],
                        "oid": f"0:{clone}"})) is not None
                    break
                except (OSError, IOError):
                    self.drop_osd_client(o)
            if not exists:
                data = self.get(pool.id, name)
                self.put(pool.id, clone, data)
            ss.setdefault("clones", []).append(
                {"id": seq, "snaps": covered})
        ss["write_seq"] = seq
        return ss

    def get_snap(self, pool_id: int, name: str, snap_id: int) -> bytes:
        """Read an object AT a snapshot: clone covering it, else the
        unchanged head (SnapSet resolution).  KeyError when the object
        DID NOT EXIST at that snapshot — a head written at/after the
        snap with no covering clone means the object was born later,
        and serving the head would invent post-snap data."""
        pool = self.osdmap.pools[pool_id]
        pg = self._pg_for(pool, name)
        ss = self._snapset_of(pool, pg, name)
        if ss is None:
            # deleted head: its snapset survives in the sidecar object
            try:
                ss = json.loads(self.get(pool_id, f"{name}@snapset"))
            except (RemoteObjectMissing, IOError, ValueError):
                ss = None
        if ss:
            for c in ss.get("clones", []):
                if snap_id in c["snaps"]:
                    return self.get(pool_id, f"{name}@{c['id']}")
            if int(ss.get("write_seq", 0)) >= snap_id:
                raise KeyError(f"{name}: no state at snap {snap_id}")
        return self.get(pool_id, name)

    # ------------------------------------------------- cache-tier ops --
    def tier_add(self, base_id: int, cache_id: int,
                 mode: str = "writeback") -> None:
        """Wire a cache pool over a base pool: committed MAP state
        (quorum incremental — OSDMonitor 'osd tier add')."""
        self.mon_call({"cmd": "pool_tier_add", "base": base_id,
                       "cache": cache_id, "mode": mode})
        self.refresh_map()

    def tier_remove(self, base_id: int, cache_id: int,
                    force: bool = False) -> None:
        """Refused until the cache pool is drained (flush + evict) —
        unwiring with data in the cache strands acknowledged writes
        out of the read path (the reference's 'osd tier remove'
        refuses the same way).  The drain check runs SERVER-side at
        the mon — the commit point — so a write racing this call
        cannot slip through a client-only check (the old TOCTOU);
        ``force`` is forwarded for operators who accept stranding."""
        self.mon_call({"cmd": "pool_tier_remove", "base": base_id,
                       "cache": cache_id, "force": force})
        self.refresh_map()

    def copy_from(self, dst_pool: int, dst_name: str,
                  src_pool: int, src_name: str) -> int:
        """COPY_FROM between pools as an OP: the DESTINATION primary
        daemon pulls the source object server-side (possibly from
        another OSD) and commits it as a logged replicated write —
        the client never carries the payload
        (src/osd/PrimaryLogPG.cc:5886 do_copy_from; daemon handler
        cluster/daemon.py 'copy_from')."""
        dpool = self.osdmap.pools[dst_pool]
        spool = self.osdmap.pools[src_pool]
        dpg = self._pg_for(dpool, dst_name)
        spg = self._pg_for(spool, src_name)
        dst_members = [o for o in self._up(dpool, dpg)
                       if o != ITEM_NONE]
        src_members = [o for o in self._up(spool, spg)
                       if o != ITEM_NONE]
        if not dst_members or not src_members:
            raise IOError("copy_from: no primary")
        r = self.osd_call(dst_members[0], {
            "cmd": "copy_from", "coll": [dst_pool, dpg],
            "oid": f"0:{dst_name}",
            "src_coll": [src_pool, spg], "src_oid": f"0:{src_name}",
            "src_osd": src_members[0], "replicas": dst_members})
        return int(r["acks"])

    def _tier_mark(self, cache_id: int, name: str,
                   dirty: bool) -> None:
        pool = self.osdmap.pools[cache_id]
        pg = self._pg_for(pool, name)
        blob = b"1" if dirty else b"0"
        for o in [x for x in self._up(pool, pg) if x != ITEM_NONE]:
            try:
                self.osd_call(o, {"cmd": "setattr_shard",
                                  "coll": [cache_id, pg],
                                  "oid": f"0:{name}",
                                  "attrs": {"tier_dirty": blob}})
            except (OSError, IOError):
                pass

    def tier_dirty(self, base_id: int, name: str) -> bool:
        pool = self.osdmap.pools[base_id]
        cache = self.osdmap.pools[pool.read_tier]
        pg = self._pg_for(cache, name)
        for o in [x for x in self._up(cache, pg) if x != ITEM_NONE]:
            try:
                raw = self.osd_call(o, {"cmd": "getattr_shard",
                                        "coll": [cache.id, pg],
                                        "oid": f"0:{name}",
                                        "key": "tier_dirty"})
            except (OSError, IOError):
                continue
            return raw == b"1"
        return False

    def tier_flush(self, base_id: int, name: str) -> int:
        """Writeback flush: demote a dirty cache object to the base
        tier as a COPY_FROM op, then mark it clean.

        Concurrency caveat (same single-writer assumption as
        RemoteIoCtx.write's RMW): a put racing between the copy and
        the clean-mark can be marked clean unflushed — callers that
        run multiple agents/writers against one tiered pool must
        serialize flushes per object."""
        pool = self.osdmap.pools[base_id]
        acks = self.copy_from(base_id, name, pool.write_tier, name)
        self._tier_mark(pool.write_tier, name, False)
        return acks

    def tier_evict(self, base_id: int, name: str) -> int:
        """Evict a CLEAN cache object (dirty must flush first)."""
        pool = self.osdmap.pools[base_id]
        if self.tier_dirty(base_id, name):
            raise IOError(f"{name}: dirty, flush before evict")
        return self.delete(pool.read_tier, name)

    def tier_agent_work(self, base_id: int,
                        target_objects: int = 0) -> Dict[str, int]:
        """One agent pass over the cache pool: flush every dirty
        object; evict the COLDEST clean ones down to target_objects
        (warmth = this client's read counters — the agent that runs
        the workload holds the hit history, the sim tier's
        HitSetHistory role)."""
        pool = self.osdmap.pools[base_id]
        cache_id = pool.read_tier
        stats = {"flushed": 0, "evicted": 0}
        cached = self.list_objects(cache_id)
        for nm in cached:
            if self.tier_dirty(base_id, nm):
                self.tier_flush(base_id, nm)
                stats["flushed"] += 1
        if target_objects and len(cached) > target_objects:
            cold = sorted(cached, key=lambda nm: self._tier_reads.get(
                (base_id, nm), 0))
            for nm in cold[:len(cached) - target_objects]:
                self.tier_evict(base_id, nm)
                stats["evicted"] += 1
        return stats

    # ----------------------------------------------------------------- IO --
    def put(self, pool_id: int, name: str, data: bytes,
            csums=None) -> int:
        """Returns the number of shard/replica writes acknowledged.

        ``csums`` — optional precomputed :class:`crcutil.Csums` for
        ``data`` (the staged-in-HBM shape: ``crc32_gf2.csums_for``
        computes them on-device).  With them the client never
        host-scans the payload — the wire layer folds the combined
        crc into the frame/doorbell and the daemon's single verify
        re-derives the trusted blob csums it stores and forwards to
        replicas.  Replicated pools only; EC encode re-chunks the
        bytes, so per-chunk csums come from the encode path instead."""
        return self._tracked("put", pool_id, name,
                             lambda: self._put_routed(pool_id, name,
                                                      data, csums))

    def _put_routed(self, pool_id: int, name: str, data: bytes,
                    csums=None) -> int:
        pool = self.osdmap.pools[pool_id]
        if pool.write_tier >= 0 and "@" not in name:
            # writeback cache routing (the Objecter consults the
            # pool's write_tier): the write lands in the cache pool
            # marked dirty; the agent/flush demotes it later.  Writes
            # count as warmth like the sim's HitSet record, or the
            # agent would evict just-written objects first
            self._tier_reads[(pool_id, name)] = \
                self._tier_reads.get((pool_id, name), 0) + 1
            return self._put_inner(pool.write_tier, name, data,
                                   extra_attrs={"tier_dirty": b"1"},
                                   csums=csums)
        return self._put_inner(pool_id, name, data, csums=csums)

    def _put_inner(self, pool_id: int, name: str, data: bytes,
                   extra_attrs: Optional[Dict[str, bytes]] = None,
                   csums=None) -> int:
        pool = self.osdmap.pools[pool_id]
        pg = self._pg_for(pool, name)
        up = self._up(pool, pg)
        coll = [pool_id, pg]
        snapset = self._maybe_cow(pool, pg, name) \
            if "@" not in name else None
        if pool.type != POOL_ERASURE:
            # bounded retry with a map refresh between attempts: a
            # dropped connection (daemon restart, injected socket
            # failure) is transient, and the full-object write +
            # fresh version make the resend idempotent.  8 attempts
            # with capped backoff out-wait a kill9'd primary's reboot
            # window instead of racing it (a 5-attempt budget ran out
            # under CPU contention).
            last: Optional[Exception] = None
            # (session, seq) stamps are PER PRIMARY: a resend to the
            # SAME primary replays one stamp (its dup table applies
            # the write at most once), while a re-homed primary gets
            # its own fresh stamp — sessions are per-OSD state, and
            # replaying osd.A's stamp at osd.B would smuggle seqs
            # into an unrelated dedup stream
            stamps: Dict[int, Dict] = {}
            attempts = 8
            for attempt in range(attempts):
                replicas = [o for o in up if o != ITEM_NONE]
                if not replicas:
                    # booting cluster / transient all-down map: retry
                    # against a refreshed map like any other failure
                    last = IOError(f"{name}: no live replica target")
                    self._backoff.sleep(attempt)
                    try:
                        self.refresh_map()
                    except (OSError, IOError):
                        pass
                    up = self._up(pool, pg)
                    continue
                primary = replicas[0]
                stamp = stamps.get(primary)
                if stamp is None:
                    stamp = stamps[primary] = self._next_stamp(primary)
                try:
                    req = {"cmd": "put_object", "coll": coll,
                           "oid": f"0:{name}", "data": data,
                           "attrs": extra_attrs,
                           "replicas": replicas, **stamp}
                    if csums is not None and \
                            csums.length == len(data):
                        # trusted client csums: the wire layer folds
                        # the combined crc instead of re-scanning
                        req["_csums"] = csums
                    r = self.osd_call(primary, req)
                except (OSError, IOError) as e:
                    last = e
                    if attempt < attempts - 1:   # no backoff on the
                        # last throw
                        self._backoff.sleep(attempt)
                        try:
                            self.refresh_map()
                        except (OSError, IOError):
                            pass
                        up = self._up(pool, pg)
                    continue
                # snapset persistence is OUTSIDE the retry: the object
                # write committed, so its failure must surface as its
                # own error, not masquerade as a dead primary
                if snapset is not None:
                    self._store_snapset(pool, pg, name, snapset)
                return int(r["acks"])
            raise IOError(f"{name}: put failed after retries ({last})")
        codec = self.codec_for(pool)
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        self._evict_staging(pool_id, pg, name)
        chunks = codec.encode(set(range(n)), data)
        # geometry attrs are REWRITTEN on every put: an overwrite of a
        # stripewise (batched-put) object must not leave stale S/U
        # behind, or readers would reassemble the new single-stripe
        # chunks with the old stripe interleave
        chunk_len = int(np.asarray(chunks[0]).size)
        obj_attrs = {"size": str(len(data)).encode(),
                     "S": b"1", "U": str(chunk_len).encode()}
        if extra_attrs:
            obj_attrs.update(extra_attrs)
        # EC write contract: the primary gathers
        # ALL shard commits before acknowledging
        # (src/osd/ECBackend.cc:1150) — transient failures retry
        # against a refreshed map, and success requires every MAPPED
        # shard committed (plus >= k overall: a write that cannot
        # tolerate the advertised failures must not ack)
        # acked maps shard -> the OSD that committed it; a shard only
        # counts when its ack matches its CURRENT mapped home, so a
        # mid-write re-homing (map refresh between attempts) resends
        # rather than silently counting a write to the old home
        acked: Dict[int, int] = {}
        attempts = 3
        for attempt in range(attempts):
            # shard fan-out rides the async core: every sub-write is
            # submitted to its target's stream pool (payload on the
            # scatter-gather frame tail), then the GATHER-COMMITS
            # step collects per-shard verdicts — the k+m frames
            # encode/transmit concurrently across streams instead of
            # one blocking RTT per shard
            fan: List[Tuple[int, int, object]] = []
            # submission order: on a multi-host plane the sub-writes
            # interleave round-robin across the targets' hosts so
            # every host's dispatch queue fills from the first
            # submit; single-host it is the identity order (today's
            # fan-out, byte for byte)
            targets = [up[s] if s < len(up) else ITEM_NONE
                       for s in range(n)]
            from ..parallel.multihost import stripe_order
            for shard in stripe_order(targets):
                tgt = targets[shard]
                if tgt == ITEM_NONE or acked.get(shard) == tgt:
                    continue
                fan.append((shard, tgt, self.aio.call_async(tgt, {
                    "cmd": "put_shard", "coll": coll,
                    "oid": f"{shard}:{name}",
                    # zero-copy: the encoded shard's buffer view goes
                    # straight to the SG frame / shm ring — tobytes()
                    # re-copied every shard byte client-side
                    "data": _as_buf(chunks[shard]),
                    # logical object size travels as shard metadata
                    # so ANY client can unpad reads (object_info_t)
                    "attrs": obj_attrs})))
            fatal: Optional[BaseException] = None
            for (shard, tgt, comp), (_r, err) in zip(
                    fan, self.aio.gather([c for _, _, c in fan])):
                if err is None:
                    acked[shard] = tgt
                elif not isinstance(err, OSError):
                    # only connection-class failures are transient
                    # resend material; a daemon REJECTION (caps,
                    # registry, cls errors surfaced as non-IO types)
                    # must not be laundered into 'EC write incomplete'
                    # by the retry loop — same taxonomy the blocking
                    # osd_call path applied
                    fatal = err
            if fatal is not None:
                raise fatal
            mapped = [s for s in range(n)
                      if s < len(up) and up[s] != ITEM_NONE]
            # an UNMAPPED slot is not "done" either: a stale client
            # map (fetched before a booting OSD's epoch landed) maps
            # the slot ITEM_NONE while every sub-write succeeds — the
            # refresh below fills the hole and the next round writes
            # the missing shard instead of acking a degraded-at-birth
            # object; a slot that stays unmapped after the retries is
            # a genuinely down OSD and the >= k verdict applies
            done = len(mapped) == n and \
                all(acked.get(s) == up[s] for s in mapped)
            if done or attempt == attempts - 1:
                break
            # transient shard failure: re-pull the map (the target may
            # have been marked down/re-homed) and resend the misses
            self._backoff.sleep(attempt)
            try:
                self.refresh_map()
            except (OSError, IOError):
                pass
            up = self._up(pool, pg)
        # verdict against the map the final sends targeted
        mapped = [s for s in range(n)
                  if s < len(up) and up[s] != ITEM_NONE]
        missing = [s for s in mapped if acked.get(s) != up[s]]
        acks = sum(1 for s in mapped if acked.get(s) == up[s])
        if missing or acks < k:
            raise IOError(
                f"{name}: EC write incomplete — {acks}/{n} shards "
                f"committed, unacked mapped shards {missing} "
                f"(gather-all-commits contract)")
        if snapset is not None:
            self._store_snapset(pool, pg, name, snapset)
        return acks

    def get(self, pool_id: int, name: str,
            size: Optional[int] = None) -> bytes:
        """Read with bounded whole-read retries: one round can lose to
        transient connection drops on every holder (socket-failure
        injection, daemons restarting); the retry refreshes the map
        and sweeps again before reporting the object unreadable.

        Tiered pools (read_tier set): the read serves from the cache
        pool; a cache MISS promotes the object through the op engine
        (COPY_FROM base -> cache, executed by the cache primary
        daemon — PrimaryLogPG::promote_object, :3932) and then serves
        the promoted copy."""
        return self._tracked("get", pool_id, name,
                             lambda: self._get_routed(pool_id, name,
                                                      size))

    def _get_routed(self, pool_id: int, name: str,
                    size: Optional[int] = None) -> bytes:
        pool = self.osdmap.pools[pool_id]
        if pool.read_tier >= 0 and "@" not in name:
            try:
                data = self.get(pool.read_tier, name, size)
                self._tier_reads[(pool_id, name)] = \
                    self._tier_reads.get((pool_id, name), 0) + 1
                return data
            except RemoteObjectMissing:
                pass
            try:
                self.copy_from(pool.read_tier, name, pool_id, name)
            except (OSError, IOError):
                # promote failed — could be a TRANSIENT daemon issue,
                # not absence: fall back to a PROXY READ of the base
                # tier (Ceph's proxy-read mode); only a definitive
                # base miss propagates as missing
                return self._get_base_direct(pool_id, name, size)
            self._tier_reads[(pool_id, name)] = \
                self._tier_reads.get((pool_id, name), 0) + 1
            return self.get(pool.read_tier, name, size)
        return self._get_base_direct(pool_id, name, size)

    def _get_base_direct(self, pool_id: int, name: str,
                         size: Optional[int] = None) -> bytes:
        """The retrying read against ONE pool, no tier routing.  Six
        attempts with capped backoff + map refresh: a degraded sweep
        can lose one round to EVERY holder transiently (kill9'd
        daemons whose sockets refuse, starved survivors, injected
        drops) — the budget must out-wait a markdown/reboot window
        rather than race it (the same contention budget as the put
        path)."""
        last: Optional[Exception] = None
        attempts = 6
        for attempt in range(attempts):
            try:
                return self._get_once(pool_id, name, size)
            except RemoteObjectMissing:
                raise        # definitive miss (targets answered): no retry
            except (OSError, IOError) as e:
                last = e
                if attempt < attempts - 1:   # no backoff on last throw
                    self._backoff.sleep(attempt)
                    try:
                        self.refresh_map()
                    except (OSError, IOError):
                        pass
        raise IOError(f"{name}: unreadable after retries ({last})")

    def _get_once(self, pool_id: int, name: str,
                  size: Optional[int] = None) -> bytes:
        pool = self.osdmap.pools[pool_id]
        pg = self._pg_for(pool, name)
        up = self._up(pool, pg)
        coll = [pool_id, pg]
        if pool.type != POOL_ERASURE:
            last_err = None
            conn_errors = 0
            for o in [x for x in up if x != ITEM_NONE] + \
                    [x for x in self.addrs if x not in up]:
                try:
                    data = self.osd_call(o, {
                        "cmd": "get_shard", "coll": coll,
                        "oid": f"0:{name}"})
                except (OSError, IOError) as e:
                    last_err = e
                    conn_errors += 1
                    continue
                if data is not None:
                    return data
            if conn_errors == 0:
                # every target ANSWERED and none has it: a definitive
                # miss, not a connectivity problem — callers probing
                # existence must not pay the retry sweep
                raise RemoteObjectMissing(f"{name}: no such object")
            raise IOError(f"{name}: no replica served ({last_err})")
        codec = self.codec_for(pool)
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        shards: Dict[int, bytes] = {}
        obj_size: Optional[int] = None
        geom_s: Optional[int] = None
        geom_u: Optional[int] = None
        geom_resolved = False
        conn_errors = 0
        for shard in range(n):
            # client HBM staging first: a shard this client wrote or
            # read serves from device words (dirty entries are
            # authoritative; clean ones validate against the daemon's
            # stored checksum, one digest RTT, no payload transfer)
            key = (pool_id, pg, name, shard)
            staged = self.dev.dirty_get(key)
            attrs_src = None
            if staged is None and self.dev.has(key):
                io = self.ec_backend(pool_id).io
                try:
                    dg = io._digest(pg, shard, name)
                except (OSError, IOError):
                    dg = None      # unreachable: fall to wire fetch
                if dg is not None:
                    staged = self.dev.get(key, dg)
            if staged is not None:
                shards[shard] = to_host(staged.materialize()).tobytes()
                a = self._staged_attrs.get(key)
                if a:
                    attrs_src = lambda kk, a=a: a.get(kk)
                else:
                    io = self.ec_backend(pool_id).io

                    def attrs_src(kk, shard=shard):
                        return io.getattr(pg, name, shard, kk)
            else:
                srcs = [up[shard]] if shard < len(up) and \
                    up[shard] != ITEM_NONE else []
                srcs += [o for o in self.addrs if o not in srcs]
                for o in srcs:
                    try:
                        d = self.osd_call(o, {
                            "cmd": "get_shard", "coll": coll,
                            "oid": f"{shard}:{name}"})
                    except (OSError, IOError):
                        conn_errors += 1
                        continue
                    if d is not None:
                        shards[shard] = d

                        def attrs_src(kk, o=o, shard=shard):
                            # propagate wire errors: "attr absent"
                            # and "holder unreachable" must not be
                            # conflated (geometry decides assembly)
                            return self.osd_call(o, {
                                "cmd": "getattr_shard",
                                "coll": coll,
                                "oid": f"{shard}:{name}",
                                "key": kk})
                        break
            if attrs_src is not None and not geom_resolved:
                try:
                    sz = attrs_src("size")
                    s_raw, u_raw = attrs_src("S"), attrs_src("U")
                except (OSError, IOError):
                    continue      # try the next shard's holder
                if sz is not None:
                    obj_size = int(sz)
                # a DEFINITIVE answer: attrs answered (None = a
                # legacy single-stripe object, values = stripewise)
                geom_resolved = True
                if s_raw is not None and u_raw is not None:
                    geom_s, geom_u = int(s_raw), int(u_raw)
        if len(shards) < k:
            if not shards and conn_errors == 0:
                raise RemoteObjectMissing(f"{name}: no such object")
            raise IOError(f"{name}: only {len(shards)} shards (< k)")
        if not geom_resolved and obj_size is None and shards:
            # shards readable but NO holder answered the attr probes:
            # assembling with guessed geometry could silently scramble
            # a stripewise object — error out and let the caller's
            # retry loop re-sweep
            raise IOError(f"{name}: shard attrs unreadable "
                          f"(geometry unknown)")
        be = self.ec_backend(pool_id)
        plan, missing = be.plan(list(shards))
        if geom_s is not None and geom_u:
            # stripewise object (batched put): shard files are S
            # chunks of U bytes; degraded decode runs per-stripe
            # geometry — on device in the word domain when the codec
            # supports it
            S, U = geom_s, geom_u
            dec8 = None
            if missing:
                if be.words_supported():
                    stack = np.stack(
                        [np.frombuffer(shards[c], dtype="<i4")
                         .reshape(S, U // 4) for c in plan], axis=1)
                    # the host-to-device staging: onto the codec's
                    # device, not the package default
                    job = (plan, torch.from_numpy(stack).to(
                        be.codec.device), missing)
                    dec = be.decode_signature_groups([job])[0]
                    dec8 = to_host(dec).view(np.uint8).reshape(
                        S, len(missing), U)
                else:
                    stack = np.stack(
                        [np.frombuffer(shards[c], dtype=np.uint8)
                         .reshape(S, U) for c in plan], axis=1)
                    dec8 = np.asarray(codec.decode_chunks_batch(
                        plan, stack, missing))
            cols = []
            for c in range(k):
                if c in shards:
                    cols.append(np.frombuffer(shards[c],
                                              dtype=np.uint8)
                                .reshape(S, U))
                else:
                    cols.append(dec8[:, missing.index(c)])
            buf = np.stack(cols, axis=1).reshape(-1).tobytes()
        else:
            # legacy single-stripe object: whole shard = one chunk
            stack = np.stack([np.frombuffer(shards[c], dtype=np.uint8)
                              for c in plan])
            if missing:
                dec = np.asarray(codec.decode_chunks(plan, stack,
                                                     missing))
            data_chunks = []
            for c in range(k):
                if c in shards:
                    data_chunks.append(np.frombuffer(shards[c],
                                                     dtype=np.uint8))
                else:
                    data_chunks.append(dec[missing.index(c)])
            buf = np.concatenate(data_chunks).tobytes()
        if size is None:
            size = obj_size if obj_size is not None else len(buf)
        return buf[:size]

    def delete(self, pool_id: int, name: str) -> int:
        """Delete an object.  Replicated pools go through the
        primary's LOGGED delete (delete_object: version + OP_DELETE
        entry + fan-out — src/osd/PrimaryLogPG.cc delete shape), so a
        down replica cannot resurrect the object on log-driven
        recovery.  EC pools delete per shard, mirroring this client's
        shard-direct write path.

        In a snapped pool the head is COW-preserved first and its
        snapset moves to a sidecar object (the head's xattr dies with
        it) — deleting an object must not delete its history
        (make_writeable-on-delete; the sim keeps this in SnapMapper).

        Tiered base pools delete BOTH copies (cache first), or the
        next read would promote the object back to life."""
        pool = self.osdmap.pools[pool_id]
        if pool.write_tier >= 0 and "@" not in name:
            # delete the cache copy FIRST — a real failure here must
            # surface (a surviving cache copy would keep serving, and
            # a later flush would resurrect the object in the base);
            # then fall through to the base delete, which is
            # idempotent on absence
            try:
                self.delete(pool.write_tier, name)
            except RemoteObjectMissing:
                pass              # not (or no longer) cached
            self._tier_reads.pop((pool_id, name), None)
        pg = self._pg_for(pool, name)
        if "@" not in name:
            ss = self._maybe_cow(pool, pg, name)
            if ss is not None and (ss.get("clones") or
                                   ss.get("write_seq")):
                self.put(pool_id, f"{name}@snapset",
                         json.dumps(ss).encode())
        self._evict_staging(pool_id, pg, name)
        up = self._up(pool, pg)
        coll = [pool_id, pg]
        if pool.type != POOL_ERASURE:
            last: Optional[Exception] = None
            for attempt in range(3):
                replicas = [o for o in up if o != ITEM_NONE]
                if not replicas:
                    raise IOError(f"{name}: no live replica target")
                try:
                    r = self.osd_call(replicas[0], {
                        "cmd": "delete_object", "coll": coll,
                        "oid": f"0:{name}", "replicas": replicas})
                    return int(r["acks"])
                except (OSError, IOError) as e:
                    last = e
                    if attempt < 2:
                        self._backoff.sleep(attempt)
                        try:
                            self.refresh_map()
                        except (OSError, IOError):
                            pass
                        up = self._up(pool, pg)
            raise IOError(f"{name}: delete failed after retries "
                          f"({last})")
        acks = 0
        codec = self.codec_for(pool)
        for shard in range(codec.get_chunk_count()):
            tgt = up[shard] if shard < len(up) else ITEM_NONE
            if tgt == ITEM_NONE:
                continue
            try:
                # osd_call: session-stamped (replay-safe) + one
                # reconnect retry per target
                self.osd_call(tgt, {
                    "cmd": "delete_shard", "coll": coll,
                    "oid": f"{shard}:{name}"})
                acks += 1
            except (OSError, IOError):
                pass
        return acks

    def list_objects(self, pool_id: int) -> List[str]:
        """Logical object names in a pool: PG-walk each primary's
        listing, collapsing shard prefixes and snapshot clones (the
        `rados ls` shape; also the admin CLIs' shared listing)."""
        pool = self.osdmap.pools[pool_id]
        names = set()
        for pg in range(pool.pg_num):
            ups = self._up(pool, pg)
            members = [o for o in ups if o != ITEM_NONE]
            if not members:
                continue
            # the PRIMARY is the one member guaranteed current (it
            # applies every write locally before fanning out), so ask
            # it first; if it is truly unreachable, fall back to the
            # surviving member with the HIGHEST pg-log head — a plain
            # union would transiently resurrect objects a stale
            # replica missed the logged delete for, and a stale
            # replica alone could hide a degraded write; the log head
            # identifies the most-current survivor
            listed: Optional[List[str]] = None
            for attempt in range(3):
                try:
                    listed = self.osd_call(
                        members[0],
                        {"cmd": "list_pg", "coll": [pool_id, pg]})
                    break
                except (OSError, IOError):
                    self._backoff.sleep(attempt)
            if listed is None:
                # cheap pg_info probe first, then list only the
                # best-head member; a member whose probe failed is
                # still tried last so one blip cannot turn a listable
                # PG into an error
                heads = []
                for tgt in members[1:]:
                    try:
                        info = self.osd_call(
                            tgt,
                            {"cmd": "pg_info", "coll": [pool_id, pg]})
                        heads.append((tuple(info["head"]), tgt))
                    except (OSError, IOError):
                        heads.append(((-1, -1), tgt))
                heads.sort(key=lambda h: h[0], reverse=True)
                for _, tgt in heads:
                    try:
                        listed = self.osd_call(
                            tgt,
                            {"cmd": "list_pg", "coll": [pool_id, pg]})
                        break
                    except (OSError, IOError):
                        continue
                if listed is None:
                    raise IOError(
                        f"pg {pool_id}.{pg}: no member listable")
            for n in listed:
                # PG-internal rows ("meta:pglog") carry no shard
                # prefix; data objects are "<shard>:<name>"
                if n.startswith("meta:") or ":" not in n:
                    continue
                head = n.split(":", 1)[1]
                if head.startswith("meta:") or "@" in head:
                    continue
                names.add(head)
        return sorted(names)

    # ------------------------------------------------------------ recovery --
    def recover_pool(self, pool_id: int) -> Dict:
        """Replicated pools: primary-driven PEERING recovery per PG
        (GetInfo/GetLog/GetMissing on the primary daemon; members
        catch up by log delta when the log covers their gap, else
        backfill — src/osd/PeeringState.h:561, PGLog.h).

        PGs recover CONCURRENTLY under the daemons' recovery
        reservations (osd_max_backfills): each primary takes a local
        slot plus remote slots on its members before moving a byte; a
        denied PG comes back ``deferred`` and requeues.  When a whole
        round defers (every slot held elsewhere), one PG runs solo so
        the loop always advances."""
        pool = self.osdmap.pools[pool_id]
        totals = {"copied": 0, "delta_objects": 0,
                  "backfill_objects": 0, "deletes_applied": 0,
                  "modes": {"delta": 0, "backfill": 0, "clean": 0}}
        work = []
        for pg in range(pool.pg_num):
            up = self._up(pool, pg)
            members = [o for o in up if o != ITEM_NONE]
            if not members:
                continue
            # every non-member OSD is a potential STRAY log/data
            # source (the past-interval role): a map flap can have
            # landed acked writes on a substitute member that has
            # since dropped out of the set — the primary must be
            # able to find that log or the objects are unreachable
            # to recovery forever
            strays = [int(o) for o in self.addrs
                      if int(o) not in members]
            work.append((pg, members, strays))

        def run_pg(item):
            pg, members, strays = item
            for attempt in range(3):  # a skipped PG stays unrepaired
                try:
                    return self.osd_call(members[0], {
                        "cmd": "recover_pg", "coll": [pool_id, pg],
                        "members": members, "strays": strays})
                except (OSError, IOError):
                    self._backoff.sleep(attempt)
            return None

        def merge(r) -> None:
            for key in ("copied", "delta_objects",
                        "backfill_objects", "deletes_applied"):
                totals[key] += r.get(key, 0)
            for mode in r.get("mode", {}).values():
                totals["modes"][mode] = \
                    totals["modes"].get(mode, 0) + 1

        def run(item):
            r = run_pg(item)
            if r is None:
                return {}         # unreachable primary: next pass
            return None if r.get("deferred") else r

        left = self._drain_pg_queue(list(work), run, merge)
        if left:
            totals["deferred_pgs"] = left
        return totals

    def _drain_pg_queue(self, queue: List, run, merge,
                        max_workers: int = 8) -> int:
        """Concurrent requeue loop shared by the reservation-gated
        recovery sweeps: ``run(item)`` returns a stats dict (merged)
        or None for a DEFERRED item (requeued).  When a whole round
        defers, one item runs SOLO so the loop always advances; a
        bounded stall (a foreign client holding every slot) gives up
        and returns how many items stayed deferred."""
        import concurrent.futures as cf
        stalled = 0
        with cf.ThreadPoolExecutor(
                max_workers=min(max_workers,
                                max(1, len(queue) or 1))) as ex:
            while queue:
                deferred = []
                for item, r in zip(queue, ex.map(run, queue)):
                    if r is None:
                        deferred.append(item)
                    else:
                        merge(r)
                if len(deferred) == len(queue):
                    r = run(deferred[0])
                    if r is not None:
                        merge(r)
                        deferred.pop(0)
                        stalled = 0   # solo progress IS progress
                    else:
                        stalled += 1
                        if stalled > 10:
                            return len(deferred)
                        self._backoff.sleep(stalled)
                else:
                    stalled = 0
                queue = deferred
        return 0

    def scrub_pool(self, pool_id: int,
                   repair: bool = False) -> Dict:
        """Cross-replica scrub over the wire, per PG on the primary
        (pg_scrubber role): digests compared across members,
        inconsistencies listed, optionally repaired from the
        majority."""
        pool = self.osdmap.pools[pool_id]
        if pool.type == POOL_ERASURE:
            raise IOError(
                "scrub_pool compares replica digests; EC pools "
                "scrub by parity re-encode (ClusterSim.scrub / "
                "recover_ec_pool)")
        totals = {"objects": 0, "inconsistent": [], "repaired": 0}
        for pg in range(pool.pg_num):
            up = self._up(pool, pg)
            members = [o for o in up if o != ITEM_NONE]
            if not members:
                continue
            r = None
            for attempt in range(3):  # a skipped PG goes unscrubbed
                try:
                    r = self.osd_call(members[0], {
                        "cmd": "scrub_pg", "coll": [pool_id, pg],
                        "members": members, "repair": repair})
                    break
                except (OSError, IOError):
                    self._backoff.sleep(attempt)
            if r is None:
                continue
            totals["objects"] += r["objects"]
            totals["inconsistent"].extend(
                dict(i, pg=pg) for i in r["inconsistent"])
            totals["repaired"] += r["repaired"]
        return totals

    def _reserve_pg_members(self, members: List[int]
                            ) -> Optional[List[int]]:
        """Client-side reservation acquisition for CLIENT-driven EC
        recovery (this client is the card-attached primary): one
        REMOTE slot per member, all-or-nothing with rollback — an
        explicit denial defers the PG to the caller's requeue loop
        (returns None), never waits while holding.  Returns the list
        of members actually holding a slot (the ONLY ones the caller
        may release — releasing an unreserved member would decrement
        a concurrent PG's slot)."""
        got: List[int] = []
        for m in members:
            try:
                r = self.osd_call(m, {"cmd": "reserve_recovery",
                                      "role": "remote"})
            except (OSError, IOError):
                # UNREACHABLE member: nothing to reserve — proceed
                # without its slot (its pushes will fail and the
                # object stays visibly missing for the next pass);
                # deferring on a dead-but-in-map member would block
                # every reachable member's repair forever
                continue
            if not (r or {}).get("granted"):
                self._release_pg_members(got)
                return None
            got.append(m)
        return got

    def _release_pg_members(self, members: List[int]) -> None:
        for m in members:
            try:
                self.osd_call(m, {"cmd": "release_recovery",
                                  "role": "remote"})
            except (OSError, IOError):
                pass

    def _gather_shard_fetches(self, coll, wants: Dict) -> Dict:
        """Submit-all-then-gather shard reads for one PG's repair
        set: every (object, shard) fetch pipelines onto the
        AsyncObjecter's multi-stream pools as one round per holder
        rank — the per-shard blocking round trips this replaces were
        the wire tier's recovery floor.  ``wants`` maps (name, shard)
        to (ordered holder list, byte ranges|None); a failed holder
        fails over to the next on the following round."""
        out: Dict = {}
        pending = {wk: (list(hs), rg)
                   for wk, (hs, rg) in wants.items()}
        while pending:
            fan = []
            for wk, (hs, rg) in list(pending.items()):
                if not hs:
                    del pending[wk]
                    continue
                o = hs.pop(0)
                name, shard = wk
                req = {"cmd": "get_shard", "coll": coll,
                       "oid": f"{shard}:{name}",
                       "klass": "background_recovery"}
                if rg:
                    req["ranges"] = [list(r) for r in rg]
                fan.append((wk, o, self.aio.call_async(o, req)))
            if not fan:
                break
            for (wk, o, _c), (d, err) in zip(
                    fan, self.aio.gather([c for _, _, c in fan])):
                if err is None and d is not None:
                    out[wk] = (d, o)
                    pending.pop(wk, None)
        return out

    def _gather_attrs(self, coll, cands: Dict) -> Dict:
        """One ``getattrs_shard`` round trip per object (size/S/U in
        a single frame), submit-all-then-gather; ``cands`` maps name
        to its ordered (holder, shard) candidates — each candidate is
        asked about the shard IT served, and one holder supplies ALL
        attrs (mixing two holders' geometries is how stale attrs
        corrupt a rebuild)."""
        out: Dict = {}
        pending = {nm: list(cs) for nm, cs in cands.items()}
        while pending:
            fan = []
            for nm, cs in list(pending.items()):
                if not cs:
                    del pending[nm]
                    continue
                o, shard = cs.pop(0)
                fan.append((nm, self.aio.call_async(o, {
                    "cmd": "getattrs_shard", "coll": coll,
                    "oid": f"{shard}:{nm}",
                    "keys": ["size", "S", "U"],
                    "klass": "background_recovery"})))
            if not fan:
                break
            for (nm, _c), (d, err) in zip(
                    fan, self.aio.gather([c for _, c in fan])):
                if err is None and d:
                    cand = {ak: bytes(av) for ak, av in d.items()
                            if av is not None}
                    if cand:
                        out[nm] = cand
                        pending.pop(nm, None)
        return out

    def recover_ec_pool(self, pool_id: int) -> Dict[str, int]:
        """Client-driven EC recovery (the client is the card-attached
        primary), reservation-gated and CONCURRENT across PGs, each
        PG in three passes: (1) union every daemon's shard listing
        and fetch only the shards the codec's MINIMAL repair plan
        requires (``minimum_to_decode`` — LRC repairs inside the
        covering local group, Clay single losses fetch d helpers'
        repair SUB-CHUNK ranges and regenerate via ``codec.repair``);
        (2) decode the PG's lost shards in signature-GROUPED device
        dispatches; (3) push surviving copies and rebuilt shards to
        their up targets.  Every fetch and push is submit-all-then-
        gather on the AsyncObjecter's pipelined streams; pushes carry
        (session, seq) stamps so a stream-death replay applies at
        most once.  PG-scoped batching keeps client memory bounded by
        one PG's repair set."""
        pool = self.osdmap.pools[pool_id]
        be = self.ec_backend(pool_id)
        stats: Dict[str, int] = {"objects": 0, "shards_copied": 0,
                                 "shards_rebuilt": 0}
        live = [o for o in self.addrs
                if self.osdmap.osd_up[o]]

        def sweep(pg: int) -> Optional[Dict[str, int]]:
            return self._recover_ec_pg(pool, be, pg, live)

        def merge(r) -> None:
            for kk, v in r.items():
                stats[kk] = stats.get(kk, 0) + v

        left = self._drain_pg_queue(list(range(pool.pg_num)), sweep,
                                    merge)
        if left:
            stats["deferred_pgs"] = left
        return stats

    def _recover_ec_pg(self, pool: PGPool, be, pg: int,
                       live: List[int]) -> Optional[Dict[str, int]]:
        """One PG's repair sweep; None = reservation denied (the
        caller requeues).  The reservation is taken only once the
        plan pass proves there is work to move — a clean PG costs
        its listings, never a reservation round."""
        codec, k, n = be.codec, be.k, be.n
        stats = {"objects": 0, "shards_copied": 0, "shards_rebuilt": 0}
        coll = [pool.id, pg]
        # -- listings: one async gather across every live daemon
        fan = [(o, self.aio.call_async(o, {"cmd": "list_pg",
                                           "coll": coll}))
               for o in live]
        holdings: Dict[int, set] = {}
        for (o, _c), (r, err) in zip(
                fan, self.aio.gather([c for _, c in fan])):
            if err is None and r is not None:
                holdings[o] = set(r)
        names = set()
        for objs in holdings.values():
            for oid in objs:
                shard_s, nm = oid.split(":", 1)
                names.add(nm)
        up = self._up(pool, pg)

        def holders_of(name, shard):
            oid = f"{shard}:{name}"
            return [x for x, objs in holdings.items() if oid in objs]

        # -- plan pass: decide, per object, the minimal fetch set
        plans = {}
        for name in sorted(names):
            stats["objects"] += 1
            # cheap membership pass first: skip healthy objects
            # without moving a byte (holdings already lists every
            # daemon's oids)
            have_somewhere = {s for s in range(n)
                              if any(f"{s}:{name}" in objs
                                     for objs in holdings.values())}
            need = [s for s in range(n)
                    if s < len(up) and up[s] != ITEM_NONE and
                    f"{s}:{name}" not in holdings.get(up[s], set())]
            if not need:
                continue
            lost = [s for s in need if s not in have_somewhere]
            # fetch only what the repair requires: the sources of
            # displaced shards, plus the codec's MINIMAL decode set
            # (not every survivor) when shards must be rebuilt
            fetch = set(need) & have_somewhere
            sub_plan = None
            if lost:
                try:
                    sub_plan = codec.minimum_to_decode(
                        set(lost), set(have_somewhere))
                except ErasureCodeError:
                    sub_plan = None
                if sub_plan is None:
                    fetch |= set(sorted(have_somewhere)[:n])
                else:
                    fetch |= set(sub_plan)
            plans[name] = (sorted(fetch), lost, have_somewhere,
                           sub_plan)
        if not plans:
            return stats      # clean PG: listings only, no reservation
        # there IS work to move: take the recovery reservations
        # (one REMOTE slot per member, all-or-nothing) before the
        # first payload byte; an explicit denial defers the whole PG
        members = [o for o in up if o != ITEM_NONE]
        reserved = self._reserve_pg_members(members)
        if reserved is None:
            return None
        try:
            return self._recover_ec_pg_move(
                pool, be, pg, coll, up, plans, holdings, holders_of,
                stats)
        finally:
            self._release_pg_members(reserved)

    def _recover_ec_pg_move(self, pool: PGPool, be, pg: int, coll,
                            up: List[int], plans: Dict,
                            holdings: Dict[int, set], holders_of,
                            stats: Dict[str, int]) -> Dict[str, int]:
        codec, k, n = be.codec, be.k, be.n
        sub_chunks = codec.get_sub_chunk_count()
        records: List[Dict] = []
        # -- ranged (regenerating-code) single-loss repair CANDIDATES
        # — the partial-plan shape is decidable from the SubChunkPlan
        # alone; only these need geometry attrs BEFORE their byte
        # fetch (byte ranges derive from U), so only they pay a
        # pre-fetch attr round against listing-derived holders
        maybe_ranged = {
            name for name, (fetch, lost, _h, sub_plan)
            in plans.items()
            if sub_plan is not None and len(lost) == 1 and
            not (set(fetch) - set(sub_plan)) and
            any(sum(c for _o, c in rg) < sub_chunks
                for rg in sub_plan.values())}
        attrs_by_name = self._gather_attrs(coll, {
            name: [(h, s) for s in plans[name][0]
                   for h in holders_of(name, s)]
            for name in sorted(maybe_ranged)})
        ranged = {name: plans[name][3] for name in maybe_ranged
                  if "U" in attrs_by_name.get(name, {})}
        wants: Dict = {}
        for name, (fetch, lost, have, sub_plan) in plans.items():
            if name in ranged:
                continue
            for shard in fetch:
                wants[(name, shard)] = (holders_of(name, shard), None)
        fetched = self._gather_shard_fetches(coll, wants)
        # -- attrs for the decode/push path come from the holders
        # that actually SERVED each object's bytes (one holder, all
        # attrs — a holder serving stale bytes with fresh attrs, or
        # vice versa, must not mix geometries; stripewise objects
        # must decode with per-stripe plane geometry, and the attrs
        # ride along to re-homed copies so geometry never strands)
        attrs_by_name.update(self._gather_attrs(coll, {
            name: [(src, shard)
                   for shard in fetch
                   if (name, shard) in fetched
                   for src in [fetched[(name, shard)][1]]]
            for name, (fetch, _l, _h, _p) in plans.items()
            if name not in ranged and fetch}))
        pushes: List[Tuple] = []
        for name, sub_plan in ranged.items():
            st = self._repair_ranged_wire(pool, be, pg, name, up,
                                          plans[name],
                                          attrs_by_name.get(name, {}),
                                          holders_of, pushes)
            for kk, v in st.items():
                stats[kk] = stats.get(kk, 0) + v
        # gather the rebuilt-shard pushes submitted above: one
        # blocking put_shard RTT per repaired object was the ranged
        # loop's wire floor (CTL120) — the pushes pipeline on the
        # async objecter and complete here in one gather
        for comp, tgt, oid, nbytes_fetched in pushes:
            try:
                comp.get_return_value()
            except (OSError, IOError):
                # not a swallowed loss: the shard stays missing in
                # the next sweep's listings; this pass reports it
                stats["unrecoverable"] = \
                    stats.get("unrecoverable", 0) + 1
                continue
            holdings.setdefault(tgt, set()).add(oid)
            for kk, v in (("shards_rebuilt", 1),
                          ("ranged_repairs", 1),
                          ("repair_bytes_fetched", nbytes_fetched)):
                stats[kk] = stats.get(kk, 0) + v
        # top-up round: ONLY a name whose minimal-plan fetch actually
        # FAILED a shard widens to the survivors the plan skipped
        # (the old fetch-everything slack, paid strictly on failure —
        # a successful LRC local-group plan is SMALLER than k by
        # design and must not trigger a fetch of every survivor)
        topup: Dict = {}
        for name, (fetch, lost, have, sub_plan) in plans.items():
            if name in ranged or not lost:
                continue
            if any((name, s) not in fetched for s in fetch):
                for s in sorted(have - set(fetch)):
                    topup[(name, s)] = (holders_of(name, s), None)
        if topup:
            fetched.update(self._gather_shard_fetches(coll, topup))
            # a top-up source may be the only holder that answered
            # at all: its attrs must be fetchable too (an object
            # decoded without its S would scramble stripewise plane
            # boundaries past the geometry gate)
            attrs_by_name.update(self._gather_attrs(coll, {
                name: [(src, shard)
                       for (nm, shard), (_d, src) in sorted(
                           fetched.items(),
                           key=lambda it: it[0][1])
                       if nm == name]
                for name in {nm for nm, _s in topup}
                if name not in attrs_by_name}))
        for name, (fetch, lost, have, sub_plan) in plans.items():
            if name in ranged:
                continue
            shards: Dict[int, bytes] = {}
            shard_src: Dict[int, int] = {}
            for shard in set(fetch) | (set(have) if lost else set()):
                hit = fetched.get((name, shard))
                if hit is not None:
                    shards[shard], shard_src[shard] = hit
            missing = [s for s in lost if s not in shards]
            if missing:
                # decodability gate: can the FETCHED set regenerate
                # the losses?  (Not `len(shards) < k` — an LRC
                # local-group plan is SMALLER than k by design and
                # still decodes; only the codec can answer.)  A 'no'
                # is an UNFOUND object callers must see — a
                # clean-looking stats dict would hide data loss
                try:
                    codec.minimum_to_decode(set(missing), set(shards))
                except ErasureCodeError:
                    stats["unrecoverable"] = \
                        stats.get("unrecoverable", 0) + 1
                    continue
            obj_attrs = attrs_by_name.get(name, {})
            S_obj = int(obj_attrs["S"]) if "S" in obj_attrs else 1
            # geometry gate: every fetched shard must be ONE
            # consistent length L with L == S_obj * U (attrs) —
            # a mismatched holder (truncated shard, stale attrs)
            # counts the object unrecoverable/skipped instead of
            # an uncaught reshape ValueError killing the whole
            # pool sweep
            lengths = {len(d) for d in shards.values()}
            L = lengths.pop() if len(lengths) == 1 else None
            bad = shards and (
                L is None or (S_obj > 1 and L % S_obj != 0))
            if not bad and shards and "U" in obj_attrs:
                bad = L != S_obj * int(obj_attrs["U"])
            if bad:
                stats["unrecoverable"] = \
                    stats.get("unrecoverable", 0) + 1
                stats["geometry_skipped"] = \
                    stats.get("geometry_skipped", 0) + 1
                continue
            records.append({"pg": pg, "coll": coll, "name": name,
                            "up": up, "holdings": holdings,
                            "shards": shards, "missing": missing,
                            "S": S_obj, "attrs": obj_attrs,
                            "rebuilt": set(), "on_device": {}})
        # -- signature-grouped decode of this PG's rebuilds
        jobs, job_recs = [], []
        for rec in records:
            missing, shards = rec["missing"], rec["shards"]
            if not missing:
                continue
            plan = sorted(codec.minimum_to_decode(set(missing),
                                                  set(shards)))
            # decode-fetch payload only (same semantics as the sim
            # tier's counter: displaced-copy traffic is re-placement,
            # not repair bandwidth)
            stats["repair_bytes_fetched"] = \
                stats.get("repair_bytes_fetched", 0) + \
                sum(len(shards[c]) for c in plan)
            L = len(rec["shards"][plan[0]])
            S_obj = rec["S"]
            if be.words_supported() and L % 4 == 0 and \
                    L % max(S_obj, 1) == 0:
                # [S, n_avail, W]: per-stripe plane geometry, staged
                # onto the codec's device
                stack = np.stack(
                    [np.frombuffer(shards[c], dtype="<i4")
                     .reshape(S_obj, -1) for c in plan], axis=1)
                jobs.append((plan, torch.from_numpy(stack).to(
                    be.codec.device), missing))
                job_recs.append(rec)
            else:
                stackb = np.stack(
                    [np.frombuffer(shards[c], dtype=np.uint8)
                     .reshape(S_obj, -1) for c in plan], axis=1)
                dec = np.asarray(codec.decode_chunks_batch(
                    plan, stackb, missing))
                for i, s in enumerate(missing):
                    shards[s] = np.ascontiguousarray(
                        dec[:, i]).tobytes()
                    rec["rebuilt"].add(s)
                    stats["shards_rebuilt"] += 1
        if jobs:
            decs = be.decode_signature_groups(jobs)
            for rec, dec in zip(job_recs, decs):
                out = to_host(dec)             # [S, n_erased, W]
                for i, s in enumerate(rec["missing"]):
                    rec["shards"][s] = np.ascontiguousarray(
                        out[:, i]).tobytes()
                    rec["on_device"][s] = dec[:, i]
                    rec["rebuilt"].add(s)
                    stats["shards_rebuilt"] += 1
        # -- push surviving copies + rebuilt shards to up targets:
        # submit-all-then-gather on the async streams; put_shard is a
        # replay-stamped mutation, so the one fresh-stream resubmit
        # after a stream death applies at most once
        pending_push = []
        for rec in records:
            up_r, holdings_r = rec["up"], rec["holdings"]
            for shard, data in rec["shards"].items():
                if shard >= len(up_r) or up_r[shard] == ITEM_NONE:
                    continue
                tgt = up_r[shard]
                oid = f"{shard}:{rec['name']}"
                if oid in holdings_r.get(tgt, set()):
                    continue
                pending_push.append((rec, shard, tgt, oid, data))
        # multi-host plane: interleave push submission across target
        # hosts (identity order on a single host — see stripe_order)
        from ..parallel.multihost import stripe_order
        # the pushes' checksums in one batch (on the card while the
        # device crc is on): the sender folds them, no host scan
        push_css = _staged_csums(
            [np.frombuffer(p[4], dtype=np.uint8) for p in pending_push],
            [p[0]["on_device"].get(p[1]) for p in pending_push])
        push_fan = []
        for i in stripe_order([p[2] for p in pending_push]):
            rec, shard, tgt, oid, data = pending_push[i]
            push_fan.append(
                (rec, shard, tgt, oid,
                 self.aio.call_async(tgt, {
                     "cmd": "put_shard", "coll": rec["coll"],
                     "oid": oid, "data": data, "_csums": push_css[i],
                     "attrs": rec["attrs"],
                     "klass": "background_recovery"})))
        for (rec, shard, tgt, oid, _c), (_r, err) in zip(
                push_fan,
                self.aio.gather([c for *_ign, c in push_fan])):
            if err is not None:
                continue          # dropped push: next pass
            rec["holdings"].setdefault(tgt, set()).add(oid)
            if shard not in rec["rebuilt"]:
                stats["shards_copied"] += 1
        return stats

    def _repair_ranged_wire(self, pool: PGPool, be, pg: int,
                            name: str, up: List[int], plan_item,
                            obj_attrs: Dict[str, bytes], holders_of,
                            pushes: List[Tuple]
                            ) -> Dict[str, int]:
        """Minimum-bandwidth single-loss repair over the wire: each
        helper in the codec's SubChunkPlan ships ONLY its repair
        sub-chunk byte ranges (ranged get_shard), ``codec.repair``
        regenerates the lost chunk client-side, and the rebuilt
        shard's push is SUBMITTED async onto ``pushes`` — the caller
        gathers all pushes after its ranged loop (submit-all-then-
        gather) and accounts ``shards_rebuilt``/``ranged_repairs``/
        ``repair_bytes_fetched`` per landed push, so benches/tests
        can assert the byte saving vs k full-chunk reads."""
        codec = be.codec
        _fetch, lost, _have, sub_plan = plan_item
        (lost_shard,) = lost
        coll = [pool.id, pg]
        if "U" not in obj_attrs:
            return {"unrecoverable": 1}
        U = int(obj_attrs["U"])
        S = int(obj_attrs["S"]) if "S" in obj_attrs else 1
        sc = U // codec.get_sub_chunk_count()
        # per-stripe ranges: a striped object's shard file is S
        # independent U-byte codeword chunks back to back
        wants = {(name, c): (holders_of(name, c),
                             [(s * U + off * sc, cnt * sc)
                              for s in range(S) for off, cnt in rg])
                 for c, rg in sorted(sub_plan.items())}
        got = self._gather_shard_fetches(coll, wants)
        if len(got) < len(wants):
            return {"unrecoverable": 1}   # helper lost: next pass
        helpers = {c: np.frombuffer(got[(name, c)][0], dtype=np.uint8)
                   for c, _rg in sub_plan.items()}
        fetched = sum(h.size for h in helpers.values())
        per_stripe = {c: h.size // S for c, h in helpers.items()}
        try:
            rebuilt = np.concatenate([codec.repair(
                lost_shard,
                {c: h[s * per_stripe[c]:(s + 1) * per_stripe[c]]
                 for c, h in helpers.items()}, U)
                for s in range(S)])
        except ErasureCodeError:
            return {"unrecoverable": 1}
        tgt = up[lost_shard] if lost_shard < len(up) else ITEM_NONE
        if tgt == ITEM_NONE:
            return {}
        oid = f"{lost_shard}:{name}"
        pushes.append((self.aio.call_async(tgt, {
            "cmd": "put_shard", "coll": coll, "oid": oid,
            "data": np.ascontiguousarray(rebuilt).tobytes(),
            "attrs": obj_attrs,
            "klass": "background_recovery"}), tgt, oid, fetched))
        return {}

    # ------------------------------------------ batched EC device plane --
    def put_many(self, pool_id: int, names: List[str],
                 datas: List[bytes]) -> Dict[str, int]:
        """Batched EC put: ONE device encode dispatch for all N
        objects (through the shared ECBackend engine), shard bytes
        committed to daemons with the gather-all-commits contract,
        shard plane words staged client-side for zero-copy reads.
        Falls back to per-object put() for non-EC pools / non-device
        codecs.  Returns {name: acked shard count}."""
        pool = self.osdmap.pools[pool_id]
        be = self.ec_backend(pool_id) \
            if pool.type == POOL_ERASURE else None
        if be is None or not be.words_supported():
            return {n: self.put(pool_id, n, d)
                    for n, d in zip(names, datas)}
        snapsets = {}
        if int(self.pool_snaps.get(pool_id, {}).get("seq", 0) or 0):
            for name in names:
                if "@" in name:
                    continue
                pg = self._pg_for(pool, name)
                ss = self._maybe_cow(pool, pg, name)
                if ss is not None:
                    snapsets[name] = (pg, ss)
        from ..cluster.ec_backend import ObjectGeom
        # group by stripe-count class: one encode dispatch per class.
        # Padding EVERY object to the largest object's stripe count
        # would write-amplify a mixed batch (a 100-byte object shipped
        # at a 256 MiB object's geometry); same-S objects share one
        # dispatch with zero amplification beyond their own padding
        by_class: Dict[int, List[int]] = {}
        for i, d in enumerate(datas):
            Si, U = be.batch_geometry([len(d)], pool.stripe_unit)
            by_class.setdefault(Si, []).append(i)
        acked_all: Dict[str, int] = {}
        for S, idxs in by_class.items():
            gnames = [names[i] for i in idxs]
            gdatas = [datas[i] for i in idxs]
            _, U = be.batch_geometry([len(d) for d in gdatas],
                                     pool.stripe_unit)
            stripe = be.k * U
            payload = np.zeros(len(gnames) * S * stripe,
                               dtype=np.uint8)
            for j, d in enumerate(gdatas):
                payload[j * S * stripe:j * S * stripe + len(d)] = \
                    np.frombuffer(d, dtype=np.uint8)
            geom = ObjectGeom(S * stripe, S, U)
            pg_of = {n: self._pg_for(pool, n) for n in gnames}
            sizes = {n: len(d) for n, d in zip(gnames, gdatas)}
            last: Optional[Exception] = None
            for attempt in range(3):
                writes = be.encode_to_writes(pg_of, gnames, payload,
                                             geom, durable=True,
                                             sizes=sizes)
                try:
                    acked = be.submit(writes)
                    break
                except IOError as e:
                    last = e
                    if attempt == 2:
                        raise
                    self._backoff.sleep(attempt)
                    try:
                        self.refresh_map()
                    except (OSError, IOError):
                        pass
            acked_all.update({n: len(t) for n, t in acked.items()})
        for name, (pg, ss) in snapsets.items():
            self._store_snapset(pool, pg, name, ss)
        return acked_all

    def put_many_from_device(self, pool_id: int, names: List[str],
                             payload,
                             durable: bool = False
                             ) -> Dict[str, Dict[int, int]]:
        """Batched EC ingest of an on-device payload ([N*S, k, W]
        int32 plane words on the pool codec's device — a device
        producer's output), encoded in ONE dispatch.  ``durable=False``
        is staged/WAL mode: the ack means the client's HBM holds the
        authoritative shards and flush_staged() defers the daemon
        commit — the BlueStore
        deferred-write contract at client scope (a client crash before
        flush loses the staged writes, exactly like an un-flushed
        writeback cache; use durable=True for commit-on-ack)."""
        pool = self.osdmap.pools[pool_id]
        if pool.type != POOL_ERASURE:
            raise IOError("put_many_from_device requires an EC pool")
        be = self.ec_backend(pool_id)
        if not be.words_supported():
            raise IOError("device put requires the bitsliced jax codec")
        snapsets = {}
        if int(self.pool_snaps.get(pool_id, {}).get("seq", 0) or 0):
            # snapped pool: COW each overwritten head first, exactly
            # like put_many / the sim's put_many_from_device
            for name in names:
                if "@" in name:
                    continue
                pg = self._pg_for(pool, name)
                ss = self._maybe_cow(pool, pg, name)
                if ss is not None:
                    snapsets[name] = (pg, ss)
        from ..cluster.ec_backend import ObjectGeom
        want = be.codec.device
        if not isinstance(payload, torch.Tensor) or \
                payload.dtype != torch.int32 or payload.dim() != 3 or \
                payload.device.type != want.type or \
                want.index not in (None, payload.device.index):
            raise ValueError(
                f"put_many_from_device takes a [N*S, k, W] int32 tensor "
                f"on the codec's device {be.codec.device}")
        S_total = int(payload.shape[0])
        if S_total % len(names):
            raise IOError("payload stripes not divisible by names")
        S = S_total // len(names)
        W = int(payload.shape[-1])
        geom = ObjectGeom(S * be.k * W * 4, S, W * 4)
        pg_of = {n: self._pg_for(pool, n) for n in names}
        writes = be.encode_to_writes(pg_of, names, payload, geom,
                                     durable=durable)
        acked = be.submit(writes)
        for name, (pg, ss) in snapsets.items():
            self._store_snapset(pool, pg, name, ss)
        return acked

    def flush_staged(self, pool_id: int) -> int:
        """Write every dirty client-staged shard through to its
        daemon (the WAL flush half of put_many_from_device).  A shard
        whose target is unreachable or homeless STAYS dirty — the
        device copy remains authoritative and a later flush (after
        the map re-homes it) retries; returns the count flushed.

        The drain is ONE bulk device->host readback per DISTINCT
        staged buffer (shards are columns of shared encode/stripe
        buffers — materialize_bulk slices them host-side) followed by
        an async scatter-gather sweep: every put_shard frame
        pipelines onto its daemon's stream pool round-robin, ONE
        gather for the whole drain instead of a blocking readback +
        RTT per shard.

        ZeroWire: each flushed shard's per-4KiB sub-crcs are computed
        ONCE — on device (ops/crc32_gf2's GF(2) matmul, when the
        backend makes it worthwhile) or by a single host scan — and
        that one Csums feeds the frame crc, the daemon's trusted blob
        csums AND the staging digest; the shard bytes themselves ride
        as memoryviews (no tobytes() materialization)."""
        from ..cluster.device_store import materialize_bulk
        pool = self.osdmap.pools[pool_id]
        by_tgt: Dict[int, List] = {}
        for key, ref in self.dev.dirty_items():
            pid, pg, name, shard = key
            if pid != pool_id:
                continue
            up = self._up(pool, pg)
            tgt = up[shard] if shard < len(up) else ITEM_NONE
            if tgt == ITEM_NONE:
                continue
            by_tgt.setdefault(tgt, []).append((key, ref, pg, name,
                                               shard))
        if not by_tgt:
            return 0
        # bulk readback first: one transfer per distinct buffer
        flat = [it for items in by_tgt.values() for it in items]
        hosts = materialize_bulk([ref for _k, ref, *_r in flat])
        host_of = {}
        csums_of = {}
        i = 0
        for items in by_tgt.values():
            for it in items:
                host_of[it[0]] = hosts[i]
                i += 1
        for key, cs in zip(host_of, _staged_csums(
                list(host_of.values()),
                [it[1] for items in by_tgt.values() for it in items])):
            csums_of[key] = cs
        fan: List[Tuple[Any, int, object]] = []
        # round-robin across daemons so every stream pool fills while
        # the others' frames are still queueing
        queues = {t: list(items) for t, items in by_tgt.items()}
        while queues:
            for tgt in list(queues):
                items = queues[tgt]
                if not items:
                    del queues[tgt]
                    continue
                key, ref, pg, name, shard = items.pop(0)
                cs = csums_of[key]
                fan.append((key, cs.combined,
                            self.aio.call_async(tgt, {
                                "cmd": "put_shard",
                                "coll": [pool_id, pg],
                                "oid": f"{shard}:{name}",
                                "data": _as_buf(host_of[key]),
                                "_csums": cs,
                                "attrs": self._staged_attrs.get(
                                    key, {})})))
        flushed = 0
        fatal: Optional[BaseException] = None
        for (key, crc, comp), (_r, err) in zip(
                fan, self.aio.gather([c for _, _, c in fan])):
            if err is not None:
                # not a fabricated default: the entry STAYS DIRTY in
                # the staging tier and the next flush pass retries it
                # — but only connection-class failures are retryable;
                # a daemon rejection surfaces after the sweep settles
                if not isinstance(err, OSError):
                    fatal = err
                continue
            self.dev.mark_clean(key, crc)
            flushed += 1
        if fatal is not None:
            raise fatal
        return flushed

    def get_many_to_device(self, pool_id: int, names: List[str]):
        """Batched EC read returning each object's [S, k, W] device
        words (client staging hits serve zero-copy; misses upload from
        daemon bytes; degraded objects decode through the
        signature-grouped device path).  Healthy same-geometry objects
        assemble in ONE device dispatch (assemble_many)."""
        be = self.ec_backend(pool_id)
        pool = self.osdmap.pools[pool_id]
        if not be.words_supported():
            raise IOError("device get requires the bitsliced jax codec")
        out: List[Optional[object]] = [None] * len(names)
        items, item_idx = [], []
        for idx, name in enumerate(names):
            pg = self._pg_for(pool, name)
            geom = be.read_geom(pg, name)
            if geom is None:
                raise RemoteObjectMissing(f"{name}: no such object")
            if geom.U == 0:          # legacy single-stripe object
                raw = self.get(pool_id, name)
                raw += b"\0" * ((-len(raw)) % (be.k * 4))
                out[idx] = be.to_words(raw, 1, len(raw) // be.k)
                continue
            items.append((pg, name, geom))
            item_idx.append(idx)
        if items:
            for idx, words in zip(item_idx,
                                  be.read_many_words(items)):
                out[idx] = words
        return out

    # ------------------------------------------------------ cls / watch --
    def exec_cls(self, pool_id: int, name: str, cls: str, method: str,
                 inp: bytes = b"") -> bytes:
        """Object-class call ON THE PRIMARY DAEMON (the wire
        CEPH_OSD_OP_CALL): the method executes inside the OSD process
        through the same ClassHandler the sim uses, and replicates to
        the peer replicas (deterministic re-execution)."""
        pool = self.osdmap.pools[pool_id]
        if pool.type == POOL_ERASURE:
            raise IOError("object classes require a replicated pool")
        pg = self._pg_for(pool, name)
        members = [o for o in self._up(pool, pg) if o != ITEM_NONE]
        if not members:
            raise IOError(f"{name}: no primary for cls call")
        return self.osd_call(members[0], {
            "cmd": "exec_cls", "coll": [pool_id, pg],
            "oid": f"0:{name}", "cls": cls, "method": method,
            "payload": inp, "replicas": members})

    def _watch_primary(self, pool_id: int, name: str):
        pool = self.osdmap.pools[pool_id]
        pg = self._pg_for(pool, name)
        members = [o for o in self._up(pool, pg) if o != ITEM_NONE]
        if not members:
            raise IOError(f"{name}: no primary for watch")
        return members[0], pg

    def watch_register(self, pool_id: int, name: str):
        prim, pg = self._watch_primary(pool_id, name)
        r = self.osd_call(prim, {"cmd": "watch_register",
                                 "coll": [pool_id, pg],
                                 "oid": f"0:{name}"})
        return prim, pg, int(r["cookie"])

    def notify(self, pool_id: int, name: str, payload: bytes = b"",
               timeout: float = 3.0) -> Dict:
        """Notify the object's watchers via its primary daemon and
        gather their acks (Watch/Notify over the wire,
        src/osd/Watch.cc): watchers that do not ack within the
        timeout report as None.

        The server-side wait must never outlive the transporting
        socket's timeout: a notify_wait riding the SHARED per-OSD
        client with ``timeout >= socket timeout`` used to time the
        socket out mid-wait — dropping the shared connection under
        every other caller and surfacing an IOError instead of the
        pending-watcher result.  Waits that fit comfortably inside
        the shared timeout use it; longer waits ride a DEDICATED
        connection whose socket timeout is derived from the wait."""
        prim, pg = self._watch_primary(pool_id, name)
        r = self.osd_call(prim, {"cmd": "notify",
                                 "coll": [pool_id, pg],
                                 "oid": f"0:{name}",
                                 "payload": payload})
        if not r["watchers"]:
            return {"notify_id": r["notify_id"], "acks": {}}
        req = {"cmd": "notify_wait", "notify_id": r["notify_id"],
               "timeout": timeout}
        if timeout < self._osd_timeout - 2.0:
            w = self.osd_call(prim, req)
        else:
            dc = self.new_osd_client(prim, timeout=timeout + 5.0)
            try:
                w = dc.call(req)
            finally:
                dc.close()
        acks = {int(c): a for c, a in w["acks"].items()}
        for c in w.get("pending", []):
            acks[int(c)] = None
        return {"notify_id": r["notify_id"], "acks": acks}

    # ---------------------------------------------------------- status --
    def status(self) -> Dict:
        return self.mon_call({"cmd": "status"})

    def mon_status(self) -> Dict:
        return self.mon_call({"cmd": "mon_status"})

    def osd_fsck(self, osd: int) -> List:
        """On-demand store consistency walk on one live OSD over the
        wire (the asok ``store_fsck`` twin for wire-only callers):
        returns the store's error list — [] is clean."""
        return self.osd_call(osd, {"cmd": "fsck"})

    def close(self) -> None:
        if self._aio is not None:
            self._aio.close()       # stream pools + engine workers
            self._aio = None
        for c in self._osd_clients.values():
            c.close()
        if self.mon is not None:
            self.mon.close()
        if self._admin is not None:
            self._admin.close()
            self._admin = None
            self._admin_path = None


class WireShardIO:
    """ShardIO transport over authenticated daemon sockets — the wire
    half of the PGBackend seam (cluster/ec_backend.py).  Sub-writes
    fan out concurrently across OSD connections (each WireClient
    serializes its own socket; distinct targets run in parallel), and
    every shard this client writes or reads is STAGED in its HBM cache
    as plane words, validated against the daemon's stored checksum on
    reuse — the card-attached client is the EC primary and serves its
    own data zero-copy (ARCHITECTURE.md §4; the at-rest-layout
    property of src/osd/ECBackend.cc:934,1015)."""

    def __init__(self, rc: "RemoteCluster", pool_id: int):
        self.rc = rc
        self.pool_id = pool_id
        # (pg, shard, name) -> target of this client's last committed
        # sub-write: the stray-supersession sweep only needs to run
        # when the shard's home CHANGED (or on first contact, where a
        # stray from before this client's lifetime could exist) — a
        # repeat commit to the same home overwrote the only copy our
        # previous sweep left, so the O(daemons) purge is skipped on
        # the steady-state write path
        self._committed_to: Dict[Tuple[int, int, str], int] = {}

    def _pool(self) -> PGPool:
        return self.rc.osdmap.pools[self.pool_id]

    def up_set(self, pg: int) -> List[int]:
        return self.rc._up(self._pool(), pg)

    # ---------------------------------------------------------- writes --
    def fanout(self, writes):
        """Sub-write fan-out on the ASYNC core: every durable shard is
        submitted to its target's stream pool, and the gather step
        collects every commit before the verdict."""
        rc = self.rc

        sweep: List = []
        results: List = []
        fan: List[Tuple[Any, object, object]] = []
        durable = []
        for w in writes:
            key = (self.pool_id, w.pg, w.name, w.shard)
            data = w.bytes_fn()
            if data is None:
                # staged/WAL mode: the client HBM ref is the
                # authoritative copy until flush_staged() (the
                # BlueStore deferred-write shape; durability contract
                # documented on put_many_from_device)
                rc.dev.put(key, w.ref, None)
                rc._staged_attrs[key] = w.attrs
                results.append(w)
                continue
            durable.append((w, data))
        # ONE checksum pass per sub-write, for the whole fan-out in one
        # batch (on the card by K3's crc leg, from the encode's device
        # buffers, while the device crc is on, as flush_staged does):
        # the same sub-crcs feed the frame crc (combine, no re-scan in
        # the sender), the daemon's trusted blob csums, and the staging
        # digest below
        css = _staged_csums([np.frombuffer(data, dtype=np.uint8)
                             for _w, data in durable],
                            [w.ref for w, _d in durable])
        for (w, data), cs in zip(durable, css):
            fan.append((w, cs, rc.aio.call_async(w.target, {
                "cmd": "put_shard",
                "coll": [self.pool_id, w.pg],
                "oid": f"{w.shard}:{w.name}",
                "data": data, "_csums": cs, "attrs": w.attrs})))
        fatal: Optional[BaseException] = None
        for (w, cs, comp), (_r, err) in zip(
                fan, rc.aio.gather([c for _, _, c in fan])):
            key = (self.pool_id, w.pg, w.name, w.shard)
            if err is not None:
                if not isinstance(err, OSError):
                    # daemon rejection, not a dead connection: the
                    # caller's resend loop cannot fix it — surface it
                    # after every gathered commit is recorded
                    fatal = err
                # a pre-existing staged entry for this shard is now
                # stale relative to the sibling shards that DID land:
                # drop it, or later reads would mix shard versions
                rc.dev.evict(key)
                rc._staged_attrs.pop(key, None)
                # ...and the same hazard exists SERVER-side: any
                # daemon still holding a previous version of this
                # shard would serve it to the any-holder read
                # fallback, mixing versions into a decode.  Purge,
                # mirroring SimShardIO's "no older shard version is
                # ever servable" invariant (failure path only, so
                # the sweep cost lands on the rare case).
                self.purge_shard(w.pg, w.shard, w.name, None)
                self._committed_to.pop((w.pg, w.shard, w.name), None)
                continue
            rc.dev.put(key, w.ref, cs.combined)
            # success supersedes strays: a RE-HOMED shard's previous
            # copy on its old home must not outlive this commit (the
            # peering-time supersession SimShardIO.fanout applies) —
            # without this, killing the new home resurrects the old
            # version through the any-holder fallback and the reader
            # decodes MIXED shard versions to garbage.  The sweep is
            # DEFERRED and batched below: one bulk delete_shards call
            # per daemon per fanout, and only for shards whose memoed
            # home moved (or first contact) — a repeat commit to the
            # memoized home overwrote the only copy the previous
            # sweep left (steady-state writes skip it entirely).
            if self._committed_to.get(
                    (w.pg, w.shard, w.name)) != w.target:
                sweep.append(w)
            rc._staged_attrs[key] = w.attrs
            results.append(w)
        if sweep:
            self._bulk_supersede(sweep)
        if fatal is not None:
            raise fatal
        return results

    def _bulk_supersede(self, sweep) -> None:
        """Batched stray purge for committed sub-writes: ONE
        delete_shards wire call per up daemon, covering every swept
        shard that daemon could hold — so a put_many batch of N new
        objects pays D daemon RTTs total (in parallel), not N*(k+m)*D.
        First-contact writes DO sweep: the client cannot distinguish
        a genuinely-new object from one re-homed before it connected,
        and put_shard's "existed on target" would be exactly the
        wrong signal (a re-homed shard's new target also reports
        not-existed while the stray sits on the old home) — a
        per-shard version attr is the eventual cheap evidence.
        Only a COMPLETE sweep is memoized per shard — a daemon down
        (or erroring) may still hold a stale copy, so that shard's
        next commit sweeps again.  (The memo is per-client
        best-effort — cross-client races remain the domain of
        recovery/scrub, as before.)"""
        import concurrent.futures as cf
        rc = self.rc
        daemons = list(rc.addrs)

        def purge_on(o):
            items = [[[self.pool_id, w.pg], f"{w.shard}:{w.name}"]
                     for w in sweep if w.target != o]
            if not items:
                return True
            if not rc.osdmap.osd_up[o]:
                return False            # unreachable possible holder
            try:
                rc.osd_call(o, {"cmd": "delete_shards",
                                "items": items})
                return True
            except (OSError, IOError):   # noqa: CTL603 — False =
                # "daemon unreached": the sweep is NOT memoized and
                # re-runs on the next commit (deferred retry, not a
                # fabricated result)
                return False
        if len(daemons) <= 1:
            reached = {o: purge_on(o) for o in daemons}
        else:
            with cf.ThreadPoolExecutor(
                    max_workers=min(8, len(daemons))) as ex:
                reached = dict(zip(daemons,
                                   ex.map(purge_on, daemons)))
        for w in sweep:
            memo_key = (w.pg, w.shard, w.name)
            if all(ok for o, ok in reached.items()
                   if o != w.target):
                self._committed_to[memo_key] = w.target
            else:
                self._committed_to.pop(memo_key, None)
        # unbounded-growth backstop: the memo is an optimization, so
        # wholesale reset just costs extra sweeps, never correctness
        if len(self._committed_to) > (1 << 20):
            self._committed_to.clear()

    def purge_shard(self, pg: int, shard: int, name: str,
                    keep_target) -> None:
        self.rc.dev.evict((self.pool_id, pg, name, shard))
        self._purge_daemons(pg, shard, name, keep_target)

    def _purge_daemons(self, pg: int, shard: int, name: str,
                       keep_target) -> bool:
        """Delete the shard from every daemon except ``keep_target``
        (client staging untouched).  Returns True only when every
        other daemon was REACHED — a daemon that is down or errored
        may still hold a stale copy, and callers memoizing "this
        shard is stray-free" must not record an incomplete sweep
        (the revived daemon would serve its old version forever)."""
        rc = self.rc
        complete = True
        for o in list(rc.addrs):
            if o == keep_target:
                continue
            if not rc.osdmap.osd_up[o]:
                complete = False      # unreachable possible holder
                continue
            try:
                rc.osd_call(o, {"cmd": "delete_shard",
                                "coll": [self.pool_id, pg],
                                "oid": f"{shard}:{name}"})
            except (OSError, IOError):
                complete = False
        return complete

    # ----------------------------------------------------------- reads --
    def _digest(self, pg: int, shard: int, name: str) -> Optional[int]:
        """Stored checksum from any holder; None = every reachable
        daemon ANSWERED and none holds the shard (definitive absence).
        Raises IOError when nobody answered — 'unreachable' must not
        read as 'absent' (a transient outage would otherwise evict
        valid client staging)."""
        up = self.up_set(pg)
        srcs = [up[shard]] if shard < len(up) and \
            up[shard] != ITEM_NONE else []
        srcs += [o for o in self.rc.addrs if o not in srcs]
        unreached = 0
        for o in srcs:
            try:
                d = self.rc.osd_call(o, {
                    "cmd": "digest_shard",
                    "coll": [self.pool_id, pg],
                    "oid": f"{shard}:{name}"})
            except (OSError, IOError):
                unreached += 1
                continue
            if d is not None:
                return int(d)
        if unreached:
            # ANY unreachable daemon could be the sole holder: only a
            # full sweep of answers makes absence definitive (a
            # non-holder's None must not evict a valid staged copy)
            raise IOError(f"{name} shard {shard}: {unreached} "
                          f"daemons unreachable for digest")
        return None

    def get_shard_ref(self, pg: int, shard: int, name: str):
        rc = self.rc
        key = (self.pool_id, pg, name, shard)
        dirty = rc.dev.dirty_get(key)
        if dirty is not None:
            return dirty
        if rc.dev.has(key):
            # the digest RTT only VALIDATES an existing staged entry;
            # an absent key goes straight to the byte fetch
            try:
                digest = self._digest(pg, shard, name)
            except (OSError, IOError):
                digest = False    # unreachable: keep the entry
            if digest is not None and digest is not False:
                arr = rc.dev.get(key, digest)
                if arr is not None:
                    return arr
            elif digest is None:
                # definitive absence on the daemons: the staged copy
                # is an orphan of a deleted/rewritten object
                rc.dev.evict(key)
        data = self.get_shard_bytes(pg, shard, name)
        if data is None or len(data) % 4:
            return None
        from ..cluster.device_store import as_ref
        # the host-to-device staging, onto the codec's device; the
        # staging digest (the crc32 of the shard) through the same
        # checksum gate as every other client checksum, from the
        # staged copy
        words = torch.from_numpy(
            np.frombuffer(data, dtype="<i4").copy()).to(
                rc.ec_backend(self.pool_id).codec.device)
        ref = as_ref(words)
        rc.dev.put(key, ref, _staged_csums(
            [np.frombuffer(data, dtype=np.uint8)], [words])[0].combined)
        return ref

    def get_shard_bytes(self, pg: int, shard: int,
                        name: str) -> Optional[bytes]:
        rc = self.rc
        dirty = rc.dev.dirty_get((self.pool_id, pg, name, shard))
        if dirty is not None:
            return to_host(dirty.materialize()).tobytes()
        up = self.up_set(pg)
        srcs = [up[shard]] if shard < len(up) and \
            up[shard] != ITEM_NONE else []
        srcs += [o for o in rc.addrs if o not in srcs]
        for o in srcs:
            try:
                d = rc.osd_call(o, {"cmd": "get_shard",
                                    "coll": [self.pool_id, pg],
                                    "oid": f"{shard}:{name}"})
            except (OSError, IOError):
                continue
            if d is not None:
                return d
        return None

    def getattr(self, pg: int, name: str, shard: int,
                key: str) -> Optional[bytes]:
        rc = self.rc
        akey = (self.pool_id, pg, name, shard)
        if rc.dev.dirty_get(akey) is not None:
            raw = rc._staged_attrs.get(akey, {}).get(key)
            if raw is not None:
                return raw
        up = self.up_set(pg)
        srcs = [up[shard]] if shard < len(up) and \
            up[shard] != ITEM_NONE else []
        srcs += [o for o in rc.addrs if o not in srcs]
        for o in srcs:
            try:
                d = rc.osd_call(o, {"cmd": "getattr_shard",
                                    "coll": [self.pool_id, pg],
                                    "oid": f"{shard}:{name}",
                                    "key": key})
            except (OSError, IOError):
                continue
            if d is not None:
                return d
        return None
