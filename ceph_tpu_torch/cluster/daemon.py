"""Daemon processes: authenticated wire servers for mon and OSD.

The process model: OSDs and the mon
run as REAL operating-system processes, each owning a durable store,
exchanging the typed envelopes over unix-domain sockets with a
cephx-style handshake on every connection (common/auth.py) and
per-frame session MACs (msg/wire.py).  Reference shape: ceph_osd.cc
main wiring messengers + OSD::init (src/ceph_osd.cc:540-551,
src/osd/OSD.cc:3373), ceph_mon main, and the cephx handshake on every
connection (src/auth/cephx/CephxProtocol.h).

Servers here are intentionally compact: a threaded accept loop; each
connection = banner -> auth -> framed request/reply.  Two handshake
modes, matching cephx:

  * secret mode (client <-> mon): the entity proves knowledge of its
    OWN keyring secret; the mon returns a sealed session key.  This is
    the cephx AUTH phase that bootstraps everything else.
  * ticket mode (anything <-> osd): the client presents a ticket
    sealed under the TARGET's secret plus an authorizer; no mon
    round-trip needed (CephxAuthorizeHandler::verify role).

OSD daemons: FileStore-backed shard ops through the mClock scheduler,
peer heartbeats with failure reports to the mon, replicated-write
fan-out to peer OSDs (daemon-to-daemon traffic), and primary-driven
PG recovery (list/pull/push).

Port of ``ceph_tpu/cluster/daemon.py``.  ``main`` takes ``--device``
(default ``cuda``): it becomes the process's package default device,
which the receive verify of ``msg/wire.py`` and the mon's batched
mapper follow.  ``tools/vstart.py`` starts every daemon with
``--device cpu``, so the daemons open no CUDA context and scan their
receive verify on the host, as the reference's daemons do under
``JAX_PLATFORMS=cpu``; without a card and without ``--device cpu`` a
daemon raises at start.  The mon's ``balancer_eval`` raises
``NotImplementedError``: the balancer advisor is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os
import secrets
import socket
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common import auth as cx
from ..common import crcutil
from ..common import faults
from ..common import tracer as _trace
from ..common.admin import AdminServer
from ..common.backoff import ExpBackoff
from ..common.lockdep import LockdepLock
from ..common.op_tracker import mark_active, tracker as _op_tracker
from ..common.perf_counters import perf as _perf
from ..msg import encoding
from ..msg.queue import Envelope
from ..msg import wire

# daemon-tier faultpoints: the ms_inject_socket_failures option is now
# a registry client (name + status field kept for compat), and the
# thrasher's crash/hang axes fire at the op-dispatch phase boundary
# (select a phase by arming with match={"cmd": "put_shard"})
faults.declare("wire.inject_socket_failures",
               "drop the connection mid-request without a reply — the "
               "reference's ms_inject_socket_failures axis, armed "
               "one-in-N from the cluster spec; every client path "
               "must reconnect and retry")
faults.declare("daemon.crash_op",
               "kill this daemon process (os._exit) as a wire op "
               "arrives — the thrashosds kill_osd axis at a chosen "
               "phase (arm with match={'cmd': ...})")
faults.declare("daemon.hang_op",
               "stall a wire op for params['seconds'] (default 0.5) "
               "before dispatch — the stalled-daemon axis feeding the "
               "SLOW_OPS / heartbeat pipelines")

# message types — canonical values live with the framing (msg/wire.py);
# aliased here for the daemon code that grew up around these names
MSG_AUTH_NONCE = wire.MSG_AUTH_NONCE
MSG_AUTH_SECRET = wire.MSG_AUTH_SECRET   # secret-mode proof
MSG_AUTH_TICKET = wire.MSG_AUTH_TICKET   # ticket-mode (ticket + authorizer)
MSG_AUTH_OK = wire.MSG_AUTH_OK
MSG_AUTH_FAIL = wire.MSG_AUTH_FAIL
MSG_REQ = wire.MSG_REQ       # typed-encoded {"cmd": ..., ...}
MSG_REPLY = wire.MSG_REPLY
MSG_ERR = wire.MSG_ERR

# typed wire encoding (msg/encoding.py) — pickle never touches
# network input (reference: typed struct encode/decode,
# src/include/encoding.h)
_dumps = encoding.dumps


class _ShmPoisoned(Exception):
    """A shared-memory doorbell's ring record failed its verify scan
    (bit flip, torn record, client overwrite): the connection must
    DROP without a reply, exactly like a corrupt socket frame —
    an error reply would acknowledge bytes that were never valid."""


def mon_sockets(cluster_dir: str) -> List[str]:
    """The cluster's mon socket paths (single source of the naming
    convention: 'mon.sock' for a lone mon, 'mon.{r}.sock' per rank
    for a quorum).  Consumed by clients, OSDs and vstart alike."""
    try:
        spec = json.load(open(os.path.join(cluster_dir,
                                           "cluster.json")))
        n = int(spec.get("n_mons", 1))
    except FileNotFoundError:
        n = 1
    if n == 1:
        return [os.path.join(cluster_dir, "mon.sock")]
    return [os.path.join(cluster_dir, f"mon.{r}.sock")
            for r in range(n)]


# ---------------------------------------------------------------- server ---

class WireServer:
    """Threaded unix-socket server with mandatory auth handshake."""

    def __init__(self, sock_path: str, service: str, keyring: cx.Keyring,
                 handler: Callable[[str, Dict[str, Any]], Any],
                 secret_mode_keyring: Optional[cx.Keyring] = None,
                 inject_socket_failures: int = 0,
                 net_entity: Optional[str] = None):
        """``handler(entity, request) -> reply_obj`` (may raise).
        ``secret_mode_keyring``: when set (the mon), clients may
        authenticate by entity secret; otherwise only tickets sealed
        under this service's secret are accepted.
        ``inject_socket_failures``: fault injection (the reference's
        ms_inject_socket_failures option, src/common/options.cc) —
        on average one in N requests has its connection dropped
        WITHOUT a reply, exercising every client's reconnect/retry
        path; 0 disables.  Implemented on the faultpoint registry
        (``wire.inject_socket_failures``, seeded from the service
        name so runs reproduce); the registry is process-wide, so the
        last arm in a multi-server process sets the schedule and every
        server in that process drops — daemon processes host exactly
        one server.  The option is only the boot-time arming path: a
        runtime ``fault_injection`` asok arm works identically on a
        daemon whose spec option was 0."""
        self.sock_path = sock_path
        self.service = service
        # this daemon's name in net.partition groups (the service
        # string for OSDs; mons pass their RANKED entity, since
        # "mon." cannot distinguish quorum members in a split)
        self.net_entity = net_entity or service
        self.keyring = keyring
        self.secret_mode_keyring = secret_mode_keyring
        self.handler = handler
        self.inject_socket_failures = int(inject_socket_failures)
        self.injected = 0
        if self.inject_socket_failures > 0:
            faults.arm("wire.inject_socket_failures", mode="one_in",
                       n=self.inject_socket_failures,
                       seed=zlib.crc32(service.encode()))
        self.auth_failures = 0
        self._stop = threading.Event()
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        # reap ring files orphaned by kill9'd clients (a crashed
        # client never reaches its StreamPool.close unlink; the
        # files are sparse but accumulate across chaos soaks)
        from ..msg.shm_ring import sweep_stale
        sweep_stale(os.path.dirname(sock_path) or ".")
        # daemon→client reply rings (RingReply): ONE per client
        # request-ring path, shared by every serving connection of
        # that client's stream pool (a reply doorbell must resolve on
        # whichever stream it arrives; ShmRing's lock makes the
        # cross-connection puts safe).  Refcounted by serving conns —
        # the last close unlinks the file; a kill9'd daemon's orphans
        # are swept by the CLIENT on reconnect (zwreply prefix).
        self._reply_rings: Dict[str, list] = {}
        self._reply_lock = LockdepLock("srv.reply_rings", recursive=False)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(sock_path)
        # deep backlog: injected-drop reconnect storms (every client
        # path re-dialing at once) overflow a 64-entry queue under
        # CPU contention and surface as ECONNREFUSED from a
        # perfectly healthy daemon
        self._sock.listen(512)
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name=f"srv-{service}")
        self._thread.start()

    def _accept_loop(self) -> None:
        import errno
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError as e:
                # TRANSIENT resource pressure must not kill the
                # accept loop: an EMFILE spike (fd exhaustion under
                # reconnect storms / parallel suites) used to return
                # here, after which the still-bound socket's backlog
                # filled and every connect was REFUSED forever — a
                # live daemon that can never be reached again.  Only
                # a closed listener (stop()) ends the loop.
                if e.errno in (errno.EMFILE, errno.ENFILE,
                               errno.ENOBUFS, errno.ENOMEM,
                               errno.EINTR):
                    time.sleep(0.05)
                    continue
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> Tuple[str, bytes]:
        """-> (entity, session_key); raises on any failure."""
        wire.exchange_banners(conn)
        nonce = secrets.token_bytes(16)
        wire.send_frame(conn, Envelope(MSG_AUTH_NONCE, 0, -1, nonce))
        env = wire.recv_frame(conn)
        if env.type == MSG_AUTH_TICKET:
            blob = encoding.loads(env.payload)
            entity, session_key = cx.verify_authorizer(
                self.keyring.secret(self.service), blob["ticket"],
                blob["authorizer"], nonce)
            return entity, session_key
        if env.type == MSG_AUTH_SECRET and self.secret_mode_keyring:
            blob = encoding.loads(env.payload)
            entity = blob["entity"]
            secret = self.secret_mode_keyring.secret(entity)
            import hmac as _hmac
            want = _hmac.new(secret, b"secret-proof" + nonce,
                             "sha256").digest()
            if not _hmac.compare_digest(blob["proof"], want):
                raise cx.AuthError(f"bad secret proof from {entity!r}")
            session_key = secrets.token_bytes(32)
            wire.send_frame(conn, Envelope(
                MSG_AUTH_OK, 0, -1, cx.seal(secret, session_key)))
            return entity, session_key
        raise cx.AuthError(f"unsupported auth frame {env.type:#x}")

    def _acquire_reply_ring(self, client_path: str, size: int):
        """Create-or-join the reply ring paired with one client
        request ring; returns the ShmRing or None (creation failed —
        the reply lane stays off, socket replies still work)."""
        from ..msg.shm_ring import ShmRing
        with self._reply_lock:
            ent = self._reply_rings.get(client_path)
            if ent is not None:
                ent[1] += 1
                return ent[0]
            try:
                ring = ShmRing.create(
                    os.path.dirname(self.sock_path) or ".",
                    self.service, int(size), prefix="zwreply")
            except OSError:
                return None
            self._reply_rings[client_path] = [ring, 1]
            return ring

    def _release_reply_ring(self, client_path: str) -> None:
        with self._reply_lock:
            ent = self._reply_rings.get(client_path)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] > 0:
                return
            del self._reply_rings[client_path]
            ring = ent[0]
        ring.close(unlink=True)

    def _reply_blobs(self, conn, rid: int, reply, key, mode: str,
                     entity: str, reply_ring, reply_toks: dict,
                     reply_sg: bool) -> list:
        """Reply-direction chokepoint (RingReply): route one handler
        reply onto the cheapest lane.  A BulkReply carries the csums
        the store already trusts for its bytes, so in preference
        order: (1) same-host reply ring — the payload crosses via
        mmap and only a one-key doorbell marker rides the typed
        reply: zero copies AND zero send scans; (2) MSG_REPLY_SG
        socket frame — the trusted csums FOLD into the frame crc
        (crc32_combine): zero send scans; (3) legacy typed reply
        (client never advertised reply_sg — blocking WireClient):
        materialized bytes, the send scan runs and is COUNTED,
        exactly the before-lane the bench prices.  A dict carrying
        BulkReply values (the recovery-pull shape) rides the ring
        per-object under a ``_shm_objs`` marker.  Everything else is
        a plain typed reply, unchanged."""
        pc = crcutil._counters()
        if isinstance(reply, wire.BulkReply):
            data, csums = reply.data, reply.csums
            combined = csums.combined if (
                csums is not None and
                csums.length == len(data)) else None
            if reply_ring is not None and len(data) >= wire.SG_MIN:
                tok = reply_ring.put(data, combined)
                if tok is not None:
                    reply_toks[(tok.off, tok.gen)] = tok
                    pc.inc("shm_reply_frames")
                    pc.inc("shm_reply_bytes", len(data))
                    return wire.prepare_frame(
                        conn, MSG_REPLY, rid, -1,
                        [_dumps({"_shm_reply": tok.meta})], key,
                        mode, self.net_entity, entity)
            if reply_sg and len(data) >= wire.SG_MIN:
                return wire.prepare_frame(
                    conn, wire.MSG_REPLY_SG, rid, -1,
                    [wire._U32.pack(0), data], key, mode,
                    self.net_entity, entity, data_csums=csums)
            reply = reply.to_bytes()
        elif isinstance(reply, dict) and any(
                isinstance(v, wire.BulkReply)
                for v in reply.values()):
            if reply_ring is not None:
                out: Dict[str, Any] = {}
                for k, v in reply.items():
                    if isinstance(v, wire.BulkReply) and \
                            len(v.data) >= wire.SG_MIN:
                        comb = v.csums.combined if (
                            v.csums is not None and
                            v.csums.length == len(v.data)) else None
                        tok = reply_ring.put(v.data, comb)
                        if tok is not None:
                            reply_toks[(tok.off, tok.gen)] = tok
                            pc.inc("shm_reply_frames")
                            pc.inc("shm_reply_bytes", len(v.data))
                            out[k] = tok.meta
                            continue
                    out[k] = v.to_bytes() \
                        if isinstance(v, wire.BulkReply) else v
                reply = {"_shm_objs": out}
            else:
                reply = wire.unwrap_bulk(reply)
        return wire.prepare_frame(
            conn, MSG_REPLY, rid, -1, [_dumps(reply)], key, mode,
            self.net_entity, entity)

    def _serve_conn(self, conn: socket.socket) -> None:
        shm_reader = None           # per-connection mapped client ring
        reply_ring = None           # shared daemon→client reply ring
        reply_key: Optional[str] = None   # registry key (client path)
        reply_toks: dict = {}       # (off, gen) -> ShmToken awaiting free
        reply_sg = False            # client understands MSG_REPLY_SG
        try:
            # deep kernel buffers: one pipelined client window should
            # land in as few recv syscalls as possible (syscalls are
            # the priced resource on shared CI hosts)
            for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                try:
                    conn.setsockopt(socket.SOL_SOCKET, opt, 1 << 21)
                except OSError:
                    pass
            try:
                entity, key = self._handshake(conn)
            except (cx.AuthError, wire.WireError, Exception) as e:
                self.auth_failures += 1
                try:
                    wire.send_frame(conn, Envelope(
                        MSG_AUTH_FAIL, 0, -1, str(e).encode()))
                except OSError:
                    pass
                return
            try:
                # the handshake-completion ack is un-MAC'd so a
                # rejected client can still read MSG_AUTH_FAIL's reason;
                # integrity comes from the authorizer + every
                # subsequent frame being MAC'd
                wire.send_frame(conn, Envelope(MSG_AUTH_OK, 0, -1, b""))
            except OSError:
                return
            mode = wire.MODE_SECURE
            # Buffered frame reads + coalesced replies: a pipelined
            # stream lands whole windows of requests in one recv, and
            # their replies leave in one sendmsg — on syscall-priced
            # hosts this is where the multi-stream path's throughput
            # lives.  Replies are FLUSHED before any read that could
            # block (a held reply + a blocked read is a distributed
            # deadlock with a window-limited client).
            rd = wire.SockReader(conn)
            out_blobs: list = []

            def _flush() -> None:
                if out_blobs:
                    wire._sendmsg_all(conn, out_blobs)
                    out_blobs.clear()

            while not self._stop.is_set():
                try:
                    env = rd.try_frame(session_key=key, mode=mode)
                    if env is None:
                        _flush()
                        env = rd.read_frame(session_key=key,
                                            mode=mode)
                except OSError:
                    # covers clean closes (WireClosed) AND rejected
                    # frames (WireError is an IOError == OSError):
                    # a poisoned frame (flip_bit) drops the
                    # connection, the client's retry path reconnects
                    return
                if env.type == wire.MSG_SET_MODE:
                    # authenticated data-mode downgrade (the ms_mode
                    # crc/secure negotiation): ack in the OLD mode —
                    # the client switches only after reading it.
                    # ``reply_sg`` advertises a reader that parses
                    # MSG_REPLY_SG bulk replies; legacy blocking
                    # clients never set it and keep typed replies.
                    blob = encoding.loads(env.payload)
                    want = blob.get("mode")
                    if want not in (wire.MODE_CRC, wire.MODE_SECURE):
                        return
                    reply_sg = bool(blob.get("reply_sg"))
                    try:
                        wire.send_frame(conn, Envelope(
                            MSG_REPLY, env.id, -1,
                            _dumps({"mode": want})),
                            session_key=key, src=self.net_entity,
                            dst=entity, mode=mode)
                    except OSError:
                        return
                    mode = want
                    continue
                if env.type == wire.MSG_SHM_ATTACH:
                    # same-host shared-memory lane negotiation: map
                    # the authenticated client's ring file, but ONLY
                    # from this daemon's own cluster directory — an
                    # arbitrary path from a (still authenticated)
                    # client must not make the daemon mmap foreign
                    # files.  Refusal is an ok=False ack: the client
                    # keeps the pure socket lane.
                    ok = False
                    ack: Dict[str, Any] = {}
                    try:
                        blob = encoding.loads(bytes(env.payload))
                        path = os.path.realpath(str(blob["path"]))
                        root = os.path.realpath(
                            os.path.dirname(self.sock_path))
                        if os.path.dirname(path) == root:
                            from ..msg.shm_ring import RingReader
                            if shm_reader is not None:
                                shm_reader.close()
                            shm_reader = RingReader(
                                path, int(blob["size"]))
                            ok = True
                        if ok and blob.get("reply") and \
                                crcutil.flag("wire_reply_ring"):
                            # RingReply: pair the client's request
                            # ring with a daemon-created reply ring
                            # (same size) and name it in the ack —
                            # same-host gets/recovery pulls go
                            # zero-copy BOTH directions
                            if reply_key is not None and \
                                    reply_key != path:
                                self._release_reply_ring(reply_key)
                                reply_ring = reply_key = None
                            if reply_key is None:
                                r = self._acquire_reply_ring(
                                    path, int(blob["size"]))
                                if r is not None:
                                    reply_ring, reply_key = r, path
                            if reply_ring is not None:
                                ack["reply_path"] = reply_ring.path
                                ack["reply_size"] = reply_ring.size
                    except (OSError, KeyError, ValueError, TypeError):
                        # (EncodingError is a ValueError)
                        # ANY malformed attach (non-dict blob, bad
                        # size type, undecodable payload) is a
                        # refusal, never a torn-down connection —
                        # the client just keeps the socket lane
                        ok = False
                        ack = {}
                    ack["ok"] = ok
                    try:
                        wire.send_frame(conn, Envelope(
                            MSG_REPLY, env.id, -1,
                            _dumps(ack)),
                            session_key=key, src=self.net_entity,
                            dst=entity, mode=mode)
                    except OSError:
                        return
                    continue
                if env.type == wire.MSG_SHM_FREE:
                    # reply-ring reclaim doorbell (rid 0, no reply):
                    # the client consumed these records — their
                    # extents may be reused.  Forge-proof and
                    # idempotent: only (off, gen) pairs THIS conn
                    # allocated resolve; anything else is a no-op.
                    try:
                        for m in encoding.loads(bytes(env.payload)):
                            tok = reply_toks.pop(
                                (int(m[0]), int(m[1])), None)
                            if tok is not None and \
                                    reply_ring is not None:
                                reply_ring.free(tok)
                    except (ValueError, TypeError, IndexError):
                        pass    # malformed free: conn-close reclaims
                    continue
                if env.type not in (MSG_REQ, wire.MSG_REQ_SG):
                    continue
                if faults.fire("net.partition", src=entity,
                               dst=self.net_entity) is not None:
                    # inbound half of a cut: the request frame never
                    # arrived — drop the connection, no reply (covers
                    # peers whose OWN registry is not armed: one
                    # process's arm severs both directions with it)
                    return
                if faults.fire("wire.inject_socket_failures",
                               service=self.service) is not None:
                    # drop the connection mid-op, no reply — the
                    # msgr-failure-injection suite axis, now a
                    # registry client (fire counts on perf("faults")).
                    # No option gate here: armed-or-not lives in the
                    # registry alone, so a runtime asok arm works on a
                    # daemon whose spec option was 0 (an arm that
                    # silently injected nothing would be exactly the
                    # CTL601 failure mode)
                    self.injected += 1
                    return
                try:
                    if env.type == wire.MSG_REQ_SG:
                        # scatter-gather request: bulk payload rides
                        # outside the typed encoding and lands back
                        # on the meta dict's "data" key — as a
                        # zero-copy view over the receive buffer,
                        # with the one-pass verify scan's TRUSTED
                        # sub-crcs alongside (the store consumes them
                        # as ready-made blob csums)
                        meta, data = wire.split_sg(env.payload)
                        req = encoding.loads(meta)
                        req["data"] = data
                        if env.csums is not None:
                            req["_csums"] = env.csums
                    else:
                        req = encoding.loads(bytes(env.payload))
                    shm_meta = req.pop("_shm", None) \
                        if isinstance(req, dict) else None
                    if shm_meta is not None:
                        # shared-memory doorbell: the payload lives
                        # in the client's mapped ring; resolve +
                        # verify it in ONE scan.  A poisoned record
                        # (flip_bit, torn, overwritten) is rejected
                        # like a corrupt socket frame — connection
                        # drop, never a delivered payload.
                        if shm_reader is None:
                            raise IOError(
                                "shm doorbell but no ring attached "
                                "on this connection")
                        try:
                            # receive verify through the device-crc
                            # gate: with wire_device_crc active the
                            # ring bytes are staged to HBM and
                            # checked by the GF(2) matmul — zero
                            # host scans; off/cpu = the counted
                            # host scan, same verdict either way
                            data, csums = shm_reader.read(
                                shm_meta, scanner=wire.receive_csums)
                        except wire.WireError as e:
                            raise _ShmPoisoned(str(e))
                        req["data"] = data
                        req["_csums"] = csums
                    reply = self.handler(entity, req)
                    err = None
                except _ShmPoisoned:
                    return
                except Exception as e:
                    reply, err = None, (type(e).__name__, str(e))
                try:
                    # reply direction carries its own src/dst: a
                    # oneway cut can apply the op yet lose the ack —
                    # the case session replay dedup exists for.
                    # Assembled (faultpoints fired per frame) but
                    # only flushed before a blocking read or past
                    # the batch bound — pipelined requests share one
                    # reply sendmsg.  Bulk replies route through the
                    # RingReply chokepoint (_reply_blobs): reply
                    # ring, MSG_REPLY_SG csum fold, or legacy typed.
                    if err is not None:
                        out_blobs.extend(wire.prepare_frame(
                            conn, wire.MSG_ERR, env.id, -1,
                            [_dumps(err)], key, mode,
                            self.net_entity, entity))
                    else:
                        out_blobs.extend(self._reply_blobs(
                            conn, env.id, reply, key, mode, entity,
                            reply_ring, reply_toks, reply_sg))
                    if sum(len(b) for b in out_blobs) >= (4 << 20):
                        _flush()
                except OSError:
                    return
        finally:
            if reply_key is not None:
                # extents whose reclaim doorbell never arrived
                # (client died mid-get, stream killed): freed here,
                # then this conn's ref dropped — the LAST serving
                # conn's release unlinks the ring file
                if reply_ring is not None:
                    for tok in reply_toks.values():
                        reply_ring.free(tok)
                self._release_reply_ring(reply_key)
            if shm_reader is not None:
                shm_reader.close()
            conn.close()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------- client ---

class WireClient:
    """Authenticated connection to one daemon (reconnects per call on
    failure are the caller's policy; this object is one session)."""

    def __init__(self, sock_path: str, entity: str, *,
                 secret: Optional[bytes] = None,
                 ticket: Optional[bytes] = None,
                 session_key: Optional[bytes] = None,
                 timeout: float = 10.0,
                 peer: Optional[str] = None,
                 mode: str = wire.MODE_SECURE):
        self.entity = entity
        # the peer's entity name, when the caller knows it: the
        # net.partition faultpoint severs (entity -> peer) traffic at
        # connect AND per request frame (asymmetric cuts can still
        # deliver the reverse direction)
        self.peer = peer
        if peer is not None and faults.fire(
                "net.partition", src=entity, dst=peer) is not None:
            raise wire.WireClosed(
                f"fault injected: {entity} -> {peer} partitioned "
                f"(connect refused)")
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(sock_path)
        wire.exchange_banners(self.sock)
        env = wire.recv_frame(self.sock)
        if env.type != MSG_AUTH_NONCE:
            raise wire.WireError("expected auth nonce")
        nonce = env.payload
        if ticket is not None:
            if session_key is None:
                raise ValueError("ticket mode needs the session key")
            self.key = session_key
            wire.send_frame(self.sock, Envelope(
                MSG_AUTH_TICKET, 0, -1, _dumps({
                    "ticket": ticket,
                    "authorizer": cx.make_authorizer(session_key, nonce),
                })))
        elif secret is not None:
            import hmac as _hmac
            proof = _hmac.new(secret, b"secret-proof" + nonce,
                              "sha256").digest()
            wire.send_frame(self.sock, Envelope(
                MSG_AUTH_SECRET, 0, -1,
                _dumps({"entity": entity, "proof": proof})))
            env = wire.recv_frame(self.sock)
            if env.type != MSG_AUTH_OK:
                raise cx.AuthError(env.payload.decode(errors="replace"))
            self.key = cx.unseal(secret, env.payload)
        else:
            raise ValueError("need secret or ticket")
        env = wire.recv_frame(self.sock)      # un-MAC'd completion ack
        if env.type == MSG_AUTH_FAIL:
            raise cx.AuthError(env.payload.decode(errors="replace"))
        if env.type != MSG_AUTH_OK:
            raise cx.AuthError("handshake rejected")
        self._id = 0
        self._lock = LockdepLock("wire.client", recursive=False)
        # buffered reply reads (one recv where hdr/payload/mac used
        # to take three syscalls); created after the handshake so no
        # handshake byte is ever buffered past a raw recv_frame
        self._rd = wire.SockReader(self.sock)
        self.mode = wire.MODE_SECURE
        if mode == wire.MODE_CRC:
            # authenticated downgrade to crc data mode (the
            # Stream._negotiate_crc contract): the request and its
            # ack travel sealed+MAC'd; only then do frames switch to
            # crc'd plaintext under header-only HMAC.  Required for
            # the one-pass handoff — only crc-mode SG frames carry
            # verify-derived trusted csums to the receiver's store.
            wire.send_frame(self.sock, Envelope(
                wire.MSG_SET_MODE, 0, -1,
                _dumps({"mode": wire.MODE_CRC})),
                session_key=self.key, src=self.entity, dst=self.peer)
            env = self._rd.read_frame(session_key=self.key)
            if env.type != MSG_REPLY:
                raise wire.WireError("mode negotiation rejected")
            self.mode = wire.MODE_CRC

    SG_MIN = wire.SG_MIN

    def call(self, req: Dict[str, Any]) -> Any:
        """One request/reply RTT.  A bulk ``data`` payload rides the
        scatter-gather frame tail (MSG_REQ_SG) — same one-pass
        integrity contract as the async streams (the shared
        wire.extract_bulk split): precomputed ``_csums`` fold into
        the frame crc with no sender scan, and the receiver's single
        verify scan hands trusted csums to its store.  This is the
        daemon->replica sub-write path, so without it every replica
        paid a second (store) scan."""
        req, data, csums = wire.extract_bulk(req, "peer_call")
        with self._lock:
            self._id += 1
            rid = self._id
            if data is not None:
                wire.send_frame_sg(self.sock, wire.MSG_REQ_SG, rid,
                                   _dumps(req), data,
                                   session_key=self.key,
                                   src=self.entity, dst=self.peer,
                                   mode=self.mode, data_csums=csums)
            else:
                wire.send_frame(self.sock, Envelope(MSG_REQ, rid, -1,
                                                    _dumps(req)),
                                session_key=self.key,
                                src=self.entity, dst=self.peer,
                                mode=self.mode)
            env = self._rd.read_frame(session_key=self.key,
                                      mode=self.mode)
        if env.type == MSG_ERR:
            wire.raise_reply_error(env.payload)
        return encoding.loads(env.payload)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- mon daemon ---

class MonDaemon:
    """Monitor process: durable map + config + auth ticket server.

    Serves (entity-checked): get_ticket, get_map, osd_boot,
    report_failure, mark_out, status, mon_status, config_get/set,
    health.

    Multi-mon (``n_mons`` > 1 in cluster.json): each rank runs a
    QuorumNode (cluster/mon_quorum.py) — elected leader, replicated
    commit over authenticated mon<->mon wire calls, per-rank durable
    store that replays the quorum log on restart.  Followers forward
    map mutations to the leader (the reference's peons do the same);
    reads serve the local committed state.  Reference:
    src/mon/Elector.h:37, Paxos.{h,cc}, MonitorDBStore.h.
    """

    MUTATIONS = ("osd_boot", "report_failure", "mark_out", "mark_in",
                 "pool_create", "pool_rm",
                 "pool_tier_add", "pool_tier_remove",
                 "pool_snap_create", "pool_snap_remove",
                 "osd_set_flag", "osd_unset_flag",
                 "config_set")

    def __init__(self, cluster_dir: str, rank: int = 0):
        self.dir = cluster_dir
        self.rank = rank
        spec = json.load(open(os.path.join(cluster_dir, "cluster.json")))
        self.spec = spec
        self.n_mons = int(spec.get("n_mons", 1))
        self.keyring = cx.Keyring.load(
            os.path.join(cluster_dir, "keyring.mon"))
        self.entity = f"mon.{rank}" if \
            f"mon.{rank}" in self.keyring.entries else "mon."
        # span attribution for cross-process trace assembly
        _trace.set_service("mon" if self.n_mons == 1
                           else f"mon.{rank}")
        self.tickets = cx.TicketServer(self.keyring)
        from .monitor import Monitor
        from .wal_kv import WalDB
        store = "mon-store" if self.n_mons == 1 else f"mon-store.{rank}"
        self.db = WalDB(os.path.join(cluster_dir, store),
                        fsync=bool(spec.get("fsync", True)))
        base = self._base_map()
        self.mon = Monitor.open(
            base, self.db,
            failure_reports_needed=spec.get("failure_reports_needed", 2))
        # markdown hysteresis (the osd_markdown_log role): wall-clock
        # windows on the process tier; 0 markdowns-to-hold = disabled
        self.mon.configure_flap_dampening(
            count=int(spec.get("osd_flap_markdown_count", 0)),
            window=float(spec.get("osd_flap_window", 60.0)),
            hold=float(spec.get("osd_flap_hold", 5.0)),
            hold_cap=float(spec.get("osd_flap_hold_cap", 30.0)))
        # RLock: the leader's propose path re-enters through the
        # quorum's local apply (handle -> commit_incremental ->
        # propose -> _commit_entry -> _apply_decree)
        self._lock = LockdepLock("mon.daemon")
        self._stop = threading.Event()
        self.quorum = None
        self._peer_mons: Dict[int, WireClient] = {}
        if self.n_mons > 1:
            from .mon_quorum import QuorumNode
            self.quorum = QuorumNode(
                rank, self.n_mons, self.db, self._apply_decree,
                self._send_peer_mon,
                lease_duration=float(spec.get("mon_lease", 2.0)))
            self.mon.set_proposer(self._propose_value)
            self.quorum.replay(0)      # idempotent re-apply after crash
        sock = os.path.join(cluster_dir, "mon.sock") \
            if self.n_mons == 1 else \
            os.path.join(cluster_dir, f"mon.{rank}.sock")
        self.server = WireServer(
            sock, "mon.", self.keyring, self._handle,
            secret_mode_keyring=self.keyring,
            inject_socket_failures=int(
                spec.get("ms_inject_socket_failures", 0)),
            # net.partition group name: must match what CLIENTS derive
            # from the socket basename ("mon.sock" -> "mon",
            # "mon.N.sock" -> "mon.N") — the keyring entity "mon."
            # would make single-mon cuts silently one-sided
            net_entity="mon" if self.n_mons == 1
            else f"mon.{rank}")
        # per-daemon admin socket (`ceph daemon mon.N ...` — the
        # AdminSocket surface: perf dump, config, tracked-op dumps)
        self.admin = AdminServer()
        self.admin.serve(os.path.join(
            cluster_dir, "mon.asok" if self.n_mons == 1
            else f"mon.{rank}.asok"))
        if self.n_mons > 1 and rank == 0:
            # back-compat alias: clients that only know "mon.sock"
            # reach rank 0 through a symlink
            alias = os.path.join(cluster_dir, "mon.sock")
            try:
                if os.path.islink(alias) or os.path.exists(alias):
                    os.unlink(alias)
                os.symlink(f"mon.{rank}.sock", alias)
            except OSError:
                pass
        if self.quorum is not None:
            threading.Thread(target=self._election_loop, daemon=True,
                             name=f"mon.{rank}-elect").start()

    # ------------------------------------------------------ quorum glue --
    def _peer_call(self, rank: int, req: Dict[str, Any]):
        c = self._peer_mons.get(rank)
        if c is None:
            c = WireClient(
                os.path.join(self.dir, f"mon.{rank}.sock"),
                self.entity,
                secret=self.keyring.secret(self.entity), timeout=3.0,
                peer=f"mon.{rank}")
            self._peer_mons[rank] = c
        try:
            return c.call(req)
        except (OSError, IOError):
            self._peer_mons.pop(rank, None)
            try:
                c.close()
            except Exception:
                pass
            raise

    def _send_peer_mon(self, rank: int, msg: Dict[str, Any]):
        return self._peer_call(rank, {"cmd": "quorum", "msg": msg})

    def _apply_decree(self, version: int, blob: bytes) -> None:
        """Commit path on every rank (idempotent: replay after crash
        re-applies only what the service lacks)."""
        from .mon_quorum import decode_decree
        from .monitor import Monitor
        d = decode_decree(blob)
        with self._lock:      # followers apply off quorum threads
            if d["kind"] == "osdmap":
                inc = Monitor._inc_from_json(d["inc"].encode())
                if inc.epoch <= self.mon.osdmap.epoch:
                    return
                self.mon.apply_committed_incremental(inc)
            elif d["kind"] == "config":
                self.mon.apply_committed_config(d["key"], d["value"])

    def _propose_value(self, value) -> bool:
        from .mon_quorum import encode_decree
        from .monitor import Monitor
        if value[0] == "osdmap":
            blob = encode_decree(
                "osdmap", inc=Monitor._inc_json(value[1]).decode())
        else:
            blob = encode_decree("config", key=value[1], value=value[2])
        return self.quorum.propose(blob)

    def _election_loop(self, interval: float = 0.4) -> None:
        """Leader liveness + election trigger.  Rank-staggered retry
        delays bias low ranks to win (ElectionLogic's rank preference
        without the deferral subprotocol).  Every protocol call is
        guarded: a peer dying mid-election (e.g. between granting a
        vote and serving the catch-up fetch) must not kill this
        thread — the loop IS the retry mechanism."""
        time.sleep(0.05 + 0.15 * self.rank)
        while not self._stop.is_set():
            q = self.quorum
            lead = q.leader
            try:
                if lead is None:
                    q.start_election()
                elif lead == self.rank:
                    # leader: extend the read lease on a majority each
                    # round (Paxos::extend_lease).  A leader that can
                    # no longer reach a majority (netsplit minority)
                    # fails here, its own lease expires, and its map
                    # reads stall instead of serving stale state.
                    q.extend_lease()
                elif lead != self.rank:
                    try:
                        self._send_peer_mon(lead, {"q": "ping"})
                    except Exception:
                        with self._lock:
                            if q.leader == lead:
                                q.leader = None
                        time.sleep(0.05 + 0.15 * self.rank)
                        q.start_election()
            except Exception as e:
                from ..common.log import dout
                dout("mon", 5, f"mon.{self.rank} election round "
                               f"failed: {e!r}")
            time.sleep(interval)

    def _base_map(self):
        from ..placement.compiler import compile_crushmap
        from .osdmap import OSDMap, PGPool
        cmap = compile_crushmap(
            open(os.path.join(self.dir, "crushmap.txt")).read())
        m = OSDMap(cmap)
        m.mark_all_in_up()
        for p in self.spec["pools"]:
            m.add_pool(PGPool(**p))
        return m

    def map_blob(self) -> Dict[str, Any]:
        from ..placement.compiler import decompile_crushmap
        m = self.mon.osdmap
        # pools come from the LIVE map (committed incrementals create
        # and remove them at runtime), not the static bootstrap spec
        pools = [{"id": p.id, "name": p.name, "type": p.type,
                  "size": p.size, "min_size": p.min_size,
                  "pg_num": p.pg_num, "crush_rule": p.crush_rule,
                  "erasure_code_profile": p.erasure_code_profile,
                  "stripe_unit": p.stripe_unit,
                  "tier_of": p.tier_of, "read_tier": p.read_tier,
                  "write_tier": p.write_tier,
                  "cache_mode": p.cache_mode}
                 for p in m.pools.values()]
        return {
            "epoch": m.epoch,
            "crush_text": decompile_crushmap(m.crush),
            "pools": pools,
            "flags": sorted(m.flags),
            "pool_id_max": m.pool_id_max,
            "osd_up": [bool(v) for v in m.osd_up[:m.max_osd]],
            "osd_weight": [int(v) for v in m.osd_weight[:m.max_osd]],
            "addrs": {str(i): os.path.join(self.dir, f"osd.{i}.sock")
                      for i in range(m.max_osd)},
            "mons": ([os.path.join(self.dir, "mon.sock")]
                     if self.n_mons == 1 else
                     [os.path.join(self.dir, f"mon.{r}.sock")
                      for r in range(self.n_mons)]),
            "pool_snaps": {
                str(p["id"]): (self.mon.config_get(
                    f"pool.{p['id']}.snaps") or
                    {"seq": 0, "snaps": {}})
                for p in pools},
        }

    def _osd_probe(self, osd: int, req: Dict[str, Any]) -> Any:
        """One short-lived authenticated mon -> OSD call (the mon
        holds every service secret, so it mints its own ticket)."""
        ticket, key_box = self.tickets.grant(self.entity,
                                             f"osd.{osd}")
        key = cx.open_key_box(self.keyring.secret(self.entity),
                              key_box)
        c = WireClient(os.path.join(self.dir, f"osd.{osd}.sock"),
                       self.entity, ticket=ticket, session_key=key,
                       timeout=2.0, peer=f"osd.{osd}")
        try:
            return c.call(req)
        finally:
            c.close()

    def _count_pool_objects(self, pool_id: int) -> int:
        """Best-effort object count for one pool across the OSDs
        (replica-counted — callers gate on nonzero, not the value).
        An OSD that cannot be checked — marked down, or up but
        unreachable — counts as holding data: a safety gate must not
        read 'cannot check' as 'empty' (a down OSD may hold the only
        copies of acknowledged cache writes; ``force`` is the
        operator override)."""
        m = self.mon.osdmap
        total = 0
        for osd in range(m.max_osd):
            if not m.osd_exists[osd]:
                continue
            if not m.osd_up[osd]:
                total += 1      # down holder is unverifiable: blocks
                continue
            try:
                total += int(self._osd_probe(
                    osd, {"cmd": "count_pool", "pool": pool_id}))
            except (OSError, IOError, cx.AuthError):
                total += 1      # unverifiable holder blocks the gate
        return total

    def _forward_to_leader(self, entity: str,
                           req: Dict[str, Any]) -> Any:
        lead = self.quorum.leader
        if lead is None:
            raise IOError("mon quorum has no leader (election pending)")
        fwd = dict(req)
        fwd["fwd_entity"] = entity
        return self._peer_call(lead, {"cmd": "_forwarded",
                                      "req": fwd})["reply"]

    def _handle(self, entity: str, req: Dict[str, Any]) -> Any:
        cmd = req["cmd"]
        if cmd == "quorum":
            # mon<->mon consensus traffic only
            if not entity.startswith("mon."):
                raise cx.AuthError(f"{entity} may not speak quorum")
            return self.quorum.handle(req["msg"])
        if cmd == "mon_status":
            q = self.quorum
            return {"rank": self.rank, "n_mons": self.n_mons,
                    "leader": None if q is None else q.leader,
                    "election_epoch":
                        0 if q is None else q.election_epoch,
                    "committed": 0 if q is None else q.committed,
                    "readable": True if q is None else q.readable(),
                    "epoch": self.mon.osdmap.epoch}
        if cmd == "_forwarded":
            # leader-side unwrap of a peon-forwarded mutation: the
            # peon (a mon) asserts the original requester identity
            if not entity.startswith("mon."):
                raise cx.AuthError(f"{entity} may not forward")
            inner = dict(req["req"])
            orig = inner.pop("fwd_entity")
            return {"reply": self._handle(orig, inner)}
        if (self.quorum is not None and
                cmd in self.MUTATIONS + ("report_slow_ops", "health",
                                         "report_store_health",
                                         "report_perf",
                                         "cluster_stats",
                                         "balancer_eval")
                and self.quorum.leader != self.rank):
            # slow-op/perf rollup state is leader-local (transient
            # health + stats, not a quorum decree): reports AND their
            # queries both forward so they meet on the same mon no
            # matter which socket each caller happened to connect to
            return self._forward_to_leader(entity, req)
        drain_count = None
        if cmd == "pool_tier_remove" and \
                not bool(req.get("force", False)):
            # the OSD drain probes run OUTSIDE the mon lock: one
            # 2s-timeout wire call per OSD would otherwise stall
            # every other handler (heartbeats, boots, map fetches)
            # behind a single admin command.  The unlocked osdmap
            # reads are benign (worst case a stale up view — probes
            # fail conservative); existence/relationship are checked
            # FIRST so an invalid request fails instantly instead of
            # paying the probe sweep, and re-validated under the
            # lock before committing.
            m0 = self.mon.osdmap
            b0 = m0.pools.get(int(req["base"]))
            c0 = m0.pools.get(int(req["cache"]))
            if b0 is None or c0 is None:
                raise ValueError("tier remove: no such pool")
            if b0.read_tier != int(req["cache"]) or \
                    c0.tier_of != int(req["base"]):
                raise ValueError(
                    f"tier remove: pool {req['cache']} is not a "
                    f"tier of pool {req['base']}")
            drain_count = self._count_pool_objects(int(req["cache"]))
        with self._lock:
            if cmd == "report_slow_ops":
                # daemonized OSDs roll their OpTracker slow-op
                # summaries up into this mon's SLOW_OPS health check
                # (the reference mon's per-daemon health report
                # ingestion); under _lock — wire handlers run on
                # per-connection threads
                if not entity.startswith("osd."):
                    raise cx.AuthError(
                        f"{entity} may not report slow ops")
                self.mon.record_daemon_slow_ops(
                    entity, req.get("summary") or {})
                return {"ok": True}
            if cmd == "report_store_health":
                # boot-fsck damage rollup (STORE_DAMAGED): transient
                # leader-local health state like the slow-op reports
                if not entity.startswith("osd."):
                    raise cx.AuthError(
                        f"{entity} may not report store health")
                self.mon.record_store_damage(
                    entity, int(req.get("errors", 0)),
                    repaired=int(req.get("repaired", 0)))
                return {"ok": True}
            if cmd == "report_perf":
                # ClusterTelemetry stats ingestion (the mgr-module
                # PGMap/prometheus role): each daemon's heartbeat
                # ships its perf counters, OpTracker log2 histograms
                # and store utilization; the leader-local aggregator
                # merges them into cluster p50/p99/p999, io rates and
                # per-OSD utilization (leader-local like slow ops)
                if not (entity.startswith("osd.") or
                        entity.startswith("client.")):
                    raise cx.AuthError(
                        f"{entity} may not report perf")
                # reports are attributed to the AUTHENTICATED wire
                # entity, never a caller-chosen name — a client must
                # not be able to overwrite osd.0's utilization row
                self.mon.record_daemon_perf(
                    entity, req.get("report") or {})
                return {"ok": True}
            if cmd == "cluster_stats":
                # the aggregated cluster view (`ceph -s` io lines,
                # `ceph df`, `ceph osd df`, the cluster Prometheus
                # scrape text when {"metrics": True}), plus the
                # ClusterScope sub-queries: {"history": {...}} range-
                # queries the leader's metrics-history rings (`ceph
                # telemetry history`) and {"heat": {...}} merges the
                # per-OSD PG heat tables (`ceph pg heat`)
                cs = self.mon.cluster_stats
                hq = req.get("history")
                if hq is not None:
                    return cs.history.query(
                        str(hq.get("counter", "osd.io.wr_ops")),
                        daemon=hq.get("daemon"),
                        since=hq.get("since"),
                        until=hq.get("until"))
                heat_q = req.get("heat")
                if heat_q is not None:
                    pool = heat_q.get("pool")
                    top = heat_q.get("top")
                    return {
                        "pgs": cs.pg_heat(
                            pool=None if pool is None else int(pool),
                            top=None if top is None else int(top)),
                        "osds": cs.osd_heat(),
                    }
                out = cs.dump()
                if bool(req.get("metrics", False)):
                    out["prometheus"] = cs.render_prometheus()
                return out
            if cmd == "balancer_eval":
                # ClusterScope balancer ADVISOR: score the current
                # mapping from heat x utilization history and propose
                # upmap moves as a REPORT — dry-run only, nothing here
                # may touch the osdmap (asserted: epoch unchanged)
                raise NotImplementedError(
                    "balancer_eval needs mgr/balancer_advisor.py and "
                    "cluster/balancer.py, which are not ported yet "
                    "(ROADMAP queue A, item 8)")
            if cmd == "health":
                # PG_DEGRADED needs the batched mapper (a compile in
                # this daemon) — opt-in via {"pgs": True}
                checks = self.mon.health(
                    include_pg_state=bool(req.get("pgs", False)))
                worst = "HEALTH_OK"
                if any(c.severity == "HEALTH_ERR" for c in checks):
                    worst = "HEALTH_ERR"
                elif checks:
                    worst = "HEALTH_WARN"
                return {"status": worst,
                        "checks": [{"code": c.code,
                                    "severity": c.severity,
                                    "summary": c.summary}
                                   for c in checks]}
            if cmd == "get_ticket":
                service = req["service"]
                ticket, key_box = self.tickets.grant(entity, service)
                return {"ticket": ticket, "key_box": key_box}
            if cmd == "get_map":
                if self.quorum is not None and \
                        not self.quorum.readable():
                    # minority-side mon: the read lease expired and a
                    # majority may be committing epochs this rank
                    # cannot see — STALL (IOError = retryable) rather
                    # than serve a stale map as fresh; the client's
                    # mon failover rotates to a majority mon
                    raise IOError(
                        f"{self.entity}: no quorum read lease "
                        f"(possible minority partition) — map reads "
                        f"stalled, retry another mon")
                return self.map_blob()
            if cmd == "osd_boot":
                osd = int(req["osd"])
                if entity != f"osd.{osd}":
                    raise cx.AuthError(
                        f"{entity} cannot boot osd.{osd}")
                if not self.mon.osd_boot(osd):
                    # flap dampening: a markdown-storm OSD is HELD
                    # down for its backoff; the daemon's heartbeat
                    # keeps re-announcing and eventually lands
                    return {"epoch": self.mon.osdmap.epoch,
                            "held": True,
                            "hold": self.mon.flap_status(osd)}
                return {"epoch": self.mon.osdmap.epoch}
            if cmd == "osd_set_flag":
                if not self.mon.set_flag(str(req["flag"]), True):
                    raise IOError("set flag: no quorum")
                return {"epoch": self.mon.osdmap.epoch,
                        "flags": sorted(self.mon.osdmap.flags)}
            if cmd == "osd_unset_flag":
                if not self.mon.set_flag(str(req["flag"]), False):
                    raise IOError("unset flag: no quorum")
                return {"epoch": self.mon.osdmap.epoch,
                        "flags": sorted(self.mon.osdmap.flags)}
            if cmd == "report_failure":
                if not entity.startswith("osd."):
                    raise cx.AuthError("only OSDs report failures")
                marked = self.mon.report_failure(int(req["target"]),
                                                 int(entity[4:]))
                return {"marked_down": marked,
                        "epoch": self.mon.osdmap.epoch}
            if cmd == "mark_out":
                inc = self.mon.next_incremental()
                inc.new_weight[int(req["osd"])] = 0
                if not self.mon.commit_incremental(inc):
                    # IOError = retryable at the client (mon_call
                    # backs off and retries/rotates): a quorum round
                    # that transiently failed must NOT ack with an
                    # unchanged epoch as if it committed
                    raise IOError("mark_out: no quorum")
                return {"epoch": self.mon.osdmap.epoch}
            if cmd == "mark_in":
                inc = self.mon.next_incremental()
                inc.new_weight[int(req["osd"])] = 0x10000
                if not self.mon.commit_incremental(inc):
                    raise IOError("mark_in: no quorum")
                return {"epoch": self.mon.osdmap.epoch}
            if cmd == "pool_create":
                # `ceph osd pool create` (OSDMonitor::prepare_new_pool):
                # the new pool rides one committed incremental, so every
                # map subscriber learns it atomically
                m = self.mon.osdmap
                spec = {"name": req["name"],
                        "type": int(req.get("type", 1)),
                        "size": int(req.get("size", 3)),
                        "min_size": int(req.get("min_size", 2)),
                        "pg_num": int(req.get("pg_num", 16)),
                        "crush_rule": int(req.get("crush_rule", 0)),
                        "erasure_code_profile":
                            req.get("erasure_code_profile", "")}
                existing = next((p for p in m.pools.values()
                                 if p.name == req["name"]), None)
                if existing is not None:
                    # idempotent on an identical spec (a retried
                    # request whose reply was lost must not report a
                    # committed create as failed); a DIFFERENT spec
                    # under the same name is a genuine conflict
                    same = all(getattr(existing, k) == v
                               for k, v in spec.items())
                    if same:
                        return {"pool_id": existing.id,
                                "epoch": m.epoch, "existed": True}
                    raise ValueError(
                        f"pool {req['name']!r} already exists "
                        "with a different spec")
                # NEVER reuse a deleted pool's id (data exposure:
                # surviving objects/snap state would leak into the
                # new pool) — allocate past the high-water mark
                pid = max(m.pool_id_max, max(m.pools, default=0)) + 1
                inc = self.mon.next_incremental()
                inc.new_pools[pid] = spec
                if not self.mon.commit_incremental(inc):
                    raise IOError("pool create: no quorum")
                return {"pool_id": pid, "epoch": m.epoch,
                        "existed": False}
            if cmd == "pool_rm":
                m = self.mon.osdmap
                pid = next((p.id for p in m.pools.values()
                            if p.name == req["name"]), None)
                if pid is None:
                    # idempotent: a retried rm whose first reply was
                    # lost already succeeded
                    return {"pool_id": None, "epoch": m.epoch,
                            "existed": False}
                inc = self.mon.next_incremental()
                inc.old_pools.append(pid)
                if not self.mon.commit_incremental(inc):
                    raise IOError("pool rm: no quorum")
                # the dead pool's committed snap state goes with it
                self.mon.config_set(f"pool.{pid}.snaps",
                                    {"seq": 0, "snaps": {}})
                return {"pool_id": pid, "epoch": m.epoch,
                        "existed": True}
            if cmd == "pool_tier_add":
                # 'osd tier add base cache + cache-mode writeback'
                # (OSDMonitor prepare_command tier add role): tier
                # wiring is committed MAP state, a quorum incremental
                m = self.mon.osdmap
                base, cache = int(req["base"]), int(req["cache"])
                mode = req.get("mode", "writeback")
                if mode != "writeback":
                    raise ValueError(
                        f"cache mode {mode!r} not implemented "
                        f"(writeback only)")
                if base == cache:
                    raise ValueError("tier add: base == cache")
                if base not in m.pools or cache not in m.pools:
                    raise ValueError("tier add: no such pool")
                if m.pools[cache].type != 1:     # POOL_REPLICATED
                    raise ValueError(
                        "cache tier must be a replicated pool")
                if m.pools[base].type != 1:
                    # whole-object COPY_FROM would read one EC shard
                    # as the object; refuse rather than corrupt
                    raise ValueError(
                        "tiering over an EC base pool unsupported")
                if m.pools[base].read_tier >= 0 or \
                        m.pools[base].tier_of >= 0 or \
                        m.pools[cache].tier_of >= 0 or \
                        m.pools[cache].read_tier >= 0:
                    # no re-tiering and no tier CHAINS
                    raise ValueError("tier add: pool already tiered")
                snaps = self.mon.config_get(
                    f"pool.{base}.snaps") or {}
                if snaps.get("snaps") or m.pools[base].snaps:
                    # tier routing would run COW against the cache
                    # pool's empty snap context and skip clones (the
                    # snap SEQ may outlive deleted snapshots; only
                    # LIVE snapshots make tiering unsafe)
                    raise ValueError(
                        "tiering over a snapshotted pool unsupported")
                inc = self.mon.next_incremental()
                inc.new_pool_tier[cache] = {"tier_of": base,
                                            "cache_mode": mode}
                inc.new_pool_tier[base] = {"read_tier": cache,
                                           "write_tier": cache}
                if not self.mon.commit_incremental(inc):
                    raise IOError("tier add: no quorum")
                return {"epoch": self.mon.osdmap.epoch}
            if cmd == "pool_tier_remove":
                # server-side gate (OSDMonitor 'osd tier remove'
                # role): the mon — the commit point — verifies the
                # tier RELATIONSHIP and that the cache pool is
                # drained, closing the TOCTOU where only the client
                # checked and a racing write could strand
                # acknowledged data out of the read path
                m = self.mon.osdmap
                base, cache = int(req["base"]), int(req["cache"])
                bp, cp = m.pools.get(base), m.pools.get(cache)
                if bp is None or cp is None:
                    raise ValueError("tier remove: no such pool")
                if bp.read_tier != cache or cp.tier_of != base:
                    raise ValueError(
                        f"tier remove: pool {cache} is not a tier "
                        f"of pool {base}")
                if drain_count is not None:
                    held = drain_count
                    if held:
                        # IOError: surfaces as IOError at the client
                        # (retryable operator condition, like the
                        # no-quorum refusal), unlike the ValueError
                        # config mistakes above
                        raise IOError(
                            f"tier remove: cache pool still holds "
                            f"~{held} objects (down/unreachable "
                            f"daemons count as holding) — drain "
                            f"first (tier_agent_work + evict), or "
                            f"force")
                inc = self.mon.next_incremental()
                inc.new_pool_tier[cache] = {"tier_of": -1,
                                            "cache_mode": ""}
                inc.new_pool_tier[base] = {"read_tier": -1,
                                           "write_tier": -1}
                if not self.mon.commit_incremental(inc):
                    raise IOError("tier remove: no quorum")
                return {"epoch": self.mon.osdmap.epoch}
            if cmd == "pool_snap_create":
                # pool snapshot state is COMMITTED mon state (the
                # pg_pool_t::snap_seq + snaps role, committed through
                # the quorum's config decree path)
                pid = int(req["pool"])
                if self.mon.osdmap.pools.get(pid) is not None and \
                        self.mon.osdmap.pools[pid].write_tier >= 0:
                    raise ValueError(
                        "pool snapshots on a tiered base pool "
                        "unsupported")
                cur = self.mon.config_get(f"pool.{pid}.snaps") or \
                    {"seq": 0, "snaps": {}}
                # retry-idempotent (mon_call resends after a lost
                # reply): an already-present name returns its existing
                # seq instead of minting a duplicate id
                for s, n in cur["snaps"].items():
                    if n == req["name"]:
                        return {"snap_seq": int(s)}
                seq = int(cur["seq"]) + 1
                snaps = dict(cur["snaps"])
                snaps[str(seq)] = req["name"]
                if not self.mon.config_set(
                        f"pool.{pid}.snaps",
                        {"seq": seq, "snaps": snaps}):
                    raise IOError("snap create: no quorum")
                return {"snap_seq": seq}
            if cmd == "pool_snap_remove":
                pid = int(req["pool"])
                cur = self.mon.config_get(f"pool.{pid}.snaps") or \
                    {"seq": 0, "snaps": {}}
                snaps = {s: n for s, n in cur["snaps"].items()
                         if n != req["name"]}
                if not self.mon.config_set(
                        f"pool.{pid}.snaps",
                        {"seq": int(cur["seq"]), "snaps": snaps}):
                    raise IOError("snap remove: no quorum")
                return {"snaps": snaps}
            if cmd == "pool_snap_ls":
                pid = int(req["pool"])
                return self.mon.config_get(f"pool.{pid}.snaps") or \
                    {"seq": 0, "snaps": {}}
            if cmd == "config_set":
                # central config db (ConfigMonitor role): committed
                # through the quorum's decree path like every other
                # mon mutation
                if not self.mon.config_set(req["key"], req["value"]):
                    raise IOError("config set: no quorum")
                return {"ok": True}
            if cmd == "config_get":
                return {"value": self.mon.config_get(req["key"])}
            if cmd == "status":
                m = self.mon.osdmap
                return {"epoch": m.epoch,
                        "n_up": int(sum(m.osd_up[:m.max_osd])),
                        "n_osds": m.max_osd}
            raise ValueError(f"unknown mon command {cmd!r}")

    def run_forever(self) -> None:
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass


# ------------------------------------------------------------- osd daemon ---

class OSDDaemon:
    """OSD process: durable FileStore + scheduler + wire server +
    heartbeats + replicated fan-out + primary recovery."""

    def __init__(self, osd_id: int, cluster_dir: str):
        self.id = osd_id
        self.dir = cluster_dir
        self.entity = f"osd.{osd_id}"
        # span attribution for cross-process trace assembly
        _trace.set_service(self.entity)
        self.keyring = cx.Keyring.load(
            os.path.join(cluster_dir, f"keyring.osd.{osd_id}"))
        spec = json.load(open(os.path.join(cluster_dir, "cluster.json")))
        store_path = os.path.join(cluster_dir, f"osd.{osd_id}.store")
        # objectstore backend selection (the reference's osd_objectstore
        # option, src/common/options.cc): bluestore is the flagship
        # block-device extent store, filestore the log-structured one
        backend = spec.get("objectstore", "bluestore")
        # daemons skip the full csum walk at mount by default (the
        # reference ships bluestore_fsck_on_mount=false: restart
        # latency must not scale with store size); opt in via the spec
        fsck_on_mount = bool(spec.get("fsck_on_mount", False))
        if backend == "bluestore":
            from .bluestore import BlueStore
            self.store = BlueStore(
                store_path, fsync=bool(spec.get("fsync", True)),
                device_bytes=int(spec.get("bluestore_device_bytes",
                                          1 << 28)),
                min_alloc=int(spec.get("bluestore_min_alloc_size",
                                       4096)),
                compression=spec.get(
                    "bluestore_compression_algorithm") or None,
                fsck_on_mount=fsck_on_mount)
        elif backend == "memstore":
            from .objectstore import MemStore
            self.store = MemStore()
        else:
            from .filestore import FileStore
            self.store = FileStore(
                store_path, fsync=bool(spec.get("fsync", True)),
                fsck_on_mount=fsck_on_mount)
        # power-loss boot fsck (the CrashDev pipeline): a BlockDevice
        # power cut dropped a POWER_LOSS marker in the store tree —
        # quarantine torn objects BEFORE serving (fsck repair=True
        # drops their onode rows; peering recovery re-replicates) and
        # report the count up the heartbeat so the mon raises
        # STORE_DAMAGED.  The count clears on a later clean fsck
        # (`ceph daemon osd.N store_fsck [repair]`).
        from .blockdev import (clear_power_loss_markers,
                               power_loss_markers)
        self.store_fsck_errors = 0
        self.store_fsck_repaired = 0
        self._store_reported = 0
        if power_loss_markers(store_path):
            bad = self.store.fsck(repair=True)
            self.store_fsck_errors = len(bad)
            self.store_fsck_repaired = len(bad)
            clear_power_loss_markers(store_path)
        from ..common.options import config as _config
        from ..msg.scheduler import MClockScheduler, QoS, tenant_class
        cfg = _config()
        lim = float(cfg.get("osd_mclock_scheduler_client_lim"))
        self.sched = MClockScheduler(tenant_default=QoS(
            reservation=float(
                cfg.get("osd_mclock_scheduler_client_res")),
            weight=float(cfg.get("osd_mclock_scheduler_client_wgt")),
            limit=lim if lim > 0 else float("inf")))
        # per-tenant QoS overrides from the cluster spec (the
        # osd_mclock_scheduler_client_* per-client profiles): tenants
        # named here get their own (r, w, l); unnamed tenants vivify
        # with the config defaults above
        for t, q in (spec.get("qos_tenants") or {}).items():
            tlim = float(q.get("lim", 0.0))
            self.sched.set_qos(tenant_class(t), QoS(
                reservation=float(q.get("res", 0.0)),
                weight=float(q.get("wgt", 1.0)),
                limit=tlim if tlim > 0 else float("inf")))
        self._sched_lock = LockdepLock("osd.sched", recursive=False)
        # durable per-PG op logs (process-tier PGLog, daemon_pglog.py)
        from .daemon_pglog import DurablePGLog
        self._pglogs: Dict[Tuple[int, int], DurablePGLog] = {}
        self._pglog_lock = LockdepLock("osd.pglog", recursive=False)
        # per-PG write serialization (the reference's PG lock): version
        # assignment + log append + apply must be atomic per PG across
        # the thread-per-connection wire server
        self._pg_locks: Dict[Tuple[int, int], LockdepLock] = {}
        self._peers: Dict[int, WireClient] = {}
        self._peer_lock = LockdepLock("osd.peer", recursive=False)
        self._mon: Optional[WireClient] = None
        self._map: Dict[str, Any] = {}
        self._stop = threading.Event()
        # watch/notify state (src/osd/Watch.cc role): in-memory and
        # connection-equivalent — watches die with the daemon, exactly
        # as the reference's die with the session; clients re-register
        self._watch_lock = LockdepLock("osd.watch", recursive=False)
        self._watchers: Dict[Tuple, Dict[int, list]] = {}
        self._watch_next = 1
        self._notify_state: Dict[int, Dict[str, Any]] = {}
        # in-OSD object classes (ClassHandler, shared with the sim)
        self._class_handler = None
        self.server = WireServer(
            os.path.join(cluster_dir, f"osd.{osd_id}.sock"),
            self.entity, self.keyring, self._handle,
            inject_socket_failures=int(
                spec.get("ms_inject_socket_failures", 0)))
        # per-daemon admin socket (`ceph daemon osd.N dump_historic_ops
        # | perf dump | ...` — each OSD process owns its tracker state;
        # instantiate the tracker eagerly so its perf group and dump
        # surfaces exist before the first tracked op arrives)
        _op_tracker()
        self.admin = AdminServer()
        # `ceph daemon osd.N store_fsck [repair]` — the on-demand
        # store consistency walk (and the operator's way to clear a
        # STORE_DAMAGED report after recovery healed the quarantine)
        self.admin.register("store_fsck", self._admin_store_fsck)
        self.admin.serve(os.path.join(cluster_dir,
                                      f"osd.{osd_id}.asok"))
        self._hb_misses: Dict[int, int] = {}
        self._slow_reported = 0       # last slow-op count sent to mon
        # messenger sessions (the reference's Session + pg-log reqid
        # dup detection, collapsed to one table): a client carries a
        # session id + per-session op seq across RECONNECTS, so a
        # write whose reply was lost to a cut/drop is replayed and
        # applied AT MOST ONCE — the replay returns the cached reply.
        # (entity, sid) -> {"last": applied seq high-water,
        #                   "replies": {seq: reply}, "touched": ts}
        self._session_lock = LockdepLock("osd.sessions",
                                         recursive=False)
        self._sessions: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.session_resets = 0       # unknown-sid resumes observed
        self._pc_session = _perf("osd.session")
        # OUTBOUND peer sessions: this daemon's own (session, seq)
        # stamps for mutating peer traffic (replica sub-writes,
        # recovery pushes), so the receiving daemon's dup table
        # covers daemon->daemon mutations with the same at-most-once
        # contract clients get — _peer_req is the stamping chokepoint
        # (lint CTL802)
        self._peer_sess_lock = LockdepLock("osd.peer_sessions",
                                           recursive=False)
        self._peer_sessions: Dict[int, Dict[str, Any]] = {}
        # io accounting (the osd_perf_counters rd/wr families): the
        # ClusterStats aggregator turns successive heartbeat reports
        # of these into per-OSD/per-pool io rates for `ceph -s`
        self._pc_io = _perf("osd.io")
        self._perf_reported = 0.0     # last report_perf wall time
        # per-PG client heat (pool HitSet role), counted at the same
        # _account_io chokepoint as the osd.io counters so the mon's
        # heat<->osd.io agreement check holds; wall clock on this tier
        from .pg_heat import PGHeatTracker
        from .osd_service import _heat_half_life
        self.heat = PGHeatTracker(half_life=_heat_half_life(),
                                  clock=time.time)
        # recovery/backfill reservations (the reference's AsyncReserver
        # pair + osd_max_backfills): LOCAL = this OSD driving a PG's
        # recovery as primary, REMOTE = this OSD receiving a recovery/
        # backfill stream as member/target.  Held counts are capped by
        # osd_max_backfills; peaks are exposed on `status` so chaos
        # tests can assert the cap was never exceeded.
        # slots are LEASES (grant timestamps), not bare counters: a
        # holder that dies mid-recovery (primary kill9 between
        # reserve and release, a client crash, a lost grant reply
        # re-executed by the one-shot stream retry) would otherwise
        # leak its slot until this daemon restarts and wedge every
        # later recovery under the cap — expired grants purge on the
        # next reserve/release/status touch
        self._resv_lock = LockdepLock("osd.resv", recursive=False)
        self._resv: Dict[str, List[float]] = {"local": [],
                                              "remote": []}
        self._resv_peak = {"local": 0, "remote": 0}
        self._pc_resv = _perf("osd.recovery")

    _RESV_TTL_S = 60.0

    def _resv_purge(self, role: str) -> None:
        """Drop expired leases (caller holds _resv_lock)."""
        floor = time.monotonic() - self._RESV_TTL_S
        ts = self._resv[role]
        expired = 0
        while ts and ts[0] < floor:
            ts.pop(0)
            expired += 1
        if expired:
            self._pc_resv.inc(f"{role}_expired", expired)

    def _resv_held(self) -> Dict[str, int]:
        with self._resv_lock:
            for role in self._resv:
                self._resv_purge(role)
            return {r: len(ts) for r, ts in self._resv.items()}

    # ----------------------------------------------------------- mon I/O --
    def _mon_socks(self) -> List[str]:
        return mon_sockets(self.dir)

    def mon_client(self) -> WireClient:
        """Any live mon will do (mutations forward to the leader
        server-side); fail over across the quorum."""
        if self._mon is None:
            last: Optional[Exception] = None
            for sock in self._mon_socks():
                mon_ent = os.path.basename(sock)[:-len(".sock")]
                try:
                    self._mon = WireClient(
                        sock, self.entity,
                        secret=self.keyring.secret(self.entity),
                        peer=mon_ent)
                    break
                except (OSError, IOError, cx.AuthError) as e:
                    last = e
            if self._mon is None:
                raise IOError(f"no mon reachable: {last}")
        return self._mon

    def peer_client(self, osd: int) -> WireClient:
        with self._peer_lock:
            c = self._peers.get(osd)
            if c is not None:
                return c
        mon = self.mon_client()
        grant = mon.call({"cmd": "get_ticket",
                          "service": f"osd.{osd}"})
        key = cx.open_key_box(self.keyring.secret(self.entity),
                              grant["key_box"])
        from ..common.options import config
        c = WireClient(os.path.join(self.dir, f"osd.{osd}.sock"),
                       self.entity, ticket=grant["ticket"],
                       session_key=key, timeout=5.0,
                       peer=f"osd.{osd}",
                       # intra-cluster data mode (the reference's
                       # ms_cluster_mode, its own knob — sealing
                       # client streams must not silently downgrade
                       # peer links or vice versa): crc by default,
                       # which is what lets replica sub-writes carry
                       # the one-pass trusted-csum handoff
                       mode=str(config().get("osd_cluster_wire_mode")))
        with self._peer_lock:
            self._peers[osd] = c
        return c

    def drop_peer(self, osd: int) -> None:
        with self._peer_lock:
            c = self._peers.pop(osd, None)
        if c:
            c.close()

    def boot(self) -> None:
        """Announce up + fetch the map (MOSDBoot).  Retries with a
        fresh mon connection: a transient drop (mon restarting,
        injected socket failure) at boot must not kill the daemon.
        Exponential backoff with per-daemon jitter — N OSDs booting
        against one recovering mon must not stampede in lockstep."""
        last: Optional[Exception] = None
        backoff = ExpBackoff(base=0.1, cap=1.0, seed=self.id)
        for attempt in range(5):
            try:
                mon = self.mon_client()
                mon.call({"cmd": "osd_boot", "osd": self.id})
                self._map = mon.call({"cmd": "get_map"})
                return
            except (OSError, IOError) as e:
                last = e
                if self._mon is not None:
                    try:
                        self._mon.close()
                    except OSError:
                        pass
                    self._mon = None
                backoff.sleep(attempt)
        raise IOError(f"osd.{self.id}: boot failed ({last})")

    def _pglog(self, coll: Tuple[int, int]):
        from .daemon_pglog import DurablePGLog
        with self._pglog_lock:
            log = self._pglogs.get(coll)
            if log is None:
                log = self._pglogs[coll] = DurablePGLog(self.store,
                                                        coll)
            return log

    def _pg_lock(self, coll: Tuple[int, int]) -> LockdepLock:
        with self._pglog_lock:
            lk = self._pg_locks.get(coll)
            if lk is None:
                lk = self._pg_locks[coll] = LockdepLock(
                    f"osd.pg.{coll[0]}.{coll[1]}",
                    recursive=False)
            return lk

    # ------------------------------------------------------------ serving --
    def _run_sched(self, op: Callable[[], Any], klass: str) -> Any:
        """Every op passes through the mClock scheduler — and the
        scheduler now actually ARBITRATES: the op is parked in the
        queue and connection threads cooperatively drain it in
        dmClock tag order, so under contention (many connections
        enqueueing at once) a reserved tenant's ops are dispatched
        ahead of a noisy tenant's backlog regardless of arrival
        order.  The old shape enqueued and immediately dequeued under
        one lock — the queue was empty between calls and QoS never
        reordered anything.

        A thread may execute ANOTHER connection's op (the one the
        tags say goes first) and have its own executed elsewhere;
        results route back through per-op completion events.  The
        caller's trace context is captured at enqueue so the
        dispatch span lands under the op's own osd.op span, whichever
        thread runs it."""
        mark_active("dispatched_device", osd=self.id, klass=klass)
        tctx = _trace.tracer().current_ctx() if _trace.enabled() \
            else None
        entry = {"fn": op, "tctx": tctx, "klass": klass,
                 "done": threading.Event(), "result": None,
                 "exc": None}
        with self._sched_lock:
            self.sched.enqueue(entry, klass=klass)
        while not entry["done"].is_set():
            with self._sched_lock:
                item = None if entry["done"].is_set() \
                    else self.sched.dequeue()
            if item is None:
                # our op was claimed by another thread (or just
                # finished): wait for its completion
                entry["done"].wait()
                break
            _klass, e = item
            # dispatch-stage span under the EXECUTED op's own trace
            # context (child of its osd.op span; null when untraced)
            try:
                with _trace.linked_span("osd.dispatch", e["tctx"],
                                        osd=self.id,
                                        klass=e["klass"]):
                    e["result"] = e["fn"]()
            except BaseException as ex:
                e["exc"] = ex
            e["done"].set()
            if e is entry:
                break
        if entry["exc"] is not None:
            raise entry["exc"]
        return entry["result"]

    def _check_pool_live(self, coll) -> None:
        """Refuse mutations into pools the fetched map says are
        DELETED (same gate as _purge_dead_pools): acking a write the
        next heartbeat will purge is silent data loss.  Pools newer
        than this OSD's map (id above its pool_id_max) are accepted —
        the map is merely stale."""
        pool_id_max = int(self._map.get("pool_id_max", 0))
        if not pool_id_max:
            return
        pid = int(coll[0])
        if pid <= pool_id_max and \
                pid not in {int(p["id"])
                            for p in self._map.get("pools", [])}:
            raise IOError(f"pool {pid} does not exist (deleted)")

    # wire data-path commands that get a TrackedOp (control traffic —
    # maps, watches, pg queries — stays untracked: high-rate, never the
    # ops an operator hunts with dump_historic_ops)
    _TRACKED_CMDS = frozenset((
        "put_shard", "get_shard", "delete_shard", "setattr_shard",
        "getattr_shard", "stat_shard", "digest_shard", "copy_from",
        "put_object", "delete_object", "exec_cls"))

    # mutations covered by (session, seq) dup detection: a replay of
    # an already-applied op must not apply a second time.  The bulk
    # recovery frames and the stray purge joined in CTLint v2
    # (a replayed old bulk push interleaving with a newer write has
    # the same clobber hazard the per-object table was built for)
    _REPLAY_CMDS = frozenset((
        "put_shard", "put_object", "delete_shard", "delete_object",
        "setattr_shard", "copy_from", "exec_cls",
        "put_objects", "delete_objects", "delete_shards"))

    _SESSION_REPLY_WINDOW = 64        # cached replies per session
    _MAX_SESSIONS = 256               # LRU cap across clients

    # ------------------------------------------------------- sessions --
    def _session_state(self, entity: str, sid: str) -> Dict[str, Any]:
        """Find-or-create under _session_lock (caller holds it)."""
        key = (entity, sid)
        st = self._sessions.get(key)
        if st is None:
            if len(self._sessions) >= self._MAX_SESSIONS:
                oldest = min(self._sessions,
                             key=lambda k:
                             self._sessions[k]["touched"])
                del self._sessions[oldest]
            st = self._sessions[key] = {"last": 0, "replies": {},
                                        "touched": time.monotonic()}
        st["touched"] = time.monotonic()
        return st

    def _session_hello(self, entity: str,
                       req: Dict[str, Any]) -> Dict[str, Any]:
        """Session establishment/resume on (re)connect: the client
        announces its session id and the highest seq it has USED; the
        server answers whether it still holds the session.  A resume
        (seq > 0) against an unknown sid is a detected STALE SESSION
        — this daemon restarted or evicted it — and both sides reset:
        the server starts fresh state here, the client learns its
        dedup history is gone (its durable-idempotent full-rewrite
        contract covers re-applies) and re-establishes session-scoped
        state such as watches."""
        sid = str(req["session"])
        with self._session_lock:
            known = (entity, sid) in self._sessions
            st = self._session_state(entity, sid)
            if not known and int(req.get("seq", 0)) > 0:
                self.session_resets += 1
                self._pc_session.inc("resets")
            return {"known": known, "last_applied": st["last"]}

    _MISS = object()

    class _InFlight:
        """Marker parked in the reply window while the FIRST arrival
        of a seq is still applying: a replay that races it (client
        socket timeout + retry while the apply is merely slow) must
        WAIT for that apply rather than start a second one — two
        concurrent applies of one seq could interleave with a newer
        write and clobber it."""

        __slots__ = ("event",)

        def __init__(self) -> None:
            self.event = threading.Event()

    def _session_check(self, entity: str, sid: str, seq: int) -> Any:
        """_MISS when the op must apply (an in-flight marker is
        parked first); otherwise the recorded reply.  Dedup is
        strictly against the RETAINED reply window: a seq below the
        window's floor is applied again (ops on one session run
        CONCURRENTLY over per-object paths, so ``seq <= last`` cannot
        distinguish 'applied long ago' from 'arrived out of order' —
        and the client's full-rewrite semantics make a beyond-window
        re-apply idempotent, exactly the reference's bounded pg-log
        dup window contract)."""
        with self._session_lock:
            st = self._session_state(entity, sid)
            ent = st["replies"].get(seq)
            if ent is None:
                st["replies"][seq] = self._InFlight()
                return self._MISS
            if not isinstance(ent, self._InFlight):
                self._pc_session.inc("replay_dups")
                return ent
            ev = ent.event
        # the first arrival is still applying: wait it out (outside
        # the lock — the apply needs it), then return ITS outcome
        ev.wait(30.0)
        with self._session_lock:
            st = self._sessions.get((entity, sid))
            ent = None if st is None else st["replies"].get(seq)
            if ent is None or isinstance(ent, self._InFlight):
                # first apply failed (aborted) or is still stuck:
                # surface a retryable error — the caller's resend
                # machinery comes back through a fresh check
                raise IOError(f"session {sid}: seq {seq} first "
                              f"apply did not complete")
            self._pc_session.inc("replay_dups")
            return ent

    def _session_record(self, entity: str, sid: str, seq: int,
                        reply: Any) -> None:
        with self._session_lock:
            st = self._session_state(entity, sid)
            prev = st["replies"].get(seq)
            st["replies"][seq] = reply
            st["last"] = max(st["last"], seq)
            self._pc_session.inc("applied")
            live = [s for s, e in st["replies"].items()
                    if not isinstance(e, self._InFlight)]
            while len(live) > self._SESSION_REPLY_WINDOW:
                # evict completed replies only: an in-flight marker
                # must survive until its apply resolves
                oldest = min(live)
                del st["replies"][oldest]
                live.remove(oldest)
        if isinstance(prev, self._InFlight):
            prev.event.set()          # wake replay waiters

    def _session_abort(self, entity: str, sid: str, seq: int) -> None:
        """First apply raised: clear the marker so a resend can apply
        afresh, and wake any replay waiting on it."""
        with self._session_lock:
            st = self._sessions.get((entity, sid))
            ent = None if st is None else st["replies"].get(seq)
            if isinstance(ent, self._InFlight):
                del st["replies"][seq]
        if isinstance(ent, self._InFlight):
            ent.event.set()

    def _handle(self, entity: str, req: Dict[str, Any]) -> Any:
        cmd = req["cmd"]
        inj = faults.fire("daemon.hang_op", cmd=cmd)
        if inj is not None:
            # stalled dispatch: ops pile up behind this connection's
            # thread; the OpTracker complaint window / peer heartbeats
            # are what notice
            time.sleep(float(inj.get("seconds", 0.5)))
        if faults.fire("daemon.crash_op", cmd=cmd) is not None:
            # process death mid-op: no reply, no cleanup — exactly the
            # thrasher's kill -9; durable state must carry the cluster
            os._exit(17)
        if cmd == "session_hello":
            return self._session_hello(entity, req)
        sid, seq = req.get("session"), req.get("seq")
        if sid is not None and seq is not None and \
                cmd in self._REPLAY_CMDS:
            cached = self._session_check(entity, str(sid), int(seq))
            if cached is not self._MISS:
                return cached          # replayed op: applied once
            try:
                reply = self._handle_tracked(entity, req)
            except BaseException:
                self._session_abort(entity, str(sid), int(seq))
                raise
            self._session_record(entity, str(sid), int(seq), reply)
            return reply
        return self._handle_tracked(entity, req)

    def _handle_tracked(self, entity: str, req: Dict[str, Any]) -> Any:
        cmd = req["cmd"]
        if cmd not in self._TRACKED_CMDS:
            return self._handle_inner(entity, req)
        tr = _op_tracker()
        top = tr.create(cmd, service=self.entity, client=entity,
                        oid=req.get("oid"))
        top.mark_event("reached_osd", osd=self.id,
                       klass=req.get("klass", "client"))
        error = None
        try:
            # daemon-side op span, LINKED under the trace context the
            # client stamped into the wire request meta (``tctx``) —
            # this is where a cross-process trace enters this daemon;
            # peer fan-outs below stamp THIS span as their parent, so
            # replica daemons' spans land as grandchildren
            with _trace.linked_span("osd.op", req.get("tctx"),
                                    osd=self.id, cmd=cmd) as span:
                if span.trace_id and top.tracked:
                    top.tags["trace_id"] = span.trace_id
                with tr.track(top):
                    reply = self._handle_inner(entity, req)
                self._account_io(entity, req, reply)
                return reply
        except BaseException as e:
            error = type(e).__name__
            raise
        finally:
            tr.finish(top, error=error)

    _WR_CMDS = frozenset(("put_shard", "put_object", "setattr_shard",
                          "copy_from"))
    _RD_CMDS = frozenset(("get_shard", "getattr_shard", "stat_shard",
                          "digest_shard"))

    def _account_io(self, entity: str, req: Dict[str, Any],
                    reply: Any) -> None:
        """Per-daemon (and per-pool) rd/wr op+byte counters — the
        sensor the `ceph -s` client io line aggregates from.  Only
        CLIENT-facing ops count: replica fan-outs and recovery
        pushes re-enter this handler from peer OSDs, and counting
        them would inflate "client io" by the replication factor
        (the PGMap client-vs-recovery distinction)."""
        if entity.startswith("osd.") or \
                req.get("klass") == "background_recovery":
            return
        cmd = req["cmd"]
        coll = req.get("coll")
        pool = int(coll[0]) if coll else -1
        pg = int(coll[1]) if coll is not None and len(coll) > 1 else -1
        if cmd in self._WR_CMDS:
            nbytes = len(req.get("data") or b"")
            self._pc_io.inc("wr_ops")
            self._pc_io.inc("wr_bytes", nbytes)
            if pool >= 0:
                self._pc_io.inc(f"pool.{pool}.wr_ops")
                self._pc_io.inc(f"pool.{pool}.wr_bytes", nbytes)
                if pg >= 0:
                    self.heat.record(pool, pg, "wr", nbytes=nbytes)
        elif cmd in self._RD_CMDS:
            if isinstance(reply, wire.BulkReply):
                nbytes = len(reply.data)
            else:
                nbytes = len(reply) if isinstance(
                    reply, (bytes, bytearray, memoryview)) else 0
            self._pc_io.inc("rd_ops")
            self._pc_io.inc("rd_bytes", nbytes)
            if pool >= 0:
                self._pc_io.inc(f"pool.{pool}.rd_ops")
                self._pc_io.inc(f"pool.{pool}.rd_bytes", nbytes)
                if pg >= 0:
                    self.heat.record(pool, pg, "rd", nbytes=nbytes)
        elif cmd in ("delete_shard", "delete_object"):
            self._pc_io.inc("wr_ops")
            if pool >= 0:
                self._pc_io.inc(f"pool.{pool}.wr_ops")
                if pg >= 0:
                    self.heat.record(pool, pg, "wr")

    def _handle_inner(self, entity: str, req: Dict[str, Any]) -> Any:
        cmd = req["cmd"]
        klass = req.get("klass", "client")
        tenant = req.get("tenant")
        if tenant and klass == "client":
            # tenant identity propagated from S3 auth through the
            # objecter: client ops dispatch under the tenant's OWN
            # dmClock class (auto-vivified with the
            # osd_mclock_scheduler_client_* defaults, or the spec's
            # qos_tenants override)
            from ..msg.scheduler import tenant_class
            klass = tenant_class(str(tenant))
        if cmd in ("put_shard", "put_object", "delete_object",
                   "setattr_shard"):
            self._check_pool_live(req["coll"])
        if cmd == "put_shard":
            coll = tuple(req["coll"])
            from .objectstore import Transaction

            def put():
                # trusted csums from the wire's one-pass verify scan
                # (socket SG frame or shm ring): the store writes the
                # payload WITHOUT re-scanning it — its per-block blob
                # csums are the very values that just verified these
                # bytes.  copy=False: the buffer is a per-frame view
                # nobody mutates; write_full must not materialize it.
                txn = Transaction().write_full(
                    coll, req["oid"], req["data"],
                    csums=req.get("_csums"), copy=False)
                for ak, av in (req.get("attrs") or {}).items():
                    txn.setattr(coll, req["oid"], ak, av)
                lg = req.get("log")
                if not lg:
                    self.store.apply_transaction(txn)
                    return True
                with self._pg_lock(coll):
                    # replica-side log append in the SAME txn; the
                    # replica only advances last_complete when it was
                    # current through the primary's previous version —
                    # otherwise the entry lands but the gap stays
                    # visible to peering (missing-set semantics)
                    log = self._pglog(coll)
                    v = tuple(lg["version"])
                    prev = tuple(lg.get("prev", (0, 0)))
                    log.append_txn(
                        txn, v, req["oid"],
                        advance_lc=log.last_complete >= prev)
                    self.store.apply_transaction(txn)
                return True
            return self._run_sched(put, klass)
        if cmd == "setattr_shard":
            coll = tuple(req["coll"])
            from .objectstore import Transaction

            def sa():
                txn = Transaction()
                for ak, av in req["attrs"].items():
                    txn.setattr(coll, req["oid"], ak, av)
                self.store.apply_transaction(txn)
                return True
            return self._run_sched(sa, klass)
        if cmd == "getattr_shard":
            coll = tuple(req["coll"])
            def rd():
                try:
                    return self.store.getattr(coll, req["oid"],
                                              req["key"])
                except (IOError, KeyError):
                    return None
            return self._run_sched(rd, klass)
        if cmd == "get_shard":
            coll = tuple(req["coll"])
            def read():
                rg = req.get("ranges")
                rwc = None if rg else getattr(
                    self.store, "read_with_csums", None)
                try:
                    if rwc is not None:
                        # full-object read with the store-trusted
                        # blob csums alongside (RingReply): the
                        # reply chokepoint folds them into the frame
                        # crc / ring doorbell, so the get reply
                        # leaves this daemon with ZERO send scans
                        data, cs = rwc(coll, req["oid"])
                        return wire.BulkReply(data, cs)
                    data = self.store.read(coll, req["oid"])
                except IOError:
                    return None
                if rg:
                    # sub-shard ranged read: only the requested byte
                    # ranges cross the wire (a regenerating-code
                    # helper ships its repair sub-chunks, not the
                    # whole shard — the Clay minimum-bandwidth fetch)
                    data = b"".join(bytes(data[int(o):int(o) + int(n)])
                                    for o, n in rg)
                return data
            return self._run_sched(read, klass)
        if cmd == "getattrs_shard":
            # all requested attrs in ONE round trip (the recovery
            # geometry probe used to cost one blocking call per key)
            coll = tuple(req["coll"])

            def rda():
                out = {}
                for akey in req["keys"]:
                    try:
                        out[akey] = self.store.getattr(
                            coll, req["oid"], akey)
                    except (IOError, KeyError):
                        out[akey] = None
                return out
            return self._run_sched(rda, klass)
        if cmd == "get_objects":
            # bulk recovery pull: one scatter-gather frame for a
            # whole chunk of objects ({oid: bytes|None}).  The reply
            # is BYTE-CAPPED server-side (an uncapped 64-object chunk
            # of 8 MiB objects would exceed the 256 MiB wire frame
            # limit and fail the member's recovery forever): oids the
            # budget excludes are simply OMITTED — absent, not None —
            # and the puller re-requests them next round
            coll = tuple(req["coll"])

            def read_many():
                out = {}
                nbytes = 0
                rwc = getattr(self.store, "read_with_csums", None)
                for oid in req["oids"]:
                    if out and nbytes >= self._RECOVERY_CHUNK_BYTES:
                        break     # omitted: the caller re-requests
                    try:
                        if rwc is not None:
                            # trusted csums per object: same-host
                            # recovery pulls ride the reply ring
                            # with zero send scans (RingReply)
                            data, cs = rwc(coll, oid)
                        else:
                            data, cs = self.store.read(coll, oid), \
                                None
                        nbytes += len(data)
                        out[oid] = wire.BulkReply(data, cs)
                    except IOError:
                        out[oid] = None
                return out
            return self._run_sched(read_many, klass)
        if cmd == "put_objects":
            # bulk recovery push: the whole chunk lands in ONE
            # transaction (apply is atomic per store barrier)
            coll = tuple(req["coll"])
            self._check_pool_live(coll)
            from .objectstore import Transaction

            def put_many():
                txn = Transaction()
                for oid, data in req["objs"]:
                    txn.write_full(coll, oid, data)
                self.store.apply_transaction(txn)
                return len(req["objs"])
            return self._run_sched(put_many, klass)
        if cmd == "delete_objects":
            coll = tuple(req["coll"])
            from .objectstore import Transaction

            def rm_many():
                txn = Transaction()
                for oid in req["oids"]:
                    if self.store.exists(coll, oid):
                        txn.remove(coll, oid)
                if len(txn):
                    self.store.apply_transaction(txn)
                return len(req["oids"])
            return self._run_sched(rm_many, klass)
        if cmd == "reserve_recovery":
            role = str(req.get("role", "remote"))
            if role not in self._resv:
                raise ValueError(f"unknown reservation role {role!r}")
            granted = self._reserve(role)
            return {"granted": granted,
                    "held": self._resv_held()[role]}
        if cmd == "release_recovery":
            role = str(req.get("role", "remote"))
            if role in self._resv:
                self._release(role)
            return {"held": self._resv_held().get(role, 0)}
        if cmd == "delete_shard":
            coll = tuple(req["coll"])
            from .objectstore import Transaction

            def rm():
                txn = Transaction()
                if self.store.exists(coll, req["oid"]):
                    txn.remove(coll, req["oid"])
                lg = req.get("log")
                if not lg:
                    if len(txn):
                        self.store.apply_transaction(txn)
                    return True
                with self._pg_lock(coll):
                    # replica half of a logged delete: the OP_DELETE
                    # entry rides the same txn as the removal (mirror
                    # of put_shard), so recovery can never resurrect
                    # the object from a log that lacks its delete
                    from .pglog import OP_DELETE
                    log = self._pglog(coll)
                    v = tuple(lg["version"])
                    prev = tuple(lg.get("prev", (0, 0)))
                    log.append_txn(
                        txn, v, req["oid"], op=OP_DELETE,
                        advance_lc=log.last_complete >= prev)
                    self.store.apply_transaction(txn)
                return True
            return self._run_sched(rm, klass)
        if cmd == "copy_from":
            # PrimaryLogPG copy-from (src/osd/PrimaryLogPG.cc
            # do_copy_from role): the DESTINATION primary pulls the
            # source object server-side — possibly from another OSD —
            # and commits it locally + to replicas as a logged write;
            # the client never carries the payload
            coll = tuple(req["coll"])
            self._check_pool_live(coll)
            src_coll = tuple(req["src_coll"])

            def read_src():
                src_oid = req["src_oid"]
                if req.get("src_osd") in (None, self.id):
                    try:
                        return self.store.read(src_coll, src_oid)
                    except IOError:
                        return None
                return self._peer_req(int(req["src_osd"]),
                                      _trace.stamp(
                                          {"cmd": "get_shard",
                                           "coll": list(src_coll),
                                           "oid": src_oid}))
            data = read_src()
            if data is None:
                raise IOError(f"copy_from: source "
                              f"{req['src_oid']!r} unreadable")
            fwd = {"cmd": "put_object", "coll": list(coll),
                   "oid": req["oid"], "data": bytes(data),
                   "replicas": req["replicas"], "klass": klass}
            return self._handle(entity, fwd)
        if cmd == "delete_object":
            # replicated primary delete: version + OP_DELETE log entry
            # + removal in ONE txn, fanned out to replicas — the
            # PrimaryLogPG delete shape; without this, a down replica
            # resurrects the object on log-driven recovery
            coll = tuple(req["coll"])
            from .objectstore import Transaction
            from .pglog import OP_DELETE
            with self._pg_lock(coll):
                log = self._pglog(coll)
                prev = log.log.head
                version = log.next_version(
                    int(self._map.get("epoch", prev[0] or 1)))

                def rm_primary():
                    txn = Transaction()
                    if self.store.exists(coll, req["oid"]):
                        txn.remove(coll, req["oid"])
                    log.append_txn(txn, version, req["oid"],
                                   op=OP_DELETE)
                    self.store.apply_transaction(txn)
                self._run_sched(rm_primary, klass)
                acks = 1
                for peer in req["replicas"]:
                    if peer == self.id:
                        continue
                    # replica sub-delete through the _peer_req
                    # chokepoint: trace-stamped AND (session, seq)-
                    # stamped (at-most-once on the replica)
                    if self._peer_req(peer, _trace.stamp({
                            "cmd": "delete_shard", "coll": list(coll),
                            "oid": req["oid"], "klass": klass,
                            "log": {"version": list(version),
                                    "prev": list(prev)}})) is not None:
                        acks += 1
            return {"acks": acks, "version": list(version)}
        if cmd == "put_object":
            # replicated primary: assign the version, persist object +
            # log entry in ONE txn, fan the versioned write out to
            # replicas (PrimaryLogPG::execute_ctx -> issue_repop shape)
            coll = tuple(req["coll"])
            from .objectstore import Transaction
            with self._pg_lock(coll):      # PG lock: serialize writes
                log = self._pglog(coll)
                prev = log.log.head
                version = log.next_version(
                    int(self._map.get("epoch", prev[0] or 1)))

                def put_primary():
                    txn = Transaction().write_full(
                        coll, req["oid"], req["data"],
                        csums=req.get("_csums"), copy=False)
                    for ak, av in (req.get("attrs") or {}).items():
                        txn.setattr(coll, req["oid"], ak, av)
                    log.append_txn(txn, version, req["oid"])
                    self.store.apply_transaction(txn)
                self._run_sched(put_primary, klass)
                acks = 1
                for peer in req["replicas"]:
                    if peer == self.id:
                        continue
                    # replica sub-write through the _peer_req
                    # chokepoint: carries the trace context of THIS
                    # daemon's active osd.op span (replica spans link
                    # as children, the >= 3-process trace shape) AND
                    # a (session, seq) stamp (at-most-once replay)
                    if self._peer_req(peer, _trace.stamp({
                            "cmd": "put_shard", "coll": list(coll),
                            "oid": req["oid"], "data": req["data"],
                            # the primary's verify-trusted csums fold
                            # into the peer frame crc (no re-scan on
                            # this send) and become the replica's
                            # trusted handoff in turn
                            "_csums": req.get("_csums"),
                            "klass": klass, "attrs": req.get("attrs"),
                            "log": {"version": list(version),
                                    "prev": list(prev)}})) is not None:
                        acks += 1
            return {"acks": acks, "version": list(version)}
        if cmd == "list_pg":
            coll = tuple(req["coll"])
            return self.store.list_objects(coll)
        if cmd == "delete_shards":
            # bulk stray purge (the client fanout's supersession
            # sweep): many (coll, oid) removals in one RTT instead of
            # one delete_shard call per shard
            from .objectstore import Transaction
            removed = 0
            for c, oid in req["items"]:
                c = tuple(c)
                if self.store.exists(c, oid):
                    self.store.apply_transaction(
                        Transaction().remove(c, oid))
                    removed += 1
            return removed
        if cmd == "count_pool":
            # non-meta objects this OSD holds for one pool, across
            # all its PG collections (the mon's tier-remove drain
            # gate: one RTT per OSD instead of pg_num listings)
            pid = int(req["pool"])
            n = 0
            for c in self.store.list_collections():
                if c[0] == pid:
                    n += sum(1 for o in self.store.list_objects(c)
                             if not o.startswith("meta:"))
            return n
        if cmd == "pg_info":
            # GetInfo: this replica's log bounds + applied version
            return self._pglog(tuple(req["coll"])).info()
        if cmd == "pg_log":
            # GetLog: authoritative entries after a version
            log = self._pglog(tuple(req["coll"]))
            return {"entries": [(list(v), o, op) for v, o, op in
                                log.entries_after(tuple(req["after"]))],
                    "head": list(log.log.head)}
        if cmd == "log_sync":
            # merge the authority's tail + advance last_complete
            # (PGLog::merge_log after recovery completes)
            coll = tuple(req["coll"])
            from .objectstore import Transaction
            log = self._pglog(coll)
            txn = Transaction()
            log.merge_tail_txn(
                txn,
                [(tuple(v), o, op) for v, o, op in req["entries"]],
                tuple(req["head"]))
            self.store.apply_transaction(txn)
            return True
        if cmd == "digest_shard":
            coll = tuple(req["coll"])
            try:
                return self.store.stat(coll, req["oid"])["csum"]
            except (IOError, KeyError):
                return None
        if cmd == "watch_register":
            # Watch role (src/osd/Watch.cc): the object's PRIMARY
            # keeps the watcher registry; each watcher gets a cookie
            # and a pending-notification queue it polls (this wire is
            # request/reply, so delivery is poll-based rather than
            # connection-push)
            wk = (tuple(req["coll"]), req["oid"])
            with self._watch_lock:
                cookie = self._watch_next
                self._watch_next += 1
                self._watchers.setdefault(wk, {})[cookie] = []
            return {"cookie": cookie}
        if cmd == "watch_unregister":
            wk = (tuple(req["coll"]), req["oid"])
            with self._watch_lock:
                self._watchers.get(wk, {}).pop(int(req["cookie"]),
                                               None)
            return {"ok": True}
        if cmd == "watch_poll":
            wk = (tuple(req["coll"]), req["oid"])
            with self._watch_lock:
                q = self._watchers.get(wk, {}).get(int(req["cookie"]))
                if q is None:
                    # daemon restarted / watch expired: the client
                    # must re-register (the reference's watch timeout)
                    return {"gone": True, "events": []}
                events, q[:] = list(q), []
            return {"events": events}
        if cmd == "notify":
            wk = (tuple(req["coll"]), req["oid"])
            payload = req.get("payload", b"")
            with self._watch_lock:
                nid = self._watch_next
                self._watch_next += 1
                watchers = self._watchers.get(wk, {})
                for cookie, q in watchers.items():
                    q.append([nid, payload])
                # snapshot INSIDE the lock: `watchers` aliases the
                # live dict and concurrent register/unregister would
                # race the iteration
                w_list = sorted(watchers)
                if watchers:
                    # zero-watcher notifies allocate NO wait state:
                    # the notifier returns early and nothing would
                    # ever pop the entry
                    self._notify_state[nid] = {"want": set(watchers),
                                               "acks": {}}
            return {"notify_id": nid, "watchers": w_list}
        if cmd == "notify_ack":
            with self._watch_lock:
                st = self._notify_state.get(int(req["notify_id"]))
                if st is not None:
                    st["acks"][int(req["cookie"])] = req.get("ack")
            return {"ok": True}
        if cmd == "notify_wait":
            # gather acks until every watcher answered or timeout —
            # non-answering watchers are reported pending (the Notify
            # timeout shape); each connection has its own server
            # thread, so blocking here is fine
            nid = int(req["notify_id"])
            deadline = time.monotonic() + float(req.get("timeout",
                                                        3.0))
            while True:
                with self._watch_lock:
                    st = self._notify_state.get(nid)
                    if st is None:
                        return {"acks": {}, "pending": []}
                    if set(st["acks"]) >= st["want"] or \
                            time.monotonic() >= deadline:
                        self._notify_state.pop(nid, None)
                        return {"acks": {str(c): a for c, a in
                                         st["acks"].items()},
                                "pending": sorted(st["want"] -
                                                  set(st["acks"]))}
                time.sleep(0.02)
        if cmd == "exec_cls":
            # CEPH_OSD_OP_CALL over the wire: the method runs INSIDE
            # the primary OSD through the SAME ClassHandler the sim
            # tier uses (cluster/class_handler.py), then re-executes
            # on each replica — cls methods are deterministic
            # functions of (object state, input), so re-execution IS
            # state-machine replication and replicas converge
            coll = tuple(req["coll"])
            self._check_pool_live(coll)
            if self._class_handler is None:
                from .class_handler import ClassHandler
                self._class_handler = ClassHandler()

            def run_cls():
                out = self._class_handler.call(
                    self.store, coll, req["oid"], req["cls"],
                    req["method"], req.get("payload", b""))
                for rep in req.get("replicas", []):
                    if rep == self.id:
                        continue
                    try:
                        self._peer_req(rep, _trace.stamp({
                            "cmd": "exec_cls", "coll": list(coll),
                            "oid": req["oid"], "cls": req["cls"],
                            "method": req["method"],
                            "payload": req.get("payload", b""),
                            "replicas": []}))
                    except (OSError, IOError):
                        pass      # stale replica heals via recovery
                return out
            return self._run_sched(run_cls, klass)
        if cmd == "stat_shard":
            # size/digest without payload transfer (rados_stat role)
            coll = tuple(req["coll"])
            try:
                st = self.store.stat(coll, req["oid"])
                return {"size": st["size"]}
            except (IOError, KeyError):
                return None
        if cmd == "scrub_pg":
            return self._scrub_pg(tuple(req["coll"]), req["members"],
                                  bool(req.get("repair", False)))
        if cmd == "recover_pg":
            return self._recover_pg(tuple(req["coll"]), req["members"],
                                    req.get("strays") or [])
        if cmd == "ping":
            return {"osd": self.id, "alive": True}
        if cmd == "status":
            with self._session_lock:
                n_sessions = len(self._sessions)
            resv = {"held": self._resv_held(),
                    "peak": dict(self._resv_peak)}
            with self._sched_lock:
                sched = {"dequeued": dict(self.sched.stats),
                         "queued": len(self.sched),
                         "classes": sorted(self.sched.qos)}
            return {"osd": self.id,
                    "objects": sum(
                        len(self.store.list_objects(c))
                        for c in self.store.list_collections()),
                    "injected_failures": self.server.injected,
                    "sessions": n_sessions,
                    "session_resets": self.session_resets,
                    "recovery_reservations": resv,
                    "scheduler": sched}
        if cmd == "fsck":
            return [list(map(str, b)) for b in self.store.fsck()]
        raise ValueError(f"unknown osd command {cmd!r}")

    def _peer_stamp(self, m: int) -> Dict[str, Any]:
        """Draw one (session, seq) replay stamp for a mutating
        request bound for peer ``m`` — the daemon-side twin of the
        client's ``_next_stamp`` (sid kept across reconnects)."""
        with self._peer_sess_lock:
            st = self._peer_sessions.get(m)
            if st is None:
                st = self._peer_sessions[m] = {
                    "sid": f"osd{self.id}-{secrets.token_hex(8)}",
                    "seq": 0}
            st["seq"] += 1
            return {"session": st["sid"], "seq": st["seq"]}

    def _peer_req(self, m: int, req: Dict[str, Any]):
        """One guarded peer call (None on failure).  Mutating
        commands are stamped with this daemon's per-peer
        (session, seq) so the receiver applies them at most once —
        every daemon->daemon mutation must route through here (or
        carry its own stamp): the CTL802 chokepoint contract."""
        if req.get("cmd") in self._REPLAY_CMDS and \
                "session" not in req:
            req = dict(req, **self._peer_stamp(m))
        try:
            return self.peer_client(m).call(req)
        except (OSError, IOError):
            self.drop_peer(m)
            return None

    # ---------------------------------------------- recovery reservations --
    def _reserve(self, role: str) -> bool:
        """One reservation lease under the osd_max_backfills cap;
        False = denied (the caller defers and requeues, never
        waits)."""
        from ..common.options import config
        cap = int(config().get("osd_max_backfills"))
        with self._resv_lock:
            self._resv_purge(role)
            if len(self._resv[role]) >= cap:
                self._pc_resv.inc(f"{role}_denials")
                return False
            self._resv[role].append(time.monotonic())
            held = len(self._resv[role])
            self._resv_peak[role] = max(self._resv_peak[role], held)
        self._pc_resv.inc(f"{role}_grants")
        self._pc_resv.set(f"{role}_held", held)
        return True

    def _release(self, role: str) -> None:
        with self._resv_lock:
            self._resv_purge(role)
            if self._resv[role]:
                self._resv[role].pop(0)
            held = len(self._resv[role])
        self._pc_resv.set(f"{role}_held", held)

    # ------------------------------------------------- bulk object moves --
    _RECOVERY_CHUNK_OBJS = 64
    _RECOVERY_CHUNK_BYTES = 64 << 20

    def _pull_objects(self, coll, src: int,
                      oids: List[str]) -> Dict[str, Any]:
        """{oid: bytes|None} from ONE holder — scatter-gather
        ``get_objects`` frames instead of a blocking round trip per
        object (the per-object `_pull_object` loop this replaces was
        the wire tier's recovery bottleneck).  The server byte-caps
        each reply and OMITS overflow oids; the loop re-requests the
        omissions until everything is answered or a round makes no
        progress (which reads as failure — None — for the rest)."""
        out: Dict[str, Any] = {}
        pending = list(oids)
        while pending:
            chunk = pending[:self._RECOVERY_CHUNK_OBJS]
            if src == self.id:
                for oid in chunk:
                    try:
                        out[oid] = self.store.read(coll, oid)
                    except IOError:
                        out[oid] = None
                pending = pending[len(chunk):]
                continue
            r = self._peer_req(src, _trace.stamp({
                "cmd": "get_objects", "coll": list(coll),
                "oids": chunk, "klass": "background_recovery"}))
            if not r:
                for oid in pending:
                    out.setdefault(oid, None)
                break
            out.update(r)
            pending = [o for o in pending if o not in out]
        return out

    def _push_objects(self, coll, dst: int, items) -> int:
        """Push [(oid, data)] to one member in bounded
        ``put_objects`` frames; returns objects landed."""
        from .objectstore import Transaction
        n = i = 0
        while i < len(items):
            chunk, nbytes = [], 0
            while i < len(items) and \
                    len(chunk) < self._RECOVERY_CHUNK_OBJS and \
                    nbytes < self._RECOVERY_CHUNK_BYTES:
                chunk.append(items[i])
                nbytes += len(items[i][1])
                i += 1
            if dst == self.id:
                txn = Transaction()
                for oid, data in chunk:
                    txn.write_full(coll, oid, data)
                self.store.apply_transaction(txn)
                n += len(chunk)
            elif self._peer_req(dst, _trace.stamp({
                    "cmd": "put_objects", "coll": list(coll),
                    "objs": [[oid, data] for oid, data in chunk],
                    "klass": "background_recovery"})) is not None:
                n += len(chunk)
        return n

    def _move_objects(self, coll, src: int, dst: int,
                      oids: List[str]) -> int:
        """Bulk pull from ``src`` + bulk push to ``dst``; returns
        objects moved (missing pulls and failed pushes both count
        against completeness — the caller must not advance
        last_complete past them)."""
        pulled = self._pull_objects(coll, src, oids)
        items = [(oid, pulled[oid]) for oid in oids
                 if pulled.get(oid) is not None]
        return self._push_objects(coll, dst, items)

    def _pull_object(self, coll, oid, holders) -> Optional[bytes]:
        for h in holders:
            if h == self.id:
                try:
                    return self.store.read(coll, oid)
                except IOError:
                    continue
            d = self._peer_req(h, _trace.stamp(
                {"cmd": "get_shard",
                 "coll": list(coll), "oid": oid,
                 "klass": "background_recovery"}))
            if d is not None:
                return d
        return None

    def _push_object(self, coll, oid, data, m) -> bool:
        from .objectstore import Transaction
        if m == self.id:
            self.store.apply_transaction(
                Transaction().write_full(coll, oid, data))
            return True
        return self._peer_req(m, _trace.stamp({
            "cmd": "put_shard", "coll": list(coll), "oid": oid,
            "data": data,
            "klass": "background_recovery"})) is not None

    def _recover_pg(self, coll: Tuple[int, int],
                    members: List[int],
                    strays: Optional[List[int]] = None
                    ) -> Dict[str, Any]:
        """Reservation gate around one PG's recovery: LOCAL slot on
        this primary, REMOTE slot on every other member — acquired
        all-or-nothing with rollback (never wait while holding, so
        concurrent primaries cannot deadlock); any denial returns
        ``{"deferred": True}`` for the caller's requeue loop.  This is
        the osd_max_backfills contract: concurrent PG recoveries
        saturate spare bandwidth without unbounded fan-in on one OSD,
        and client QoS survives because every recovery op already
        rides the background_recovery dmClock class."""
        me = self.id
        if not self._reserve("local"):
            return {"deferred": True, "by": me}
        got: List[int] = []
        try:
            for m in members:
                if m == me:
                    continue
                r = self._peer_req(m, {"cmd": "reserve_recovery",
                                       "role": "remote"})
                if r is None:
                    # UNREACHABLE member: no slot to take and no
                    # reason to defer — the recovery pass itself
                    # marks it incomplete (deferring here would let
                    # one dead-but-in-map member block every
                    # reachable member's recovery forever)
                    continue
                if not r.get("granted"):
                    return {"deferred": True, "by": m}
                got.append(m)
            return self._recover_pg_inner(coll, members, strays)
        finally:
            for m in got:
                self._peer_req(m, {"cmd": "release_recovery",
                                   "role": "remote"})
            self._release("local")

    def _recover_pg_inner(self, coll: Tuple[int, int],
                          members: List[int],
                          strays: Optional[List[int]] = None
                          ) -> Dict[str, Any]:
        """Primary-driven PG recovery running the PeeringState shape
        over the wire (GetInfo -> GetLog -> GetMissing -> Recovering
        or Backfilling, src/osd/PeeringState.h:561):

        1. GetInfo: every member reports its log bounds +
           last_complete (pg_info).  ``strays`` — OSDs OUTSIDE the
           current acting set — are consulted as info/log SOURCES
           only (the reference's past-interval/stray peering): a
           write that landed on a substitute member during a map
           flap must not become unreachable when the map heals and
           that member drops out of the set — without stray infos
           the newest log (and its objects) would be invisible to
           every future recovery pass.
        2. GetLog: the authority is the info-holder with the newest
           head; a stale primary first catches ITSELF up from it.
        3. GetMissing: per MEMBER (never a stray), if the
           authoritative log still covers its last_complete, recover
           by LOG DELTA — only the objects the log names after that
           version (deletes applied as deletes); otherwise fall back
           to BACKFILL (full listing diff, the pre-peering path).
        4. Recovered members merge the authority's log tail and
           advance last_complete (log_sync).
        Stats record which path each member took so chaos tests can
        assert delta vs backfill.
        """
        from .pglog import OP_DELETE
        me = self.id
        log = self._pglog(coll)
        infos: Dict[int, Dict] = {me: log.info()}
        stray_set = set(strays or []) - set(members)
        peers = [m for m in members if m != me] + \
            [s for s in sorted(stray_set) if s != me]
        for m in peers:
            inf = self._peer_req(m, {"cmd": "pg_info",
                                     "coll": list(coll)})
            if inf is not None:
                infos[m] = inf
        # a stray with an EMPTY log never held this PG — drop it so
        # the member loop below doesn't try to "recover" it
        for s in list(stray_set):
            if s in infos and tuple(infos[s]["head"]) == (0, 0):
                infos.pop(s)
        # authority = newest head (member or stray)
        auth = max(infos, key=lambda m: tuple(infos[m]["head"]))
        auth_head = tuple(infos[auth]["head"])
        stats: Dict[str, Any] = {"authority": auth, "mode": {},
                                 "delta_objects": 0,
                                 "backfill_objects": 0,
                                 "deletes_applied": 0, "copied": 0}

        def sync_member(m, entries, head):
            if m == me:
                from .objectstore import Transaction
                txn = Transaction()
                log.merge_tail_txn(txn, entries, head)
                self.store.apply_transaction(txn)
                return True
            return self._peer_req(m, {
                "cmd": "log_sync", "coll": list(coll),
                "entries": [(list(v), o, op) for v, o, op in entries],
                "head": list(head)}) is not None

        def auth_entries_after(v):
            if auth == me:
                return log.entries_after(v)
            r = self._peer_req(auth, {"cmd": "pg_log",
                                      "coll": list(coll),
                                      "after": list(v)})
            if r is None:
                return None
            return [(tuple(vv), o, op) for vv, o, op in r["entries"]]

        def listing_of(m):
            """None on a FAILED peer listing — an unreachable peer
            must read as 'unknown', never as 'holds nothing': a
            failure collapsed into an empty set once let a backfill
            pass copy nothing, then stamp the member current
            (last_complete = auth head with neither data nor log) —
            after which every future pass called it clean and the
            objects were unreachable to recovery forever.  The
            server-side twin of the CTL603 lost-object class."""
            if m == me:
                return set(o for o in self.store.list_objects(coll)
                           if not o.startswith("meta:"))
            r = self._peer_req(m, {"cmd": "list_pg",
                                   "coll": list(coll)})
            if r is None:
                return None
            return set(o for o in r if not o.startswith("meta:"))

        auth_listing = None
        for m in sorted(infos, key=lambda x: x != auth):
            if m == auth or m in stray_set:
                # strays are log/data SOURCES, never recovery
                # targets: the map does not want data there
                continue
            # recovery baseline: last_complete CLAMPED to the
            # member's own log head.  lc > head is impossible in a
            # healthy log (they advance together in one txn), so a
            # member showing it was stamped current by a broken past
            # pass (the swallowed-failure bug above) — trusting the
            # lie would read it as clean forever; clamping makes the
            # delta path re-copy from its true position and HEALS it
            lc = min(tuple(infos[m]["last_complete"]),
                     tuple(infos[m]["head"]))
            if lc >= auth_head:
                stats["mode"][str(m)] = "clean"
                continue
            covered = tuple(infos[auth]["tail"]) <= lc
            entries = auth_entries_after(lc) if covered else None
            complete = True       # every needed object moved
            if entries is not None:
                stats["mode"][str(m)] = "delta"
                # latest op per object wins (missing-set semantics of
                # PGLog::missing_since, over the fetched entries);
                # movement is BULK scatter-gather — one get_objects /
                # put_objects / delete_objects frame per bounded
                # chunk, not a blocking round trip per object
                latest: Dict[str, int] = {}
                for v, obj, op in entries:
                    latest[obj] = op
                dels = sorted(o for o, op in latest.items()
                              if op == OP_DELETE)
                copies = sorted(o for o, op in latest.items()
                                if op != OP_DELETE)
                stats["delta_objects"] += len(latest)
                if dels:
                    if m == me:
                        for obj in dels:
                            self._local_delete(coll, obj)
                    elif self._peer_req(m, _trace.stamp(
                            {"cmd": "delete_objects",
                             "coll": list(coll),
                             "oids": dels})) is None:
                        complete = False
                    stats["deletes_applied"] += len(dels)
                moved = self._move_objects(coll, auth, m, copies)
                stats["copied"] += moved
                if moved < len(copies):
                    complete = False
            else:
                stats["mode"][str(m)] = "backfill"
                if auth_listing is None:
                    auth_listing = listing_of(auth)
                if auth_listing is None:
                    # the AUTHORITY listing failed: nothing provable
                    # for this member, and nothing cacheable either
                    stats["mode"][str(m)] += "-incomplete"
                    continue
                have = listing_of(m)
                if have is None:
                    # an unreachable MEMBER means this pass proved
                    # nothing about it — never advance last_complete
                    # (the cached authority listing stays valid for
                    # the remaining members)
                    stats["mode"][str(m)] += "-incomplete"
                    continue
                objs = sorted(auth_listing - have)
                stats["backfill_objects"] += len(objs)
                moved = self._move_objects(coll, auth, m, objs)
                stats["copied"] += moved
                if moved < len(objs):
                    complete = False
                entries = auth_entries_after(lc)
                if entries is None:
                    # the log fetch failed: the data may have moved
                    # but the member's log view is unproven —
                    # last_complete must not advance past it
                    complete = False
                    entries = []
            # advance last_complete ONLY when every object landed —
            # a partial pass must stay visible to the next peering
            # round, or the gap is masked forever
            if complete:
                sync_member(m, entries, auth_head)
            else:
                stats["mode"][str(m)] += "-incomplete"
        return stats

    def _local_delete(self, coll, oid) -> None:
        from .objectstore import Transaction
        if self.store.exists(coll, oid):
            self.store.apply_transaction(
                Transaction().remove(coll, oid))

    def _scrub_pg(self, coll: Tuple[int, int], members: List[int],
                  repair: bool) -> Dict[str, Any]:
        """Cross-replica scrub over the wire (pg_scrubber role): every
        member digests every object; mismatching or absent copies are
        inconsistencies.  With ``repair`` the majority digest's bytes
        overwrite the minority (scrub repair)."""
        listings = {m: set() for m in members}
        for m in members:
            if m == self.id:
                listings[m] = set(
                    o for o in self.store.list_objects(coll)
                    if not o.startswith("meta:"))
            else:
                r = self._peer_req(m, {"cmd": "list_pg",
                                       "coll": list(coll)})
                listings[m] = set(o for o in (r or [])
                                  if not o.startswith("meta:"))
        universe = set().union(*listings.values())
        inconsistent: List[Dict[str, Any]] = []
        repaired = 0
        for oid in sorted(universe):
            digests: Dict[int, Optional[int]] = {}
            for m in members:
                if oid not in listings[m]:
                    digests[m] = None
                    continue
                if m == self.id:
                    try:
                        digests[m] = self.store.stat(coll,
                                                     oid)["csum"]
                    except (IOError, KeyError):
                        digests[m] = None
                else:
                    digests[m] = self._peer_req(
                        m, _trace.stamp(
                            {"cmd": "digest_shard",
                             "coll": list(coll), "oid": oid}))
            present = [d for d in digests.values() if d is not None]
            if not present or len(set(present)) == 1 and \
                    len(present) == len(members):
                continue
            # STRICT majority digest — on a tie (e.g. size-2 pool,
            # 1-vs-1) there is no safe repair source: report the
            # inconsistency but never overwrite either copy
            counts: Dict[int, int] = {}
            for d in present:
                counts[d] = counts.get(d, 0) + 1
            best = max(counts, key=counts.get)
            strict = counts[best] * 2 > len(members)
            bad = [m for m, d in digests.items() if d != best] \
                if strict else []
            inconsistent.append({
                "oid": oid, "bad_members": bad,
                "majority": best if strict else None,
                "no_majority": not strict})
            if repair and strict:
                holders = [m for m, d in digests.items() if d == best]
                data = self._pull_object(coll, oid, holders)
                if data is not None:
                    for m in bad:
                        if self._push_object(coll, oid, data, m):
                            repaired += 1
        return {"objects": len(universe),
                "inconsistent": inconsistent, "repaired": repaired}

    # --------------------------------------------------------- heartbeats --
    def _purge_dead_pools(self) -> None:
        """Map-driven PG teardown (the reference removes a deleted
        pool's PGs when the map lands): drop collections whose pool is
        gone from the fetched map.  Gated on the monotonic pool-id
        high-water mark so a collection created by a put that RACED
        this OSD's stale map (its pool id is above the fetched
        pool_id_max) is never mistaken for deleted-pool debris."""
        pool_id_max = int(self._map.get("pool_id_max", 0))
        if not pool_id_max:
            return               # pre-upgrade mon: no purge authority
        epoch = int(self._map.get("epoch", 0))
        if epoch == getattr(self, "_last_purge_epoch", -1):
            return               # nothing changed: skip the store scan
        self._last_purge_epoch = epoch
        live = {int(p["id"]) for p in self._map.get("pools", [])}
        from .objectstore import Transaction
        for coll in list(self.store.list_collections()):
            pid = coll[0]
            if pid in live or pid > pool_id_max:
                continue
            with self._pg_lock(tuple(coll)):
                txn = Transaction()
                for oid in self.store.list_objects(coll):
                    txn.remove(coll, oid)
                if len(txn):
                    self.store.apply_transaction(txn)
            with self._pglog_lock:
                self._pglogs.pop(tuple(coll), None)

    def _admin_store_fsck(self, args: Dict[str, Any]) -> Dict[str, Any]:
        """Admin-socket store fsck: walk every object (csum + layout
        checks); ``repair`` quarantines inconsistencies so recovery
        re-replicates them.  Updates the health rollup state the
        heartbeat reports to the mon."""
        repair = str(args.get("repair", "")).lower() in (
            "1", "true", "yes", "repair")
        bad = self.store.fsck(repair=repair)
        if repair:
            self.store_fsck_repaired += len(bad)
            self.store_fsck_errors = 0      # quarantined = consistent
        else:
            self.store_fsck_errors = len(bad)
        return {"backend": type(self.store).__name__,
                "errors": [[list(map(int, c)), o] for c, o in bad],
                "n_errors": len(bad),
                "repaired": len(bad) if repair else 0}

    def _report_store_health(self) -> None:
        """Roll boot-fsck damage up to the mon (STORE_DAMAGED).  Sent
        when nonzero, plus one zero report to clear the mon entry
        once a clean fsck resets the count — the _report_slow_ops
        pattern."""
        n = self.store_fsck_errors
        if n == 0 and not self._store_reported:
            return
        try:
            self.mon_client().call({
                "cmd": "report_store_health", "osd": self.id,
                "errors": n, "repaired": self.store_fsck_repaired})
            self._store_reported = n
        except (OSError, IOError):
            self._mon = None

    _UTIL_SCAN_INTERVAL_S = 5.0

    def _store_util(self) -> Dict[str, Any]:
        """Store utilization snapshot for the ClusterStats rollup:
        allocator-backed used/total bytes (BlueStore) plus per-pool
        object counts from the collection listing.  The object scan
        is O(store) so it runs at most every _UTIL_SCAN_INTERVAL_S;
        between scans the cached snapshot rides the (cheap, 1 s)
        perf-counter reports."""
        now = time.monotonic()
        cached = getattr(self, "_util_cache", None)
        if cached is not None and \
                now - cached[0] < self._UTIL_SCAN_INTERVAL_S:
            return cached[1]
        util: Dict[str, Any] = {"bytes": 0, "total_bytes": 0,
                                "objects": 0, "pools": {}}
        st = self.store
        alloc = getattr(st, "alloc", None)
        if alloc is not None:
            free = int(alloc.free_blocks)
            util["bytes"] = (st.n_blocks - free) * st.min_alloc
            util["total_bytes"] = st.device_bytes
        try:
            for coll in st.list_collections():
                # data shards only (the count_pool convention):
                # pglog/meta rows are bookkeeping, not user objects
                pid = int(coll[0])
                row = util["pools"].setdefault(
                    pid, {"objects": 0, "bytes": 0})
                for o in st.list_objects(coll):
                    if o.startswith("meta:"):
                        continue
                    util["objects"] += 1
                    row["objects"] += 1
                    try:
                        # per-pool BYTE accounting (onode sizes, the
                        # PGMap per-pool STORED figure): this is what
                        # lets `ceph df` quote bytes per pool — and a
                        # rebuild bench quote bytes-remaining —
                        # instead of the allocator-level '-'
                        row["bytes"] += int(
                            st.stat(coll, o)["size"])
                    except (IOError, KeyError):
                        pass      # torn object mid-fsck: count 0
        except (OSError, IOError):
            pass          # a store mid-fsck must not kill the report
        self._util_cache = (now, util)
        return util

    def _report_perf(self) -> None:
        """Ship this daemon's perf counters (histograms included) and
        store utilization to the mon's ClusterStats aggregator — the
        telemetry half of the heartbeat, next to the slow-op and
        store-health rollups."""
        now = time.time()
        if now - self._perf_reported < 1.0:
            return        # cheap cadence floor under fast heartbeats
        # heat BEFORE perf: _account_io bumps osd.io first and the
        # heat ledger second, so snapshotting in this order keeps
        # heat <= osd.io at every instant — the mon's agreement
        # assert depends on it
        heat = self.heat.dump()
        report = {"perf": _perf().dump_typed(), "heat": heat,
                  "util": self._store_util(), "ts": now}
        try:
            self.mon_client().call({"cmd": "report_perf",
                                    "osd": self.id,
                                    "report": report})
            self._perf_reported = now
        except (OSError, IOError):
            self._mon = None

    def _report_slow_ops(self) -> None:
        """Roll this process's slow-op summary up to the mon (daemon
        trackers are otherwise visible only on their own asok).  Sent when nonzero, plus one zero report to clear the
        mon entry once the window drains."""
        try:
            s = _op_tracker().slow_ops_summary()
        except Exception:
            return
        n = int(s.get("num", 0))
        if n == 0 and not self._slow_reported:
            return
        try:
            self.mon_client().call({"cmd": "report_slow_ops",
                                    "osd": self.id, "summary": s})
            self._slow_reported = n
        except (OSError, IOError):
            self._mon = None

    def _heartbeat_loop(self, interval: float, grace: int) -> None:
        # the OUTER catch is the thread's survival contract: this
        # loop is the daemon's only path back into the map (boot
        # re-announce, failure reports, map fetch) — ANY exception
        # that kills it leaves an alive daemon marked down FOREVER,
        # so non-IO surprises (encoding errors on a mangled reply, a
        # handler bug) must log and retry next round, the same rule
        # the mon election loop follows.
        while not self._stop.is_set():
            time.sleep(interval)
            try:
                self._heartbeat_once(grace)
            except Exception as e:
                from ..common.log import dout
                dout("osd", 5, f"osd.{self.id} heartbeat round "
                               f"failed: {e!r}")
                self._mon = None

    def _heartbeat_once(self, grace: int) -> None:
        try:
            self._map = self.mon_client().call({"cmd": "get_map"})
        except (OSError, IOError):
            self._mon = None
            return
        self._report_slow_ops()
        self._report_store_health()
        self._report_perf()
        self._purge_dead_pools()
        up = self._map.get("osd_up", [])
        # spuriously marked down (missed heartbeats during a stall
        # or injected drops) but clearly alive: re-announce — the
        # reference OSD re-sends MOSDBoot when it sees itself down
        # in a newer map (OSD::_committed_osd_maps)
        if self.id < len(up) and not up[self.id]:
            try:
                self.mon_client().call(
                    {"cmd": "osd_boot", "osd": self.id})
            except (OSError, IOError):
                self._mon = None
        for peer in range(len(up)):
            if peer == self.id or not up[peer]:
                continue
            try:
                self.peer_client(peer).call({"cmd": "ping"})
                self._hb_misses[peer] = 0
            except (OSError, IOError):
                self.drop_peer(peer)
                self._hb_misses[peer] = \
                    self._hb_misses.get(peer, 0) + 1
                if self._hb_misses[peer] >= grace:
                    try:
                        self.mon_client().call(
                            {"cmd": "report_failure", "target": peer})
                    except (OSError, IOError):
                        self._mon = None

    def run_forever(self, hb_interval: float = 0.5,
                    hb_grace: int = 2) -> None:
        # boot must not be fatal: with socket-failure injection (or a
        # mon mid-restart) every call of a boot attempt can drop, and
        # a daemon that EXITS on that leaves a bound-but-dead socket
        # refusing connections forever — the reference OSD retries
        # mon contact indefinitely, so do we
        backoff = ExpBackoff(base=0.2, cap=2.0, seed=self.id)
        attempt = 0
        while True:
            try:
                self.boot()
                break
            except (OSError, IOError):
                backoff.sleep(attempt)
                attempt += 1
        t = threading.Thread(target=self._heartbeat_loop,
                             args=(hb_interval, hb_grace), daemon=True)
        t.start()
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph-tpu-torch-daemon")
    ap.add_argument("role", choices=["mon", "osd"])
    ap.add_argument("--cluster-dir", required=True)
    ap.add_argument("--id", type=int, default=0)
    ap.add_argument("--hb-interval", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="the process's package default device: cuda "
                         "(default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from .. import resolve_device, set_default_device
    set_default_device(resolve_device(args.device))
    if args.role == "mon":
        d = MonDaemon(args.cluster_dir, rank=args.id)
        d.run_forever()
    else:
        d = OSDDaemon(args.id, args.cluster_dir)
        d.run_forever(hb_interval=args.hb_interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
