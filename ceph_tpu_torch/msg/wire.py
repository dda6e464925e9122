"""Socket wire protocol — typed envelopes between daemon processes.

The process-boundary transport of the messenger (the AsyncMessenger /
Protocol V2 role, src/msg/async/ProtocolV2.cc): length-prefixed,
CRC-protected frames carrying the same typed envelopes the in-process
queues move, over unix-domain or TCP sockets.  Kept deliberately small:
banner exchange, an authentication frame (common/auth.py — the
cephx handshake role), then framed request/reply.

Frame:  u32 magic | u32 type | u64 id | i32 shard | u32 len |
        u32 crc(wire_payload) | wire_payload
Secure mode (every frame after the auth handshake, Protocol V2's
crypto_onwire role, src/msg/async/crypto_onwire.cc): the payload is a
SEALED BOX under the session key (PRF-CTR encryption, encrypt-then-MAC
— common/auth.seal), so traffic is unreadable on the socket, plus a
32-byte HMAC-SHA256 trailer over header+ciphertext so the plaintext
header cannot be tampered with either.  Pre-auth frames (banner,
nonce, auth blobs) are plaintext by necessity; secrets inside them are
themselves sealed under entity keys.

Port of ``ceph_tpu/msg/wire.py``, copied but for the receive-verify
scanner (``receive_csums``), which differs from the reference in two
deliberate ways:

  * no silent fallback: ``wire_device_crc=on``, and ``auto`` while the
    package default device is CUDA, run the device crc
    (``ops/crc32_gf2.csums_for``, kernel K3's crc leg on the card) and
    a failure there raises; ``off``, and ``auto`` with the CPU asked
    for, host-scan as configured choices;
  * no sticky probe: whether ``auto`` engages is asked of the default
    device on every call, so ``set_default_device`` takes effect at
    once.
"""
from __future__ import annotations

import hmac
import os
import socket
import struct
import threading
import time
import zlib
from typing import Optional

from ..common import crcutil, faults
from .queue import Envelope

# messenger-frame faultpoints (the qa msgr-failures suite axes): armed
# by the thrasher / fault_injection admin command, never in production
faults.declare("wire.drop_frame",
               "drop an outbound frame before any byte hits the "
               "socket (connection torn down, peer sees a clean "
               "close) — the ms_inject_socket_failures send half")
faults.declare("wire.truncate_frame",
               "send only the first half of a frame, then tear the "
               "connection down — the peer's length-prefixed read "
               "unblocks with WireClosed when the socket dies")
faults.declare("wire.flip_bit",
               "flip one bit in the last byte of the assembled frame "
               "(payload crc in plaintext mode, MAC trailer in secure "
               "mode) — the receiver must REJECT the frame, never "
               "deliver corrupt bytes")

MAGIC = 0x43455054        # "CEPT"
BANNER = b"ceph-tpu v1\n"
_FHDR = struct.Struct("<IIQiII")
_U32 = struct.Struct("<I")
_MAC_LEN = 32
# unauthenticated peers control the length field: cap it so a forged
# header cannot make _recv_exact buffer gigabytes pre-auth (the
# Throttle/ms_max_message_size role)
MAX_FRAME = 256 << 20

# message types (the protocol's canonical home; cluster/daemon.py
# aliases these for its handshake/dispatch code)
MSG_AUTH_NONCE = 0x01
MSG_AUTH_SECRET = 0x02       # secret-mode proof
MSG_AUTH_TICKET = 0x03       # ticket-mode (ticket + authorizer)
MSG_AUTH_OK = 0x04
MSG_AUTH_FAIL = 0x05
MSG_REQ = 0x10               # typed-encoded {"cmd": ..., ...}
MSG_REPLY = 0x11
MSG_ERR = 0x12
MSG_REQ_SG = 0x13            # scatter-gather request: u32 metalen |
#                              encoded meta dict | raw data payload —
#                              bulk bytes never pass through the typed
#                              encoder (zero intermediate copies)
MSG_SET_MODE = 0x14          # authenticated per-connection downgrade
#                              to "crc" data mode (the reference's
#                              ms_mode crc vs secure negotiation)
MSG_SHM_ATTACH = 0x15        # same-host shared-memory ring handoff:
#                              the client asks the daemon to map its
#                              ring file; subsequent requests may then
#                              carry payloads out-of-band with only a
#                              doorbell (meta + ring extent + crc)
#                              crossing the socket (msg/shm_ring.py)
MSG_REPLY_SG = 0x16          # scatter-gather REPLY: u32 metalen |
#                              meta | raw bulk bytes — the reply value
#                              IS the data segment, and the daemon
#                              folds store-trusted blob csums into the
#                              frame crc (crc32_combine) so the reply
#                              leaves with ZERO send scans
MSG_SHM_FREE = 0x17          # reply-ring reclaim doorbell (client ->
#                              daemon, rid 0, no reply): the client
#                              consumed the reply records named in the
#                              payload, the daemon may reuse their
#                              extents.  Ordering: the client
#                              materializes the payload BEFORE sending
#                              this, so the extent is never read after
#                              it is freed.

# per-connection data modes after the auth handshake (the reference's
# ms_cluster_mode / ms_client_mode values, src/msg/msg_types.h):
#   secure — payload sealed (PRF-CTR + MAC): confidentiality + integrity
#   crc    — payload plaintext but hdr+payload HMAC'd under the session
#            key: integrity/authenticity only, the reference's DEFAULT
#            for intra-cluster traffic (and ~10x cheaper per byte on
#            stdlib-crypto hosts, which is what lets the multi-stream
#            data path reach device-adjacent rates)
MODE_SECURE = "secure"
MODE_CRC = "crc"


class WireError(IOError):
    pass


class WireClosed(WireError):
    pass


# cached ZeroWire config flags (common/crcutil.flag, observer-refreshed
# — the hot path must not pay a layered-options lookup per frame):
# wire_one_pass gates the sub-crc/combine integrity scan, wire_zero_copy
# the buffer-view spine (both default True; the bench's "before" phases
# flip them to price the legacy 3-pass/copying path against the same
# daemons)
_opt = crcutil.flag

# observer-cached wire_device_crc MODE (a string enum, not a bool, so
# crcutil.flag cannot carry it): auto / on / off, refreshed on config
# set like the hot bool flags
_dev_crc: dict = {}


def _device_crc_mode() -> str:
    v = _dev_crc.get("mode")
    if v is None:
        from ..common.options import config
        cfg = config()

        def _refresh(_n, val):
            _dev_crc["mode"] = str(val)

        cfg.observe("wire_device_crc", _refresh)
        v = _dev_crc["mode"] = str(cfg.get("wire_device_crc"))
    return v


def _device_worthwhile() -> bool:
    # asked on every call (no process cache): set_default_device must
    # take effect at once
    from ..ops import crc32_gf2
    return crc32_gf2.device_worthwhile()


def receive_csums(buf, site: str = "verify") -> crcutil.Csums:
    """THE receive-verify scanner — every inbound bulk payload
    (socket SG frames, request-ring doorbells, reply-ring records)
    funnels through here.  With ``wire_device_crc`` active the scan
    runs on the device (ops/crc32_gf2.csums_for: full 4-KiB blocks in
    ONE dispatch of kernel K3's crc leg, the sub-block tail
    host-scanned and counted at ``device_tail``) — ZERO host passes
    over the full blocks, with device dispatches counted separately so
    the zero is falsifiable.  A device failure raises: there is no
    fallback.  ``off``, and ``auto`` with the CPU asked for: one
    counted host pass, bit-identical verdict either way — a flipped
    bit fails the combine on both paths."""
    mode = _device_crc_mode()
    if mode == "on" or (mode == "auto" and _device_worthwhile()):
        from ..ops import crc32_gf2
        return crc32_gf2.csums_for(crcutil.as_u8(buf))
    # noqa: CTL131 — receive-direction counted host pass of the verify
    # (``off``, or ``auto`` with the CPU asked for), not a reply send
    # (flagged only because the serve loop hands this scanner to the
    # ring readers)
    return crcutil.Csums.scan(buf, block=crcutil.CSUM_BLOCK,  # noqa: CTL131
                              site=site)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # recv_into a preallocated buffer: bulk payloads land in place
    # (one allocation, no per-chunk copies) — on the multi-stream
    # data path this is a per-byte cost, not a nicety
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise WireClosed("peer closed")
        got += r
    return bytes(buf)  # noqa: CTL130 — pre-auth handshake frames
    # only (banner/nonce/auth blobs): small and off the data path


_IOV_MAX = 1024      # POSIX sysconf(_SC_IOV_MAX) floor; sendmsg with
                     # more iovecs fails EMSGSIZE, and a greedy batch
                     # drain of a deep window can exceed it


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """sendall over a scatter-gather buffer list: one syscall per
    window, partial sends resumed without re-joining the parts."""
    bufs = [memoryview(p) for p in parts if len(p)]
    while bufs:
        sent = sock.sendmsg(bufs[:_IOV_MAX])
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent and bufs:
            bufs[0] = bufs[0][sent:]


def _frame_parts(env_type: int, env_id: int, shard: int, parts,
                 session_key: Optional[bytes],
                 mode: str, data_csums=None) -> list:
    """Assemble one frame as a buffer list: header | payload [| mac].
    Per-byte integrity is mode-priced the way the reference prices
    ms_mode: secure seals and MACs every payload byte; crc mode runs
    one crc32 pass (C speed) and binds the digest into the header,
    whose HMAC is then constant-cost — the payload never feeds SHA256,
    which is the difference between ~150 MiB/s and line rate on a
    syscall-priced host.  Plaintext (no session key) is crc-only.

    ``data_csums`` (a crcutil.Csums for the LAST part — the bulk data
    segment) is the one-pass handoff: its combined sub-crcs are FOLDED
    into the frame crc via crc32_combine, so a payload whose csums are
    already known (device crc kernel, staging digest, content cache)
    crosses the sender with ZERO crc scans.  The wire value is
    bit-identical to a whole-payload zlib.crc32 — receivers cannot
    tell the difference."""
    crc = 0
    if session_key is not None and mode == MODE_SECURE:
        from ..common.auth import seal_parts
        parts = seal_parts(session_key, parts)
    elif data_csums is not None and parts and \
            data_csums.length == len(parts[-1]) and _opt("wire_one_pass"):
        for p in parts[:-1]:
            crc = zlib.crc32(p, crc)
            crcutil.note_scan(len(p), "send")
        crc = crcutil.crc32_combine(crc, data_csums.combined,
                                    data_csums.length)
    else:
        for p in parts:
            crc = zlib.crc32(p, crc)
            crcutil.note_scan(len(p), "send")
    total = sum(len(p) for p in parts)
    hdr = _FHDR.pack(MAGIC, env_type, env_id, shard, total, crc)
    if session_key is None:
        return [hdr] + list(parts)
    mac = hmac.new(session_key, hdr, "sha256")
    if mode == MODE_SECURE:
        for p in parts:
            mac.update(p)
    return [hdr] + list(parts) + [mac.digest()]


def prepare_frame(sock: socket.socket, env_type: int, env_id: int,
                  shard: int, parts,
                  session_key: Optional[bytes], mode: str,
                  src: Optional[str], dst: Optional[str],
                  data_csums=None) -> list:
    """Per-frame assembly with every wire faultpoint applied; returns
    the frame's buffer list WITHOUT sending it, so callers (the
    stream sender, the server's reply batching) can coalesce many
    frames into one sendmsg.  A fired drop/truncate raises exactly as
    the unbatched path did (truncate pushes its half-frame first)."""
    if src is not None and dst is not None and \
            faults.partitioned(src, dst):
        raise WireClosed(f"fault injected: {src} -> {dst} partitioned")
    blobs = _frame_parts(env_type, env_id, shard, parts,
                         session_key, mode, data_csums=data_csums)
    if faults.fire("wire.drop_frame", type=env_type) is not None:
        raise WireClosed("fault injected: frame dropped before send")
    if faults.fire("wire.truncate_frame", type=env_type) is not None:
        whole = b"".join(bytes(p) for p in blobs)  # noqa: CTL130 —
        # fault path only: the half-frame join never runs in production
        sock.sendall(whole[:max(1, len(whole) // 2)])
        raise WireClosed("fault injected: frame truncated mid-send")
    if faults.fire("wire.flip_bit", type=env_type) is not None:
        # last non-empty blob: MAC trailer (MAC'd frames), crc-covered
        # payload tail (plaintext), or the header itself when the
        # plaintext payload is empty — rejection every way
        for bi in range(len(blobs) - 1, -1, -1):
            tail = bytes(blobs[bi])
            if tail:
                blobs[bi] = tail[:-1] + bytes([tail[-1] ^ 0x01])
                break
    return blobs


def _send_parts(sock: socket.socket, env_type: int, env_id: int,
                shard: int, parts,
                session_key: Optional[bytes],
                mode: str,
                src: Optional[str], dst: Optional[str],
                data_csums=None) -> None:
    _sendmsg_all(sock, prepare_frame(sock, env_type, env_id, shard,
                                     parts, session_key, mode,
                                     src, dst, data_csums=data_csums))


def send_frame(sock: socket.socket, env: Envelope,
               session_key: Optional[bytes] = None,
               src: Optional[str] = None,
               dst: Optional[str] = None,
               mode: str = MODE_SECURE) -> None:
    """``src``/``dst`` are the sending/receiving entity names, passed
    by callers that know them (WireClient requests, WireServer
    replies): an armed ``net.partition`` that severs src -> dst drops
    the frame before any byte hits the socket — per-direction, so a
    oneway cut can deliver the request yet drop the reply (the
    half-open-link shape the session-replay machinery must absorb).
    ``mode`` applies only when a session key is present: "secure"
    seals the payload, "crc" sends it plaintext with a crc32 bound
    into the HMAC-authenticated header (constant-cost MAC)."""
    _send_parts(sock, env.type, env.id, env.shard,
                [env.payload or b""], session_key, mode, src, dst)


def send_frame_sg(sock: socket.socket, env_type: int, env_id: int,
                  meta: bytes, data,
                  session_key: Optional[bytes] = None,
                  src: Optional[str] = None,
                  dst: Optional[str] = None,
                  mode: str = MODE_SECURE,
                  data_csums=None) -> None:
    """Scatter-gather frame: typed-encoded ``meta`` plus a raw bulk
    ``data`` buffer shipped as separate segments of ONE frame
    (u32 metalen | meta | data), so multi-MB shard payloads go from
    their staging buffers to the socket without passing through the
    typed encoder or any intermediate join (crc mode: zero copies;
    secure mode: single cipher+MAC pass via auth.seal_parts).
    ``data_csums`` (crcutil.Csums of ``data``) folds precomputed
    sub-crcs into the frame crc instead of re-scanning."""
    _send_parts(sock, env_type, env_id, -1,
                [_U32.pack(len(meta)), meta, data],
                session_key, mode, src, dst, data_csums=data_csums)


def split_sg(payload):
    """Inverse of the SG payload layout: -> (meta_bytes, data).

    ``data`` is a zero-copy memoryview over the received frame buffer
    (the buffer stays alive as long as the view does — Python buffer
    semantics carry the lifetime); the meta prefix is materialized
    because the typed decoder wants bytes and it is ~100 bytes.  With
    ``wire_zero_copy`` off the legacy whole-payload copy runs and is
    COUNTED (copies/MiB in the bench decomposition)."""
    mv = crcutil.as_u8(payload)
    if len(mv) < 4:
        raise WireError("SG frame truncated")
    (mlen,) = _U32.unpack_from(mv, 0)
    if 4 + mlen > len(mv):
        raise WireError("SG meta length exceeds frame")
    data = mv[4 + mlen:]
    if not _opt("wire_zero_copy"):
        crcutil.note_copy(len(data), "split_sg")
        data = bytes(data)  # noqa: CTL130 — the counted legacy path
    return bytes(mv[4:4 + mlen]), data


# bulk payloads at/above this ride a scatter-gather frame: below it
# the typed encoder re-buffers anyway and the SG framing overhead
# dominates.  ONE constant shared by both senders (the async
# objecter's client streams and the daemon's peer client) — the
# zero-copy view contract relies on every sender agreeing on it.
SG_MIN = 1024


def extract_bulk(req, site: str):
    """Split a bulk ``data`` payload (and its precomputed ``_csums``)
    out of a request dict for the scatter-gather frame tail; returns
    (req, data|None, csums|None).  Zero-copy: the payload buffer
    (bytes, bytearray or memoryview — staged numpy shards arrive as
    views) goes to the frame assembly UNTOUCHED; with
    ``wire_zero_copy`` off the legacy materialization runs and is
    COUNTED at ``site``.  Sub-SG_MIN payloads ride the typed encoder
    (memoryviews materialized — tiny by definition) and drop their
    ``_csums`` (not wire-encodable, and the scan saved is tiny)."""
    payload = req.get("data") if isinstance(req, dict) else None
    if isinstance(payload, (bytes, bytearray, memoryview)) and \
            len(payload) >= SG_MIN:
        req = dict(req)
        data = req.pop("data")
        csums = req.pop("_csums", None)
        if not _opt("wire_zero_copy") and not isinstance(data, bytes):
            crcutil.note_copy(len(data), site)
            data = bytes(data)  # noqa: CTL130 — counted legacy path
        return req, data, csums
    if isinstance(req, dict) and ("_csums" in req or
                                  isinstance(payload, memoryview)):
        req = dict(req)
        req.pop("_csums", None)
        if isinstance(payload, memoryview):
            req["data"] = bytes(payload)  # noqa: CTL130 — sub-SG_MIN
            # payloads ride the typed encoder, which re-buffers
            # anyway (tiny by definition)
    return req, None, None


class BulkReply:
    """Handler-arm carrier for a bulk reply: the payload plus the
    Csums the STORE already trusts for it (BlueStore blob csums via
    read_with_csums, or a receive-verify product).  The serve loop's
    reply chokepoint turns it into a reply-ring record (same-host:
    zero copies, zero scans) or a MSG_REPLY_SG socket frame whose
    crc the trusted csums FOLD into (crc32_combine — zero send
    scans); in-process dispatch unwraps it to the raw value.  csums
    None means no trusted digest exists (compressed blob, csums off)
    — the send side scans once and COUNTS it, same as today."""

    __slots__ = ("data", "csums")

    def __init__(self, data, csums=None):
        self.data = data
        self.csums = csums

    def to_bytes(self) -> bytes:
        d = self.data
        return d if isinstance(d, bytes) else bytes(d)


def unwrap_bulk(val):
    """Collapse BulkReply carriers to their raw values — the
    in-process dispatch path (local OSD calls, tests poking
    _handle_inner) sees exactly what the wire client would."""
    if isinstance(val, BulkReply):
        return val.to_bytes()
    if isinstance(val, dict) and \
            any(isinstance(v, BulkReply) for v in val.values()):
        return {k: (v.to_bytes() if isinstance(v, BulkReply) else v)
                for k, v in val.items()}
    return val


def _parse_frame(hdr: bytes, payload, mac: Optional[bytes],
                 session_key: Optional[bytes],
                 mode: str) -> Envelope:
    """Verify one received frame (crc / MAC / unseal) — shared by the
    raw-socket recv_frame and the buffered SockReader.

    One-pass integrity (ZeroWire): for a scatter-gather frame (either
    direction — MSG_REQ_SG requests, MSG_REPLY_SG replies) the verify
    scan runs per 4-KiB sub-block of the data segment and the
    sub-crcs are COMBINED (crc32_combine) against the header crc —
    same accept/reject verdict as a whole-payload crc32, but the
    sub-crcs survive the verify as TRUSTED values on the returned
    envelope, which the daemon hands to BlueStore as ready-made blob
    csums: the store never scans payload bytes again.  The scan
    itself is ``receive_csums``: with ``wire_device_crc`` active it
    is the GF(2) matmul on the accelerator slice and the host never
    touches the full blocks at all."""
    magic, typ, mid, shard, ln, crc = _FHDR.unpack(hdr)
    csums = None
    if crc and typ in (MSG_REQ_SG, MSG_REPLY_SG) and \
            _opt("wire_one_pass"):
        mv = crcutil.as_u8(payload)
        if len(mv) < 4:
            raise WireError("payload crc mismatch")
        (mlen,) = _U32.unpack_from(mv, 0)
        dstart = 4 + mlen
        if dstart > len(mv):
            raise WireError("payload crc mismatch")
        head_crc = zlib.crc32(mv[:dstart])
        crcutil.note_scan(dstart, "verify")
        csums = receive_csums(mv[dstart:], site="verify")
        got = crcutil.crc32_combine(head_crc, csums.combined,
                                    csums.length)
        if got != crc:
            raise WireError("payload crc mismatch")
    elif crc:
        if zlib.crc32(payload) != crc:
            raise WireError("payload crc mismatch")
        crcutil.note_scan(len(payload), "verify")
    if session_key is not None:
        # the MAC covers the header always (which binds the crc field,
        # hence the payload, in crc mode) and the payload bytes only
        # in secure mode — mirror of _frame_parts' pricing
        want = hmac.new(session_key, hdr, "sha256")
        if mode == MODE_SECURE:
            want.update(payload)
        if mac is None or not hmac.compare_digest(mac, want.digest()):
            raise WireError("frame MAC rejected")
        if mode == MODE_SECURE:
            from ..common.auth import AuthError, unseal
            try:
                payload = unseal(session_key, bytes(payload))  # noqa: CTL130
                # — secure mode decrypts into fresh bytes by nature;
                # zero-copy applies to the crc data mode
            except AuthError as e:
                raise WireError(f"secure payload rejected: {e}")
    return Envelope(typ, mid, shard, payload, csums)


def _check_hdr(hdr: bytes) -> int:
    magic, typ, mid, shard, ln, crc = _FHDR.unpack(hdr)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic:#x}")
    if ln > MAX_FRAME:
        raise WireError(f"frame length {ln} exceeds cap {MAX_FRAME}")
    return ln


def recv_frame(sock: socket.socket,
               session_key: Optional[bytes] = None,
               mode: str = MODE_SECURE) -> Envelope:
    hdr = _recv_exact(sock, _FHDR.size)
    ln = _check_hdr(hdr)
    payload = _recv_exact(sock, ln) if ln else b""
    mac = _recv_exact(sock, _MAC_LEN) if session_key is not None \
        else None
    return _parse_frame(hdr, payload, mac, session_key, mode)


class SockReader:
    """Buffered frame reader over one socket.

    On hosts where every syscall is expensive (virtualized kernels —
    exactly where this repo's daemons run in CI), reading one frame
    as hdr/payload/mac recv calls costs three syscalls per frame;
    under a pipelined stream most of those frames are ALREADY in the
    kernel buffer.  This reader pulls large chunks and parses frames
    out of its own buffer: one recv can yield a whole window of
    pipelined frames (and ``try_frame`` drains them with no syscall
    at all, which is what lets a server batch its replies).

    A socket timeout mid-frame leaves the partial bytes buffered;
    the next read resumes where it stopped (the raw ``_recv_exact``
    path would have dropped them)."""

    # one recv per window, not per frame: sized to the 2 MiB kernel
    # buffers the streams set, so a full bulk frame (or several) lands
    # in ONE syscall — at ~1 ms/syscall a 256 KiB chunk made every
    # 1 MiB frame cost four recvs before any byte was parsed
    CHUNK = 1 << 21

    # payloads at/above this size take the DIRECT path: recv_into a
    # dedicated exact-size buffer handed out as a zero-copy memoryview
    # (no scratch->buf append, no _take materialization — the two
    # avoidable copies the legacy reader charged every bulk byte)
    BIG = 1 << 16

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray()
        self._pos = 0
        # persistent recv_into target: recv(CHUNK) would allocate (and
        # mmap) CHUNK bytes per call even for a 100-byte reply frame.
        # Starts small so the many control connections don't each pin
        # 2 MiB; the first bulk frame upgrades it to CHUNK for good.
        self._scratch = bytearray(1 << 16)
        # a direct big-frame read interrupted by a socket timeout
        # parks here and resumes on the next read_frame call (the
        # buffered path gets the same resume property from _buf)
        self._partial: Optional[tuple] = None

    def _avail(self) -> int:
        return len(self._buf) - self._pos

    def _fill(self, want: int) -> None:
        """Grow the buffer to at least ``want`` available bytes."""
        while self._avail() < want:
            if self._pos and self._pos >= (1 << 20):
                del self._buf[:self._pos]
                self._pos = 0
            if want - self._avail() > len(self._scratch):
                self._scratch = bytearray(self.CHUNK)
            r = self.sock.recv_into(self._scratch)
            if not r:
                raise WireClosed("peer closed")
            self._buf += memoryview(self._scratch)[:r]

    def _take(self, n: int) -> bytes:
        out = bytes(self._buf[self._pos:self._pos + n])
        self._pos += n
        if self._pos == len(self._buf):
            self._buf.clear()
            self._pos = 0
        return out

    def _take_view(self, n: int):
        """Zero-copy take: hand out a memoryview over the CURRENT
        buffer and retire it (a bytearray with an exported buffer can
        never be resized, so the reader starts a fresh one seeded
        with the few bytes that followed this frame — those would
        have been copied by their own _take anyway)."""
        old = self._buf
        view = memoryview(old)[self._pos:self._pos + n]
        self._buf = bytearray(memoryview(old)[self._pos + n:])
        self._pos = 0
        return view

    def _frame_len(self, with_mac: bool) -> Optional[int]:
        """Total length of the next frame if its header is buffered
        (validates it), else None."""
        if self._avail() < _FHDR.size:
            return None
        hdr = bytes(self._buf[self._pos:self._pos + _FHDR.size])
        ln = _check_hdr(hdr)
        return _FHDR.size + ln + (_MAC_LEN if with_mac else 0)

    def try_frame(self, session_key: Optional[bytes] = None,
                  mode: str = MODE_SECURE) -> Optional[Envelope]:
        """Parse one frame ENTIRELY from the buffer; None when the
        next frame is absent or incomplete (never a syscall)."""
        total = self._frame_len(session_key is not None)
        if total is None or self._avail() < total:
            return None
        return self._consume(session_key, mode)

    def read_frame(self, session_key: Optional[bytes] = None,
                   mode: str = MODE_SECURE) -> Envelope:
        """Blocking read of one frame (buffered; bulk payloads land
        DIRECTLY in a dedicated buffer — one recv-side copy total,
        handed out as a zero-copy view)."""
        if self._partial is not None:
            hdr, buf, got = self._partial
            return self._finish_big(hdr, buf, got, session_key, mode)
        self._fill(_FHDR.size)
        total = self._frame_len(session_key is not None)
        ln = total - _FHDR.size - \
            (_MAC_LEN if session_key is not None else 0)
        if ln >= self.BIG and _opt("wire_zero_copy"):
            hdr = self._take(_FHDR.size)
            buf = bytearray(ln)
            mv = memoryview(buf)
            have = min(self._avail(), ln)
            if have:
                mv[:have] = memoryview(self._buf)[
                    self._pos:self._pos + have]
                self._pos += have
                if self._pos == len(self._buf):
                    self._buf.clear()
                    self._pos = 0
            return self._finish_big(hdr, buf, have, session_key, mode)
        self._fill(total)
        return self._consume(session_key, mode)

    def _finish_big(self, hdr: bytes, buf: bytearray, got: int,
                    session_key: Optional[bytes],
                    mode: str) -> Envelope:
        """Drain the rest of a direct big-frame read; a socket timeout
        parks the partial state for the next call (the stream reader's
        idle/stall loop relies on resumability)."""
        mv = memoryview(buf)
        try:
            while got < len(buf):
                r = self.sock.recv_into(mv[got:])
                if not r:
                    raise WireClosed("peer closed")
                got += r
            mac = None
            if session_key is not None:
                self._fill(_MAC_LEN)
        except socket.timeout:
            self._partial = (hdr, buf, got)
            raise
        self._partial = None
        if session_key is not None:
            mac = self._take(_MAC_LEN)
        return _parse_frame(hdr, mv, mac, session_key, mode)

    def _consume(self, session_key: Optional[bytes],
                 mode: str) -> Envelope:
        hdr = self._take(_FHDR.size)
        ln = _FHDR.unpack(hdr)[4]
        if ln >= self.BIG and _opt("wire_zero_copy"):
            # whole frame already buffered (pipelined window): hand
            # out a view instead of materializing the payload
            payload = self._take_view(ln)
        elif ln:
            payload = self._take(ln)
            if ln >= self.BIG:
                crcutil.note_copy(ln, "reader")
        else:
            payload = b""
        mac = self._take(_MAC_LEN) if session_key is not None \
            else None
        return _parse_frame(hdr, payload, mac, session_key, mode)


def exchange_banners(sock: socket.socket) -> None:
    sock.sendall(BANNER)
    got = _recv_exact(sock, len(BANNER))
    if got != BANNER:
        raise WireError(f"bad banner {got!r}")


def raise_reply_error(payload: bytes) -> None:
    """Re-raise a MSG_ERR payload as the matching client-side
    exception (shared by the blocking WireClient and the async
    streams, so both paths surface identical error types)."""
    from . import encoding
    from ..common import auth as _cx
    name, msg = encoding.loads(payload)
    exc = {"IOError": IOError, "OSError": IOError,
           "KeyError": KeyError,
           "AuthError": _cx.AuthError,
           "PermissionError": PermissionError,
           "ClsError": IOError,
           "ObjectStoreError": IOError}.get(name, RuntimeError)
    raise exc(f"{name}: {msg}")


# ------------------------------------------------------------- streams ---

class Stream:
    """One PIPELINED framed connection — the async half of the
    messenger (AsyncConnection role): a bounded send window feeding a
    sender thread (frame assembly + crypto runs there, so N streams
    give N concurrent crypto lanes off the submitter's thread) and a
    reader thread matching replies to pending completions by frame id.
    Submissions never wait for replies; completions are delivered as
    ``cb(result, exc)`` callbacks from the reader thread.

    Built OVER an authenticated connection (a WireClient that finished
    its handshake): per-stream framing, faultpoints and the
    net.partition src/dst checks are exactly the blocking path's.  If
    ``mode`` is "crc" the stream performs the authenticated
    MSG_SET_MODE downgrade before pipelining begins.
    """

    def __init__(self, conn, mode: str = MODE_SECURE,
                 window: int = 16, ring=None,
                 want_reply: bool = False, resolver=None):
        import queue as _queue
        from ..common.lockdep import LockdepLock
        self._conn = conn                  # owns the socket lifetime
        self.sock = conn.sock
        self.key = conn.key
        self.entity = conn.entity
        self.peer = getattr(conn, "peer", None)
        self.mode = MODE_SECURE
        self.ring_ok = False
        # daemon→client reply ring (RingReply): ``want_reply`` asks
        # for one in the MSG_SHM_ATTACH handshake; the daemon's ack
        # names its ring file in ``reply_info`` = (path, size).  The
        # ``resolver`` (StreamPool.resolve_reply) turns reply-ring
        # doorbells arriving on this stream back into bytes.
        self._want_reply = bool(want_reply)
        self._resolver = resolver
        self.reply_info = None
        # MSG_SHM_FREE doorbells that hit a full send window park
        # here and ride the front of the next free (order preserved;
        # frees are idempotent daemon-side so a lost one only delays
        # extent reuse until conn close)
        self._free_backlog: list = []
        self.dead = False
        # True while the sender thread is inside sendmsg: a full
        # window + a socket-blocked sender means the PEER is the
        # bottleneck (the pool must not spill to more streams); a
        # full window with the sender in crypto/assembly means this
        # lane's CPU is, and a second lane genuinely helps
        self.sending = False
        self._id = 0
        self._lock = LockdepLock("wire.stream", recursive=False)
        self._pending = {}                 # id -> (cb, t_submit)
        self._sendq = _queue.Queue(maxsize=max(1, window))
        self._stall_s = (self.sock.gettimeout() or 30.0) * 2.0
        # deep kernel buffers: a pipelined stream must absorb a full
        # window of bulk frames without blocking the sender mid-batch
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, 1 << 21)
            except OSError:
                pass
        if mode == MODE_CRC:
            self._negotiate_crc()
        if ring is not None:
            self._attach_ring(ring)
        self._sender = threading.Thread(
            target=self._sender_loop, daemon=True,
            name=f"stream-send-{self.peer}")
        self._reader = threading.Thread(
            target=self._reader_loop, daemon=True,
            name=f"stream-recv-{self.peer}")
        self._sender.start()
        self._reader.start()

    # ------------------------------------------------------ handshake --
    def _negotiate_crc(self) -> None:
        """Authenticated downgrade to crc data mode: the request and
        its ack travel sealed+MAC'd, so a middle box cannot forge the
        downgrade; only then do frames switch to crc'd plaintext
        under header-only HMAC.  ``reply_sg`` advertises that this
        reader understands MSG_REPLY_SG frames — the daemon sends
        bulk replies scatter-gather (trusted csums folded, zero send
        scans) only to connections that said so; legacy blocking
        clients keep getting typed replies."""
        from . import encoding
        send_frame(self.sock, Envelope(
            MSG_SET_MODE, 0, -1,
            encoding.dumps({"mode": MODE_CRC, "reply_sg": True})),
            session_key=self.key, src=self.entity, dst=self.peer)
        env = recv_frame(self.sock, session_key=self.key)
        if env.type != MSG_REPLY:
            raise WireError("mode negotiation rejected")
        self.mode = MODE_CRC

    def _attach_ring(self, ring) -> None:
        """Shared-memory lane negotiation (the session_hello-time
        handoff): ask the daemon to map this client's ring file.  The
        request and ack ride the authenticated connection, so only
        the cephx-verified peer learns the path.  A daemon that
        refuses (shm disabled, foreign path) leaves the stream on the
        pure socket lane — fallback is per-stream and silent.  With
        ``want_reply`` the request also asks for the daemon→client
        REPLY ring; an accepting daemon's ack carries its ring file
        as ``reply_path``/``reply_size`` (one reply ring per client
        request ring, shared by every conn of the pool)."""
        from . import encoding
        send_frame(self.sock, Envelope(
            MSG_SHM_ATTACH, 0, -1,
            encoding.dumps({"path": ring.path, "size": ring.size,
                            "reply": self._want_reply})),
            session_key=self.key, src=self.entity, dst=self.peer,
            mode=self.mode)
        env = recv_frame(self.sock, session_key=self.key,
                         mode=self.mode)
        ack = encoding.loads(bytes(env.payload)) \
            if env.type == MSG_REPLY else {}
        self.ring_ok = bool(isinstance(ack, dict) and ack.get("ok"))
        if self.ring_ok and self._want_reply and ack.get("reply_path"):
            self.reply_info = (str(ack["reply_path"]),
                               int(ack.get("reply_size") or 0))

    # --------------------------------------------------------- submit --
    def inflight(self) -> int:
        with self._lock:
            return len(self._pending)

    def submit(self, req_meta: bytes, data=None, cb=None,
               csums=None) -> None:
        """Queue one request frame (blocks only on the send window).
        ``req_meta`` is the typed-encoded request dict; ``data``, when
        given, rides the scatter-gather tail (MSG_REQ_SG) straight
        from its buffer; ``csums`` (crcutil.Csums of ``data``) lets
        the sender fold precomputed sub-crcs into the frame crc
        instead of re-scanning.  ``cb(result, exc)`` fires from the
        reader thread on reply, or with the error that killed the
        stream."""
        with self._lock:
            if self.dead:
                raise WireClosed(f"stream to {self.peer} is dead")
            self._id += 1
            rid = self._id
            self._pending[rid] = (cb, time.monotonic())
        # bounded-wait put: a stream that dies with a FULL window has
        # no sender draining it — the pending entry registered above
        # already got its failure callback from _fail_all, but this
        # producer must not block forever on the dead queue
        import queue as _q
        while True:
            try:
                self._sendq.put((rid, req_meta, data, csums),
                                timeout=0.2)
                return
            except _q.Full:
                with self._lock:
                    if self.dead:
                        raise WireClosed(
                            f"stream to {self.peer} died mid-submit")

    def try_submit(self, req_meta: bytes, data=None, cb=None,
                   csums=None) -> bool:
        """Non-blocking submit: False when the send window is full
        (the pool's spill signal — this sender is saturated)."""
        import queue as _q
        with self._lock:
            if self.dead:
                return False
            self._id += 1
            rid = self._id
            self._pending[rid] = (cb, time.monotonic())
        try:
            self._sendq.put_nowait((rid, req_meta, data, csums))
            return True
        except _q.Full:
            with self._lock:
                self._pending.pop(rid, None)
            return False

    def queue_free(self, payload: bytes) -> None:
        """Queue one MSG_SHM_FREE reclaim doorbell (rid 0 — no
        pending entry, the daemon never replies).  Non-blocking from
        the reader thread: a full send window parks the doorbell on
        the backlog, flushed by the next call; a dead stream drops
        it (the daemon's conn-close cleanup frees the extents)."""
        import queue as _q
        with self._lock:
            if self.dead:
                return
            items, self._free_backlog = \
                self._free_backlog + [payload], []
        for i, p in enumerate(items):
            try:
                self._sendq.put_nowait((0, p, None, None))
            except _q.Full:
                with self._lock:
                    self._free_backlog = \
                        items[i:] + self._free_backlog
                return

    # -------------------------------------------------------- threads --
    def _sender_loop(self) -> None:
        import queue as _q
        while True:
            item = self._sendq.get()
            if item is None:
                return
            # greedy drain: every frame already queued rides ONE
            # sendmsg — per-frame thread wakeups and syscalls are
            # what caps small-op throughput on a busy host, and the
            # coalesced write is how "batch i+1 encodes while batch
            # i is on the wire" survives the GIL.  Fault checks
            # (partition, drop/truncate/flip) stay per-frame.
            batch = [item]
            try:
                while True:
                    nxt = self._sendq.get_nowait()
                    if nxt is None:
                        self._sendq.put(None)   # close() sentinel
                        break
                    batch.append(nxt)
            except _q.Empty:
                pass
            try:
                blobs: list = []
                for rid, meta, data, csums in batch:
                    if rid == 0:
                        # reply-ring reclaim doorbell (queue_free):
                        # a control frame riding the same coalesced
                        # sendmsg as the data frames around it
                        typ, parts = MSG_SHM_FREE, [meta]
                    elif data is None:
                        typ, parts = MSG_REQ, [meta]
                    else:
                        typ = MSG_REQ_SG
                        parts = [_U32.pack(len(meta)), meta, data]
                    blobs.extend(prepare_frame(
                        self.sock, typ, rid, -1, parts, self.key,
                        self.mode, self.entity, self.peer,
                        data_csums=csums))
                self.sending = True
                try:
                    _sendmsg_all(self.sock, blobs)
                finally:
                    self.sending = False
            except (OSError, IOError) as e:
                self._fail_all(e)
                return

    def _reader_loop(self) -> None:
        rd = SockReader(self.sock)
        while True:
            try:
                env = rd.read_frame(session_key=self.key,
                                    mode=self.mode)
            except socket.timeout:
                # idle is fine; a pending op older than the stall
                # bound means the peer wedged mid-reply — fail the
                # stream so callers retry elsewhere (the blocking
                # client's per-call socket timeout, stream-shaped)
                with self._lock:
                    oldest = min((t for _, t in
                                  self._pending.values()),
                                 default=None)
                if oldest is not None and \
                        time.monotonic() - oldest > self._stall_s:
                    self._fail_all(IOError(
                        f"stream to {self.peer}: reply stalled "
                        f"past {self._stall_s:.0f}s"))
                    return
                continue
            except (OSError, IOError) as e:
                self._fail_all(e)
                return
            with self._lock:
                ent = self._pending.pop(env.id, None)
            if ent is None:
                continue                   # unsolicited/duplicate id
            cb = ent[0]
            if cb is None:
                continue
            result, exc, poison = None, None, None
            if env.type == MSG_ERR:
                try:
                    raise_reply_error(env.payload)
                except Exception as e:
                    exc = e
            elif env.type == MSG_REPLY_SG:
                # bulk reply: the data segment IS the reply value,
                # already one-pass verified by _parse_frame (device
                # crc when armed).  Materialized once here — the
                # ownership copy out of the reader's frame buffer,
                # same convention as the typed decoder's output —
                # then the buffer retires.
                try:
                    _meta, data = split_sg(env.payload)
                    result = bytes(data)  # noqa: CTL130 — ownership copy out of the retiring frame buffer, not an avoidable dup
                except Exception as e:
                    exc = e
            else:
                from . import encoding
                try:
                    result = encoding.loads(env.payload)
                except Exception as e:
                    exc = e
                if exc is None and self._resolver is not None and \
                        isinstance(result, dict) and \
                        len(result) == 1 and \
                        ("_shm_reply" in result or
                         "_shm_objs" in result):
                    # reply-ring doorbell: resolve the ring extents
                    # to bytes (verify scan via receive_csums) and
                    # queue the reclaim doorbell.  A poisoned record
                    # gets connection-drop parity with a flipped
                    # socket frame: deliver the error, then kill the
                    # stream so the caller's retry machinery re-asks.
                    try:
                        result = self._resolver(result, self)
                    except WireError as e:
                        result, poison = None, e
                    except Exception as e:
                        exc = e
            try:
                cb(result, exc if poison is None else poison)
            except Exception:
                pass                       # callbacks must not kill IO
            if poison is not None:
                self._fail_all(poison)
                return

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            if self.dead:
                pending, self._pending = self._pending, {}
            else:
                self.dead = True
                pending, self._pending = self._pending, {}
            # parked reclaim doorbells die with the conn — the
            # daemon's conn-close cleanup frees the extents
            self._free_backlog = []
        try:
            self.sock.close()
        except OSError:
            pass
        # drain unsent frames so no submitter blocks on a dead window
        try:
            while True:
                self._sendq.get_nowait()
        except Exception:
            pass
        for cb, _t in pending.values():
            if cb is None:
                continue
            try:
                cb(None, exc)
            except Exception:
                pass

    def close(self) -> None:
        self._fail_all(WireClosed("stream closed"))
        try:
            self._sendq.put_nowait(None)
        except Exception:
            pass


class StreamPool:
    """N parallel pipelined streams to ONE daemon: a logical op's
    shard fan-out (and whole batches of ops) stripe across the
    streams, so frame crypto and socket writes run concurrently while
    the daemon's per-connection threads handle them in parallel.
    Streams are built lazily from ``factory`` (an authenticated
    connection constructor — the mon-ticket handshake happens there)
    and replaced when they die; a dead daemon surfaces as the
    factory's connect error on the caller."""

    def __init__(self, factory, size: int = 4,
                 mode: str = MODE_CRC, window: int = 16,
                 name: str = "", shm_dir: Optional[str] = None,
                 shm_bytes: int = 0):
        from ..common.lockdep import LockdepLock
        self._factory = factory
        self.size = max(1, int(size))
        self.mode = mode
        self.window = max(1, int(window))
        self.name = name
        self._lock = LockdepLock("wire.streampool", recursive=False)
        self._streams = []
        # same-host shared-memory lane (msg/shm_ring.py): ONE ring
        # per (client, daemon) pair shared by every stream of this
        # pool — a resubmit on a fresh stream must still find the
        # payload at the extents baked into the doorbell meta.  Built
        # lazily with the first stream; any daemon refusal disables
        # the lane for good (pure-socket fallback, no renegotiation
        # churn).
        self._shm_dir = shm_dir
        self._shm_bytes = int(shm_bytes)
        self._ring_obj = None
        self._ring_dead = shm_bytes <= 0 or shm_dir is None
        # daemon→client reply ring (RingReply): the daemon creates
        # and bump-allocates it, this pool only MAPS it (RingReader)
        # and reclaims consumed records via MSG_SHM_FREE doorbells.
        # One reply ring per client request ring — a reply doorbell
        # resolved on any stream of the pool finds the same extents.
        self._reply_reader = None
        self._want_reply = not self._ring_dead and \
            crcutil.flag("wire_reply_ring")
        # True only after a stream's MSG_SHM_ATTACH was ACCEPTED: a
        # doorbell baked into a frame before the verdict is known
        # would turn an attach refusal into a hard op failure (the
        # daemon cannot resolve it), so payloads ride the socket
        # until the lane is proven up
        self._ring_attached = False

    def _ring(self):
        with self._lock:
            if self._ring_dead:
                return None
            if self._ring_obj is None:
                try:
                    from .shm_ring import ShmRing
                    self._ring_obj = ShmRing.create(
                        self._shm_dir, self.name, self._shm_bytes)
                except OSError:
                    self._ring_dead = True
                    return None
            return self._ring_obj

    def _ensure_attach(self) -> None:
        """Resolve the attach verdict BEFORE any doorbell is staged:
        grow the first stream (whose construction runs the
        MSG_SHM_ATTACH handshake synchronously) when none is live
        yet.  Streams that already exist carry a verdict — attach
        happens inside Stream.__init__, so 'live stream + not
        attached' can only mean the daemon refused (lane dead)."""
        with self._lock:
            if self._ring_dead or self._ring_attached:
                return
            have = any(not s.dead for s in self._streams)
        if not have:
            try:
                self._grow()
            except (OSError, IOError):
                pass          # daemon unreachable: submit will retry

    def ring_put(self, data, csums=None):
        """Stage one payload in the shared-memory ring; returns the
        doorbell token (meta extent + crc) or None when the lane is
        unavailable/full — the caller falls back to the socket
        scatter-gather tail transparently.  Never stages before some
        stream's attach handshake has been ACCEPTED: a doorbell baked
        into a frame before the verdict would turn a refusal into a
        hard op failure (the daemon cannot resolve it)."""
        self._ensure_attach()
        with self._lock:
            if not self._ring_attached or self._ring_dead:
                return None
        ring = self._ring()
        if ring is None:
            return None
        combined = csums.combined if (
            csums is not None and csums.length == len(data)) else None
        return ring.put(data, combined)

    def ring_free(self, tok) -> None:
        with self._lock:
            ring = self._ring_obj
        if ring is not None:
            ring.free(tok)

    def ring_live(self) -> bool:
        with self._lock:
            return self._ring_obj is not None and not self._ring_dead

    def _live(self) -> list:
        with self._lock:
            self._streams = [s for s in self._streams if not s.dead]
            return list(self._streams)

    def _grow(self) -> Stream:
        # client-side orphan sweep on every (re)connect: a kill9'd
        # daemon can never unlink the reply rings IT created, and
        # the daemon that replaces it makes fresh ones — same
        # creator-pid liveness rule as the daemon's zwring sweep at
        # bind, mirrored (the ring-ownership fix)
        if self._shm_dir is not None and not self._ring_dead:
            try:
                from .shm_ring import sweep_stale
                sweep_stale(self._shm_dir, prefix="zwreply")
            except OSError:
                pass
        # build outside the pool lock: the factory does wire RTTs
        st = Stream(self._factory(), mode=self.mode,
                    window=self.window, ring=self._ring(),
                    want_reply=self._want_reply,
                    resolver=self.resolve_reply)
        if self._ring() is not None:
            with self._lock:
                if st.ring_ok:
                    self._ring_attached = True
                else:
                    # the daemon refused the mapping: disable the
                    # lane (every stream of a pool must agree — a
                    # doorbell routed to a ring-less connection
                    # would error)
                    self._ring_dead = True
        if st.reply_info is not None:
            self._open_reply_reader(*st.reply_info)
        with self._lock:
            self._streams.append(st)
        return st

    def _open_reply_reader(self, path: str, size: int) -> None:
        """Map the daemon's reply ring named in an accepted attach
        ack.  Mirrors the daemon's own path check: the ring file must
        live in this pool's shm dir (next to the daemon socket) — an
        ack naming a foreign path leaves the reply lane off.  The
        ring PATH keys the daemon generation (creator pid + random
        token in the filename): an ack naming a different path means
        the daemon restarted and made a fresh ring, so the stale
        mapping is replaced — resolving a new doorbell against the
        dead generation's mmap would fail every retry forever."""
        with self._lock:
            cur = self._reply_reader
            if self._ring_dead or \
                    (cur is not None and cur.path == path):
                return
        if self._shm_dir is None or os.path.dirname(
                os.path.realpath(path)) != os.path.realpath(
                    self._shm_dir):
            return
        try:
            from .shm_ring import RingReader
            rd = RingReader(path, size)
        except (OSError, IOError):  # noqa: CTL603 — the reply ring
            # is an OPTIMIZATION lane: a map failure here must not
            # poison the pool (the daemon falls back to MSG_REPLY_SG
            # socket frames for every reply it cannot ring), so
            # "absent reader" is the correct, fully-served state.
            return
        stale = None
        with self._lock:
            cur = self._reply_reader
            if cur is not None and cur.path == path:
                rd.close()            # raced with another _grow
                return
            stale, self._reply_reader = cur, rd
        if stale is not None:
            stale.close()

    def resolve_reply(self, result: dict, stream: Stream):
        """Resolve a reply-ring doorbell (called from a stream reader
        thread): read each named extent through ``receive_csums``
        (device crc when armed — zero host passes), materialize the
        bytes, THEN queue the MSG_SHM_FREE reclaim doorbell — the
        daemon never reuses an extent before its free arrives, so the
        read is race-free by construction.  ``_shm_reply`` marks a
        whole-reply bulk value; ``_shm_objs`` a recovery-pull dict
        whose values may each be a ring extent.  WireError (torn or
        poisoned record) propagates — the caller kills the stream,
        connection-drop parity with a flipped socket frame."""
        rd = self._reply_reader
        if rd is None:
            raise WireError("reply doorbell without a mapped "
                            "reply ring")
        pc = crcutil._counters()
        frees: list = []
        try:
            if "_shm_reply" in result:
                meta = result["_shm_reply"]
                view, _cs = rd.read(meta, scanner=receive_csums)
                out = bytes(view)
                frees.append([int(meta[0]), int(meta[2])])
                pc.inc("shm_reply_frames_served")
                pc.inc("shm_reply_bytes_served", len(out))
                return out
            objs = result["_shm_objs"]
            out_d: dict = {}
            for oid, m in objs.items():
                if isinstance(m, (list, tuple)):
                    view, _cs = rd.read(m, scanner=receive_csums)
                    out_d[oid] = bytes(view)
                    frees.append([int(m[0]), int(m[2])])
                    pc.inc("shm_reply_frames_served")
                    pc.inc("shm_reply_bytes_served", len(out_d[oid]))
                else:
                    out_d[oid] = m    # inline bytes / None
            return out_d
        finally:
            if frees:
                from . import encoding
                stream.queue_free(encoding.dumps(frees))

    def submit(self, req_meta: bytes, data=None, cb=None,
               csums=None) -> None:
        """Fill-first with spill-on-backpressure: the frame goes to
        the FIRST live stream whose send window has room — frames
        concentrate on few streams (deep sender batches, few hot
        threads), and a new stream spins up only when every live
        sender is saturated (its crypto+socket lane is the
        bottleneck), up to ``size``.  Hosts with spare cores spread
        to real parallel lanes; small hosts self-limit instead of
        thrashing.  Raises the connect/submit error when no stream
        can take the frame — the caller's retry-once contract
        handles it like any dropped connection."""
        last: Optional[Exception] = None
        for _ in range(2):
            live = self._live()
            try:
                taken = False
                for st in live:
                    if st.try_submit(req_meta, data=data, cb=cb,
                                     csums=csums):
                        taken = True
                        break
                if taken:
                    return
                if len(live) < self.size and \
                        not any(st.sending for st in live):
                    # every window full with senders CPU-bound in
                    # crypto/assembly: a new lane adds throughput.
                    # (A sender blocked INSIDE sendmsg means the
                    # peer is saturated — more connections to the
                    # same daemon add contention, not capacity.)
                    self._grow().submit(req_meta, data=data, cb=cb,
                                        csums=csums)
                else:
                    # every window full at the cap: block on the
                    # least-loaded sender until it drains
                    min(live,
                        key=lambda s: s.inflight()).submit(
                            req_meta, data=data, cb=cb, csums=csums)
                return
            except (OSError, IOError) as e:
                last = e
        raise last if last is not None else WireClosed("pool closed")

    def streams_live(self) -> int:
        with self._lock:
            return len([s for s in self._streams if not s.dead])

    def close(self) -> None:
        with self._lock:
            streams, self._streams = self._streams, []
            ring, self._ring_obj = self._ring_obj, None
            reply_rd, self._reply_reader = self._reply_reader, None
            self._ring_dead = True
        for s in streams:
            s.close()
        if ring is not None:
            ring.close(unlink=True)
        if reply_rd is not None:
            reply_rd.close()          # the DAEMON owns the unlink
