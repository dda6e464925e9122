"""Shared-memory ring lane for same-host client↔daemon payloads.

The vstart topology colocates every daemon with its clients, yet each
bulk payload still paid sendmsg+recv syscalls and a trip through two
kernel socket buffers — on syscall-priced hosts that
tax capped the whole wire tier (the wire bench decomposition).  This
module moves the BYTES out of band: the client appends each payload
to a file-backed ring both processes mmap, and only a doorbell — the
typed request meta plus ``[offset, length, gen, crc]`` — crosses the
socket (the reference's rdma/dpdk "posted buffer + completion"
shape, src/msg/async/rdma, grafted onto the unix-socket messenger).

Safety model:

  * ORDERING — the socket doorbell is the happens-before edge: the
    client publishes the record (payload, then seqlock header) before
    sending the doorbell, and the daemon only dereferences an extent
    named by a received doorbell.  No cross-process atomics needed.
  * INTEGRITY — the doorbell carries the payload's combined crc32
    inside the crc/MAC-protected socket frame; the daemon's ONE
    verify scan over the ring bytes (per-4KiB sub-crcs, combined)
    must reproduce it.  A torn/overwritten/bit-flipped ring record is
    REJECTED exactly like a corrupt socket frame: the connection
    drops and the client's resend machinery takes over
    (``wire.flip_bit`` has a fire site on the ring write path so the
    thrasher can prove it).
  * SEQLOCK — each record starts with (magic, gen, len); the daemon
    checks it before AND after the scan, so a client reusing the
    extent mid-read surfaces as a gen mismatch, not silent garbage.
  * RECLAIM — extents free when the op completes (reply or terminal
    failure); a resubmit-after-stream-death reuses the SAME extent,
    which is why the ring belongs to the (client, daemon) pool, not
    to one connection.  Ring full / lane refused / daemon restarted
    without the file ⇒ transparent fallback to the socket
    scatter-gather tail (no acked-write loss — proven by the kill9
    chaos test).
"""
from __future__ import annotations

import mmap
import os
import secrets
import struct
import zlib
from collections import deque
from typing import List, Optional, Tuple

from ..common import crcutil, faults
from ..common.lockdep import LockdepLock

_HDR = struct.Struct("<III")        # file header: magic, version, rsvd
_REC = struct.Struct("<IIQ")        # record: magic, gen, payload len
MAGIC = 0x5A57524E                  # "ZWRN"
REC_MAGIC = 0x5A57524B              # "ZWRK"
HDR_SPACE = 4096                    # header page; data area follows
_ALIGN = 64


class ShmRingError(IOError):
    pass


def sweep_stale(dir_path: str, prefix: str = "zwring") -> int:
    """Unlink ring files whose creator process is gone.  The filename
    embeds the creating pid (``<prefix>.<name>.<pid>.<hex>``) and the
    lane is same-host BY DESIGN, so pid liveness is an authoritative
    orphan test.  Ownership decides who sweeps what: daemons sweep
    CLIENT-created request rings (``zwring``) when they bind their
    socket — a kill9'd client can never reclaim its ring, and nothing
    else will; clients sweep DAEMON-created reply rings (``zwreply``)
    when they (re)connect — a kill9'd daemon orphans its reply rings
    the same way, and the daemon that replaces it creates fresh ones.
    Live rings (creator running) and rings a serving connection
    already mapped (mmap survives the unlink) are safe either way."""
    n = 0
    want = prefix.rstrip(".") + "."
    try:
        names = os.listdir(dir_path)
    except OSError:  # noqa: CTL603 — best-effort housekeeping: an
        # unreadable dir means nothing to sweep, not lost state
        return 0
    for fn in names:
        if not fn.startswith(want):
            continue
        try:
            pid = int(fn.split(".")[-2])
        except (ValueError, IndexError):
            continue
        try:
            os.kill(pid, 0)
            continue                  # creator alive: ring is live
        except ProcessLookupError:
            pass                      # creator gone: orphan
        except OSError:
            continue                  # EPERM etc — assume alive
        try:
            os.unlink(os.path.join(dir_path, fn))
            n += 1
        except OSError:
            pass
    return n


class ShmRing:
    """Client-side ring: single-owner allocator + record writer.

    Allocation is a bump cursor with wraparound over the data area;
    extents retire in completion order behind a deque of live records
    (out-of-order completions delay reuse, never corrupt it).  ``put``
    returns None when the contiguous space is exhausted — the caller
    falls back to the socket for that frame."""

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = int(size)
        if create:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL,
                         0o600)
            try:
                os.ftruncate(fd, HDR_SPACE + self.size)
                self.mm = mmap.mmap(fd, HDR_SPACE + self.size)
            finally:
                os.close(fd)
            _HDR.pack_into(self.mm, 0, MAGIC, 1, 0)
        else:
            raise ShmRingError("use ShmRing.create")
        self._lock = LockdepLock("wire.shmring", recursive=False)
        self._head = 0                  # next alloc offset (data area)
        self._gen = 0
        # (off, total_len, gen, freed) in allocation order
        self._live: deque = deque()
        self._used = 0
        self.closed = False

    @classmethod
    def create(cls, shm_dir: str, name: str, size: int,
               prefix: str = "zwring") -> "ShmRing":
        """Ring file next to the daemon's socket (both processes can
        reach it there); unique per creator process + pool.  The
        ``prefix`` names the OWNER: ``zwring`` = client-created
        request ring (daemon sweeps orphans at bind), ``zwreply`` =
        daemon-created reply ring (client sweeps orphans on
        reconnect) — the embedded pid is the creator's either way."""
        fname = (f"{prefix}.{name or 'pool'}.{os.getpid()}."
                 f"{secrets.token_hex(4)}")
        return cls(os.path.join(shm_dir, fname), size, create=True)

    # ---------------------------------------------------------- alloc --
    def _fit(self, need: int) -> Optional[int]:
        """Contiguous offset for ``need`` bytes, or None.  Live
        extents occupy [tail_off, head) in ring order."""
        if need > self.size:
            return None
        if not self._live:
            self._head = 0
            return 0
        tail = self._live[0][0]
        head = self._head
        if head == tail:
            # live extents cover the whole ring ([tail, head) wrapped
            # all the way around): FULL, not empty — allocating here
            # would overwrite the oldest in-flight record's seqlock
            # header and poison its doorbell
            return None
        if head > tail:
            if self.size - head >= need:
                return head
            if tail >= need:          # wrap: skip the ragged end
                return 0
            return None
        return head if tail - head >= need else None

    def put(self, data, combined: Optional[int] = None):
        """Write one payload record; returns the doorbell token or
        None (ring full / closed).  ``combined`` is the payload's
        crc32 when the caller already knows it (precomputed Csums —
        zero client scans); otherwise ONE scan here is the client's
        single integrity pass for this payload."""
        mv = crcutil.as_u8(data)
        ln = len(mv)
        need = _REC.size + ln
        need += (-need) % _ALIGN
        with self._lock:
            if self.closed:
                return None
            off = self._fit(need)
            if off is None:
                crcutil._counters().inc("shm_full")
                return None
            self._gen += 1
            gen = self._gen
            self._live.append([off, need, gen, False])
            self._head = (off + need) % self.size
            self._used += need
            base = HDR_SPACE + off
            self.mm[base + _REC.size:base + _REC.size + ln] = mv
            _REC.pack_into(self.mm, base, REC_MAGIC, gen, ln)
        if combined is None:
            combined = zlib.crc32(mv)
            crcutil.note_scan(ln, "shm_send")
        inj = faults.fire("wire.flip_bit", site="shm_ring")
        if inj is not None and ln:
            # corrupt ONE ring byte after the crc was taken: the
            # daemon's verify scan must reject the record and drop
            # the connection, exactly like the socket-frame flip
            pos = HDR_SPACE + off + _REC.size + (ln - 1)
            self.mm[pos] ^= 0x01
        pc = crcutil._counters()
        pc.inc("shm_frames")
        pc.inc("shm_bytes", ln)
        return ShmToken(off, ln, gen, combined & 0xFFFFFFFF)

    def free(self, tok: "ShmToken") -> None:
        with self._lock:
            for rec in self._live:
                if rec[0] == tok.off and rec[2] == tok.gen:
                    rec[3] = True
                    break
            while self._live and self._live[0][3]:
                _off, need, _gen, _ = self._live.popleft()
                self._used -= need

    def close(self, unlink: bool = False) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass                      # exported views keep it alive
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ShmToken:
    """Doorbell payload: where the bytes live + what they must hash
    to.  ``meta`` is the wire-encodable form carried on the request
    dict's ``_shm`` key."""

    __slots__ = ("off", "ln", "gen", "crc")

    def __init__(self, off: int, ln: int, gen: int, crc: int):
        self.off, self.ln, self.gen, self.crc = off, ln, gen, crc

    @property
    def meta(self) -> List[int]:
        return [self.off, self.ln, self.gen, self.crc]


class RingReader:
    """Daemon-side view of a client's ring (read-only mmap).  One per
    authenticated connection; ``read`` resolves a doorbell into a
    zero-copy memoryview plus the TRUSTED sub-crcs its verify scan
    produced (the same one-pass handoff the socket SG path does)."""

    def __init__(self, path: str, size: int):
        st = os.stat(path)
        if st.st_size < HDR_SPACE + size:
            raise ShmRingError(f"ring file shorter than advertised "
                               f"({st.st_size} < {HDR_SPACE + size})")
        fd = os.open(path, os.O_RDONLY)
        try:
            self.mm = mmap.mmap(fd, HDR_SPACE + size,
                                prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        magic, version, _ = _HDR.unpack_from(self.mm, 0)
        if magic != MAGIC:
            self.close()
            raise ShmRingError(f"bad ring magic {magic:#x}")
        self.size = int(size)
        self.path = path

    def _rec_hdr(self, off: int) -> Tuple[int, int, int]:
        return _REC.unpack_from(self.mm, HDR_SPACE + off)

    def read(self, meta, scanner=None
             ) -> Tuple[memoryview, crcutil.Csums]:
        """Resolve one doorbell: seqlock-check the record header,
        ONE verify scan (sub-crcs + combine) against the doorbell's
        crc, re-check the header.  Any mismatch raises WireError —
        the serve loop drops the connection like a poisoned socket
        frame.  ``scanner`` (a ``view -> Csums`` callable, e.g.
        ``wire.receive_csums``) replaces the host verify scan — the
        device-crc path: same combine verdict, zero host passes over
        the full blocks; a flipped ring byte still fails the combine
        and kills the connection exactly like the host path."""
        from .wire import WireError
        try:
            off, ln, gen, want = (int(meta[0]), int(meta[1]),
                                  int(meta[2]), int(meta[3]))
        except (TypeError, ValueError, IndexError):
            raise WireError("malformed shm doorbell")
        if off < 0 or ln < 0 or off + _REC.size + ln > self.size:
            raise WireError("shm doorbell extent out of bounds")
        magic, g, l = self._rec_hdr(off)
        if magic != REC_MAGIC or g != gen or l != ln:
            raise WireError(
                f"shm record header mismatch at {off} "
                f"(gen {g} != {gen} or len {l} != {ln})")
        view = memoryview(self.mm)[HDR_SPACE + off + _REC.size:
                                   HDR_SPACE + off + _REC.size + ln]
        if scanner is not None:
            csums = scanner(view)
            ok = csums.combined == (want & 0xFFFFFFFF)
        else:
            ok, csums = crcutil.verify_blocks(
                view, crcutil.CSUM_BLOCK, want, site="verify")
        if not ok:
            raise WireError("shm payload crc mismatch")
        magic, g, l = self._rec_hdr(off)      # seqlock re-check
        if magic != REC_MAGIC or g != gen:
            raise WireError("shm record overwritten mid-read")
        pc = crcutil._counters()
        pc.inc("shm_frames_served")
        pc.inc("shm_bytes_served", ln)
        return view, csums

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass                      # exported views keep it alive
