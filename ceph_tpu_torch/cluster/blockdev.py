"""BlockDevice — the store tier's one door to persistent media.

Role of the reference's block-device abstraction under BlueStore
(src/os/bluestore/KernelDevice.cc: aio writes, flush() barriers) plus
the crash-state *recorder* the CrashDev harness (cluster/crashdev.py)
needs: every byte the storage tier persists — BlueStore data pwrites,
WalDB WAL appends, KV snapshots, MANIFEST renames, FileStore log
appends — crosses this API, so the recorder sees the complete
(offset, bytes, barrier-epoch) stream and can enumerate what a power
cut at any instruction could have left on media.

Model (the ALICE/CrashMonkey block-order model, restricted to what
these stores actually rely on):

  * ``pwrite``/``append`` are asynchronous: until the file's next
    ``fsync`` they are *pending* — a crash may persist each of them
    fully, partially (torn), or not at all, in any order;
  * ``fsync`` is a **barrier**: everything written to that file
    before it is durable once it returns;
  * ``replace`` (atomic rename) and ``unlink``/``truncate`` are
    treated as ordering points for the file(s) they touch — the
    stores only rename files whose bytes were fsynced first (the
    write-tmp/fsync/rename idiom), so modelling metadata ops as
    ordered is sound for this tree and keeps generated images states
    a real ext4-ordered-mode cut could produce.

Faultpoints (declared in common/faults.py, armable over every
daemon's ``fault_injection`` asok grammar):

  * ``device.torn_write``  — a pwrite persists only a prefix and the
    process browns out mid-write (params: ``keep`` bytes, ``exit``);
  * ``device.lost_write``  — the device acks a write that never
    reaches media (firmware write loss); the process continues, the
    per-block checksums / fsck are the detectors;
  * ``device.power_loss``  — the process dies AT a barrier, before
    the fsync completes (params: ``exit``).

A dying fire drops a ``POWER_LOSS`` marker next to the device file so
the next daemon boot knows to run a full ``fsck(repair=True)`` and
report quarantined objects up the heartbeat (the STORE_DAMAGED
health-check pipeline).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..common import faults
from ..common import tracer as _trace

POWER_LOSS_MARKER = "POWER_LOSS"

# record ops (op, relpath, a, b):
#   ("write",   rel, offset, bytes)    data landing on the file
#   ("trunc",   rel, size,   None)     ftruncate (also file creation)
#   ("barrier", rel, None,   None)     fsync — seals prior writes
#   ("rename",  rel_src, rel_dst, None)
#   ("unlink",  rel, None,   None)
#   ("mark",    label, a,    None)     harness annotation (acked txn)
OP_WRITE = "write"
OP_TRUNC = "trunc"
OP_BARRIER = "barrier"
OP_RENAME = "rename"
OP_UNLINK = "unlink"
OP_MARK = "mark"


class PowerLoss(IOError):
    """An injected power cut surfaced in-process (``exit=False``
    arming; daemons arm with ``exit=True`` and simply die)."""


class Recorder:
    """Ordered write-stream recorder for one store tree.  Paths are
    stored RELATIVE to ``root`` so crash images materialize into any
    directory.  Thread-safe: stores submit from many threads."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._lock = threading.Lock()
        self.log: List[Tuple[str, str, Any, Any]] = []

    def _rel(self, path: str) -> str:
        return os.path.relpath(os.path.abspath(path), self.root)

    def record(self, op: str, path: str, a: Any = None,
               b: Any = None) -> None:
        with self._lock:
            self.log.append((op, self._rel(path), a, b))

    def record_rename(self, src: str, dst: str) -> None:
        with self._lock:
            self.log.append((OP_RENAME, self._rel(src),
                             self._rel(dst), None))

    def mark(self, label: Any, extra: Any = None) -> None:
        """Harness annotation: 'the transaction identified by
        ``label`` was ACKED here' — the crash-state checker's oracle
        boundary."""
        with self._lock:
            self.log.append((OP_MARK, label, extra, None))

    def snapshot(self) -> List[Tuple[str, str, Any, Any]]:
        with self._lock:
            return list(self.log)

    def __len__(self) -> int:
        with self._lock:
            return len(self.log)


_REG_LOCK = threading.Lock()
_RECORDERS: List[Recorder] = []


def attach(root: str) -> Recorder:
    """Start recording every BlockDevice op under ``root`` (a store
    directory).  Returns the recorder; pair with detach()."""
    r = Recorder(root)
    with _REG_LOCK:
        _RECORDERS.append(r)
    return r


def detach(rec: Recorder) -> None:
    with _REG_LOCK:
        try:
            _RECORDERS.remove(rec)
        except ValueError:
            pass


def recorder_for(path: str) -> Optional[Recorder]:
    p = os.path.abspath(path)
    with _REG_LOCK:
        for r in reversed(_RECORDERS):
            if p == r.root or p.startswith(r.root + os.sep):
                return r
    return None


def _wants_exit(params: Dict[str, Any]) -> bool:
    v = params.get("exit", True)
    return str(v).lower() not in ("false", "0", "no")


class BlockDevice:
    """One persistent file behind the barrier API.

    Covers both shapes the stores use: random-access block files
    (BlueStore's ``block``: ``pwrite``/``pread`` at offsets) and
    append-only logs (WAL / data logs: ``append`` returns the offset
    written).  ``fresh=True`` truncates on open (a restarted WAL);
    ``size=`` pins a fixed-size device (recorded so crash images
    recreate the geometry)."""

    def __init__(self, path: str, *, fresh: bool = False,
                 size: Optional[int] = None):
        self.path = path
        self.rec = recorder_for(path)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self._closed = False
        if fresh:
            os.ftruncate(self._fd, 0)
            self._size = 0
            if self.rec is not None:
                self.rec.record(OP_TRUNC, path, 0)
        else:
            self._size = os.fstat(self._fd).st_size
        if size is not None and self._size != size:
            os.ftruncate(self._fd, size)
            self._size = size
            if self.rec is not None:
                self.rec.record(OP_TRUNC, path, size)

    # ------------------------------------------------------------ write --
    def pwrite(self, data: bytes, offset: int) -> int:
        # no bytes() snapshot: os.pwrite takes any buffer, and the
        # zero-copy wire path hands views straight off the receive
        # buffer — materializing here re-copied EVERY stored byte.
        # The recorder path (crash harness) still snapshots its own
        # stable copy below.
        p = faults.fire("device.torn_write", path=self.path)
        if p is not None:
            keep = int(p.get("keep", max(1, len(data) // 2)))
            os.pwrite(self._fd, data[:keep], offset)
            self._power_cut(p, f"torn write ({keep}/{len(data)} "
                               f"bytes) at {offset}")
        if faults.fire("device.lost_write", path=self.path) is not None:
            # firmware-lost write: the OS acks it, the media never
            # sees it.  The logical size still advances (subsequent
            # appends land past it); the hole reads back as zeros and
            # the checksum tier is the detector.
            self._size = max(self._size, offset + len(data))
            return len(data)
        os.pwrite(self._fd, data, offset)
        self._size = max(self._size, offset + len(data))
        if self.rec is not None:
            # the recorder replays writes long after the caller's
            # buffer view is reused: snapshot (harness-only cost)
            self.rec.record(OP_WRITE, self.path, offset, bytes(data))
        return len(data)

    def append(self, data: bytes) -> int:
        off = self._size
        self.pwrite(data, off)
        return off

    def truncate(self, n: int) -> None:
        os.ftruncate(self._fd, n)
        self._size = n
        if self.rec is not None:
            self.rec.record(OP_TRUNC, self.path, n)

    def fsync(self) -> None:
        p = faults.fire("device.power_loss", path=self.path)
        if p is not None:
            self._power_cut(p, "power loss at barrier")
        # store-barrier trace stage: null unless the op above this
        # barrier carries an active span (the ClusterTelemetry
        # queue/dispatch/store-barrier/device stage set)
        with _trace.child_span("store.barrier"):
            os.fsync(self._fd)
        if self.rec is not None:
            self.rec.record(OP_BARRIER, self.path)

    def flush(self) -> None:
        """Compat no-op (writes are unbuffered; fsync is the barrier)."""

    # ------------------------------------------------------------- read --
    def pread(self, n: int, offset: int) -> bytes:
        return os.pread(self._fd, n, offset)

    def tell(self) -> int:
        """Logical size / next append offset."""
        return self._size

    # ---------------------------------------------------------- lifetime --
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            os.close(self._fd)
        except OSError:
            pass

    def _power_cut(self, params: Dict[str, Any], why: str) -> None:
        # marker first: the next boot of this store must know a power
        # cut happened and run fsck(repair) (best-effort — a marker
        # that fails to land just skips the automatic fsck)
        try:
            mfd = os.open(
                os.path.join(os.path.dirname(self.path) or ".",
                             POWER_LOSS_MARKER),
                os.O_WRONLY | os.O_CREAT, 0o644)
            os.close(mfd)
        except OSError:
            pass
        if _wants_exit(params):
            os._exit(9)
        raise PowerLoss(f"fault injected: {why} on {self.path}")


# ------------------------------------------------------- metadata ops ---

def replace(src: str, dst: str) -> None:
    """Atomic rename through the recorder (the snapshot/MANIFEST
    pointer-flip idiom)."""
    rec = recorder_for(dst)
    os.replace(src, dst)
    if rec is not None:
        rec.record_rename(src, dst)


def unlink(path: str, missing_ok: bool = True) -> None:
    rec = recorder_for(path)
    try:
        os.unlink(path)
    except FileNotFoundError:
        if not missing_ok:
            raise
        return
    if rec is not None:
        rec.record(OP_UNLINK, path)


def power_loss_markers(store_root: str) -> List[str]:
    """POWER_LOSS markers under a store directory (root + immediate
    subdirs — the block file and the KV live one level apart)."""
    out = []
    root = os.path.abspath(store_root)
    cand = [root]
    try:
        cand += [os.path.join(root, d) for d in os.listdir(root)
                 if os.path.isdir(os.path.join(root, d))]
    except OSError:
        return []
    for d in cand:
        m = os.path.join(d, POWER_LOSS_MARKER)
        if os.path.exists(m):
            out.append(m)
    return out


def clear_power_loss_markers(store_root: str) -> int:
    n = 0
    for m in power_loss_markers(store_root):
        try:
            os.unlink(m)
            n += 1
        except OSError:
            pass
    return n
