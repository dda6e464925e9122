"""Typed message queues over the native C++ runtime — messenger-analog.

The reference's Messenger stack (src/msg/Messenger.cc:15-42 transport
selection, AsyncMessenger worker loops, DispatchQueue, per-peer Throttle
policies, and the 170 typed classes in src/messages/) exists to move
typed, flow-controlled messages between daemons.  On the TPU runtime
the hop that matters is host producers → batched device dispatch; what
this layer preserves (SURVEY.md §2.4) is:

  * typed request/reply envelopes (the src/messages/ role — a compact
    type tag instead of 170 subclasses),
  * backpressure: bounded item+byte throttles with blocking producers
    (src/common/Throttle.h role),
  * batch forming: the consumer drains up to N envelopes or lingers
    T µs so device dispatches stay large (DispatchQueue role).

The queue core is C++ (native/msgqueue.cpp) behind ctypes, matching
the reference's native messenger; this module is the typed veneer.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native_bridge

# message types (role of src/messages/M*.h — the subset the framework
# speaks; values are arbitrary but stable)
MSG_PING = 1                  # MOSDPing
MSG_OSD_OP = 10               # MOSDOp
MSG_OSD_OP_REPLY = 11         # MOSDOpReply
MSG_EC_SUB_WRITE = 20         # MOSDECSubOpWrite
MSG_EC_SUB_WRITE_REPLY = 21   # MOSDECSubOpWriteReply
MSG_EC_SUB_READ = 22          # MOSDECSubOpRead
MSG_EC_SUB_READ_REPLY = 23    # MOSDECSubOpReadReply


class QueueFull(RuntimeError):
    """Throttle exhausted and the push deadline passed."""


class QueueClosed(RuntimeError):
    pass


@dataclass(frozen=True)
class Envelope:
    type: int
    id: int
    shard: int
    payload: bytes          # bytes, or a zero-copy memoryview over
    #                         the receive buffer (wire.SockReader)
    # trusted per-block sub-crcs from the wire's one-pass verify scan
    # (common/crcutil.Csums) — present only on scatter-gather request
    # frames received in crc mode; the store consumes them as blob
    # csums without re-scanning the payload
    csums: Optional[object] = None


_U8P = ctypes.POINTER(ctypes.c_uint8)
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = native_bridge.lib()
    if not _configured:
        lib.ceph_tpu_mq_create.restype = ctypes.c_void_p
        lib.ceph_tpu_mq_create.argtypes = [ctypes.c_uint64,
                                           ctypes.c_uint64]
        lib.ceph_tpu_mq_destroy.argtypes = [ctypes.c_void_p]
        lib.ceph_tpu_mq_close.argtypes = [ctypes.c_void_p]
        lib.ceph_tpu_mq_push.restype = ctypes.c_int
        lib.ceph_tpu_mq_push.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.c_int32, _U8P, ctypes.c_uint64, ctypes.c_int64]
        lib.ceph_tpu_mq_pop_batch.restype = ctypes.c_int64
        lib.ceph_tpu_mq_pop_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(_U8P),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.ceph_tpu_mq_free_payload.argtypes = [_U8P]
        lib.ceph_tpu_mq_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 5
        _configured = True
    return lib


class MessageQueue:
    """Bounded typed queue with byte+item throttles (native-backed)."""

    def __init__(self, capacity_items: int = 4096,
                 capacity_bytes: int = 1 << 30):
        self._lib = _lib()
        self._q = self._lib.ceph_tpu_mq_create(capacity_items,
                                               capacity_bytes)
        if not self._q:
            raise MemoryError("mq_create failed")

    def push(self, env: Envelope, timeout: Optional[float] = None) -> None:
        """Blocks while the throttle is exhausted; QueueFull on
        deadline, QueueClosed after close()."""
        payload = env.payload or b""
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload) \
            if payload else None
        t_us = -1 if timeout is None else int(timeout * 1e6)
        rc = self._lib.ceph_tpu_mq_push(
            self._q, env.type, env.id, env.shard,
            ctypes.cast(buf, _U8P) if buf else None,
            len(payload), t_us)
        if rc == -1:
            raise QueueFull(f"push timed out after {timeout}s")
        if rc == -2:
            raise QueueClosed("queue closed")
        if rc == -3:
            raise ValueError("payload exceeds queue byte capacity")
        if rc == -4:
            raise MemoryError("envelope payload allocation failed")

    def pop_batch(self, max_items: int = 256,
                  max_bytes: int = 1 << 30,
                  wait_first: Optional[float] = 1.0,
                  linger: float = 0.0) -> List[Envelope]:
        """Blocks up to ``wait_first`` for one envelope, then drains up
        to the caps, lingering ``linger`` seconds for stragglers (the
        batch-forming window).  Empty list on timeout/close."""
        n = max_items
        types = (ctypes.c_uint32 * n)()
        ids = (ctypes.c_uint64 * n)()
        shards = (ctypes.c_int32 * n)()
        payloads = (_U8P * n)()
        lens = (ctypes.c_uint64 * n)()
        w_us = -1 if wait_first is None else int(wait_first * 1e6)
        got = self._lib.ceph_tpu_mq_pop_batch(
            self._q, n, max_bytes, w_us, int(linger * 1e6),
            types, ids, shards, payloads, lens)
        out: List[Envelope] = []
        for i in range(got):
            ln = lens[i]
            data = ctypes.string_at(payloads[i], ln) if ln else b""
            if payloads[i]:
                self._lib.ceph_tpu_mq_free_payload(payloads[i])
            out.append(Envelope(types[i], ids[i], shards[i], data))
        return out

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(5)]
        self._lib.ceph_tpu_mq_stats(self._q, *[ctypes.byref(v)
                                               for v in vals])
        keys = ("depth", "bytes", "pushed", "popped", "throttle_waits")
        return dict(zip(keys, (v.value for v in vals)))

    def close(self) -> None:
        if self._q:
            self._lib.ceph_tpu_mq_close(self._q)

    def destroy(self) -> None:
        """Free the native queue.  The native side closes the queue,
        wakes all waiters, and defers the delete until every REGISTERED
        in-flight push/pop_batch/stats call has drained (Queue::inflight
        covers the call from its first instruction), so destroying with
        parked waiter threads is safe.  A thread that has called into an
        entry point but not yet executed its first instruction is
        indistinguishable from a new call — callers must ensure no calls
        can START once destroy begins (stop producers/consumers first;
        threads already blocked inside the queue need no joining)."""
        if self._q:
            self._lib.ceph_tpu_mq_destroy(self._q)
            self._q = None

    def __del__(self):
        # close (wakes waiters) but deliberately LEAK the native queue:
        # a racing push/pop entered AFTER interpreter teardown began
        # could still touch a freed Queue header; callers with
        # known-quiesced queues use destroy() explicitly
        try:
            self.close()
        except Exception:
            pass
