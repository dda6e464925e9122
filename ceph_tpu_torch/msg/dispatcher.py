"""Batching dispatcher + shard fan-out/gather over MessageQueues.

Two messenger roles on top of the native queues:

  * BatchingDispatcher — the consumer loop in front of a jitted kernel:
    a worker thread drains envelope batches and hands them to a
    handler whose replies (if any) are routed to a reply queue.  This
    is the OSD-side pattern `ms_fast_dispatch -> sharded OpScheduler ->
    dequeue` (src/osd/OSD.cc:7114,9745) collapsed to one stage whose
    queue IS the batch former.
  * ShardFanout — the ECBackend primary pattern: send one sub-op per
    shard queue, gather k+m acks before completing the op
    (src/osd/ECBackend.cc: per-shard MOSDECSubOpWrite fan-out,
    handle_sub_write_reply gathering).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..common import faults
from ..common import tracer as _trace
from ..common.lockdep import LockdepLock
from ..common.perf_counters import perf as _perf
from .queue import Envelope, MessageQueue

Handler = Callable[[List[Envelope]], Optional[List[Envelope]]]


class BatchingDispatcher:
    """Worker thread: pop_batch(in_q) -> handler -> push(reply_q)."""

    def __init__(self, in_q: MessageQueue, handler: Handler,
                 reply_q: Optional[MessageQueue] = None,
                 max_items: int = 256, linger: float = 0.0005,
                 name: str = "dispatcher"):
        self.in_q = in_q
        self.reply_q = reply_q
        self.handler = handler
        self.max_items = max_items
        self.linger = linger
        self.last_error: Optional[Exception] = None
        self._pc = _perf(f"msg.{name}")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)

    def start(self) -> "BatchingDispatcher":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self.in_q.pop_batch(max_items=self.max_items,
                                        wait_first=0.05,
                                        linger=self.linger)
            if not batch:
                continue
            self._pc.inc("batches")
            self._pc.inc("envelopes", len(batch))
            self._pc.inc("bytes", sum(len(e.payload) for e in batch))
            try:
                with self._pc.time("handle_s"):
                    replies = self.handler(batch)
                if replies and self.reply_q is not None:
                    for r in replies:
                        self.reply_q.push(r)
            except Exception as e:           # the loop must survive: a
                # dead worker silently deadlocks every producer on the
                # bounded queue
                self._pc.inc("handler_errors")
                self.last_error = e

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


class ShardFanout:
    """Primary-side fan-out/gather: one envelope per shard queue, op
    completes when every shard acked (or fails on nack)."""

    def __init__(self, shard_queues: Sequence[MessageQueue],
                 ack_q: MessageQueue, entity: str = "client",
                 shard_entities: Optional[Sequence[str]] = None):
        """``entity``/``shard_entities`` name this primary and its
        shard servers for the ``net.partition`` faultpoint: a severed
        sub-op is never enqueued (the peer's frame vanished), so the
        gather sees a missing ack — exactly a netsplit's face."""
        self.shard_queues = list(shard_queues)
        self.ack_q = ack_q
        self.entity = entity
        self.shard_entities = list(shard_entities) if shard_entities \
            else [f"shard.{i}" for i in range(len(self.shard_queues))]
        self._lock = LockdepLock("msg.fanout", recursive=False)
        self._pending: Dict[int, Dict] = {}
        self._pc = _perf("msg.fanout")

    def submit(self, op_id: int, msg_type: int,
               shard_payloads: Sequence[bytes],
               tctx: Optional[Sequence[int]] = None) -> None:
        """``tctx`` links this fan-out under an active trace: the
        sub-op scatter is a stage of the op that triggered it (the
        CTL701 propagation contract for dispatch fan-out sites).
        Callers without an explicit context inherit the submitting
        thread's active span."""
        if len(shard_payloads) != len(self.shard_queues):
            raise ValueError("one payload per shard queue")
        with self._lock:
            self._pending[op_id] = {
                "want": len(shard_payloads), "got": 0, "failed": False,
                "event": threading.Event()}
        self._pc.inc("ops_submitted")
        # service = the fanning-out entity (this primary), not the
        # process-wide default — sim-tier spans must name who ran them
        with _trace.linked_span("msg.fanout", tctx,
                                service=self.entity,
                                shards=len(shard_payloads)):
            for shard, (q, payload) in enumerate(
                    zip(self.shard_queues, shard_payloads)):
                if faults.partitioned(self.entity,
                                      self.shard_entities[shard]):
                    # the frame is lost on the cut link: no push, no
                    # ack — the waiter's timeout is the failure
                    # signal, as on a real netsplit (a nack would be
                    # a delivered frame)
                    self._pc.inc("subops_partitioned")
                    continue
                q.push(Envelope(msg_type, op_id, shard, payload))

    def ack(self, op_id: int, shard: int, ok: bool = True) -> None:
        """Called by shard servers (normally via the ack queue)."""
        with self._lock:
            st = self._pending.get(op_id)
            if st is None:
                return
            if not ok:
                st["failed"] = True
            st["got"] += 1
            if st["got"] >= st["want"]:
                st["event"].set()

    def pump_acks(self, wait_first: float = 0.05) -> int:
        """Drain the ack queue into pending-op state; returns count."""
        batch = self.ack_q.pop_batch(wait_first=wait_first, linger=0.0)
        for e in batch:
            self.ack(e.id, e.shard, ok=(not e.payload or
                                        e.payload[0] == 0))
        return len(batch)

    def wait(self, op_id: int, timeout: float = 10.0) -> bool:
        """True when all shards acked ok; raises on failed sub-op."""
        with self._lock:
            st = self._pending.get(op_id)
        if st is None:
            raise KeyError(f"unknown op {op_id}")
        import time
        t_end = time.monotonic() + timeout
        while not st["event"].is_set():
            if time.monotonic() > t_end:
                return False
            self.pump_acks(wait_first=0.02)
        with self._lock:
            self._pending.pop(op_id, None)
        if st["failed"]:
            raise IOError(f"op {op_id}: sub-op failed")
        self._pc.inc("ops_completed")
        return True
