"""OSDService — the simulator OSD behind the real messenger stack.

The native queues, mClock scheduler and dispatcher carry the data
path through this module:
every shard op now enters an OSD through its bounded native
MessageQueue, drains into the dmClock scheduler, and executes in QoS
order on the OSD's dispatch thread — the reference shape
``OSD::ms_fast_dispatch -> enqueue_op -> sharded OpScheduler ->
dequeue_op`` (src/osd/OSD.cc:7114,9745,9807), with client IO and
recovery pushes in different QoS classes (mClockScheduler,
src/osd/scheduler/mClockScheduler.cc).

Callers get synchronous helpers (put/get/delete) that block on the op's
completion event, so ClusterSim semantics — and the chaos test — are
unchanged while every byte flows queue -> scheduler -> dispatch.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common import faults
from ..common import tracer as _trace
from ..common.lockdep import LockdepLock
from ..common.op_tracker import tracker as _op_tracker
from ..common.perf_counters import perf as _perf
from ..msg import encoding

faults.declare("msg.drop_op",
               "drop an op at the in-process messenger boundary "
               "(queue admission raises IOError, no dispatch) — the "
               "sim tier's frame-drop axis: sub-writes degrade and "
               "recovery must repair, reads fail over")
from ..msg.dispatcher import BatchingDispatcher
from ..msg.queue import Envelope, MessageQueue, QueueClosed, QueueFull
from ..msg.scheduler import CLASS_CLIENT, CLASS_RECOVERY, MClockScheduler
from .pg_heat import PGHeatTracker


def _heat_half_life() -> float:
    try:
        from ..common.options import config
        return float(config().get("pg_heat_half_life"))
    except Exception:
        return 60.0

MSG_OSD_OP = 0x10

ShardKey = Tuple[int, int, str, int]


class OSDService:
    """Per-OSD op front end: queue -> mClock -> execute."""

    def __init__(self, osd, *, capacity_items: int = 4096,
                 capacity_bytes: int = 1 << 28):
        self.osd = osd
        self.in_q = MessageQueue(capacity_items=capacity_items,
                                 capacity_bytes=capacity_bytes)
        self.sched = MClockScheduler()
        self._ids = itertools.count(1)
        self._lock = LockdepLock("osd.service", recursive=False)
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Any] = {}
        # device-array side table: the control frame rides the native
        # queue, the HBM buffer handle rides here (the zero-copy "data
        # segment" of a real messenger frame — device payloads never
        # serialize through the wire path in-process)
        self._op_objs: Dict[int, Any] = {}
        # dispatch-latency histogram + slow-op test hook: one shared
        # "osd.service" group (per-OSD families would explode the
        # exporter); per-OSD attribution rides the tracked-op events
        self._pc = _perf("osd.service")
        # test hook: seconds to sleep inside _execute (models a stalled
        # device dispatch; drives the SLOW_OPS acceptance path)
        self.inject_execute_delay = 0.0
        # per-PG client-io heat (pool HitSet role).  Manual clock: the
        # heartbeat advances it to its tick count, so decay is
        # seed-deterministic on the sim tick clock
        self.heat = PGHeatTracker(half_life=_heat_half_life())
        self.dispatcher = BatchingDispatcher(
            self.in_q, self._handle, linger=0.0,
            name=f"osd.{osd.id}").start()

    # ------------------------------------------------------- server side --
    def _handle(self, batch: List[Envelope]) -> None:
        # fast dispatch: envelopes land in the QoS scheduler first.
        # batch occupancy is THE feed-the-MXU knob, so it lands on every
        # tracked op in the batch (dispatcher thread -> mark by id)
        trk = _op_tracker()
        depth = self.in_q.stats()["depth"]
        for env in batch:
            op = encoding.loads(env.payload)
            with self._lock:
                obj = self._op_objs.pop(env.id, None)
            if obj is not None:
                op["_obj"] = obj
            trk.mark(op.get("track_id"), "reached_osd",
                     osd=self.osd.id, batch_occupancy=len(batch),
                     queue_depth=depth)
            self.sched.enqueue((env.id, op),
                               klass=op.get("klass", CLASS_CLIENT))
        # dequeue_op in scheduler order
        while True:
            item = self.sched.dequeue()
            if item is None:
                break
            _klass, (op_id, op) = item
            try:
                result = self._execute(op)
            except Exception as e:         # surfaced to the waiter
                result = e
            with self._lock:
                ev = self._events.get(op_id)
                if ev is not None:         # waiter gone (timeout): drop
                    self._results[op_id] = result
            if ev is not None:
                ev.set()

    def _execute(self, op: Dict[str, Any]):
        _op_tracker().mark(op.get("track_id"), "dispatched_device",
                           osd=self.osd.id, kind=op["kind"])
        t0 = time.perf_counter()
        try:
            if self.inject_execute_delay > 0:
                time.sleep(self.inject_execute_delay)
            # daemon-side dispatch stage span, linked under the
            # submitting op's trace context (carried on the op dict —
            # the in-process half of trace propagation); the nested
            # device.dispatch child covers the store/device access.
            # service = the EXECUTING entity (this OSD), not the
            # process-wide default "client" the sim tier used to stamp
            with _trace.linked_span(
                    "osd.dispatch", op.get("tctx"),
                    service=f"osd.{self.osd.id}",
                    osd=self.osd.id, kind=op["kind"]):
                with _trace.child_span("device.dispatch",
                                       service=f"osd.{self.osd.id}",
                                       osd=self.osd.id):
                    out = self._execute_inner(op)
            self._record_heat(op, out)
            return out
        finally:
            # device-dispatch latency distribution (the encode/store
            # stage averages hide; acceptance histogram family)
            self._pc.hinc("dispatch_s", time.perf_counter() - t0)

    def _record_heat(self, op: Dict[str, Any], result: Any) -> None:
        """Count a completed CLIENT op against its PG's heat ledger —
        recovery traffic is placement churn, not client load, so it
        stays out (matching what ``osd.io`` counts on the daemon
        tier)."""
        if op.get("klass", CLASS_CLIENT) != CLASS_CLIENT:
            return
        key = op.get("key")
        if key is None:                    # bulk *_many ride recovery
            return
        kind = op["kind"]
        pool, pg = int(key[0]), int(key[1])
        if kind in ("put", "put_dev"):
            data = op.get("data")
            nbytes = (len(data) if data is not None
                      else int(getattr(op.get("_obj"), "nbytes", 0)
                               or 0))
            self.heat.record(pool, pg, "wr", nbytes=nbytes)
        elif kind in ("get", "get_dev"):
            self.heat.record(pool, pg, "rd",
                             nbytes=int(getattr(result, "nbytes", 0)
                                        or 0))
        elif kind == "delete":
            self.heat.record(pool, pg, "wr")

    def _execute_inner(self, op: Dict[str, Any]):
        kind = op["kind"]
        if kind == "get_dev_many":
            # bulk device read: ONE queue->scheduler->dispatch round
            # for a whole recovery gather (None per absent/EIO key —
            # the caller's per-key failover decides what that means)
            return [self.osd.get_device(tuple(k))
                    for k in op["keys"]]
        if kind == "put_dev_many":
            # bulk device push (the recovery-push scatter half): the
            # HBM refs ride the _obj side table as one list; optional
            # per-key durable bytes ride ``datas`` (eager mode)
            arrs = op["_obj"]
            datas = op.get("datas") or [None] * len(op["keys"])
            for k, a, d in zip(op["keys"], arrs, datas):
                self.osd.put_device(tuple(k), a, d)
            return len(op["keys"])
        key: ShardKey = tuple(op["key"])   # typed encoding lists it
        if kind == "put":
            self.osd.put(key, np.frombuffer(op["data"], dtype=np.uint8))
            return True
        if kind == "get":
            if op.get("ranges"):
                # sub-shard ranged read (Clay repair helpers): only
                # the requested byte ranges cross the messenger
                return self.osd.get_ranges(key, op["ranges"])
            return self.osd.get(key)
        if kind == "put_dev":
            self.osd.put_device(key, op["_obj"], op.get("data"))
            return True
        if kind == "get_dev":
            return self.osd.get_device(key)
        if kind == "delete":
            self.osd.delete(key)
            return True
        raise ValueError(f"unknown osd op kind {kind!r}")

    # ------------------------------------------------------- client side --
    def call_async(self, op: Dict[str, Any], timeout: float = 30.0,
                   obj: Any = None) -> Tuple[int, threading.Event]:
        """Enqueue an op without waiting (the MOSDECSubOp fan-out
        shape: a primary keeps k+m sub-ops in flight concurrently,
        src/osd/ECBackend.cc:1976).  Pair with wait_async()."""
        if faults.fire("msg.drop_op", osd=self.osd.id,
                       kind=op.get("kind")) is not None:
            # fires on the SUBMITTING thread (deterministic order for
            # seeded thrash runs), before any state is registered
            raise IOError(f"osd.{self.osd.id}: op dropped "
                          f"(fault injected)")
        src = op.get("src", "client")
        if faults.partitioned(src, f"osd.{self.osd.id}"):
            # in-process netsplit: the op never reaches this OSD's
            # queue.  Sim-tier traffic all originates at the client/
            # primary entity "client" (recovery pushes included — the
            # sim's orchestrator IS the primary), so a partition that
            # cuts "client" from a group of OSDs severs their whole
            # data path while the daemons stay alive
            raise IOError(f"osd.{self.osd.id}: unreachable from "
                          f"{src} (netsplit)")
        op_id = next(self._ids)
        ev = threading.Event()
        with self._lock:
            self._events[op_id] = ev
            if obj is not None:
                self._op_objs[op_id] = obj
        top = _op_tracker().current()
        if top is not None:
            # ride the tracked-op id on the control frame so the
            # dispatcher thread can mark events on the same record
            op = dict(op, track_id=top.op_id)
            top.mark_event("queued", osd=self.osd.id,
                           queue_depth=self.in_q.stats()["depth"])
        # trace propagation (in-process dispatch half): the active
        # span's (trace_id, span_id) rides the op dict so the
        # dispatcher thread's stage spans link under it; the queue
        # admission itself is the "osd.queue" stage
        op = _trace.stamp(dict(op)) if _trace.enabled() else op
        with _trace.child_span("osd.queue", osd=self.osd.id):
            payload = encoding.dumps(op)
            try:
                self.in_q.push(Envelope(MSG_OSD_OP, op_id, -1,
                                        payload), timeout=timeout)
            except (QueueFull, QueueClosed):
                with self._lock:
                    self._events.pop(op_id, None)
                    self._op_objs.pop(op_id, None)
                raise IOError(f"osd.{self.osd.id}: op queue "
                              f"unavailable")
        return op_id, ev

    def wait_async(self, op_id: int, ev: threading.Event,
                   timeout: float = 30.0):
        if not ev.wait(timeout):
            with self._lock:
                self._events.pop(op_id, None)
                self._results.pop(op_id, None)
                self._op_objs.pop(op_id, None)
            raise IOError(f"osd.{self.osd.id}: op {op_id} timed out")
        with self._lock:
            self._events.pop(op_id, None)
            result = self._results.pop(op_id)
        if isinstance(result, Exception):
            raise result
        return result

    def _call(self, op: Dict[str, Any], timeout: float = 30.0,
              obj: Any = None):
        op_id, ev = self.call_async(op, timeout, obj)
        return self.wait_async(op_id, ev, timeout)

    def put(self, key: ShardKey, data: np.ndarray,
            klass: str = CLASS_CLIENT) -> None:
        self._call({"kind": "put", "key": key, "klass": klass,
                    "data": np.asarray(data, dtype=np.uint8).tobytes()})

    def get(self, key: ShardKey, klass: str = CLASS_CLIENT,
            ranges=None) -> Optional[np.ndarray]:
        op = {"kind": "get", "key": key, "klass": klass}
        if ranges:
            op["ranges"] = [list(r) for r in ranges]
        return self._call(op)

    def delete(self, key: ShardKey, klass: str = CLASS_CLIENT) -> None:
        self._call({"kind": "delete", "key": key, "klass": klass})

    def put_recovery(self, key: ShardKey, data: np.ndarray) -> None:
        """Recovery pushes ride the background-recovery QoS class."""
        self.put(key, data, klass=CLASS_RECOVERY)

    # --------------------------------------------- device-staged shards --
    def put_device(self, key: ShardKey, arr,
                   data_bytes: Optional[bytes] = None,
                   klass: str = CLASS_CLIENT) -> None:
        """Stage a device shard array on the OSD.  ``data_bytes`` is the
        eager durable write-through (same bytes); None defers flushing
        (staged/WAL mode)."""
        self._call({"kind": "put_dev", "key": key, "klass": klass,
                    "data": data_bytes}, obj=arr)

    def get_device(self, key: ShardKey, klass: str = CLASS_CLIENT):
        """Fetch a shard as a device array (HBM-resident if staged)."""
        return self._call({"kind": "get_dev", "key": key,
                           "klass": klass})

    def put_device_recovery(self, key: ShardKey, arr,
                            data_bytes: Optional[bytes] = None) -> None:
        self.put_device(key, arr, data_bytes, klass=CLASS_RECOVERY)

    # --------------------------------------------- bulk recovery sub-ops --
    def get_device_many_async(self, keys: List[ShardKey],
                              klass: str = CLASS_RECOVERY
                              ) -> Tuple[int, threading.Event]:
        """Submit ONE bulk device read for ``keys`` (pair with
        wait_async; result is a per-key list, None per miss).  The
        recovery sweep's gather half: submit-all-then-gather across
        OSDs instead of one blocking round trip per shard."""
        return self.call_async({"kind": "get_dev_many",
                                "keys": [list(k) for k in keys],
                                "klass": klass})

    def put_device_many_async(self, items: List[Tuple[ShardKey, Any,
                                                      Optional[bytes]]],
                              klass: str = CLASS_RECOVERY
                              ) -> Tuple[int, threading.Event]:
        """Submit ONE bulk device push of (key, ref, durable_bytes)
        triples — the recovery-push scatter half."""
        return self.call_async(
            {"kind": "put_dev_many",
             "keys": [list(k) for k, _, _ in items],
             "datas": [d for _, _, d in items],
             "klass": klass},
            obj=[a for _, a, _ in items])

    def stats(self) -> Dict[str, int]:
        return self.in_q.stats()

    def stop(self) -> None:
        self.dispatcher.stop()
        self.in_q.close()
