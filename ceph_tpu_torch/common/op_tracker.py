"""OpTracker — per-op lifecycle tracking from objecter to device dispatch.

Role of the reference's OpTracker/TrackedOp (src/common/TrackedOp.{h,cc}:
every client op carries a typed event trail — "initiated", "queued",
"reached_pg", "done" — with a bounded in-flight registry, ring buffers of
historic and historic-slow ops, and the `dump_ops_in_flight` /
`dump_historic_ops` / `dump_historic_slow_ops` admin commands; ops older
than `osd_op_complaint_time` feed the SLOW_OPS health check).

TPU-native shape: the interesting lifecycle here is

    initiated (objecter) -> queued (OSD native queue) -> reached_osd
    (batch formed, QoS-scheduled) -> dispatched_device (XLA executes,
    compile vs cached tagged) -> done

so the tracker records batch occupancy and queue depth at enqueue time
(the knobs that decide whether the MXU stays fed) and compile-vs-cached
on each device dispatch.  Per-stage durations land in log2-bucketed
``PerfHistogram``s (perf_counters.py) — averages hide exactly the
queueing/encode tails that dominate EC latency.

Cross-thread contract: the submitting thread owns the op and activates
it with ``tracker().track(op)`` (a thread-local stack, like the tracer's
span stack); code below the queue boundary — running on dispatcher
threads — marks events by op id via ``tracker().mark(op_id, ...)``.
All event appends serialize on the tracker lock.

Config (observed live, like ``perf_counters_enabled``):
    op_tracker_enabled          master switch (disabled -> null ops)
    op_tracker_complaint_time   seconds before an op counts as slow
    op_tracker_history_size     historic ring capacity
    op_tracker_history_slow_size  historic-slow ring capacity
    op_tracker_max_inflight     in-flight table bound (excess untracked)
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .options import OptionError, config
from .perf_counters import perf as _perf
from .tracer import pin_trace as _pin_trace

# canonical lifecycle events (free-form names are also accepted)
EVENT_INITIATED = "initiated"
EVENT_QUEUED = "queued"
EVENT_REACHED_OSD = "reached_osd"
EVENT_DISPATCHED_DEVICE = "dispatched_device"
# the op's work fanned out across the device mesh (sharded data
# plane, parallel/data_plane.py) — dump_historic_ops shows which
# client ops dispatched multi-chip and over how many shards
EVENT_DISPATCHED_MESH = "dispatched_mesh"
# the op's frames left on the asynchronous wire path (stream pool,
# cluster/async_objecter.py) — dump_ops_in_flight between this event
# and "done" IS the in-flight wire window
EVENT_DISPATCHED_WIRE = "dispatched_wire"
EVENT_DONE = "done"

# per-stage histogram keys: (from_event, to_event) -> perf key
_STAGE_HISTS = (
    (EVENT_INITIATED, EVENT_QUEUED, "stage_init_to_queue_s"),
    (EVENT_QUEUED, EVENT_REACHED_OSD, "stage_queue_to_osd_s"),
    (EVENT_REACHED_OSD, EVENT_DISPATCHED_DEVICE, "stage_osd_to_device_s"),
    (EVENT_DISPATCHED_DEVICE, EVENT_DONE, "stage_device_to_done_s"),
    (EVENT_DISPATCHED_MESH, EVENT_DONE, "stage_mesh_to_done_s"),
    (EVENT_DISPATCHED_WIRE, EVENT_DONE, "stage_wire_to_done_s"),
)

_ids = itertools.count(1)

# hot-path config cache, kept fresh by observers (the registry walk is
# too expensive per op; same pattern as perf_counters._counters_enabled)
_cfg_cache: Optional[Dict[str, Any]] = None
_cfg_lock = threading.Lock()

_CFG_KEYS = ("op_tracker_enabled", "op_tracker_complaint_time",
             "op_tracker_history_size", "op_tracker_history_slow_size",
             "op_tracker_max_inflight")
_CFG_DEFAULTS = {"op_tracker_enabled": True,
                 "op_tracker_complaint_time": 30.0,
                 "op_tracker_history_size": 100,
                 "op_tracker_history_slow_size": 20,
                 "op_tracker_max_inflight": 1024}


def _cfg(key: str) -> Any:
    global _cfg_cache
    cache = _cfg_cache
    if cache is None:
        with _cfg_lock:
            cache = _cfg_cache
            if cache is None:
                cache = {}
                cfg = config()
                for name in _CFG_KEYS:
                    try:
                        cache[name] = cfg.get(name)
                    except OptionError:
                        cache[name] = _CFG_DEFAULTS[name]

                    def _refresh(n, value):
                        cache[n] = value
                    try:
                        cfg.observe(name, _refresh)
                    except OptionError:
                        pass
                _cfg_cache = cache
    return cache[key]


class TrackedOp:
    """One client op's lifecycle record (TrackedOp analog)."""

    __slots__ = ("op_id", "optype", "service", "tags", "start", "start_ts",
                 "events", "duration", "error", "_tracker")

    def __init__(self, tracker: "OpTracker", optype: str, service: str,
                 tags: Dict[str, Any]):
        self.op_id = next(_ids)
        self.optype = optype
        self.service = service
        self.tags = tags
        self.start = time.perf_counter()
        self.start_ts = time.time()          # wall clock, log-correlatable
        self.events: List[Dict[str, Any]] = []
        self.duration: Optional[float] = None
        self.error: Optional[str] = None
        self._tracker = tracker

    @property
    def tracked(self) -> bool:
        return True

    def mark_event(self, event: str, **tags) -> None:
        self._tracker._append_event(self, event, tags)

    def age(self) -> float:
        return (time.perf_counter() - self.start
                if self.duration is None else self.duration)

    def first_event_t(self, event: str) -> Optional[float]:
        """perf_counter offset (seconds since initiation) of the first
        occurrence of ``event``, or None."""
        for e in self.events:
            if e["event"] == event:
                return e["dt_s"]
        return None

    def dump(self) -> Dict[str, Any]:
        d = {"op_id": self.op_id, "type": self.optype,
             "service": self.service,
             "initiated_at": round(self.start_ts, 6),
             "age_s": round(self.age(), 9)}
        d.update(self.tags)
        if self.duration is not None:
            d["duration_s"] = round(self.duration, 9)
        if self.error is not None:
            d["error"] = self.error
        d["events"] = [dict(e, dt_s=round(e["dt_s"], 9),
                            ts=round(e["ts"], 6))
                       for e in self.events]
        return d


class _NullOp:
    """Tracking disabled / table full: every call is a no-op."""

    __slots__ = ()
    op_id = 0
    optype = service = ""
    duration = error = None
    events: List[Dict[str, Any]] = []

    @property
    def tracked(self) -> bool:
        return False

    def mark_event(self, event: str, **tags) -> None:
        pass

    def age(self) -> float:
        return 0.0


_NULL_OP = _NullOp()


class OpTracker:
    """Bounded in-flight table + historic / historic-slow rings."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: Dict[int, TrackedOp] = {}
        self._historic: deque = deque(
            maxlen=int(_cfg("op_tracker_history_size")))
        self._historic_slow: deque = deque(
            maxlen=int(_cfg("op_tracker_history_slow_size")))
        # cumulative slow-op counts per daemon ("osd.3" -> n) plus a
        # recent-completion trail for the SLOW_OPS health window
        self._slow_by_daemon: Dict[str, int] = {}
        self._tls = threading.local()
        self._pc = _perf("op_tracker")

    # ---------------------------------------------------------- lifecycle --
    def create(self, optype: str, service: str = "objecter",
               **tags) -> TrackedOp:
        """Register a new tracked op (marks "initiated").  Returns a
        null op when tracking is off or the in-flight table is full —
        callers never branch on enablement."""
        if not _cfg("op_tracker_enabled"):
            return _NULL_OP
        op = TrackedOp(self, optype, service, tags)
        with self._lock:
            if len(self._inflight) >= int(_cfg("op_tracker_max_inflight")):
                self._pc.inc("ops_untracked")
                return _NULL_OP
            self._inflight[op.op_id] = op
            self._append_event_locked(op, EVENT_INITIATED, {})
        self._pc.inc("ops_tracked")
        return op

    def finish(self, op: TrackedOp, error: Optional[str] = None) -> None:
        """Complete an op: mark "done", move to the historic ring,
        record per-stage histograms, and classify slow ops."""
        if not op.tracked:
            return
        with self._lock:
            if self._inflight.pop(op.op_id, None) is None:
                return                      # double finish: keep first
            self._append_event_locked(op, EVENT_DONE,
                                      {} if error is None
                                      else {"error": error})
            op.duration = time.perf_counter() - op.start
            op.error = error
            self._resize_rings_locked()
            self._historic.append(op)
            complaint = float(_cfg("op_tracker_complaint_time"))
            slow = op.duration >= complaint
            if slow:
                self._historic_slow.append(op)
                for d in self._op_daemons(op):
                    self._slow_by_daemon[d] = \
                        self._slow_by_daemon.get(d, 0) + 1
        # histograms outside the tracker lock (they take the group lock)
        pc = _perf(op.service)
        pc.hinc("op_e2e_s", op.duration)
        tpc = self._pc
        for frm, to, key in _STAGE_HISTS:
            t0 = op.first_event_t(frm)
            t1 = op.first_event_t(to)
            if t0 is not None and t1 is not None and t1 >= t0:
                tpc.hinc(key, t1 - t0)
        if slow:
            tpc.inc("slow_ops")
            # auto-sampling: an op that crossed the
            # complaint time pins its trace, so the slow op's
            # end-to-end flame trace survives buffer churn and stays
            # retrievable by op id (`ceph trace <op>`)
            _pin_trace(op.tags.get("trace_id"))

    def mark(self, op_id: Optional[int], event: str, **tags) -> None:
        """Cross-thread event append by op id (below-queue code paths
        that only see the serialized op).  Unknown/finished ids drop."""
        if not op_id:
            return
        with self._lock:
            op = self._inflight.get(op_id)
            if op is not None:
                self._append_event_locked(op, event, tags)

    # ------------------------------------------------------- active-op tls --
    def track(self, op: TrackedOp):
        """Context manager: make ``op`` the thread's active op so code
        deeper in the pipeline can tag it without plumbing."""
        return _ActiveOp(self, op)

    def current(self) -> Optional[TrackedOp]:
        stack = getattr(self._tls, "stack", None)
        op = stack[-1] if stack else None
        return op if op is not None and op.tracked else None

    # ------------------------------------------------------------- events --
    def _resize_rings_locked(self) -> None:
        """Honor runtime changes to the history-size knobs: the deques'
        maxlen is fixed at construction, so rebuild (keeping the newest
        entries) whenever the observed config no longer matches."""
        hist = int(_cfg("op_tracker_history_size"))
        if self._historic.maxlen != hist:
            self._historic = deque(self._historic, maxlen=hist)
        slow = int(_cfg("op_tracker_history_slow_size"))
        if self._historic_slow.maxlen != slow:
            self._historic_slow = deque(self._historic_slow, maxlen=slow)

    def _append_event(self, op: TrackedOp, event: str,
                      tags: Dict[str, Any]) -> None:
        with self._lock:
            self._append_event_locked(op, event, tags)

    def _append_event_locked(self, op: TrackedOp, event: str,
                             tags: Dict[str, Any]) -> None:
        e = {"event": event, "ts": time.time(),
             "dt_s": time.perf_counter() - op.start}
        if tags:
            e.update(tags)
        op.events.append(e)

    @staticmethod
    def _op_daemons(op: TrackedOp) -> List[str]:
        seen = []
        for e in op.events:
            osd = e.get("osd")
            if osd is not None and f"osd.{osd}" not in seen:
                seen.append(f"osd.{osd}")
        return seen

    # --------------------------------------------------------------- dump --
    def dump_ops_in_flight(self) -> Dict[str, Any]:
        complaint = float(_cfg("op_tracker_complaint_time"))
        with self._lock:
            ops = sorted(self._inflight.values(), key=lambda o: o.op_id)
            out = [dict(o.dump(), slow=o.age() >= complaint) for o in ops]
        return {"num_ops": len(out), "complaint_time_s": complaint,
                "ops": out}

    def dump_historic_ops(self) -> Dict[str, Any]:
        with self._lock:
            self._resize_rings_locked()
            size = self._historic.maxlen
            ops = [o.dump() for o in self._historic]
        return {"size": size, "num_ops": len(ops), "ops": ops}

    def dump_historic_slow_ops(self) -> Dict[str, Any]:
        with self._lock:
            self._resize_rings_locked()
            size = self._historic_slow.maxlen
            ops = [o.dump() for o in self._historic_slow]
        return {"size": size, "num_ops": len(ops),
                "complaint_time_s": float(_cfg("op_tracker_complaint_time")),
                "ops": ops}

    # ------------------------------------------------------------- health --
    def slow_ops_summary(self, window_s: float = 600.0) -> Dict[str, Any]:
        """Input for the mon's SLOW_OPS check: currently-blocked ops
        (in flight past the complaint time) plus historic slow ops that
        completed within ``window_s``.  Daemons listed by osd tag."""
        complaint = float(_cfg("op_tracker_complaint_time"))
        now_wall = time.time()
        blocked = 0
        oldest = 0.0
        daemons: List[str] = []
        with self._lock:
            for op in self._inflight.values():
                a = op.age()
                if a >= complaint:
                    blocked += 1
                    oldest = max(oldest, a)
                    for d in self._op_daemons(op):
                        if d not in daemons:
                            daemons.append(d)
            recent = 0
            for op in self._historic_slow:
                done_ts = op.start_ts + (op.duration or 0.0)
                if now_wall - done_ts <= window_s:
                    recent += 1
                    oldest = max(oldest, op.duration or 0.0)
                    for d in self._op_daemons(op):
                        if d not in daemons:
                            daemons.append(d)
            by_daemon = dict(self._slow_by_daemon)
        return {"num": blocked + recent, "blocked": blocked,
                "recent": recent, "oldest_s": round(oldest, 6),
                "daemons": sorted(daemons), "by_daemon": by_daemon}

    def reset(self) -> None:
        """Drop all state (tests / `perf reset`-style hygiene)."""
        with self._lock:
            self._inflight.clear()
            self._historic.clear()
            self._historic_slow.clear()
            self._slow_by_daemon.clear()


class _ActiveOp:
    __slots__ = ("_tracker", "_op")

    def __init__(self, tracker: OpTracker, op):
        self._tracker = tracker
        self._op = op

    def __enter__(self):
        stack = getattr(self._tracker._tls, "stack", None)
        if stack is None:
            stack = self._tracker._tls.stack = []
        stack.append(self._op)
        return self._op

    def __exit__(self, *exc):
        self._tracker._tls.stack.pop()
        return False


_tracker: Optional[OpTracker] = None
_tracker_lock = threading.Lock()


def tracker() -> OpTracker:
    """The process-wide tracker (the per-daemon OpTracker analog)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = OpTracker()
        return _tracker


def mark_active(event: str, **tags) -> None:
    """Tag the calling thread's active op, if any — the seam device
    dispatch layers (xla_mapper, gf_jax) use so compile-vs-cached lands
    on whatever client op triggered the dispatch."""
    t = _tracker
    if t is None:
        return
    op = t.current()
    if op is not None:
        op.mark_event(event, **tags)
