"""Tracing spans — the distributed-tracing substrate.

Roles of the reference's tracer (src/common/tracer.{h,cc}: jspan /
child_span wrappers over Jaeger/OpenTracing, threaded through ops e.g.
PrimaryLogPG.cc:11060) and the LTTng tracepoints in hot paths
(src/tracing/*.tp).  TPU-native shape: spans wrap host-side stages
around device dispatches (map sweep, encode, recovery) with parent /
child links and wall-time, collected in a bounded in-process buffer
dumped as JSON (the role the Jaeger agent plays).

ClusterTelemetry grew this into CROSS-PROCESS tracing:

  * a ``(trace_id, span_id)`` trace context is stamped into every
    request a client submits (``stamp(req)`` at the objecter /
    AsyncObjecter submit path) and rides the typed request meta of
    both MSG_REQ and scatter-gather MSG_REQ_SG wire frames (key
    ``tctx``) as well as in-process dispatch op dicts — the
    reference's jaeger trace-context header propagation;
  * daemons open LINKED child spans around their queue / dispatch /
    store-barrier / device-dispatch stages via ``child_of`` remote
    parents, each tagged with the process's ``service`` entity, so
    one logical op's spans scatter across every process it touched;
  * ``assemble()`` is the collector: it merges span dumps fetched
    from many daemons' ``dump_traces`` asok surfaces into one tree
    per trace (the Jaeger query/assembly role) — ``ceph trace <op>``
    drives it cluster-wide;
  * slow ops AUTO-SAMPLE: when the OpTracker finishes an op past
    ``op_tracker_complaint_time`` it pins that op's trace
    (``pin_trace``), exempting its spans from buffer trimming, so a
    slow op always has its end-to-end flame trace retrievable.

Cost contract (the faults.fire dict-miss rule): span and stamp sites
sit on put/get hot paths, so DISARMED tracing is a single dict
membership test — no config resolve, no lock, no allocation.  Span
ids are drawn from a per-process RNG (not a counter) so ids never
collide across the processes one trace spans.

The profiler's clock and the card's: while a ``torch.profiler`` is
active, every context-managed span also opens a ``record_function``
range of its name, so it stands in the profiler's own timeline (and
names the card's idle gaps there); with no profiler active that costs
one C call.  A span opened ``on_device`` also measures the device's
time between its entry and its exit (``device_s`` in its dump; see
``Span.device_s``).  Manually opened spans (``span_open``) cross
threads and are not bridged.
"""
from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from .perf_counters import perf as _perf

# armed-state fast path: ``"on" in _armed`` is the whole disarmed
# cost (the faults registry pattern — see common/faults.py)
_armed: Dict[str, bool] = {"on": True}

# this process's service entity ("client", "osd.3", "mon.1"), stamped
# on every span so cross-process assembly can attribute stages
_service: Dict[str, str] = {"name": "client"}

# cluster-unique span/trace ids: a counter collides across processes,
# so ids come from a per-process RNG (ids carry no schedule state —
# seeded thrash determinism never reads them)
_rng = random.Random()

# a span's CUDA timing events are read once, by whichever dump comes
# first (two threads may dump at once)
_events_lock = threading.Lock()


def enabled() -> bool:
    """One dict-miss check — safe on any hot path."""
    return "on" in _armed


def arm() -> None:
    _armed["on"] = True


def disarm() -> None:
    _armed.pop("on", None)


def set_service(name: str) -> None:
    """Name this process for span attribution (daemons call it at
    boot with their entity; clients default to "client")."""
    _service["name"] = str(name)


def service() -> str:
    return _service["name"]


def stamp(req: Dict[str, Any]) -> Dict[str, Any]:
    """Propagate the active trace context into an outbound request
    dict (key ``tctx`` — the trace-context wire format for MSG_REQ /
    MSG_REQ_SG meta and in-process dispatch ops).  Disarmed: one
    dict-miss, the dict passes through untouched.  The CTL701 lint
    rule requires every data-path send site to route through here."""
    if "on" not in _armed:
        return req
    t = _tracer
    if t is None:
        return req
    span = t._current()
    if span is not None:
        req["tctx"] = [span.trace_id, span.span_id]
    return req


@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_id: Optional[int]
    name: str
    start: float                 # perf_counter (duration arithmetic)
    ts: float = 0.0              # wall clock at start: correlates spans
    #                              with log lines and tracked-op events
    end: Optional[float] = None
    service: str = "client"      # owning process's entity
    tags: Dict[str, Any] = field(default_factory=dict)
    device: Optional[str] = None  # the device a span opened on_device
    #                               measures (see device_s)
    events: Optional[list] = None  # its CUDA timing events, until read
    _device_s: Optional[float] = None

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def ctx(self) -> Tuple[int, int]:
        """The (trace_id, span_id) context children link under."""
        return (self.trace_id, self.span_id)

    def device_s(self) -> Optional[float]:
        """The device's time between the span's entry and its exit, for
        a span opened ``on_device``; None for any other.

        On a CUDA device it is the current stream's time between two
        timing events recorded at entry and exit, which the span records
        only while a profiler is active: the stage's kernels plus any
        idle inside it (the card waiting for the host to enqueue).  The
        events are read here, at dump time, never at exit, so a span
        adds no synchronisation; None when no events were recorded.  On
        the CPU, torch runs each op before it returns, so it is the
        span's own duration."""
        if self.device is None:
            return None
        if self.device == "cpu":
            return self.duration
        with _events_lock:
            if self.events is not None and len(self.events) == 2:
                first, last = self.events
                last.synchronize()
                self._device_s = first.elapsed_time(last) / 1e3
                self.events = None
            return self._device_s

    def dump(self) -> Dict[str, Any]:
        out = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "service": self.service, "ts": round(self.ts, 6),
            # perf_counter at start: orders spans of one process only
            "t0": self.start,
            "duration_s": round(self.duration or 0.0, 9),
            "tags": self.tags,
        }
        if self.device is not None:
            out["device_s"] = self.device_s()
        return out


class _NullSpan:
    """Disarmed span: every call a no-op (the OpTracker _NullOp
    pattern) — callers never branch on enablement."""

    __slots__ = ()
    trace_id = span_id = 0
    parent_id = None
    name = service = ""
    duration = end = None
    tags: Dict[str, Any] = {}

    def set_tag(self, key: str, value: Any) -> None:
        pass

    def ctx(self) -> Tuple[int, int]:
        return (0, 0)


_NULL_SPAN = _NullSpan()


class _NullSpanCM:
    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullSpanCM()


def _cuda_event(device: str):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _SpanCM:
    """Context-managed span: an exception propagating through the
    body finishes the span WITH an ``error`` tag (the leaked-span
    satellite's contract — an abandoned stage must not dump as a
    mysteriously fast clean stage).

    While a profiler is active the span is also a ``record_function``
    range of its name, and a span on a CUDA device records a timing
    event at entry and one at exit on the device's current stream."""

    __slots__ = ("_tracer", "span", "_range")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._range = None

    def __enter__(self) -> Span:
        span = self.span
        self._tracer._push(span)
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(
                span.name)
            self._range.__enter__()
            if span.device is not None and \
                    span.device.startswith("cuda"):
                span.events = [_cuda_event(span.device)]
        return span

    def __exit__(self, et, ev, tb):
        span = self.span
        if et is not None:
            span.tags.setdefault("error", et.__name__)
        if self._range is not None:
            if span.events is not None:
                span.events.append(_cuda_event(span.device))
            self._range.__exit__(et, ev, tb)
            self._range = None
        self._tracer._pop_finish(span)
        return False


class Tracer:
    """Span factory + bounded finished-span buffer.

    The buffer bound used to drop silently; drops are now counted
    (``tracer.spans_dropped`` perf counter + a cumulative tally) and
    ``dump_traces`` exposes buffer occupancy.  Pinned (auto-sampled
    slow) traces are exempt from trimming, bounded by
    ``MAX_PINNED_TRACES`` with LRU eviction.
    """

    MAX_PINNED_TRACES = 32
    # manual-open spans (callback paths that cannot hold a context
    # manager) older than this are force-finished with error="leaked"
    LEAK_AGE_S = 300.0

    def __init__(self, max_spans: int = 10000):
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._finished: List[Span] = []
        self._tls = threading.local()
        self.spans_dropped = 0
        # trace_id -> [spans] rescued from trimming (sampled traces)
        self._pinned: "OrderedDict[int, List[Span]]" = OrderedDict()
        self._sampled: set = set()
        # manually opened spans (span_open) awaiting finish_span
        self._open: Dict[int, Span] = {}

    # ------------------------------------------------------------- spans --
    def _current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def current_ctx(self) -> Optional[Tuple[int, int]]:
        """(trace_id, span_id) of this thread's active span, or None
        (what submit paths stamp into outbound requests)."""
        span = self._current()
        return None if span is None else span.ctx()

    def _make_span(self, name: str,
                   child_of: Optional[Iterable[int]],
                   tags: Dict[str, Any],
                   service: Optional[str] = None,
                   on_device=None) -> Span:
        parent = self._current()
        if parent is not None:
            tid, pid = parent.trace_id, parent.span_id
        elif child_of:
            # remote parent: a (trace_id, span_id) context carried in
            # from another process/thread (wire frames, dispatch ops)
            tid, pid = int(child_of[0]), int(child_of[1])
        else:
            tid, pid = _rng.getrandbits(48), None
        return Span(trace_id=tid, span_id=_rng.getrandbits(48),
                    parent_id=pid, name=name,
                    start=time.perf_counter(), ts=time.time(),
                    service=service or _service["name"],
                    tags=dict(tags),
                    device=None if on_device is None else str(on_device))

    def start_span(self, name: str,
                   child_of: Optional[Iterable[int]] = None,
                   service: Optional[str] = None, on_device=None,
                   **tags):
        """Root span, child of the active span on this thread
        (child_span semantics, src/common/tracer.h:10-30), or child
        of a REMOTE parent via ``child_of=(trace_id, span_id)``.
        ``service`` overrides the process entity for this span — the
        sim tier's attribution fix: one process hosts MANY logical
        entities (client, every osd.N, the mon), and a span must name
        the entity that EXECUTED the stage, not whoever owns the
        process (which is always "client" in-process).
        ``on_device`` (a torch device) makes the span measure that
        device's time too (``Span.device_s``); being a keyword of its
        own, it is never a tag.
        Disarmed: returns a shared null context manager."""
        if "on" not in _armed:
            return _NULL_CM
        return _SpanCM(self, self._make_span(name, child_of, tags,
                                             service, on_device))

    def child_span(self, name: str, service: Optional[str] = None,
                   on_device=None, **tags):
        """A span ONLY when a parent is active on this thread (stage
        sites deep in daemons — an untraced op must not spawn orphan
        root spans at every stage it passes)."""
        if "on" not in _armed or self._current() is None:
            return _NULL_CM
        return _SpanCM(self, self._make_span(name, None, tags,
                                             service, on_device))

    # ----------------------------------------------- manual open/finish --
    def span_open(self, name: str,
                  child_of: Optional[Iterable[int]] = None, **tags):
        """Open a span WITHOUT entering it on this thread's stack —
        for completion-callback paths where open and finish happen on
        different threads (the async objecter).  Must be closed with
        ``finish_span``; leaked spans are swept by ``finish_leaked``
        with an error tag."""
        if "on" not in _armed:
            return _NULL_SPAN
        span = self._make_span(name, child_of, tags)
        with self._lock:
            self._open[span.span_id] = span
        return span

    def finish_span(self, span, error: Optional[str] = None) -> None:
        if span is None or span is _NULL_SPAN or \
                not isinstance(span, Span):
            return
        with self._lock:
            was_open = self._open.pop(span.span_id, None) is not None
        if not was_open:
            # already finished — the leak sweep won the race (an op
            # stalled past LEAK_AGE_S then completed): finishing
            # again would insert the same span twice and inflate
            # occupancy; the sweep's error=leaked verdict stands
            return
        if error is not None:
            span.tags.setdefault("error", error)
        self._finish(span)

    def finish_leaked(self, max_age_s: Optional[float] = None) -> int:
        """Force-finish manual-open spans older than ``max_age_s``
        with an ``error: leaked`` tag (exception paths that dropped
        their span on the floor must still show up in the dump, as
        errors, not vanish)."""
        bound = self.LEAK_AGE_S if max_age_s is None else max_age_s
        now = time.perf_counter()
        with self._lock:
            leaked = [s for s in self._open.values()
                      if now - s.start >= bound]
            for s in leaked:
                del self._open[s.span_id]
        for s in leaked:
            s.tags.setdefault("error", "leaked")
            self._finish(s)
        return len(leaked)

    # ----------------------------------------------------- stack/finish --
    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop_finish(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        self._finish(span)

    def _finish(self, span: Span) -> None:
        if span.end is None:
            span.end = time.perf_counter()
        dropped = 0
        with self._lock:
            self._finished.append(span)
            if len(self._finished) > self.max_spans:
                cut = len(self._finished) // 2
                trimmed, self._finished = (self._finished[:cut],
                                           self._finished[cut:])
                for s in trimmed:
                    if s.trace_id in self._sampled:
                        # auto-sampled slow trace: rescue, not drop
                        self._pinned.setdefault(s.trace_id,
                                                []).append(s)
                    else:
                        dropped += 1
                self.spans_dropped += dropped
        if dropped:
            _perf("tracer").inc("spans_dropped", dropped)

    # --------------------------------------------------------- sampling --
    def pin_trace(self, trace_id: int) -> None:
        """Auto-sampling hook (OpTracker.finish on a slow op): this
        trace's spans survive buffer trims, so the slow op's flame
        trace stays retrievable long after the buffer churned."""
        if not trace_id:
            return
        with self._lock:
            self._sampled.add(int(trace_id))
            self._pinned.setdefault(int(trace_id), [])
            self._pinned.move_to_end(int(trace_id))
            while len(self._pinned) > self.MAX_PINNED_TRACES:
                old, _spans = self._pinned.popitem(last=False)
                self._sampled.discard(old)

    def sampled_traces(self) -> List[int]:
        with self._lock:
            return sorted(self._sampled)

    # -------------------------------------------------------------- dump --
    def _all_spans_locked(self) -> List[Span]:
        pinned = [s for spans in self._pinned.values() for s in spans]
        return pinned + list(self._finished)

    def dump(self) -> List[Dict[str, Any]]:
        with self._lock:
            spans = self._all_spans_locked()
        return [s.dump() for s in spans]

    def dump_traces(self) -> Dict[str, Any]:
        """The ``ceph daemon <name> dump_traces`` surface: spans plus
        the buffer health the drop-counting satellite demands."""
        self.finish_leaked()
        with self._lock:
            spans = self._all_spans_locked()
            occupancy = len(self._finished)
            open_spans = len(self._open)
            sampled = sorted(self._sampled)
            dropped = self.spans_dropped
        return {"service": _service["name"],
                "occupancy": occupancy, "max_spans": self.max_spans,
                "open_spans": open_spans,
                "spans_dropped": dropped, "sampled": sampled,
                "num_spans": len(spans),
                "spans": [s.dump() for s in spans]}

    def spans_for(self, trace_id: int) -> List[Dict[str, Any]]:
        with self._lock:
            spans = [s for s in self._all_spans_locked()
                     if s.trace_id == int(trace_id)]
        return [s.dump() for s in spans]

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._pinned.clear()
            self._sampled.clear()
            self._open.clear()
            self.spans_dropped = 0


# ---------------------------------------------------------- assembly ----

def assemble(spans: Iterable[Dict[str, Any]]) -> Dict[int, Dict]:
    """The trace collector: merge span dicts gathered from MANY
    processes' dump_traces into one tree per trace_id (the Jaeger
    query-service assembly role).  Spans whose parent never arrived
    (buffer churn on one daemon) surface as extra roots rather than
    vanishing — a partial trace is still evidence.

    -> {trace_id: {"spans": n, "services": [...], "duration_s": ...,
                   "roots": [node...]}}, node = span dict +
    "children": [node...] sorted by start wall-clock.
    """
    by_trace: Dict[int, List[Dict[str, Any]]] = {}
    for s in spans:
        by_trace.setdefault(int(s["trace_id"]), []).append(dict(s))
    out: Dict[int, Dict] = {}
    for tid, group in by_trace.items():
        # dedup (the same daemon may be dumped twice by a collector)
        seen: Dict[int, Dict[str, Any]] = {}
        for s in group:
            seen.setdefault(int(s["span_id"]), s)
        nodes = {sid: dict(s, children=[])
                 for sid, s in seen.items()}
        roots = []
        for sid, node in nodes.items():
            pid = node.get("parent_id")
            parent = nodes.get(int(pid)) if pid else None
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: n.get("ts", 0.0))
        roots.sort(key=lambda n: n.get("ts", 0.0))
        ts0 = min(n.get("ts", 0.0) for n in nodes.values())
        ts1 = max(n.get("ts", 0.0) + n.get("duration_s", 0.0)
                  for n in nodes.values())
        out[tid] = {
            "trace_id": tid,
            "spans": len(nodes),
            "services": sorted({n.get("service", "")
                                for n in nodes.values()}),
            "duration_s": round(ts1 - ts0, 9),
            "roots": roots,
        }
    return out


def stage_breakdown(spans: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Per-stage wall-time attribution over assembled/raw spans:
    {span name: {count, total_s, max_s}} — the bench satellite's
    'WHY is this tier slow' datapoint."""
    out: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        d = out.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                       "max_s": 0.0})
        dur = float(s.get("duration_s") or 0.0)
        d["count"] += 1
        d["total_s"] = round(d["total_s"] + dur, 9)
        d["max_s"] = round(max(d["max_s"], dur), 9)
    return out


def render_trace(tree: Dict, indent: str = "  ") -> str:
    """Human flame-tree rendering of one assemble() entry."""
    lines = [f"trace {tree['trace_id']:x}: {tree['spans']} spans "
             f"across {', '.join(tree['services'])} "
             f"({tree['duration_s'] * 1e3:.3f} ms)"]

    def walk(node, depth):
        dur = node.get("duration_s", 0.0) * 1e3
        err = node.get("tags", {}).get("error")
        suffix = f"  ERROR={err}" if err else ""
        lines.append(f"{indent * depth}{node['service']}: "
                     f"{node['name']} {dur:.3f} ms{suffix}")
        for c in node["children"]:
            walk(c, depth + 1)

    for r in tree["roots"]:
        walk(r, 1)
    return "\n".join(lines)


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer(max_spans=_buffer_bound())
        return _tracer


def pin_trace(trace_id) -> None:
    """Module-level auto-sampling hook (cheap when tracing never ran:
    no tracer is constructed just to pin into an empty buffer)."""
    t = _tracer
    if t is not None and trace_id:
        t.pin_trace(int(trace_id))


def child_span(name: str, service: Optional[str] = None,
               on_device=None, **tags):
    """Module-level stage-span fast path: one dict-miss when
    disarmed, null when no parent is active (see Tracer.child_span).
    Deep fire sites (scheduler dequeue, store barriers, device
    dispatch) call this unconditionally."""
    if "on" not in _armed:
        return _NULL_CM
    t = _tracer
    if t is None:
        return _NULL_CM
    return t.child_span(name, service=service, on_device=on_device,
                        **tags)


def start_span(name: str, child_of=None,
               service: Optional[str] = None, on_device=None, **tags):
    """Module-level span fast path: the disarmed case is one
    dict-miss with no singleton lock (fire sites run per op)."""
    if "on" not in _armed:
        return _NULL_CM
    return tracer().start_span(name, child_of=child_of,
                               service=service, on_device=on_device,
                               **tags)


def linked_span(name: str, child_of,
                service: Optional[str] = None, **tags):
    """Open a span ONLY when a remote trace context arrived (or a
    local parent is active): the daemon-side rule — an op that was
    never stamped must not litter the buffer with orphan roots.
    ``service`` attributes the span to the EXECUTING logical entity
    (sim-tier daemons share one process whose default entity is
    "client")."""
    if "on" not in _armed:
        return _NULL_CM
    if child_of:
        return tracer().start_span(name, child_of=child_of,
                                   service=service, **tags)
    return child_span(name, service=service, **tags)


def _buffer_bound() -> int:
    try:
        from .options import OptionError, config
        return int(config().get("trace_max_spans"))
    except Exception:
        return 10000


# config binding: ``trace_enabled`` drives the armed dict (observed
# live, like perf_counters_enabled).  Import-time so daemons spawned
# with CEPH_TPU_TRACE_ENABLED=0 never arm; failure leaves the
# default (armed) — tracing must not break a process missing the
# options registry.
def _bind_config() -> None:
    try:
        from .options import OptionError, config
        cfg = config()
        try:
            on = bool(cfg.get("trace_enabled"))
        except OptionError:
            return
        (arm if on else disarm)()

        def _refresh(_name, value):
            (arm if bool(value) else disarm)()
        cfg.observe("trace_enabled", _refresh)
    except Exception:
        pass


_bind_config()
