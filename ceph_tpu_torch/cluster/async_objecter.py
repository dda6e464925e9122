"""AsyncObjecter — the completion-callback wire data path.

Role of the reference's asynchronous Objecter + AsyncMessenger pair
(src/osdc/Objecter.cc op_submit/_op_submit_with_budget returning to
the caller before the op completes, completions delivered as
``Context::complete`` callbacks; src/msg/async/ — every connection a
pipelined state machine): an op here is SUBMITTED, not executed —

    submit -> encode -> fan-out -> gather-commits -> complete

with completions delivered by callback from the messenger's reader
threads.  Why this exists: the device kernels run at
hundreds of GB/s while one blocking encrypted wire stream moves
~150 MiB/s — the wire tier was three orders of magnitude behind the
math it feeds, bounded by one-frame-at-a-time round trips and a
per-byte seal, not by the sockets.

Three pieces live here:

  * ``AioCompletion`` — the librados ``rados_completion_t`` role: a
    future the submitter can wait on, poll, or hang callbacks off.
  * ``AioEngine`` — a small completion-dispatch pool with per-key FIFO
    ordering: ops submitted under the same key run strictly in
    submission order (the librados per-object write ordering
    contract), distinct keys run concurrently.  Retries and op state
    machines run here, never in messenger callback context (a
    callback that blocks on a connect RTT stalls every completion
    behind it — the CTL110 lint rule polices exactly this).
  * ``AsyncObjecter`` — the wire core: N parallel pipelined streams
    per OSD daemon (msg/wire.py ``StreamPool``), scatter-gather frame
    encoding so bulk shard payloads go buffer -> socket without
    passing through the typed encoder, (session, seq) replay stamping
    threaded through UNCHANGED from the blocking path, and a single
    fresh-stream resubmit on stream death (the blocking osd_call's
    reconnect-retry, callback-shaped).

The blocking ``RemoteCluster`` paths are thin shims over this core
(``call()`` = ``call_async().result()``): one code path for stamping,
resend and backoff, sync results byte-identical to the async ones.
Completions ride OpTracker: submission marks ``dispatched_wire`` and
the ``stage_wire_to_done_s`` histogram measures the in-flight wire
window that ``dump_ops_in_flight`` exposes.
"""
from __future__ import annotations

import concurrent.futures as _cf
import os
import queue as _queue
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..common import tracer as _trace
from ..common.lockdep import LockdepLock
from ..common.op_tracker import (EVENT_DISPATCHED_WIRE,
                                 tracker as _op_tracker)
from ..common.options import config
from ..common.perf_counters import perf as _perf
from ..msg import encoding, wire


class AioCompletion(_cf.Future):
    """One async op's completion (librados ``rados_completion_t``):
    a concurrent.futures.Future (so ``asyncio.wrap_future`` and the
    whole waiting toolbox work on it) wearing the librados verbs."""

    def is_complete(self) -> bool:
        return self.done()

    def wait_for_complete(self, timeout: Optional[float] = None) -> int:
        """Block until complete (librados returns 0; errors surface
        from get_return_value, not the wait).  A wait that times out
        with the op still in flight returns -ETIMEDOUT — callers gate
        stall detection on a nonzero return, which must not be
        vacuous."""
        _cf.wait([self], timeout=timeout)
        if not self.done():
            import errno
            return -errno.ETIMEDOUT
        return 0

    def get_return_value(self) -> Any:
        """The op's result; raises the op's error (the pythonic shape
        of librados' negative-errno return)."""
        return self.result()

    def set_complete_callback(self, cb) -> None:
        """``cb(completion)`` fires when the op completes — from the
        completing thread, so callbacks must not block (CTL110)."""
        self.add_done_callback(lambda _fut: cb(self))

    # internal completion entry points: tolerant of double delivery
    # (a raced retry may complete after the first delivery landed)
    def _complete(self, result: Any) -> None:
        try:
            self.set_result(result)
        except _cf.InvalidStateError:
            pass

    def _fail(self, exc: BaseException) -> None:
        try:
            self.set_exception(exc)
        except _cf.InvalidStateError:
            pass


class AioEngine:
    """Completion-dispatch worker pool with per-key FIFO ordering.

    Ops submitted under the same ``key`` execute strictly in
    submission order — op i+1 for an object does not start until op i
    completed (the librados write-ordering guarantee overlapping
    ``aio_write_full`` calls rely on); ops under distinct keys (or
    key=None) run concurrently across the workers.  The engine is
    also where the async core schedules work that must never run in
    messenger callback context (stream rebuilds, resubmits)."""

    def __init__(self, workers: int = 2, name: str = "aio"):
        self._q: "_queue.Queue" = _queue.Queue()
        self._lock = LockdepLock(f"aio.engine.{name}", recursive=False)
        # key -> deque of (fn, comp) queued BEHIND the running op
        self._keys: Dict[Any, deque] = {}
        self._stopped = False
        self._tls = threading.local()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-{i}")
            for i in range(max(1, int(workers)))]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------- submit --
    def submit(self, fn, key: Any = None,
               completion: Optional[AioCompletion] = None
               ) -> AioCompletion:
        """Queue ``fn`` (its return value / exception completes the
        completion).  Same-key ops serialize in submission order."""
        comp = completion or AioCompletion()
        with self._lock:
            if self._stopped:
                comp._fail(RuntimeError("aio engine closed"))
                return comp
            if key is not None:
                pending = self._keys.get(key)
                if pending is not None:
                    pending.append((fn, comp))
                    return comp
                self._keys[key] = deque()
        self._q.put((key, fn, comp))
        return comp

    def run(self, fn, key: Any = None) -> Any:
        """Blocking shim: run ``fn`` through the engine and wait.
        Called FROM a worker it runs inline (a sync verb inside an
        async completion must not deadlock on its own worker pool)."""
        if getattr(self._tls, "in_worker", False):
            return fn()
        return self.submit(fn, key=key).result()

    def in_worker(self) -> bool:
        return bool(getattr(self._tls, "in_worker", False))

    # ---------------------------------------------------------- workers --
    def _worker(self) -> None:
        self._tls.in_worker = True
        while True:
            item = self._q.get()
            if item is None:
                return
            key, fn, comp = item
            try:
                comp._complete(fn())
            except BaseException as e:          # completion carries it
                comp._fail(e)
            if key is not None:
                self._advance(key)

    def _advance(self, key: Any) -> None:
        with self._lock:
            pending = self._keys.get(key)
            if not pending:
                self._keys.pop(key, None)
                return
            fn, comp = pending.popleft()
        self._q.put((key, fn, comp))

    def close(self) -> None:
        with self._lock:
            self._stopped = True
            orphans = [c for q in self._keys.values() for _, c in q]
            self._keys.clear()
        for c in orphans:
            c._fail(RuntimeError("aio engine closed"))
        for _ in self._threads:
            self._q.put(None)


class AsyncObjecter:
    """The wire tier's async op core over per-OSD stream pools.

    Owned by a ``RemoteCluster``; the blocking ``osd_call`` is a shim
    over :meth:`call` so the stamping / resend / scatter-gather logic
    exists exactly once.  Streams negotiate the configured data mode
    (``objecter_wire_mode``, default crc — the reference's
    intra-cluster ms_mode) after the cephx handshake."""

    # payloads at or above this ride the scatter-gather frame tail,
    # straight from their buffer (below it, the typed encoder's copy
    # is cheaper than a second sendmsg segment)
    SG_MIN = wire.SG_MIN

    def __init__(self, rc):
        self.rc = rc
        cfg = config()
        self.n_streams = int(cfg.get("objecter_wire_streams"))
        self.window = int(cfg.get("objecter_wire_window"))
        self.mode = str(cfg.get("objecter_wire_mode"))
        # same-host shared-memory lane (msg/shm_ring.py): ring bytes
        # per OSD pool; 0 disables and every payload rides the socket
        self.shm_bytes = int(cfg.get("wire_shm_ring_kib")) << 10
        if self.mode == wire.MODE_SECURE:
            # sealed payloads must never cross the plaintext mmap
            # ring: the lane is integrity-only (crc bound into the
            # MAC'd doorbell), so secure mode keeps every byte on
            # the sealed socket frames
            self.shm_bytes = 0
        self._pools: Dict[int, wire.StreamPool] = {}
        self._lock = LockdepLock("objecter.async", recursive=False)
        self.engine = AioEngine(workers=2, name="objecter-aio")
        # resubmits run on their own single worker: the op engine's
        # workers BLOCK in gather steps, and a retry queued behind a
        # blocked worker that is itself waiting on that retry's
        # completion would deadlock the pool — the io engine only ever
        # does pool.submit (bounded connect RTTs), never waits
        self._io = AioEngine(workers=1, name="objecter-io")
        self._pc = _perf("objecter.wire")

    # ------------------------------------------------------------ pools --
    def pool(self, osd: int) -> wire.StreamPool:
        with self._lock:
            p = self._pools.get(osd)
            if p is None:
                # ring files live next to the daemon's socket (both
                # processes reach them through the cluster dir, and
                # the server only maps paths from its own dir)
                shm_dir = None
                try:
                    shm_dir = os.path.dirname(self.rc.addrs[osd])
                except (KeyError, IndexError, AttributeError,
                        TypeError):
                    pass
                p = self._pools[osd] = wire.StreamPool(
                    factory=lambda o=osd: self.rc._stream_conn(o),
                    size=self.n_streams, mode=self.mode,
                    window=self.window, name=f"osd.{osd}",
                    shm_dir=shm_dir, shm_bytes=self.shm_bytes)
            return p

    @property
    def reply_wanted(self) -> bool:
        """True when pools built by this objecter will ask daemons
        for the shm REPLY ring (RingReply): requires a live shm lane
        (secure mode zeroes ``shm_bytes`` — sealed payloads never
        cross the plaintext mmap, in either direction) AND the
        ``wire_reply_ring`` option.  The observability twin of the
        gate each StreamPool latches at build time."""
        from ..common import crcutil
        return self.shm_bytes > 0 and crcutil.flag("wire_reply_ring")

    def drop_pool(self, osd: int) -> None:
        with self._lock:
            p = self._pools.pop(osd, None)
        if p is not None:
            p.close()

    def streams_live(self, osd: int) -> int:
        with self._lock:
            p = self._pools.get(osd)
        return 0 if p is None else p.streams_live()

    # ------------------------------------------------------------- ops --
    @staticmethod
    def _sg_payload(req: Dict[str, Any]):
        """Split a bulk ``data`` payload out of the request for the
        scatter-gather frame tail; returns (meta_req, data|None,
        csums|None) — the shared wire.extract_bulk contract (one
        threshold, one view-passing policy, for every sender)."""
        return wire.extract_bulk(req, "sg_payload")

    def call_async(self, osd: int, req: Dict[str, Any],
                   completion: Optional[AioCompletion] = None
                   ) -> AioCompletion:
        """Submit one OSD request; returns immediately with its
        completion.  Mutating commands are stamped ONCE with this
        client's (session, seq) — the single fresh-stream resubmit
        after a stream death replays the SAME stamp, so the daemon's
        dup table applies the op at most once (the PR-5 session-replay
        contract, unchanged underneath the async core)."""
        comp = completion or AioCompletion()
        tenant = getattr(self.rc, "tenant", None)
        if tenant is not None and "tenant" not in req and \
                req.get("klass", "client") == "client":
            # tenant identity (S3 auth -> set_tenant) rides every
            # client-class request so the daemon dispatches it under
            # the tenant's own dmClock class; background traffic
            # (recovery, scrub) keeps its background class untagged
            req = dict(req, tenant=tenant)
        if req.get("cmd") in self.rc._REPLAY_CMDS and \
                "session" not in req:
            req = dict(req, **self.rc._next_stamp(osd))
        tr_span = None
        if _trace.enabled():
            # wire-submit stage span, opened MANUALLY (submit and
            # completion run on different threads, so no context
            # manager can bracket it) and stamped into the request
            # meta — the trace-context wire propagation for both
            # MSG_REQ and scatter-gather MSG_REQ_SG frames
            tr_span = _trace.tracer().span_open(
                "objecter.wire_submit", osd=osd, cmd=req.get("cmd"))
            if tr_span.trace_id:
                req = dict(req)
                req["tctx"] = [tr_span.trace_id, tr_span.span_id]
        req, data, csums = self._sg_payload(req)
        pool = self.pool(osd)
        shm_tok = None
        if data is not None:
            # same-host shared-memory lane: the payload goes to the
            # ring and only a doorbell (meta + extent + crc) crosses
            # the socket.  Any failure (ring full, lane refused,
            # daemon restarted without the mapping) falls back to the
            # socket scatter-gather tail for THIS frame — the lane is
            # an optimization, never a dependency.
            shm_tok = pool.ring_put(data, csums)
        if shm_tok is not None:
            meta = encoding.dumps(dict(req, _shm=shm_tok.meta))
            # the ORIGINAL payload stays referenced: the one resend
            # re-frames it onto the socket (below) instead of
            # replaying a doorbell whose ring record may be the very
            # thing that failed (poisoned/overwritten extent — a
            # doorbell replay would fail identically forever)
            send_data = send_csums = None
        else:
            meta = encoding.dumps(req)
            send_data, send_csums = data, csums
        self._pc.inc("submits")
        tr = _op_tracker()
        cur = tr.current()
        own = None
        if cur is not None:
            # nested under a tracked client op (put/get): the wire
            # dispatch is a STAGE of that op, not its own record
            cur.mark_event(EVENT_DISPATCHED_WIRE, osd=osd)
        else:
            own = tr.create(req.get("cmd", "op"), service="objecter",
                            osd=osd, oid=req.get("oid"))
            own.mark_event(EVENT_DISPATCHED_WIRE, osd=osd)
            if tr_span is not None and own.tracked and \
                    tr_span.trace_id:
                own.tags["trace_id"] = tr_span.trace_id
        state = {"retried": False}

        def _finish(result, exc) -> None:
            if shm_tok is not None:
                # the op is terminal either way: the ring extent is
                # reusable (a resubmit-in-flight never reaches here —
                # it reuses the SAME extent until its own completion)
                pool.ring_free(shm_tok)
            if tr_span is not None:
                _trace.tracer().finish_span(
                    tr_span, error=None if exc is None
                    else type(exc).__name__)
            if own is not None:
                tr.finish(own, error=None if exc is None
                          else type(exc).__name__)
            if exc is None:
                comp._complete(result)
            else:
                self._pc.inc("errors")
                comp._fail(exc)

        def _resend_args():
            """The one resubmit always rides the SOCKET: re-encode
            the meta WITHOUT the doorbell and re-frame the original
            payload — a dead stream, a refused re-attach and a
            poisoned ring record all heal the same way (the (session,
            seq) stamp makes the replay at-most-once regardless of
            which lane the first attempt used)."""
            if shm_tok is None:
                return meta, data, csums
            return encoding.dumps(req), data, csums

        def _cb(result, exc) -> None:
            if exc is not None and isinstance(exc, (OSError, IOError)) \
                    and not state["retried"]:
                # stream died under the op (daemon restart, injected
                # socket failure, partition): one resubmit on a fresh
                # stream with the SAME stamp — scheduled on the
                # engine, never in this reader-callback context (the
                # rebuild does connect RTTs)
                state["retried"] = True
                self._pc.inc("resubmits")
                self._io.submit(
                    lambda: self._resend(osd, _resend_args(),
                                         _cb, _finish))
                return
            _finish(result, exc)

        try:
            pool.submit(meta, data=send_data, cb=_cb,
                        csums=send_csums)
        except (OSError, IOError) as e:
            if state["retried"]:
                _finish(None, e)
            else:
                state["retried"] = True
                self._pc.inc("resubmits")
                self._io.submit(
                    lambda: self._resend(osd, _resend_args(),
                                         _cb, _finish))
        return comp

    def _resend(self, osd: int, framed, cb, finish) -> None:
        meta, data, csums = framed
        try:
            self.pool(osd).submit(meta, data=data, cb=cb,
                                  csums=csums)
        except (OSError, IOError) as e:
            finish(None, e)

    # -------------------------------------------------- blocking shims --
    def call(self, osd: int, req: Dict[str, Any]) -> Any:
        """Blocking shim — the code path every sync RemoteCluster op
        rides (osd_call), so sync and async share one implementation."""
        return self.call_async(osd, req).result()

    @staticmethod
    def gather(comps: List[AioCompletion]
               ) -> List[Tuple[Any, Optional[BaseException]]]:
        """Wait for every completion; per-op (result, error) pairs in
        input order (the gather-commits step of write fan-outs, where
        per-shard failures feed the resend verdict, not an exception)."""
        out: List[Tuple[Any, Optional[BaseException]]] = []
        for c in comps:
            try:
                out.append((c.result(), None))
            except BaseException as e:
                out.append((None, e))
        return out

    def close(self) -> None:
        with self._lock:
            pools, self._pools = dict(self._pools), {}
        for p in pools.values():
            p.close()
        self.engine.close()
        self._io.close()
