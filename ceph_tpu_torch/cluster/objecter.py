"""Objecter — the client-side op engine.

Role of the reference Objecter (src/osdc/Objecter.cc: op_submit :2191,
_calc_target :2688, resend on map change): a client holds its OWN
cached OSDMap, computes each op's target from it, and when the cluster
map moves on — targets down, epoch stale — it catches up via the mon's
incremental stream and recomputes/resends instead of failing.

The simulator plays the OSD side; ops land through ClusterSim's data
path only when the client's computed target agrees with the current
map (a mismatched target = the op would have been sent to the wrong
daemon and rejected, triggering resend).
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..common import faults
from ..common.backoff import ExpBackoff, TickClock
from ..common.op_tracker import tracker as _op_tracker
from ..common.perf_counters import perf as _perf
from ..common.tracer import tracer as _tracer
from ..placement.crush_map import ITEM_NONE
from .monitor import Monitor
from .osdmap import OSDMap
from .simulator import ClusterSim


class TooManyRetries(IOError):
    pass


class WriteBlocked(IOError):
    """An EC write landed RECOVERABLE (>= k) but sub-``min_size``
    shards, and the map offers no progress that would change that —
    the reference refuses to ack such writes (min_size = k+1: a write
    acked with zero parity headroom is one failure away from loss) and
    BLOCKS them until the PG heals (src/osd/PrimaryLogPG.cc
    check_pool_min_size / PG_STATE_DEGRADED wait).  Raised only after
    the bounded in-objecter probe gave up; the bytes ARE durably
    applied at >= k, the op just never acked.  Callers that can park
    and resume (the thrasher's mid-cut ride-outs) re-drive the write
    after heal; treating this as a plain failure loses the
    write-is-still-pending distinction."""


faults.declare(
    "msg.drop_ack",
    "drop the COMPLETION of a client op after the cluster durably "
    "applied it (the lost-reply half of a cut: op committed, ack "
    "never arrived) — the client must resend and the (session, seq) "
    "dup detection must apply it at most once")

_SESSION_IDS = itertools.count(1)


class Objecter:
    """Client with a cached map; submits ops with retry-on-map-change."""

    def __init__(self, sim: ClusterSim, mon: Monitor,
                 max_retries: int = 8, seed: int = 0):
        self.sim = sim
        self.mon = mon
        # the client's PRIVATE map copy, caught up via incrementals
        self.osdmap = copy.deepcopy(sim.osdmap)
        self.max_retries = max_retries
        # retry pacing: deterministic exponential backoff with jitter
        # on a SIM-TICK clock — retries are instantaneous in wall time
        # but carry a reproducible schedule (the thrasher's clock; a
        # wall sleep here would make seeded soaks unreproducible)
        self.clock = TickClock()
        self._backoff = ExpBackoff(base=0.05, cap=2.0, seed=seed,
                                   sleep=self.clock.sleep)
        self._pc = _perf("objecter")
        # messenger session: one id per objecter lifetime, a fresh seq
        # per MUTATING logical op.  Retries/replays of one op reuse
        # its (session, seq), so the sim's dup detection applies it at
        # most once even when the first apply's ack was lost
        self.session = f"objecter.{next(_SESSION_IDS)}.{seed}"
        self._op_seq = 0
        self.replay_dups = 0      # resends suppressed by dup-detect
        self.acks_dropped = 0     # injected completion losses

    # ------------------------------------------------------------- maps --
    def maybe_update_map(self) -> int:
        """Consume the mon's incremental stream (subscription model).
        A client partitioned from the mon sees NO new epochs — its
        map simply stops advancing, the stale-target resend loop keeps
        spinning against old state until the cut heals (the
        subscription half of a netsplit)."""
        if faults.partitioned("client", "mon"):
            return 0
        incs = self.mon.get_incrementals(self.osdmap.epoch)
        for inc in incs:
            self.osdmap.apply_incremental(inc)
            self._pc.inc("map_epochs_applied")
        return len(incs)

    def calc_target(self, pool_id: int, name: str
                    ) -> Tuple[int, List[int]]:
        """(pg, up set) from the CLIENT's cached map
        (Objecter::_calc_target)."""
        pool = self.osdmap.pools[pool_id]
        pg = self.sim.object_pg(pool, name)
        up, _, acting, _ = self.osdmap.pg_to_up_acting_osds(pool_id, pg)
        return pg, (acting or up)

    def _target_current(self, pool_id: int, name: str) -> bool:
        """Would the op reach the right daemons?  (the wrong-epoch
        rejection an OSD gives a stale client)."""
        _, client_up = self.calc_target(pool_id, name)
        pool = self.sim.osdmap.pools[pool_id]
        pg = self.sim.object_pg(pool, name)
        real_up = self.sim.pg_up(pool, pg)
        if client_up != real_up:
            return False
        primary = next((o for o in client_up if o != ITEM_NONE), None)
        return primary is not None and self.sim.osds[primary].alive

    def _next_reqid(self) -> Tuple[str, int]:
        """One (session, seq) per mutating LOGICAL op — resends reuse
        it (the osd_op_reqid_t the reference dedups on in the pg log)."""
        self._op_seq += 1
        return (self.session, self._op_seq)

    # -------------------------------------------------------------- ops --
    def _submit(self, op, pool_id: int, name: str, optype: str = "op",
                names: Optional[List[str]] = None,
                reqid: Optional[Tuple[str, int]] = None):
        """op_submit: compute target, send; on stale target refresh the
        map and resend (bounded).  Traced (the jspan threaded through
        ops, src/osd/PrimaryLogPG.cc:11060 role) and TRACKED: the op
        gets a lifecycle record, active for the duration of the data-
        path call so the OSD service / device layers tag it.
        ``names`` widens the target-currency check to a whole batch
        (put_many): ANY stale member resends the batch — the rewrite
        is idempotent (stale copies are superseded).
        ``reqid`` (mutating ops) is the replay contract: every resend
        of this logical op carries the same id; an op the cluster
        already durably committed is NOT re-applied — the recorded
        completion is returned instead (at-most-once apply, even when
        the first apply's ack was dropped on a cut)."""
        self._pc.inc("op_submit")
        check = names if names else [name]
        tr = _op_tracker()
        top = tr.create(optype, service="objecter", pool=pool_id,
                        obj=name)
        error = None
        try:
            with _tracer().start_span("objecter.op", pool=pool_id,
                                      obj=name, optype=optype) as span:
                if span.trace_id and top.tracked:
                    # op id -> trace id mapping: `ceph trace <op>`
                    # resolves through the tracked-op record, and a
                    # slow finish auto-pins this trace (op_tracker)
                    top.tags["trace_id"] = span.trace_id
                blocked: Optional[WriteBlocked] = None
                for attempt in range(self.max_retries):
                    transient = False
                    blocked = None
                    if reqid is not None:
                        hit = self.sim.reqid_cached(reqid)
                        if hit is not None:
                            # this resend is a REPLAY of a committed
                            # op: dup-suppressed, completion recalled
                            self.replay_dups += 1
                            self._pc.inc("replay_dups")
                            top.mark_event("replay_dup",
                                           attempt=attempt)
                            span.set_tag("replayed", True)
                            return hit[0]
                    if all(self._target_current(pool_id, nm)
                           for nm in check):
                        try:
                            with tr.track(top):
                                result = op()
                            if reqid is not None:
                                self.sim.reqid_commit(reqid, result)
                                if faults.fire("msg.drop_ack",
                                               optype=optype
                                               ) is not None:
                                    # committed, ack lost: the caller
                                    # never hears — resend and let the
                                    # dup detection prove idempotency
                                    self.acks_dropped += 1
                                    self._pc.inc("acks_dropped")
                                    top.mark_event("ack_dropped",
                                                   attempt=attempt)
                                    transient = True
                                else:
                                    span.set_tag("attempts",
                                                 attempt + 1)
                                    return result
                            else:
                                span.set_tag("attempts", attempt + 1)
                                return result
                        except WriteBlocked as wb:
                            # durable at >= k but below the min_size
                            # write floor: keep probing (map progress
                            # / recovery may restore headroom), and
                            # if the budget runs out surface the
                            # BLOCKED state, not a retry failure
                            blocked = wb
                            self._pc.inc("op_blocked_min_size")
                            top.mark_event("blocked_min_size",
                                           attempt=attempt)
                            transient = True
                        except IOError:
                            # transient failure at a CURRENT target
                            # (EIO, injected drop): worth retrying on
                            # its own, map progress or not
                            self._pc.inc("op_eio_retries")
                            top.mark_event("eio_retry", attempt=attempt)
                            transient = True
                    else:
                        self._pc.inc("op_resends")
                        top.mark_event("resend",
                                       epoch=self.osdmap.epoch)
                    got = self.maybe_update_map()
                    if got:
                        # map-wait stall resolved: new epochs arrived
                        top.mark_event("map_update", epochs=got,
                                       epoch=self.osdmap.epoch)
                    if not got and not transient and attempt:
                        # stale target and the mon has nothing newer:
                        # no amount of resending reaches a daemon the
                        # map doesn't know about
                        span.set_tag("error", "no_usable_target")
                        error = "no_usable_target"
                        raise TooManyRetries(
                            f"{name}: no usable target at epoch "
                            f"{self.osdmap.epoch}")
                    if attempt + 1 < self.max_retries:
                        # deterministic exponential backoff with
                        # jitter, on the sim-tick clock (no wall wait)
                        self._pc.tinc("op_backoff_wait_s",
                                      self._backoff.sleep(attempt))
                if blocked is not None:
                    # never acked, still pending: the caller may park
                    # this op and re-drive it after heal (the write is
                    # durably applied at >= k; a re-drive is an
                    # idempotent full rewrite)
                    span.set_tag("error", "blocked_min_size")
                    error = "blocked_min_size"
                    raise blocked
                span.set_tag("error", "retries_exhausted")
                error = "retries_exhausted"
                raise TooManyRetries(f"{name}: gave up after "
                                     f"{self.max_retries} resends")
        except BaseException as e:
            if error is None:
                error = type(e).__name__
            raise
        finally:
            tr.finish(top, error=error)

    def _durable(self, pool_id: int, placed: List[int]) -> List[int]:
        """The client half of the EC write contract
        (src/osd/ECBackend.cc:1150 gather-all-commits, as the wire
        client already enforces): a write that landed fewer than k
        shards is NOT recoverable and must not ack — raising here
        sends it back through the resend loop (stale copies were
        purged, so the full rewrite is idempotent)."""
        from .osdmap import POOL_ERASURE
        pool = self.sim.osdmap.pools[pool_id]
        if pool.type == POOL_ERASURE:
            k = self.sim.codec_for(pool).get_data_chunk_count()
            if len(placed) < k:
                raise IOError(
                    f"EC write degraded below k "
                    f"({len(placed)} < {k} shards committed): "
                    f"un-ackable, resend")
            # the reference's min_size = k+1 write floor: a landing at
            # exactly k is durable but has ZERO parity headroom until
            # the next recovery pass — it must not ack.  (min() keeps
            # a degenerate m=0 profile writable at k.)
            min_size = min(k + 1, pool.size)
            if len(placed) < min_size:
                raise WriteBlocked(
                    f"EC write below min_size write floor "
                    f"({len(placed)} < {min_size} shards committed, "
                    f"k={k}): blocked until the PG heals")
        return placed

    def put(self, pool_id: int, name: str, data: bytes) -> List[int]:
        return self._submit(
            lambda: self._durable(pool_id,
                                  self.sim.put(pool_id, name, data)),
            pool_id, name, optype="put", reqid=self._next_reqid())

    def put_many(self, pool_id: int, names: List[str],
                 datas: List[bytes]) -> Dict[str, List[int]]:
        """Batched put: ONE tracked op, one encode dispatch per
        stripe class (ClusterSim.put_many) — sharded across the mesh
        when the parallel data plane is on, so the op's lifecycle
        record carries the ``dispatched_mesh`` event.  Each member
        object individually honors the EC >= k durability contract;
        any short landing resends the whole (idempotent) batch."""
        if not names:
            return {}

        def op():
            placed = self.sim.put_many(pool_id, names, datas)
            for nm in names:
                self._durable(pool_id, placed.get(nm, []))
            return placed

        return self._submit(op, pool_id, names[0], optype="put_many",
                            names=list(names),
                            reqid=self._next_reqid())

    def get(self, pool_id: int, name: str) -> bytes:
        return self._submit(
            lambda: self.sim.get(pool_id, name), pool_id, name,
            optype="get")

    def write(self, pool_id: int, name: str, offset: int,
              data: bytes) -> List[int]:
        return self._submit(
            lambda: self._durable(pool_id,
                                  self.sim.write(pool_id, name,
                                                 offset, data)),
            pool_id, name, optype="write", reqid=self._next_reqid())
