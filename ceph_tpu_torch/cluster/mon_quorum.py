"""Multi-mon quorum: leader election + replicated commit over peers.

The reference control plane is a mon quorum: rank-based leader election
(src/mon/Elector.h:37, ElectionLogic.cc — election epochs, one vote per
epoch, persisted), a single-slot proposal pipeline driven by the leader
(src/mon/Paxos.h:57-88 collect/begin/accept/commit), and a store every
mon replicates through the commit path (src/mon/MonitorDBStore.h).

``QuorumNode`` is that machinery, transport-abstract: ``send(rank,
msg) -> reply`` is injected (in-process dict calls in unit tests;
authenticated WireClients in the mon daemon), so the protocol is
testable without processes and deployable over the wire unchanged.

Safety properties (tested in tests/test_mon_quorum.py and the
threaded stress in test_mon_quorum_stress.py):
  * one vote per election epoch, persisted — two leaders cannot both
    win the same epoch;
  * an entry is acknowledged only after a majority stores it, so any
    later winner's vote majority intersects the storing majority and
    the collect phase recovers the entry (no acked commit lost);
  * a deposed leader's begin AND commit carry a stale election epoch
    and are refused (both are epoch-gated);
  * a recovered in-flight tail is RE-ACCEPTED by a majority under the
    new leader's epoch before it commits (Paxos phase 2 on recovery,
    src/mon/Paxos.h:57-88): a minority tail from an old epoch can
    never race a later election into a divergent commit, because the
    re-accept stamps the chosen value with the newest epoch on a
    majority, which every later collect majority intersects;
  * commits apply strictly in version order on every rank, regardless
    of which thread delivers them;
  * a restarted or lagging node catches up from the leader's log
    (fetch), applying entries in order.

Partition tolerance: the leader extends a READ LEASE on a
majority each round (Paxos::extend_lease / lease_expire roles); a rank
whose lease lapsed — a minority-side mon after a netsplit — answers
``readable() == False`` and the daemon stalls map reads instead of
serving a stale map as fresh, while the majority side elects, keeps
committing, and re-grants leases.  The healed minority catches up
through the normal fetch path, so every rank's committed log stays a
prefix of the quorum's (no split-brain double-commit).

Simplifications vs the reference, on purpose: one in-flight slot (no
pipelining, Paxos.h pipelines too but one-at-a-time is its documented
base case), and election preference by rank emerges from staggered
timeouts rather than a deferral subprotocol.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common.lockdep import LockdepLock
from ..common.log import dout

SendFn = Callable[[int, Dict[str, Any]], Dict[str, Any]]
ApplyFn = Callable[[int, bytes], None]


class NotLeader(RuntimeError):
    def __init__(self, leader: Optional[int]):
        super().__init__(f"not the leader (leader={leader})")
        self.leader = leader


class QuorumNode:
    """One mon rank's consensus state machine."""

    def __init__(self, rank: int, n_ranks: int, db, apply_fn: ApplyFn,
                 send_fn: SendFn, lease_duration: float = 2.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.rank = rank
        self.n_ranks = n_ranks
        self.db = db
        self.apply_fn = apply_fn
        self.send_fn = send_fn
        # read lease (Paxos::extend_lease / lease_expire): the leader
        # extends it on a MAJORITY each round; a rank whose lease
        # lapsed must treat its committed state as possibly stale —
        # map reads stall instead of serving a minority-side view.
        # ``now_fn`` is injectable so unit tests drive a fake clock.
        self.lease_duration = float(lease_duration)
        self._now = now_fn
        # lease state: 0.0 = never granted (bootstrap: nothing newer
        # exists to be stale against), -1.0 = EXPIRED.  Whether a
        # lease was ever granted is PERSISTED — a restarted rank that
        # held leases before must come back NOT readable, or crashing
        # a minority-side mon would silently defeat the stale-read
        # stall for the rest of the partition
        self._lease_ever = db.get("quorum", "leased") is not None
        self._lease_until = -1.0 if self._lease_ever else 0.0
        self._lock = LockdepLock("mon.quorum")
        # ordered-apply machinery: commits may be delivered on
        # concurrent wire-handler threads; the log itself grows in
        # order (version gate under _lock) and this queue + single
        # drainer guarantees apply_fn sees the same order, without
        # ever holding a quorum lock across apply_fn (the daemon's
        # apply path takes its own lock and its propose path re-enters
        # here — holding our lock across apply would deadlock)
        self._apply_q: List[Tuple[int, bytes]] = []
        self._applying = False
        # ONE in-flight slot is a safety property, not a convenience:
        # two concurrent propose() calls on the same leader would both
        # target committed+1 at the same epoch with different values,
        # and each could reach a majority on a different acceptor
        # subset — two values committed at one version.  This lock
        # serializes the whole store->begin->commit span (propose and
        # the collect re-accept share it).
        self._propose_lock = LockdepLock("mon.propose",
                                         recursive=False)
        self.leader: Optional[int] = None
        # persisted state
        self.election_epoch = int(db.get("quorum", "election_epoch")
                                  or b"0")
        self.committed = int(db.get("quorum", "committed") or b"0")
        self.applied = 0          # caller advances via replay/apply

    # -------------------------------------------------------- persistence --
    def _put(self, key: str, value: bytes) -> None:
        from .kv import WriteBatch
        self.db.submit(WriteBatch().set("quorum", key, value))

    def _log_key(self, version: int) -> str:
        return f"log:{version:010d}"

    def _get_entry(self, version: int) -> Optional[bytes]:
        return self.db.get("quorum", self._log_key(version))

    def _entry_epoch(self, version: int) -> int:
        b = self.db.get("quorum", f"logep:{version:010d}")
        return int(b or b"0")

    def _store_entry(self, version: int, value: bytes,
                     epoch: int) -> None:
        """Entry + the election epoch that accepted it: the collect
        phase must prefer the HIGHEST-epoch accepted value for a slot
        (classic Paxos — a stale minority tail at the same version
        must not beat a later majority-accepted one)."""
        from .kv import WriteBatch
        self.db.submit(WriteBatch()
                       .set("quorum", self._log_key(version), value)
                       .set("quorum", f"logep:{version:010d}",
                            str(epoch).encode()))

    def quorum(self) -> int:
        return self.n_ranks // 2 + 1

    # ------------------------------------------------------------- lease --
    def readable(self) -> bool:
        """May this rank serve committed state as CURRENT?  True until
        the first lease is granted (bootstrap: there is nothing newer
        to be stale against), then only while the lease holds — across
        restarts (the granted-once fact is persisted).  A minority-
        side rank's lease lapses within ``lease_duration`` of the cut
        and its reads stall until the quorum heals."""
        if self._lease_until == 0.0:
            return True
        return self._now() < self._lease_until

    def lease_remaining(self) -> float:
        return max(0.0, self._lease_until - self._now())

    def _grant_lease(self, until: float) -> None:
        if not self._lease_ever:
            self._lease_ever = True
            self._put("leased", b"1")
        self._lease_until = until

    def extend_lease(self) -> bool:
        """Leader-only: grant the read lease to a majority (the
        Paxos::extend_lease round).  The leader's OWN lease extends
        iff a majority acked — a deposed/minority leader fails here
        and stalls its reads too.  Returns success."""
        with self._lock:
            if self.leader != self.rank:
                return False
            e = self.election_epoch
        until = self._now() + self.lease_duration
        acks = 1
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                rep = self.send_fn(r, {"q": "lease", "epoch": e,
                                       "leader": self.rank,
                                       "duration":
                                           self.lease_duration,
                                       "committed": self.committed})
            except Exception:
                continue
            if rep.get("ok"):
                acks += 1
        if acks < self.quorum():
            return False
        self._grant_lease(until)
        return True

    def _on_lease(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        e = int(msg["epoch"])
        with self._lock:
            if e < self.election_epoch:
                # a stale (deposed, minority-side) leader's lease must
                # not let this rank serve reads on its behalf
                return {"ok": False, "epoch": self.election_epoch}
            if e > self.election_epoch:
                self.election_epoch = e
                self._put("election_epoch", str(e).encode())
            self.leader = int(msg["leader"])
            leader = self.leader
            behind = int(msg.get("committed", 0)) > self.committed
        if behind:
            # a lease that ADOPTS the leader also suppresses this
            # rank's election trigger — so it must carry the catch-up
            # duty victory messages have, or a revived laggard would
            # idle forever behind the quorum (outside the lock, like
            # _on_victory: the fetch takes peer round-trips)
            try:
                self._catch_up_from(leader, int(msg["committed"]))
            except Exception:
                # STILL behind: refuse the lease — accepting it would
                # stamp this rank's stale state as fresh, the exact
                # read the lease machinery exists to stall.  The
                # leader's next round retries the grant (and this
                # rank's fetch).
                return {"ok": False, "epoch": self.election_epoch,
                        "behind": True}
        self._grant_lease(self._now() + float(msg["duration"]))
        return {"ok": True}

    # ---------------------------------------------------------- election --
    def start_election(self) -> bool:
        """Run one election round as candidate.  Returns True when this
        rank won (and synchronized the quorum)."""
        with self._lock:
            e = self.election_epoch + 1
            self.election_epoch = e
            self._put("election_epoch", str(e).encode())
            self.leader = None
        votes = 1                      # self
        voters: List[Tuple[int, int, Optional[Tuple[int, bytes]]]] = [
            (self.rank, self.committed, self._tail())]
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                rep = self.send_fn(r, {"q": "vote", "epoch": e,
                                       "candidate": self.rank})
            except Exception:
                continue
            if rep.get("granted"):
                votes += 1
                tail = rep.get("tail")
                voters.append((r, int(rep["committed"]),
                               (int(tail[0]), bytes(tail[1]),
                                int(tail[2]))
                               if tail else None))
        if votes < self.quorum():
            dout("mon", 10, f"rank {self.rank} lost election epoch "
                            f"{e} ({votes} votes)")
            return False
        # leadership is NOT claimed yet: a client propose racing ahead
        # of the collect below would claim the very slot collect must
        # recover (overwriting a majority-accepted tail with a fresh
        # value at the new epoch — two values committed at one slot).
        # First adopt the longest committed log among the vote
        # majority; a failure (voter died) aborts the election.
        try:
            best_rank, best_committed = self.rank, self.committed
            for rank, committed, tail in voters:
                if committed > best_committed:
                    best_rank, best_committed = rank, committed
            if best_committed > self.committed:
                self._catch_up_from(best_rank, best_committed)
        except Exception:
            return False
        # victory BEFORE the collect re-accept: peers learn the leader
        # and catch up, so the re-accept round below lands on nodes
        # whose next slot is ours
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                self.send_fn(r, {"q": "victory", "epoch": e,
                                 "leader": self.rank,
                                 "committed": self.committed})
            except Exception:
                continue
        if not self._collect(voters, e):
            # the recovered tail could not be re-accepted by a
            # majority under epoch e: the election is NOT complete
            dout("mon", 5, f"rank {self.rank} won votes for epoch {e}"
                           f" but collect re-accept failed; yielding")
            return False
        with self._lock:
            if self.election_epoch != e:
                # a newer election superseded us mid-collect: its
                # winner (not us) owns the quorum now
                return False
            self.leader = self.rank      # open for proposals
        dout("mon", 5, f"rank {self.rank} won election epoch {e} "
                       f"({votes} votes)")
        return True

    def _tail(self) -> Optional[Tuple[int, bytes, int]]:
        """The accepted-but-uncommitted entry + its accept epoch, if
        any (at most one: single in-flight slot)."""
        v = self.committed + 1
        blob = self._get_entry(v)
        return (v, blob, self._entry_epoch(v)) \
            if blob is not None else None

    def _collect(self, voters, e: int) -> bool:
        """Paxos collect, phase 2 included: pick the accepted-but-
        uncommitted tail with the HIGHEST accept epoch among the vote
        majority (it may have been acknowledged to a client; a stale
        minority tail at the same version loses to a later-epoch one),
        then RE-ACCEPT it on a majority under our new epoch ``e``
        before committing.  Committing without the re-accept round is
        the classic Paxos mistake (src/mon/Paxos.h:57-88): a minority
        tail recovered here could race a later election that recovers
        a different, higher-epoch minority tail at the same version —
        two values committed at one slot.  The re-accept stamps the
        chosen value with epoch ``e`` on a majority, which every later
        collect majority intersects, making the choice final.

        Returns False when no majority re-accepts (caller must step
        down: the election is incomplete)."""
        best_tail: Optional[Tuple[int, bytes, int]] = None
        for rank, committed, tail in voters:
            if tail is None or tail[0] != self.committed + 1:
                continue              # stale/irrelevant slot
            if best_tail is None or tail[2] > best_tail[2]:
                best_tail = tail
        if best_tail is None:
            return True               # no in-flight slot to finish
        v, blob = best_tail[0], bytes(best_tail[1])
        with self._propose_lock:
            ok = self._reaccept_and_commit(v, blob, e)
        # apply AFTER releasing _propose_lock (see _commit_no_apply)
        self._drain_applies()
        return ok

    def _reaccept_and_commit(self, v: int, blob: bytes,
                             e: int) -> bool:
        with self._lock:
            # atomic re-check: a concurrent newer leader may have
            # committed this slot (or deposed us) between picking the
            # tail and storing — never overwrite a committed entry
            if v != self.committed + 1:
                return True           # slot already finished
            if self.election_epoch != e:
                return False          # deposed mid-collect
            self._store_entry(v, blob, e)      # self re-accept
        acks = 1
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                rep = self.send_fn(r, {"q": "begin", "epoch": e,
                                       "version": v, "value": blob,
                                       "leader": self.rank})
            except Exception:
                continue
            if rep.get("accepted"):
                acks += 1
        if acks < self.quorum():
            return False
        self._commit_no_apply(v, blob)    # caller holds _propose_lock
        self._replicate_commit(v, blob, e)
        return True

    def _catch_up_from(self, rank: int, target: int) -> None:
        """Fetch + commit the peer's log past ours.  Raises when the
        peer's response did not reach ``target``: callers that go on
        to act on "caught up" (the election path) must abort instead
        of proceeding on a short log."""
        rep = self.send_fn(rank, {"q": "fetch",
                                  "after": self.committed})
        for v, blob in rep["entries"]:
            if v != self.committed + 1:
                continue
            self._commit_entry(v, bytes(blob))
        if self.committed < target:
            raise IOError(f"catch-up from mon.{rank} stopped at "
                          f"{self.committed} < target {target}")

    # ------------------------------------------------------------ commit --
    def _commit_entry(self, version: int, value: bytes) -> None:
        """Persist + mark committed + apply, in that order (replay on
        restart re-applies anything past the service's state).

        The log grows strictly in order (version gate under _lock);
        applies are queued under the same lock and drained by a single
        thread so apply_fn observes that same order even when commits
        arrive on concurrent wire-handler threads.  apply_fn runs with
        NO quorum lock held (see __init__ note)."""
        self._commit_no_apply(version, value)
        self._drain_applies()

    def _commit_no_apply(self, version: int, value: bytes) -> None:
        """Log/commit-marker half of _commit_entry, for callers that
        hold _propose_lock: they must release it BEFORE draining
        applies (apply_fn may take the daemon's lock, and a daemon
        thread holding that lock may be waiting on _propose_lock —
        holding _propose_lock across apply_fn is an AB-BA deadlock)."""
        with self._lock:
            if version != self.committed + 1:
                return
            self._store_entry(version, value, self.election_epoch)
            self.committed = version
            self._put("committed", str(version).encode())
            self._apply_q.append((version, value))

    def _drain_applies(self) -> None:
        """Single-drainer, in-order apply of queued commits, holding
        no quorum lock across apply_fn.  A failed apply stays at the
        queue head so the next drain retries it first — later commits
        can never apply past a version gap in-process (replay() covers
        the restart case)."""
        with self._lock:
            if self._applying:
                return            # the active drainer will take it
            self._applying = True
        while True:
            with self._lock:
                if not self._apply_q:
                    self._applying = False
                    return
                v, blob = self._apply_q[0]
            try:
                self.apply_fn(v, blob)
            except Exception:
                with self._lock:
                    self._applying = False
                raise
            with self._lock:
                self._apply_q.pop(0)

    def _replicate_commit(self, version: int, value: bytes,
                          epoch: int) -> None:
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                self.send_fn(r, {"q": "commit", "epoch": epoch,
                                 "version": version, "value": value,
                                 "leader": self.rank})
            except Exception:
                continue          # laggard catches up later

    def propose(self, value: bytes) -> bool:
        """Leader path: begin/accept on a majority, then commit.  The
        caller may acknowledge its client iff this returns True.
        Serialized end-to-end by _propose_lock (one in-flight slot)."""
        with self._propose_lock:
            with self._lock:
                if self.leader != self.rank:
                    raise NotLeader(self.leader)
                e = self.election_epoch
                v = self.committed + 1
                self._store_entry(v, value, e)    # self-accept
            acks = 1
            for r in range(self.n_ranks):
                if r == self.rank:
                    continue
                try:
                    rep = self.send_fn(r, {"q": "begin", "epoch": e,
                                           "version": v,
                                           "value": value,
                                           "leader": self.rank})
                except Exception:
                    continue
                if rep.get("accepted"):
                    acks += 1
            if acks < self.quorum():
                # no majority (partition / deposed): the stored entry
                # stays uncommitted; a future leader's collect may
                # still finish it, which is safe — we report failure
                # and the caller must not ack its client
                return False
            self._commit_no_apply(v, value)
            self._replicate_commit(v, value, e)
        # apply AFTER releasing _propose_lock (see _commit_no_apply)
        self._drain_applies()
        return True

    # ---------------------------------------------------------- handlers --
    def handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Peer-message dispatch (the mon<->mon wire surface)."""
        q = msg["q"]
        if q == "vote":
            return self._on_vote(msg)
        if q == "victory":
            return self._on_victory(msg)
        if q == "begin":
            return self._on_begin(msg)
        if q == "commit":
            self._on_commit(msg)
            return {"ok": True}
        if q == "lease":
            return self._on_lease(msg)
        if q == "fetch":
            after = int(msg["after"])
            entries = []
            v = after + 1
            while v <= self.committed:
                blob = self._get_entry(v)
                if blob is None:
                    break
                entries.append((v, blob))
                v += 1
            return {"entries": entries, "committed": self.committed}
        if q == "ping":
            return {"leader": self.leader,
                    "epoch": self.election_epoch,
                    "committed": self.committed}
        raise ValueError(f"unknown quorum message {q!r}")

    def _on_vote(self, msg) -> Dict[str, Any]:
        e = int(msg["epoch"])
        with self._lock:
            if e <= self.election_epoch:
                return {"granted": False, "epoch": self.election_epoch}
            # one vote per epoch, persisted BEFORE granting
            self.election_epoch = e
            self._put("election_epoch", str(e).encode())
            self.leader = None
            return {"granted": True, "committed": self.committed,
                    "tail": self._tail()}

    def _on_victory(self, msg) -> Dict[str, Any]:
        e = int(msg["epoch"])
        with self._lock:
            if e < self.election_epoch:
                return {"ok": False}
            self.election_epoch = e
            self._put("election_epoch", str(e).encode())
            self.leader = int(msg["leader"])
            behind = int(msg["committed"]) > self.committed
            leader = self.leader
        if behind:
            try:
                self._catch_up_from(leader, int(msg["committed"]))
            except Exception:
                pass
        return {"ok": True}

    def _on_begin(self, msg) -> Dict[str, Any]:
        e, v = int(msg["epoch"]), int(msg["version"])
        with self._lock:
            if e < self.election_epoch:
                # deposed leader: stale epoch refused
                return {"accepted": False,
                        "epoch": self.election_epoch}
            if e > self.election_epoch:
                # a leader we missed the victory of: adopt it
                self.election_epoch = e
                self._put("election_epoch", str(e).encode())
            # a begin at epoch e can only come from e's single vote
            # winner (one persisted vote per epoch), so it is safe to
            # accept even before the victory message arrives — the
            # collect re-accept round depends on this
            if "leader" in msg:
                self.leader = int(msg["leader"])
            if v != self.committed + 1:
                return {"accepted": False,
                        "committed": self.committed}
            self._store_entry(v, bytes(msg["value"]), e)
            return {"accepted": True}

    def _on_commit(self, msg) -> None:
        e, v = int(msg.get("epoch", 0)), int(msg["version"])
        with self._lock:
            if e < self.election_epoch:
                # a deposed leader's commit is REFUSED: after a new
                # election this rank may have re-accepted a different
                # value at the same version; only current-epoch
                # commits (from the epoch's single winner) apply
                return
            if e > self.election_epoch:
                self.election_epoch = e
                self._put("election_epoch", str(e).encode())
            if "leader" in msg:
                self.leader = int(msg["leader"])
        if v == self.committed + 1:
            self._commit_entry(v, bytes(msg["value"]))
        elif v > self.committed:
            # gap: pull the backlog from the leader
            leader = int(msg.get("leader", -1))
            src = leader if leader >= 0 else \
                (self.leader if self.leader is not None else -1)
            if src >= 0 and src != self.rank:
                try:
                    self._catch_up_from(src, v)
                except Exception:
                    pass

    # ------------------------------------------------------------ replay --
    def replay(self, applied_hint: int = 0) -> int:
        """On restart: re-apply committed entries beyond what the
        service already holds (the MonitorDBStore recovery walk)."""
        applied = applied_hint
        v = applied + 1
        while v <= self.committed:
            blob = self._get_entry(v)
            if blob is None:
                break
            self.apply_fn(v, blob)
            applied = v
            v += 1
        return applied


# ----------------------------------------------------------- encoding ---

def encode_decree(kind: str, **fields) -> bytes:
    """Typed JSON decree (no pickle on the quorum wire)."""
    return json.dumps({"kind": kind, **fields}).encode()


def decode_decree(blob: bytes) -> Dict[str, Any]:
    return json.loads(bytes(blob).decode())
