"""PG peering state machine.

Role of the reference's PeeringState (src/osd/PeeringState.h:561 — a
boost::statechart driving every PG through
Reset → Started/Primary/Peering{GetInfo, GetLog, GetMissing} →
Activating → Recovering/Backfilling → Clean after EVERY map change,
re-establishing consensus on the PG's authoritative history before
serving I/O).

Compact event-driven re-creation over the simulator's state: the
machine consumes AdvMap (a new epoch touched this PG), queries member
OSDs' last_complete (the GetInfo/GetLog exchange against pg_logs),
computes missing members (GetMissing), activates, recovers via the
log-based delta path, and settles Clean.  Transitions are explicit and
recorded so tests can assert the exact path taken.

Port of ``ceph_tpu/cluster/peering.py``: host code; the log-delta
recovery it triggers runs on the sim's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..placement.crush_map import ITEM_NONE
from .pglog import ZERO

# states (subset of PeeringState.h:653ff)
RESET = "Reset"
GET_INFO = "Peering/GetInfo"
GET_LOG = "Peering/GetLog"
GET_MISSING = "Peering/GetMissing"
ACTIVATING = "Activating"
RECOVERING = "Recovering"
BACKFILLING = "Backfilling"
CLEAN = "Clean"
INCOMPLETE = "Incomplete"


@dataclass
class PeeringResult:
    state: str
    history: List[str]
    up: List[int]
    missing_osds: List[int]
    recovered: Dict[str, int] = field(default_factory=dict)


class PGStateMachine:
    """One PG's peering driver."""

    def __init__(self, sim, pool_id: int, pg: int):
        self.sim = sim
        self.pool_id = pool_id
        self.pg = pg
        self.state = RESET
        self.history: List[str] = [RESET]
        self.epoch = sim.osdmap.epoch
        self.up: List[int] = []
        self.missing_osds: List[int] = []

    def _to(self, state: str) -> None:
        self.state = state
        self.history.append(state)

    # -------------------------------------------------------------- events --
    def on_adv_map(self) -> None:
        """AdvMap: the map moved — restart interval (PeeringState.h:441)."""
        self.epoch = self.sim.osdmap.epoch
        self.state = RESET
        self.history.append(RESET)

    def peer(self) -> PeeringResult:
        """Run the full peering sequence to quiescence."""
        sim = self.sim
        pool = sim.osdmap.pools[self.pool_id]
        log = sim.pg_logs.get((self.pool_id, self.pg))

        # GetInfo: who is in the interval, what do they have
        self._to(GET_INFO)
        self.up = sim.pg_up(pool, self.pg)
        live = [o for o in self.up
                if o != ITEM_NONE and sim.osds[o].alive]
        if not live:
            self._to(INCOMPLETE)
            return self._result()

        # GetLog: the authoritative log (sim.pg_logs is the primary's)
        self._to(GET_LOG)
        head = log.head if log else ZERO

        # GetMissing: members whose last_complete lags the log head
        self._to(GET_MISSING)
        self.missing_osds = [
            o for o in live
            if sim.osds[o].last_complete.get((self.pool_id, self.pg),
                                             ZERO) < head]
        holes = [o for o in self.up if o == ITEM_NONE or
                 not sim.osds[o].alive]

        self._to(ACTIVATING)
        recovered: Dict[str, int] = {}
        if self.missing_osds or holes:
            needs_backfill = any(
                log is not None and not log.covers(
                    sim.osds[o].last_complete.get(
                        (self.pool_id, self.pg), ZERO))
                for o in self.missing_osds)
            self._to(BACKFILLING if needs_backfill else RECOVERING)
            recovered = sim.recover_delta(self.pool_id)
        self._to(CLEAN)
        return self._result(recovered)

    def _result(self, recovered: Optional[Dict[str, int]] = None
                ) -> PeeringResult:
        return PeeringResult(
            state=self.state, history=list(self.history),
            up=list(self.up), missing_osds=list(self.missing_osds),
            recovered=recovered or {})


class PeeringCoordinator:
    """All PGs of a pool: re-peer everything after a map change (the
    role OSD::consume_map plays fanning AdvMap to its PGs)."""

    def __init__(self, sim, pool_id: int):
        self.sim = sim
        self.pool_id = pool_id
        pool = sim.osdmap.pools[pool_id]
        self.machines = {pg: PGStateMachine(sim, pool_id, pg)
                         for pg in range(pool.pg_num)}

    def handle_map_change(self) -> Dict[int, PeeringResult]:
        out: Dict[int, PeeringResult] = {}
        for pg, m in self.machines.items():
            m.on_adv_map()
            out[pg] = m.peer()
        return out

    def states(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for m in self.machines.values():
            counts[m.state] = counts.get(m.state, 0) + 1
        return counts
