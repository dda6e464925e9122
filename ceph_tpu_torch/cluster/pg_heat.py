"""PGHeatTracker — per-PG client-io heat with exponential decay.

Role of the reference's pool HitSet machinery (src/osd/HitSet.h, the
pg_pool_t hit_set_* knobs: per-PG access populations the tiering agent
and read balancer consume), collapsed to the piece the ClusterScope
observability loop needs: each executing OSD counts client rd/wr
ops+bytes PER PG, decayed exponentially so the numbers mean "recent
load", and ships the table on its existing heartbeat report.  The mon
merges the per-OSD tables into `ceph pg heat` and the balancer
advisor's per-OSD load model.

Two ledgers per (pool, pg):

  * DECAYED heat — halved every ``half_life`` clock units (lazy decay
    at touch/snapshot time, no background thread), the "what is hot
    NOW" signal;
  * RAW monotonic totals — never decayed, so the per-OSD rollup can
    be asserted equal to the ``osd.io`` counters counted at the very
    same call sites (the agrees-with-osd.io acceptance check), and so
    the sim tier can synthesize per-OSD ``osd.io`` counters for the
    history/rate pipeline from one source of truth.

Clock: injectable.  The daemon tier passes wall time; the sim tier
drives the tracker off the heartbeat TICK clock (``advance()``), so
heat decay is seed-deterministic — two runs with the same seed and
tick schedule produce bit-identical heat tables (the property test's
contract).  With no clock and no advance() calls time stands still
and decay is a no-op.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common.lockdep import LockdepLock

PGId = Tuple[int, int]

_TRACKER_IDS = itertools.count(1)

_FIELDS = ("rd_ops", "wr_ops", "rd_bytes", "wr_bytes")


class PGHeatTracker:
    """Per-(pool, pg) decayed heat + raw totals, thread-safe (OSD
    dispatcher threads record while heartbeat threads snapshot)."""

    def __init__(self, half_life: float = 60.0,
                 clock: Optional[Callable[[], float]] = None):
        self.half_life = float(half_life)
        self._clock = clock
        self._now = 0.0              # manual clock (advance())
        # leaf lock (no other lock is taken while held); per-instance
        # name — non-recursive locks need one (see LockdepLock)
        self._lock = LockdepLock(
            f"pg_heat.{next(_TRACKER_IDS)}", recursive=False)
        # pg -> [decayed x4, raw x4, last_touch]
        self._pgs: Dict[PGId, List[float]] = {}

    # ------------------------------------------------------------- clock --
    def now(self) -> float:
        return self._clock() if self._clock is not None else self._now

    def advance(self, t: float) -> None:
        """Drive the manual clock (sim heartbeat ticks); never moves
        backwards."""
        with self._lock:
            if t > self._now:
                self._now = t

    def _decay_locked(self, row: List[float], now: float) -> None:
        dt = now - row[8]
        if dt <= 0:
            return
        f = 0.5 ** (dt / self.half_life)
        for i in range(4):
            row[i] *= f
        row[8] = now

    # ------------------------------------------------------------ record --
    def record(self, pool: int, pg: int, rw: str, ops: int = 1,
               nbytes: int = 0) -> None:
        """Count one client op against its PG; ``rw`` is "rd"/"wr"."""
        now = self.now()
        oi, bi = (0, 2) if rw == "rd" else (1, 3)
        with self._lock:
            row = self._pgs.get((pool, pg))
            if row is None:
                row = self._pgs[(pool, pg)] = [0.0] * 8 + [now]
            else:
                self._decay_locked(row, now)
            row[oi] += ops
            row[bi] += nbytes
            row[4 + oi] += ops
            row[4 + bi] += nbytes

    # -------------------------------------------------------------- dump --
    def dump(self) -> Dict[str, Any]:
        """Wire/heartbeat payload: {"t": clock, "pgs": {"pool.pg":
        {decayed fields..., "tot_*" raw fields...}}}.  String pg ids —
        the dict crosses typed wire encoding."""
        now = self.now()
        with self._lock:
            pgs = {}
            for (pool, pg), row in self._pgs.items():
                self._decay_locked(row, now)
                ent = {f: round(row[i], 6)
                       for i, f in enumerate(_FIELDS)}
                ent.update({f"tot_{f}": row[4 + i]
                            for i, f in enumerate(_FIELDS)})
                pgs[f"{pool}.{pg}"] = ent
            return {"t": now, "half_life": self.half_life, "pgs": pgs}

    def totals(self) -> Dict[str, float]:
        """Raw (undecayed) rollup across every PG — by construction
        equal to what the ``osd.io`` counters counted at the same
        sites."""
        with self._lock:
            out = {f: 0.0 for f in _FIELDS}
            for row in self._pgs.values():
                for i, f in enumerate(_FIELDS):
                    out[f] += row[4 + i]
            return out

    def reset(self) -> None:
        """A daemon restart loses this table (in-memory state)."""
        with self._lock:
            self._pgs.clear()


def merge_heat(dumps: Dict[str, Dict[str, Any]],
               pool: Optional[int] = None,
               top: Optional[int] = None) -> List[Dict[str, Any]]:
    """Mon-side merge of per-OSD heat dumps into `ceph pg heat` rows.

    ``dumps`` maps reporter ("osd.N") -> PGHeatTracker.dump().  Rows
    sum the decayed fields per PG across every reporting OSD (each
    OSD counts the client ops IT served, so the sum is the PG's
    cluster-wide client load), sorted hottest first.  ``heat`` is the
    ops-oriented scalar the advisor ranks on: decayed rd+wr ops plus
    a byte term scaled so 4 MiB ~ one op.
    """
    merged: Dict[str, Dict[str, Any]] = {}
    for reporter, d in sorted(dumps.items()):
        for pgid, ent in (d.get("pgs") or {}).items():
            try:
                pid = int(pgid.split(".", 1)[0])
            except (ValueError, AttributeError):
                continue
            if pool is not None and pid != pool:
                continue
            row = merged.setdefault(pgid, {
                "pgid": pgid, "pool": pid, "osds": [],
                **{f: 0.0 for f in _FIELDS},
                **{f"tot_{f}": 0.0 for f in _FIELDS}})
            for f in _FIELDS:
                row[f] += float(ent.get(f, 0.0))
                row[f"tot_{f}"] += float(ent.get(f"tot_{f}", 0.0))
            row["osds"].append(reporter)
    rows = []
    for row in merged.values():
        row["heat"] = round(
            row["rd_ops"] + row["wr_ops"] +
            (row["rd_bytes"] + row["wr_bytes"]) / (4 << 20), 6)
        for f in _FIELDS:
            row[f] = round(row[f], 6)
        rows.append(row)
    rows.sort(key=lambda r: (-r["heat"], r["pgid"]))
    return rows[:top] if top else rows


def osd_heat_rollup(dumps: Dict[str, Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    """Per-OSD rollup (raw totals + decayed heat) from the same
    dumps — the series the agrees-with-osd.io assertion compares."""
    out: Dict[str, Dict[str, float]] = {}
    for reporter, d in sorted(dumps.items()):
        tot = {f: 0.0 for f in _FIELDS}
        hot = {f: 0.0 for f in _FIELDS}
        for ent in (d.get("pgs") or {}).values():
            for f in _FIELDS:
                tot[f] += float(ent.get(f"tot_{f}", 0.0))
                hot[f] += float(ent.get(f, 0.0))
        out[reporter] = {
            **{f"tot_{f}": round(v, 6) for f, v in tot.items()},
            "heat": round(hot["rd_ops"] + hot["wr_ops"] +
                          (hot["rd_bytes"] + hot["wr_bytes"])
                          / (4 << 20), 6)}
    return out
