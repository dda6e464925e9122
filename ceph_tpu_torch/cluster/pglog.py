"""PGLog — the bounded per-PG op log enabling delta recovery.

Role of the reference's PGLog (src/osd/PGLog.{h,cc}; design
doc/dev/osd_internals/log_based_pg.rst): every PG mutation appends a
versioned entry; after a failure, a returning replica's missing set is
computed by comparing its last-applied version against the
authoritative log — objects touched since are recovered INDIVIDUALLY
(log-based delta recovery), and only a replica whose gap has been
trimmed past falls back to backfill (full object scan).

Versions are (epoch, seq) like the reference's eversion_t; the log is
bounded (min_entries/max_entries trim policy, matching
osd_min_pg_log_entries/osd_max_pg_log_entries semantics).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

OP_MODIFY = 1
OP_DELETE = 2

Version = Tuple[int, int]     # (epoch, seq) — eversion_t
ZERO: Version = (0, 0)


@dataclass(frozen=True)
class LogEntry:
    version: Version
    obj: str
    op: int = OP_MODIFY


@dataclass
class MissingSet:
    """Objects a replica lacks (PGLog::missing role): obj -> version
    it needs; `backfill` set when the log no longer covers the gap."""
    need: Dict[str, Version] = field(default_factory=dict)
    deleted: Set[str] = field(default_factory=set)
    backfill: bool = False


class PGLog:
    """Authoritative bounded op log for one PG."""

    def __init__(self, max_entries: int = 3000):
        self.entries: List[LogEntry] = []
        self.max_entries = max_entries
        self.head: Version = ZERO         # newest version
        self.tail: Version = ZERO         # version BEFORE oldest entry
        self._seq = 0

    def append(self, epoch: int, obj: str, op: int = OP_MODIFY
               ) -> LogEntry:
        self._seq += 1
        e = LogEntry((epoch, self._seq), obj, op)
        self.entries.append(e)
        self.head = e.version
        self.trim()
        return e

    def trim(self, keep: Optional[int] = None) -> None:
        """Drop oldest entries beyond the bound (PGLog::trim)."""
        limit = keep if keep is not None else self.max_entries
        while len(self.entries) > limit:
            dropped = self.entries.pop(0)
            self.tail = dropped.version

    def entries_after(self, version: Version) -> List[LogEntry]:
        return [e for e in self.entries if e.version > version]

    def covers(self, version: Version) -> bool:
        """Can a replica at `version` catch up from the log alone?"""
        return version >= self.tail

    def missing_since(self, last_complete: Version) -> MissingSet:
        """The returning replica's missing set (PGLog::merge_log +
        missing calc collapsed): latest op per object since
        last_complete; backfill when the gap is trimmed away."""
        if not self.covers(last_complete):
            return MissingSet(backfill=True)
        need: Dict[str, Version] = {}
        deleted: Set[str] = set()
        for e in self.entries_after(last_complete):
            if e.op == OP_DELETE:
                need.pop(e.obj, None)
                deleted.add(e.obj)
            else:
                need[e.obj] = e.version
                deleted.discard(e.obj)
        return MissingSet(need=need, deleted=deleted)
