"""Leveled subsystem debug logging — the dout/ldout + src/log/ role.

The reference gates debug output per subsystem with two levels
(log level = written to the log, gather level = kept in the in-memory
ring for crash dumps; src/log/SubsystemMap.h, src/common/dout.h) and
drains entries through an async Log thread with a bounded buffer
(src/log/Log.cc).  Same shape:

    log = get_logger()
    log.set_level("osd", 10)
    log.dout("osd", 5, "pg 1.2 peering")       # emitted (5 <= 10)
    log.dout("crush", 20, "...")               # gated (default 5)

Entries above the log level but within the gather level land ONLY in
the recent-entries ring, which `dump_recent()` returns — the
"dump_recent on crash" behavior.  A writer callable (default: stderr
when CEPH_TPU_LOG=stderr, else buffered) receives formatted lines.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

DEFAULT_LOG_LEVEL = 5
DEFAULT_GATHER_LEVEL = 20
RING_SIZE = 10_000


class Log:
    def __init__(self, writer: Optional[Callable[[str], None]] = None):
        self._lock = threading.Lock()
        self._levels: Dict[str, Tuple[int, int]] = {}
        self._ring: Deque[str] = collections.deque(maxlen=RING_SIZE)
        self.emitted = 0
        self.gathered = 0
        if writer is None and os.environ.get("CEPH_TPU_LOG") == "stderr":
            import sys
            writer = lambda line: print(line, file=sys.stderr)  # noqa: E731
        self._writer = writer

    # ------------------------------------------------------------ levels --
    def set_level(self, subsys: str, log_level: int,
                  gather_level: Optional[int] = None) -> None:
        if gather_level is None:
            gather_level = max(log_level, DEFAULT_GATHER_LEVEL)
        self._levels[subsys] = (log_level, gather_level)

    def levels(self, subsys: str) -> Tuple[int, int]:
        return self._levels.get(subsys,
                                (DEFAULT_LOG_LEVEL, DEFAULT_GATHER_LEVEL))

    def should_gather(self, subsys: str, level: int) -> bool:
        """The dout_impl gate: cheap check before formatting."""
        return level <= self.levels(subsys)[1]

    # -------------------------------------------------------------- dout --
    def dout(self, subsys: str, level: int, msg: str) -> None:
        log_lvl, gather_lvl = self.levels(subsys)
        if level > gather_lvl:
            return
        line = (f"{time.strftime('%Y-%m-%d %H:%M:%S')} "
                f"{level:2d} {subsys}: {msg}")
        with self._lock:
            self._ring.append(line)
            self.gathered += 1
            if level <= log_lvl:
                self.emitted += 1
                if self._writer is not None:
                    self._writer(line)

    # -------------------------------------------------------------- dump --
    def dump_recent(self, n: Optional[int] = None) -> List[str]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]


_logger: Optional[Log] = None
_logger_lock = threading.Lock()


def get_logger() -> Log:
    global _logger
    with _logger_lock:
        if _logger is None:
            _logger = Log()
        return _logger


def dout(subsys: str, level: int, msg: str) -> None:
    get_logger().dout(subsys, level, msg)
