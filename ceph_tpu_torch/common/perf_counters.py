"""Perf counters — the L0 metrics substrate.

Role of the reference's `PerfCounters` (src/common/perf_counters.h:
typed u64 counters / gauges / long-run latency averages, grouped per
subsystem, dumped as JSON over the admin socket via `perf dump`) and of
the OSD's counter set (src/osd/osd_perf_counters.cc).

TPU-native counter set: what matters on this runtime is device
dispatches (compiles vs cached executions), bytes moved host<->device,
batch occupancies, and table-cache hit rates — those are the knobs that
decide whether the MXU stays fed.  Counters are cheap (dict + lock) and
always safe to leave enabled; `perf_counters_enabled=false` turns the
`inc` calls into no-ops for hot host loops.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .options import OptionError, config

COUNTER = "counter"      # monotonically increasing u64
GAUGE = "gauge"          # instantaneous value
TIME_AVG = "time_avg"    # (sum_seconds, count) -> avg latency
HISTOGRAM = "histogram"  # log2-bucketed latency distribution

# hot-path switch: counter updates happen per device dispatch, so the
# enabled flag is cached module-level and kept fresh by a config
# observer instead of re-resolving the layered registry per inc()
_enabled: Optional[bool] = None


def _counters_enabled() -> bool:
    global _enabled
    if _enabled is None:
        cfg = config()
        try:
            _enabled = bool(cfg.get("perf_counters_enabled"))
        except OptionError:
            _enabled = True

        def _refresh(_name, value):
            global _enabled
            _enabled = bool(value)

        cfg.observe("perf_counters_enabled", _refresh)
    return _enabled


class PerfHistogram:
    """Log2-bucketed latency histogram (src/common/perf_histogram.h
    role).  Bucket i holds values in (base*2^(i-1), base*2^i]; one
    overflow bucket catches everything past the last bound.  Averages
    hide queueing/encode tails — this is the per-stage distribution the
    OpTracker records into, and it renders directly as a Prometheus
    histogram family (cumulative `_bucket` + `_sum`/`_count`)."""

    __slots__ = ("base", "n_buckets", "counts", "sum", "count")

    def __init__(self, base: float = 1e-6, n_buckets: int = 28):
        if base <= 0 or n_buckets < 1:
            raise ValueError("histogram needs base > 0, n_buckets >= 1")
        self.base = float(base)          # le bound of bucket 0
        self.n_buckets = int(n_buckets)
        self.counts = [0] * (self.n_buckets + 1)   # +1 = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def bucket_index(self, v: float) -> int:
        if v <= self.base:
            return 0
        idx = int(math.ceil(math.log2(v / self.base)))
        # float-error guard at exact power-of-two bounds: the smallest
        # bucket whose le bound still covers v wins
        if idx > 0 and v <= self.base * (2.0 ** (idx - 1)):
            idx -= 1
        return min(idx, self.n_buckets)

    def record(self, v: float) -> None:
        self.counts[self.bucket_index(v)] += 1
        self.sum += v
        self.count += 1

    def bounds(self) -> List[float]:
        """le upper bound per finite bucket (overflow bucket is +Inf)."""
        return [self.base * (2.0 ** i) for i in range(self.n_buckets)]

    def dump(self) -> Dict[str, Any]:
        """Non-cumulative counts + bounds; consumers (Prometheus)
        cumulate.  Only populated buckets are listed, keyed by le."""
        buckets = []
        bounds = self.bounds()
        for i, c in enumerate(self.counts[:-1]):
            if c:
                buckets.append([bounds[i], c])
        if self.counts[-1]:
            buckets.append(["+Inf", self.counts[-1]])
        return {"count": self.count, "sum": round(self.sum, 9),
                "buckets": buckets}

    def reset(self) -> None:
        self.counts = [0] * (self.n_buckets + 1)
        self.sum = 0.0
        self.count = 0


class PerfCounters:
    """One named group of counters (a daemon-subsystem analog)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._types: Dict[str, str] = {}
        self._vals: Dict[str, Any] = {}

    def add_counter(self, key: str, desc: str = "") -> None:
        self._declare(key, COUNTER, 0)

    def add_gauge(self, key: str, desc: str = "") -> None:
        self._declare(key, GAUGE, 0)

    def add_time_avg(self, key: str, desc: str = "") -> None:
        self._declare(key, TIME_AVG, (0.0, 0))

    def add_histogram(self, key: str, desc: str = "",
                      base: float = 1e-6, n_buckets: int = 28) -> None:
        self._declare(key, HISTOGRAM, PerfHistogram(base, n_buckets))

    def _declare(self, key: str, typ: str, init: Any) -> None:
        with self._lock:
            if key not in self._types:
                self._types[key] = typ
                self._vals[key] = init

    # ------------------------------------------------------------ update --
    def inc(self, key: str, by: int = 1) -> None:
        if not _counters_enabled():
            return
        with self._lock:
            declared = self._types.get(key)
            if declared is None:
                self._types[key] = COUNTER
                self._vals[key] = 0
            elif declared not in (COUNTER, GAUGE):
                # inc on a gauge is legitimate (up/down adjustments);
                # on a TIME_AVG/HISTOGRAM it is a typo — same friendly
                # raise as set/tinc/hinc instead of a tuple TypeError
                raise ValueError(
                    f"{self.name}.{key}: inc() on a {declared} "
                    f"(declared types are immutable)")
            self._vals[key] += by

    def set(self, key: str, value: Any) -> None:
        if not _counters_enabled():
            return
        with self._lock:
            declared = self._types.get(key)
            if declared is not None and declared != GAUGE:
                # a typo'd set() used to silently retype a COUNTER /
                # TIME_AVG / HISTOGRAM to GAUGE, changing the dump shape
                # under the exporter mid-scrape
                raise ValueError(
                    f"{self.name}.{key}: set() on a {declared} "
                    f"(declared types are immutable; use "
                    f"inc/tinc/hinc)")
            self._types[key] = GAUGE
            self._vals[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        if not _counters_enabled():
            return
        with self._lock:
            declared = self._types.get(key)
            if declared is None:
                self._types[key] = TIME_AVG
                self._vals[key] = (0.0, 0)
            elif declared != TIME_AVG:
                raise ValueError(
                    f"{self.name}.{key}: tinc() on a {declared} "
                    f"(declared types are immutable)")
            s, n = self._vals[key]
            self._vals[key] = (s + seconds, n + 1)

    def hinc(self, key: str, value: float) -> None:
        """Record one observation into a log2 histogram (auto-declared
        with default bucketing on first use, like inc/tinc)."""
        if not _counters_enabled():
            return
        with self._lock:
            declared = self._types.get(key)
            if declared is None:
                self._types[key] = HISTOGRAM
                self._vals[key] = PerfHistogram()
            elif declared != HISTOGRAM:
                raise ValueError(
                    f"{self.name}.{key}: hinc() on a {declared} "
                    f"(declared types are immutable)")
            self._vals[key].record(value)

    def time(self, key: str):
        """Context manager: `with counters.time("map_batch_s"): ...`."""
        return _Timer(self, key)

    # -------------------------------------------------------------- read --
    def get(self, key: str) -> Any:
        with self._lock:
            return self._vals.get(key)

    def type_of(self, key: str) -> Optional[str]:
        with self._lock:
            return self._types.get(key)

    def histogram(self, key: str) -> Optional[PerfHistogram]:
        """The live histogram object (exporters need bounds + counts)."""
        with self._lock:
            v = self._vals.get(key)
            return v if isinstance(v, PerfHistogram) else None

    def _dump_one(self, key: str, typ: str) -> Any:
        v = self._vals[key]
        if typ == TIME_AVG:
            s, n = v
            return {"avgcount": n, "sum": round(s, 9),
                    "avgtime": round(s / n, 9) if n else 0.0}
        if typ == HISTOGRAM:
            return v.dump()
        return v

    def dump(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            for key, typ in sorted(self._types.items()):
                out[key] = self._dump_one(key, typ)
        return out

    def dump_typed(self) -> Dict[str, Tuple[str, Any]]:
        """{key: (type, dumped value)} — exporters render by type."""
        out: Dict[str, Tuple[str, Any]] = {}
        with self._lock:
            for key, typ in sorted(self._types.items()):
                out[key] = (typ, self._dump_one(key, typ))
        return out

    def reset(self) -> None:
        with self._lock:
            for key, typ in self._types.items():
                if typ == TIME_AVG:
                    self._vals[key] = (0.0, 0)
                elif typ == HISTOGRAM:
                    self._vals[key].reset()
                else:
                    self._vals[key] = 0


class _Timer:
    def __init__(self, pc: PerfCounters, key: str):
        self.pc, self.key = pc, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.pc.tinc(self.key, time.perf_counter() - self.t0)
        return False


class PerfCountersCollection:
    """All groups in the process; `perf dump` analog
    (src/common/perf_counters_collection.h)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, PerfCounters] = {}

    def get(self, name: str) -> PerfCounters:
        with self._lock:
            pc = self._groups.get(name)
            if pc is None:
                pc = self._groups[name] = PerfCounters(name)
            return pc

    def dump(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            groups = list(self._groups.items())
        return {name: pc.dump() for name, pc in sorted(groups)}

    def dump_typed(self) -> Dict[str, Dict[str, Tuple[str, Any]]]:
        with self._lock:
            groups = list(self._groups.items())
        return {name: pc.dump_typed() for name, pc in sorted(groups)}

    def reset(self) -> None:
        with self._lock:
            groups = list(self._groups.values())
        for pc in groups:
            pc.reset()


_collection: Optional[PerfCountersCollection] = None
_collection_lock = threading.Lock()


def perf(name: str = None) -> Any:
    """perf() -> the collection; perf("group") -> that group."""
    global _collection
    with _collection_lock:
        if _collection is None:
            _collection = PerfCountersCollection()
    return _collection if name is None else _collection.get(name)
