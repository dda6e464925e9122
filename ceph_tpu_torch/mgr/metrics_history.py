"""MetricsHistory — the leader mon's time-series memory.

Role of the reference's mgr ``MetricCollector`` (src/mgr/MetricCollector.h:
bounded per-entity metric ring the mgr modules query) combined with the
``PGMap`` delta history (src/mon/PGMap.cc: per-interval stat deltas the
`ceph -s` io line and `ceph osd df` trends read).  Every ``report_perf``
delivery already reaches the leader mon's ClusterStats; this module
retains a bounded ring of those deliveries per reporter so the cluster
finally has *memory* — a `ceph -s` stops being a point-in-time snapshot.

Design:

  * per reporter, a multi-resolution ring: level 0 holds the newest
    ``metrics_history_samples`` raw deliveries; when it overflows, the
    two OLDEST raw samples merge into one level-1 sample, and so on up
    to ``metrics_history_levels`` — log2 downsampling, so retained wall
    coverage grows exponentially while memory stays bounded at
    levels x samples entries per reporter;
  * a merge keeps the NEWER sample of the pair (counters are monotonic
    cumulative values, so deltas TELESCOPE: dropping an interior sample
    fuses two adjacent intervals into one whose delta is exactly their
    sum — downsampling conserves counter sums, the property the tests
    pin);
  * rates derive from consecutive-sample deltas with RESET CLAMPING: a
    daemon restart zeroes its monotonic counters, and a negative delta
    must read as "reset, rate unknown -> 0", never as a huge negative
    or garbage-positive rate.  Resets are counted per reporter and
    surfaced (``stats.counter_resets``);
  * reporters age out after ``stale_s`` (the ClusterStats STALE_S
    window): a daemon that stopped reporting drops from history
    queries rather than pinning week-old series into the CLI.

Only COUNTER-typed keys of the ``HISTORY_GROUPS`` perf groups are
retained — rate derivation is only meaningful over monotonic counters,
which is exactly what lint CTL702 closes statically: every counter
listed in ``RATE_COUNTERS`` must be inc-typed at its declaration site
(a ``set()`` anywhere in the tree on one of these keys is a lint
error, because a gauge fed into the delta pipeline produces garbage
rates silently).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..common.perf_counters import COUNTER

# perf groups whose COUNTER-typed keys the history ring retains (the
# rate layer's input universe)
HISTORY_GROUPS = ("osd.io", "jit")

# (group, key) pairs the rate/query layer surfaces as headline series
# (CLI defaults, Prometheus short/long-window gauges).  Lint CTL702
# statically verifies each is ONLY ever updated via .inc() — a
# rate-queried counter must be monotonic at its declaration site.
RATE_COUNTERS = (
    ("osd.io", "rd_ops"),
    ("osd.io", "wr_ops"),
    ("osd.io", "rd_bytes"),
    ("osd.io", "wr_bytes"),
    ("jit", "compiles"),
)

DEFAULT_SAMPLES = 64
DEFAULT_LEVELS = 6


def _configured(name: str, default: int) -> int:
    try:
        from ..common.options import config
        return int(config().get(name))
    except Exception:
        return default


class _Ring:
    """One reporter's multi-resolution sample ring.

    ``levels[0]`` is the raw ring (newest deliveries, full
    resolution); ``levels[i]`` holds samples whose implied interval
    fuses 2^i raw deliveries.  Each level is a list of (ts, counters)
    tuples, oldest first, bounded at ``samples`` entries.
    """

    __slots__ = ("levels", "samples", "resets")

    def __init__(self, samples: int, n_levels: int):
        self.samples = max(2, int(samples))
        self.levels: List[List[Tuple[float, Dict[str, float]]]] = \
            [[] for _ in range(max(1, int(n_levels)))]
        self.resets = 0

    def push(self, ts: float, flat: Dict[str, float]) -> None:
        self.levels[0].append((ts, flat))
        # cascade: an overflowing level folds its two oldest samples
        # into the next level by KEEPING THE NEWER one (cumulative
        # counters: the survivor's value already includes the dropped
        # sample's, so the fused interval's delta is the exact sum of
        # the two raw deltas — sums conserve through downsampling)
        for lvl in range(len(self.levels)):
            ring = self.levels[lvl]
            while len(ring) > self.samples:
                if lvl + 1 < len(self.levels):
                    ring.pop(0)      # fused into the survivor's window
                    self.levels[lvl + 1].append(ring.pop(0))
                else:
                    ring.pop(0)      # deepest level: plain oldest-drop

    def series(self) -> List[Tuple[float, Dict[str, float]]]:
        """All retained samples, oldest first (coarse levels precede
        the raw ring — a level-i sample always predates every
        level-(i-1) sample by construction of the cascade)."""
        out: List[Tuple[float, Dict[str, float]]] = []
        for ring in reversed(self.levels):
            out.extend(ring)
        return out

    def newest_ts(self) -> float:
        return self.levels[0][-1][0] if self.levels[0] else 0.0

    def sample_count(self) -> int:
        return sum(len(r) for r in self.levels)


class MetricsHistory:
    """Bounded per-reporter delivery rings + range-query/rate layer.

    Owned by the leader mon's ClusterStats; ``record()`` is called
    from ``ClusterStats.ingest`` under the aggregator's report flow,
    ``query()`` serves the ``cluster_stats {"history": ...}`` wire
    sub-command (`ceph telemetry history`), and the window-rate
    helpers feed the Prometheus short/long gauges and the `ceph osd
    df` sparkline column."""

    def __init__(self, samples: Optional[int] = None,
                 levels: Optional[int] = None,
                 stale_s: float = 600.0):
        self._lock = threading.Lock()
        self.samples = samples if samples is not None else \
            _configured("metrics_history_samples", DEFAULT_SAMPLES)
        self.levels = levels if levels is not None else \
            _configured("metrics_history_levels", DEFAULT_LEVELS)
        self.stale_s = float(stale_s)
        self._rings: Dict[str, _Ring] = {}
        self.counter_resets = 0          # cumulative, all reporters

    # ------------------------------------------------------------ ingest --
    @staticmethod
    def flatten(perf: Dict[str, Any]) -> Dict[str, float]:
        """COUNTER-typed keys of the HISTORY_GROUPS as
        ``group.key`` -> value (the retained sample payload)."""
        out: Dict[str, float] = {}
        for group in HISTORY_GROUPS:
            for key, tv in (perf.get(group) or {}).items():
                if tv[0] == COUNTER and isinstance(tv[1], (int, float)):
                    out[f"{group}.{key}"] = float(tv[1])
        return out

    def record(self, reporter: str, ts: float,
               perf: Dict[str, Any]) -> int:
        """Retain one delivery; returns the number of counter RESETS
        detected against the reporter's previous sample (any retained
        counter that went backwards — a daemon restart zeroed it)."""
        flat = self.flatten(perf)
        if not flat:
            return 0
        with self._lock:
            ring = self._rings.get(reporter)
            if ring is None:
                ring = self._rings[reporter] = _Ring(self.samples,
                                                     self.levels)
            resets = 0
            if ring.levels[0]:
                _pts, pflat = ring.levels[0][-1]
                resets = sum(1 for k, v in flat.items()
                             if k in pflat and v < pflat[k])
            if resets:
                ring.resets += 1
                self.counter_resets += 1
            ring.push(ts, flat)
            return resets

    def prune(self, now: float) -> None:
        """Drop reporters whose newest delivery aged past stale_s
        (the 600 s reporter window — dead daemons leave history)."""
        with self._lock:
            for r in [r for r, ring in self._rings.items()
                      if now - ring.newest_ts() > self.stale_s]:
                del self._rings[r]

    # ------------------------------------------------------------- query --
    def reporters(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def _series_locked(self, reporter: str, counter: str,
                       since: Optional[float],
                       until: Optional[float]
                       ) -> List[Tuple[float, float]]:
        ring = self._rings.get(reporter)
        if ring is None:
            return []
        out = []
        for ts, flat in ring.series():
            if counter not in flat:
                continue
            if since is not None and ts < since:
                continue
            if until is not None and ts > until:
                continue
            out.append((ts, flat[counter]))
        return out

    @staticmethod
    def _rates(samples: List[Tuple[float, float]]
               ) -> List[Tuple[float, float]]:
        """Per-interval rates with reset clamping: a negative delta
        (daemon restart) reads as rate 0.0 at that timestamp, never a
        garbage value."""
        rates = []
        for (pts, pv), (ts, v) in zip(samples, samples[1:]):
            dt = ts - pts
            if dt <= 0:
                continue
            delta = v - pv
            rates.append((ts, 0.0 if delta < 0
                          else round(delta / dt, 6)))
        return rates

    def query(self, counter: str, daemon: Optional[str] = None,
              since: Optional[float] = None,
              until: Optional[float] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Range query: ``counter`` is a ``group.key`` name
        (``osd.io.wr_ops``); ``daemon`` narrows to one reporter, else
        every live reporter answers.  -> {"counter", "series":
        {daemon: {"samples": [[ts, value]...], "rates": [[ts,
        rate]...], "resets": n}}, "counter_resets": total}."""
        import time as _time
        if now is None:
            now = _time.time()
        self.prune(now)
        with self._lock:
            names = [daemon] if daemon else sorted(self._rings)
            series: Dict[str, Any] = {}
            for name in names:
                samples = self._series_locked(name, counter,
                                              since, until)
                if not samples:
                    continue
                ring = self._rings[name]
                series[name] = {
                    "samples": [[round(ts, 6), v]
                                for ts, v in samples],
                    "rates": [[round(ts, 6), r]
                              for ts, r in self._rates(samples)],
                    "resets": ring.resets,
                }
            return {"counter": counter, "series": series,
                    "counter_resets": self.counter_resets}

    # ------------------------------------------------------ window rates --
    def window_rate(self, reporter: str, counter: str,
                    window: int = 2) -> Optional[float]:
        """Rate over the newest ``window`` retained samples (2 =
        latest interval, the "short" Prometheus gauge; a large window
        spans the whole retained ring, the "long" gauge).  Reset
        intervals clamp to zero inside the window."""
        with self._lock:
            samples = self._series_locked(reporter, counter,
                                          None, None)
        if len(samples) < 2:
            return None
        samples = samples[-max(2, window):]
        total = 0.0
        dt = samples[-1][0] - samples[0][0]
        if dt <= 0:
            return None
        for (pts, pv), (_ts, v) in zip(samples, samples[1:]):
            d = v - pv
            if d > 0:
                total += d
        return round(total / dt, 6)

    def sparkline(self, reporter: str, counter: str,
                  width: int = 12) -> str:
        """Unicode sparkline of the newest ``width`` per-interval
        rates (the `ceph osd df` trend column); "-" when fewer than
        two samples exist."""
        with self._lock:
            samples = self._series_locked(reporter, counter,
                                          None, None)
        rates = [r for _ts, r in self._rates(samples)][-width:]
        if not rates:
            return "-"
        blocks = "▁▂▃▄▅▆▇█"
        top = max(rates)
        if top <= 0:
            return blocks[0] * len(rates)
        return "".join(
            blocks[min(len(blocks) - 1,
                       int(r / top * (len(blocks) - 1) + 0.5))]
            for r in rates)

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples_per_level": self.samples,
                "levels": self.levels,
                "counter_resets": self.counter_resets,
                "reporters": {
                    r: {"samples": ring.sample_count(),
                        "resets": ring.resets,
                        "newest_ts": round(ring.newest_ts(), 6)}
                    for r, ring in sorted(self._rings.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self.counter_resets = 0
