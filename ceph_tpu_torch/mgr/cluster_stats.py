"""ClusterStats — mgr-style cluster-wide stats aggregation.

Role of the reference's PGMap (src/mon/PGMap.cc: per-OSD/per-pool
stat ingestion from MOSDPGStats reports, the `ceph -s` io line and
`ceph df` / `ceph osd df` renderings) combined with the mgr
prometheus module's cluster scrape (src/pybind/mgr/prometheus:
per-daemon labeled families from every daemon's perf counters).

Each daemon ships, on its existing heartbeat/reporter path, a report:

    {"perf": <PerfCountersCollection.dump_typed()>,     # typed values
     "util": {"bytes": .., "total_bytes": .., "objects": ..,
              "pools": {pid: {"objects": n, "bytes": b}}},
     "ts": <wall clock>}

and the aggregator (leader-mon-local, like the SLOW_OPS rollup):

  * merges log2 ``PerfHistogram`` dumps BUCKET-WISE across daemons
    and reads cluster p50/p99/p999 off the merged distribution —
    exact within one bucket's resolution, which is the histogram's
    own resolution (averaging per-daemon quantiles would be wrong);
  * computes io RATES (ops/s, bytes/s, per pool and per daemon) from
    deltas between consecutive reports of the monotonic ``osd.io``
    counters — the `ceph -s` "io:" line;
  * aggregates utilization for `ceph df` / `ceph osd df`;
  * renders ONE cluster-wide Prometheus scrape with per-daemon
    ``ceph_daemon`` labels plus merged ``ceph_cluster_*`` families —
    the per-process-only prometheus_module view, cluster-shaped.

Stale reporters age out (a daemon that stopped reporting must not
pin week-old rates into `ceph -s` forever).
"""
from __future__ import annotations

import math
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..common.perf_counters import (COUNTER, GAUGE, HISTOGRAM,
                                    TIME_AVG)
from ..common.perf_counters import perf as _perf
from ..cluster.pg_heat import merge_heat, osd_heat_rollup
from .metrics_history import RATE_COUNTERS, MetricsHistory

QUANTILES = (0.5, 0.99, 0.999)
STALE_S = 600.0          # reporter aging (the SLOW_OPS window)


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _le_key(le) -> float:
    return math.inf if le == "+Inf" else float(le)


def merge_histograms(dumps: Iterable[Dict[str, Any]]
                     ) -> Dict[str, Any]:
    """Bucket-wise merge of PerfHistogram dumps ({count, sum,
    buckets: [[le, n], ...]}, non-cumulative, le ascending): buckets
    with the SAME le bound add their counts — all producers share the
    log2 bucket geometry, so identical bounds mean identical value
    ranges and the merged histogram is exactly the histogram of the
    pooled samples (no resolution loss beyond each sample's own
    bucket)."""
    counts: Dict[float, int] = {}
    labels: Dict[float, Any] = {}
    total = 0
    sm = 0.0
    for d in dumps:
        if not d:
            continue
        total += int(d.get("count", 0))
        sm += float(d.get("sum", 0.0))
        for le, n in d.get("buckets", []):
            k = _le_key(le)
            counts[k] = counts.get(k, 0) + int(n)
            labels[k] = le
    buckets = [[labels[k], counts[k]] for k in sorted(counts)]
    return {"count": total, "sum": round(sm, 9), "buckets": buckets}


def quantile(dump: Dict[str, Any], q: float) -> Optional[float]:
    """Read one quantile off a (merged) histogram dump: the le upper
    bound of the bucket where the cumulative count crosses q*total —
    exact to one bucket's resolution.  The +Inf bucket answers with
    the last finite bound (prometheus histogram_quantile's rule)."""
    total = int(dump.get("count", 0))
    if total <= 0:
        return None
    target = q * total
    cum = 0
    last_finite = None
    for le, n in dump.get("buckets", []):
        if le != "+Inf":
            last_finite = float(le)
        cum += int(n)
        if cum >= target:
            return float(le) if le != "+Inf" else last_finite
    return last_finite


_Q_LABEL = {0.5: "p50", 0.99: "p99", 0.999: "p999"}


def quantiles(dump: Dict[str, Any],
              qs: Tuple[float, ...] = QUANTILES) -> Dict[str, Any]:
    return {_Q_LABEL.get(q, f"q{q}"): quantile(dump, q) for q in qs}


class ClusterStats:
    """The aggregator: per-daemon latest reports + previous-report
    deltas for rates.  Thread-safe (wire handler threads ingest while
    admin/scrape threads read)."""

    def __init__(self, stale_s: float = STALE_S):
        self._lock = threading.Lock()
        self.stale_s = float(stale_s)
        # daemon -> {"ts", "perf", "util"} (latest)
        self._latest: Dict[str, Dict[str, Any]] = {}
        # daemon -> {"ts", flat io counters} (previous, for deltas)
        self._prev_io: Dict[str, Tuple[float, Dict[str, float]]] = {}
        # daemon -> computed {key: rate/s}
        self._rates: Dict[str, Dict[str, float]] = {}
        self.reports_ingested = 0
        # ClusterScope: bounded per-reporter delivery rings (the
        # mgr MetricCollector / PGMap-history role)
        self.history = MetricsHistory(stale_s=self.stale_s)
        # daemon -> latest PGHeatTracker.dump() (pool-HitSet role)
        self._heat: Dict[str, Dict[str, Any]] = {}
        # monotonic-counter resets observed across reporters (a
        # daemon restart zeroes its counters; the rate layer clamps
        # the negative delta and counts it here + stats.counter_resets)
        self.counter_resets = 0

    # ------------------------------------------------------------ ingest --
    @staticmethod
    def _flat_io(perf: Dict[str, Any]) -> Dict[str, float]:
        """Monotonic io counters a rate can be derived from — the
        ``osd.io`` group daemons count CLIENT-facing ops into (the
        only group whose keys the rate sums below understand)."""
        out: Dict[str, float] = {}
        for group in ("osd.io",):
            for key, tv in (perf.get(group) or {}).items():
                typ, val = tv[0], tv[1]
                if typ == COUNTER and isinstance(val, (int, float)):
                    out[key] = float(val)
        return out

    def ingest(self, daemon: str, report: Dict[str, Any]) -> None:
        ts = float(report.get("ts") or time.time())
        perf = report.get("perf") or {}
        util = report.get("util") or {}
        heat = report.get("heat")
        with self._lock:
            self.reports_ingested += 1
            prev = self._prev_io.get(daemon)
            flat = self._flat_io(perf)
            if prev is not None:
                pts, pflat = prev
                dt = ts - pts
                # counter-reset robustness: a restarted daemon's
                # monotonic counters went backwards — the rate clamps
                # to zero (max() below) and the reset is COUNTED, so
                # a restart reads as "reset, rate 0", not garbage
                if any(v < pflat.get(k, 0.0)
                       for k, v in flat.items() if k in pflat):
                    self.counter_resets += 1
                    _perf("stats").inc("counter_resets")
                if dt > 0:
                    self._rates[daemon] = {
                        k: max(0.0, (v - pflat.get(k, 0.0)) / dt)
                        for k, v in flat.items()}
            self._prev_io[daemon] = (ts, flat)
            self._latest[daemon] = {"ts": ts, "perf": perf,
                                    "util": util,
                                    "host": report.get("host")}
            if heat:
                self._heat[daemon] = heat
        # retain the delivery in the history ring (its own lock; the
        # ring does its own per-reporter reset detection so history
        # rate series clamp identically)
        self.history.record(daemon, ts, perf)

    def _live(self) -> Dict[str, Dict[str, Any]]:
        """Latest reports younger than the staleness window (caller
        holds the lock)."""
        now = time.time()
        return {d: r for d, r in self._latest.items()
                if now - r["ts"] <= self.stale_s}

    def daemons(self) -> List[str]:
        with self._lock:
            return sorted(self._live())

    # ----------------------------------------------------------- merging --
    def _histogram_families(self, live) -> Dict[str, Dict[str, Any]]:
        """{group.key: {"merged": dump, "per_daemon": {d: dump}}}
        across every daemon's typed perf dump."""
        fams: Dict[str, Dict[str, Any]] = {}
        for daemon, rep in live.items():
            for group, counters in (rep["perf"] or {}).items():
                for key, tv in counters.items():
                    if tv[0] != HISTOGRAM:
                        continue
                    fam = fams.setdefault(f"{group}.{key}",
                                          {"per_daemon": {}})
                    fam["per_daemon"][daemon] = tv[1]
        for fam in fams.values():
            fam["merged"] = merge_histograms(
                fam["per_daemon"].values())
            fam["quantiles"] = quantiles(fam["merged"])
        return fams

    def merged_quantiles(self) -> Dict[str, Dict[str, Any]]:
        """{group.key: {p5: .., p99: .., p999: .., count: ..}} —
        cluster percentiles off the bucket-wise merged histograms
        (the SLO surface ROADMAP item 4 consumes)."""
        with self._lock:
            fams = self._histogram_families(self._live())
        return {name: dict(fam["quantiles"],
                           count=fam["merged"]["count"])
                for name, fam in fams.items()}

    # -------------------------------------------------------------- io --
    def io_rates(self) -> Dict[str, Any]:
        """Cluster + per-pool + per-daemon io rates (the `ceph -s`
        io: line), from monotonic counter deltas between consecutive
        daemon reports."""
        with self._lock:
            live = set(self._live())
            rates = {d: dict(r) for d, r in self._rates.items()
                     if d in live}
        cluster = {"rd_ops": 0.0, "wr_ops": 0.0,
                   "rd_bytes": 0.0, "wr_bytes": 0.0}
        pools: Dict[int, Dict[str, float]] = {}
        for _d, r in rates.items():
            for k, v in r.items():
                if k in cluster:
                    cluster[k] += v
                elif k.startswith("pool."):
                    _, pid, metric = k.split(".", 2)
                    p = pools.setdefault(int(pid), {})
                    p[metric] = p.get(metric, 0.0) + v
        return {"cluster": {k: round(v, 3)
                            for k, v in cluster.items()},
                "pools": {pid: {k: round(v, 3)
                                for k, v in p.items()}
                          for pid, p in sorted(pools.items())},
                "daemons": {d: {k: round(v, 3)
                                for k, v in r.items()
                                if not k.startswith("pool.")}
                            for d, r in sorted(rates.items())}}

    # -------------------------------------------------------------- heat --
    def _live_heat(self) -> Dict[str, Dict[str, Any]]:
        """Heat dumps of non-stale reporters (caller holds no lock)."""
        with self._lock:
            live = set(self._live())
            return {d: h for d, h in self._heat.items() if d in live}

    def pg_heat(self, pool: Optional[int] = None,
                top: Optional[int] = None) -> List[Dict[str, Any]]:
        """`ceph pg heat [--pool P] [--top N]`: per-PG client-io heat
        rows merged across every reporting OSD, hottest first."""
        return merge_heat(self._live_heat(), pool=pool, top=top)

    def osd_heat(self, check: bool = True) -> Dict[str, Any]:
        """Per-OSD heat rollup.  ``check`` asserts the raw totals
        agree with the same daemon's reported ``osd.io`` counters —
        heat and io counters are incremented at the SAME call sites,
        so a mismatch means an attribution bug, and the rollup says
        so rather than letting the two surfaces silently diverge.
        (>= because the io counters may have advanced between the
        heat snapshot and the perf dump inside one report.)"""
        rollup = osd_heat_rollup(self._live_heat())
        if check:
            with self._lock:
                live = self._live()
            for daemon, row in rollup.items():
                io = (live.get(daemon) or {}).get("perf") or {}
                flat = self._flat_io(io)
                if not flat:
                    continue
                for f in ("rd_ops", "wr_ops", "rd_bytes", "wr_bytes"):
                    got, want = row.get(f"tot_{f}", 0.0), \
                        flat.get(f, 0.0)
                    if got > want + 0.5:
                        raise AssertionError(
                            f"{daemon}: heat rollup {f}={got} "
                            f"exceeds osd.io counter {want} — "
                            f"per-PG attribution double-counted")
        return rollup

    # ---------------------------------------------------------- df views --
    def osd_df(self) -> List[Dict[str, Any]]:
        """Per-OSD utilization rows (`ceph osd df`) — OSD reporters
        only (clients report perf too, but they own no store)."""
        with self._lock:
            live = self._live()
        rows = []
        for daemon, rep in sorted(live.items()):
            if not daemon.startswith("osd."):
                continue
            u = rep["util"] or {}
            total = int(u.get("total_bytes") or 0)
            used = int(u.get("bytes") or 0)
            rows.append({
                "daemon": daemon,
                "bytes_used": used,
                "bytes_total": total,
                "utilization": round(used / total, 6)
                if total else 0.0,
                "objects": int(u.get("objects") or 0),
                # recent-rate trend columns off the history rings
                # (the `ceph osd df` sparkline; "-" until 2 samples)
                "wr_trend": self.history.sparkline(
                    daemon, "osd.io.wr_ops"),
                "rd_trend": self.history.sparkline(
                    daemon, "osd.io.rd_ops")})
        return rows

    def df(self) -> Dict[str, Any]:
        """Pool + cluster usage (`ceph df`): shard/replica objects
        and bytes summed across the daemons that hold them (RAW
        usage, the STORED/USED distinction the reference draws)."""
        with self._lock:
            live = self._live()
        pools: Dict[int, Dict[str, int]] = {}
        total_used = total_bytes = total_objects = 0
        for daemon, rep in live.items():
            if not daemon.startswith("osd."):
                continue          # only store owners count toward RAW
            u = rep["util"] or {}
            total_used += int(u.get("bytes") or 0)
            total_bytes += int(u.get("total_bytes") or 0)
            total_objects += int(u.get("objects") or 0)
            for pid, p in (u.get("pools") or {}).items():
                row = pools.setdefault(int(pid),
                                       {"objects": 0, "bytes": 0})
                row["objects"] += int(p.get("objects") or 0)
                row["bytes"] += int(p.get("bytes") or 0)
        return {"total_bytes": total_bytes,
                "total_used_bytes": total_used,
                "total_objects": total_objects,
                "pools": dict(sorted(pools.items()))}

    # -------------------------------------------------------- mesh plane --
    _CHIP_KEY = re.compile(r"^(r(\d+)c(\d+)|shard(\d+))\.(.+)$")

    def mesh_rollup(self) -> Dict[str, Any]:
        """Per-(host, chip) data-plane counter rollup — the MeshPlane2D
        cluster view.  Each reporter's ``dataplane`` perf group is
        scanned for per-chip keys and attributed to the host label its
        report carried (``host0`` when absent — single-process plane).
        A reporter writing BOTH the 2-D coordinate keys and the 1-D
        ``shard<i>`` aliases contributes the coordinate namespace only
        (the alias is the same value under another name — summing both
        would double-count); ``totals`` sums every (host, chip) cell,
        so a 2-process plane's totals equal the single-process run's
        (per-cell accounting is locality-gated at the source)."""
        with self._lock:
            live = self._live()
        hosts: Dict[str, Dict[str, Dict[str, float]]] = {}
        totals: Dict[str, float] = {}
        rows = cols = 0
        for daemon, rep in live.items():
            grp = (rep["perf"] or {}).get("dataplane") or {}
            chips: Dict[str, Dict[str, float]] = {}
            coords = False
            for key, tv in grp.items():
                m = self._CHIP_KEY.match(key)
                if not m or tv[0] != COUNTER:
                    continue
                if m.group(2) is not None:
                    coords = True
            for key, tv in grp.items():
                m = self._CHIP_KEY.match(key)
                if not m or tv[0] != COUNTER \
                        or not isinstance(tv[1], (int, float)):
                    continue
                is_coord = m.group(2) is not None
                if coords != is_coord:
                    continue          # skip the alias namespace
                if is_coord:
                    rows = max(rows, int(m.group(2)) + 1)
                    cols = max(cols, int(m.group(3)) + 1)
                chips.setdefault(m.group(1), {})[m.group(5)] = \
                    float(tv[1])
            if not chips:
                continue
            host = str(rep.get("host") or "host0")
            hrow = hosts.setdefault(host, {})
            for chip, counters in chips.items():
                cell = hrow.setdefault(chip, {})
                for k, v in counters.items():
                    cell[k] = cell.get(k, 0.0) + v
                    totals[k] = totals.get(k, 0.0) + v
        n_chips = sum(len(h) for h in hosts.values())
        return {"hosts": hosts, "totals": totals,
                "n_hosts": len(hosts), "n_chips": n_chips,
                "shape": [rows, cols] if rows else None}

    # ------------------------------------------------------------- dump --
    def dump(self) -> Dict[str, Any]:
        return {"daemons": self.daemons(),
                "reports_ingested": self.reports_ingested,
                "counter_resets": self.counter_resets,
                "quantiles": self.merged_quantiles(),
                "io": self.io_rates(),
                "df": self.df(),
                "osd_df": self.osd_df(),
                "mesh": self.mesh_rollup(),
                "history": self.history.dump()}

    # -------------------------------------------------------- prometheus --
    @staticmethod
    def _safe(name: str) -> str:
        return name.replace(".", "_").replace("-", "_")

    @staticmethod
    def _hist_lines(lines: List[str], name: str, labels: str,
                    dump: Dict[str, Any]) -> None:
        cum = 0
        saw_inf = False
        for le, n in dump.get("buckets", []):
            cum += int(n)
            saw_inf = saw_inf or le == "+Inf"
            le_s = le if le == "+Inf" else repr(float(le))
            sep = "," if labels else ""
            lines.append(f'{name}_bucket{{{labels}{sep}le="{le_s}"}} '
                         f'{cum}')
        if not saw_inf:
            sep = "," if labels else ""
            lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} '
                         f'{dump.get("count", 0)}')
        lab = f"{{{labels}}}" if labels else ""
        lines.append(f'{name}_sum{lab} {dump.get("sum", 0.0)}')
        lines.append(f'{name}_count{lab} {dump.get("count", 0)}')

    def render_prometheus(self) -> str:
        """The single cluster-wide scrape: every daemon's counters
        with a ``ceph_daemon`` label, merged ``ceph_cluster_*``
        histogram families, merged quantile gauges, and per-OSD
        utilization."""
        with self._lock:
            live = {d: {"perf": dict(r["perf"] or {}),
                        "util": dict(r["util"] or {})}
                    for d, r in self._live().items()}
            fams = self._histogram_families(live)
        lines: List[str] = []
        # per-daemon families use their own ceph_daemon_* namespace:
        # the per-process exporter already emits UNLABELED
        # ceph_tpu_* families for this process's counters, and one
        # scrape body must never carry two # TYPE lines for one
        # family name (a real Prometheus parser rejects the whole
        # scrape)
        # scalar families, per daemon (gauges/counters/time_avgs).
        # Per-pool io counters ("pool.<pid>.<metric>" keys) render as
        # ONE family per metric with a pool label — ids belong in
        # labels, not metric names, or no PromQL query can aggregate
        # across pools
        scalars: Dict[str, List[Tuple[str, str, Any]]] = {}
        for daemon, rep in sorted(live.items()):
            for group, counters in sorted(rep["perf"].items()):
                for key, tv in sorted(counters.items()):
                    typ, val = tv[0], tv[1]
                    labels = f'ceph_daemon="{_esc(daemon)}"'
                    if key.startswith("pool.") and \
                            key.count(".") >= 2:
                        _p, pid, metric = key.split(".", 2)
                        key = f"pool_{metric}"
                        labels += f',pool="{_esc(pid)}"'
                    name = self._safe(f"ceph_daemon_{group}_{key}")
                    if typ == HISTOGRAM:
                        continue                 # rendered below
                    if typ == TIME_AVG:
                        val = (val or {}).get("avgtime", 0.0)
                        typ = GAUGE
                    if isinstance(val, bool) or \
                            not isinstance(val, (int, float)):
                        continue
                    scalars.setdefault(name, []).append(
                        (labels, "gauge" if typ == GAUGE
                         else "counter", val))
        for name, samples in sorted(scalars.items()):
            lines.append(f"# HELP {name} per-daemon perf counter")
            lines.append(f"# TYPE {name} {samples[0][1]}")
            for labels, _typ, val in samples:
                lines.append(f"{name}{{{labels}}} {val}")
        # histogram families: per-daemon labeled + cluster-merged
        for fname, fam in sorted(fams.items()):
            name = self._safe(f"ceph_daemon_{fname}")
            lines.append(f"# HELP {name} per-daemon histogram")
            lines.append(f"# TYPE {name} histogram")
            for daemon, dump in sorted(fam["per_daemon"].items()):
                self._hist_lines(lines, name,
                                 f'ceph_daemon="{_esc(daemon)}"',
                                 dump)
            cname = self._safe(f"ceph_cluster_{fname}")
            lines.append(f"# HELP {cname} bucket-wise merged "
                         f"cluster histogram")
            lines.append(f"# TYPE {cname} histogram")
            self._hist_lines(lines, cname, "", fam["merged"])
            qname = cname + "_quantile"
            lines.append(f"# HELP {qname} merged cluster quantiles "
                         f"(one log2 bucket resolution)")
            lines.append(f"# TYPE {qname} gauge")
            for q in QUANTILES:
                v = quantile(fam["merged"], q)
                if v is not None:
                    lines.append(f'{qname}{{quantile="{q}"}} {v}')
        # utilization (`ceph osd df` as a scrape family)
        rows = self.osd_df()
        if rows:
            lines.append("# HELP ceph_osd_utilization used/total "
                         "store bytes per OSD")
            lines.append("# TYPE ceph_osd_utilization gauge")
            for r in rows:
                lines.append(
                    f'ceph_osd_utilization{{ceph_daemon='
                    f'"{_esc(r["daemon"])}"}} {r["utilization"]}')
        # io rates (the `ceph -s` io line as gauges)
        io = self.io_rates()
        lines.append("# HELP ceph_cluster_io_rate cluster io rates "
                     "from counter deltas")
        lines.append("# TYPE ceph_cluster_io_rate gauge")
        for k, v in sorted(io["cluster"].items()):
            lines.append(f'ceph_cluster_io_rate{{metric="{k}"}} {v}')
        # short/long window rates off the history rings: the latest
        # interval vs the whole retained window, per daemon per
        # headline counter (reset intervals clamp to zero inside)
        hist = self.history
        rate_lines: List[str] = []
        for daemon in hist.reporters():
            for group, key in RATE_COUNTERS:
                counter = f"{group}.{key}"
                short = hist.window_rate(daemon, counter, window=2)
                long = hist.window_rate(daemon, counter,
                                        window=1 << 30)
                for win, v in (("short", short), ("long", long)):
                    if v is not None:
                        rate_lines.append(
                            f'ceph_history_rate{{ceph_daemon='
                            f'"{_esc(daemon)}",counter='
                            f'"{_esc(counter)}",window="{win}"}} '
                            f'{v}')
        if rate_lines:
            lines.append("# HELP ceph_history_rate windowed counter "
                         "rates from the metrics-history rings "
                         "(reset-clamped)")
            lines.append("# TYPE ceph_history_rate gauge")
            lines.extend(rate_lines)
        # cumulative reset count (alerting on restart storms)
        lines.append("# HELP ceph_cluster_counter_resets monotonic "
                     "counter resets observed (daemon restarts)")
        lines.append("# TYPE ceph_cluster_counter_resets counter")
        lines.append(f"ceph_cluster_counter_resets "
                     f"{self.counter_resets}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._latest.clear()
            self._prev_io.clear()
            self._rates.clear()
            self._heat.clear()
            self.reports_ingested = 0
            self.counter_resets = 0
        self.history.reset()
