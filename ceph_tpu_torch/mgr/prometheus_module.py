"""Prometheus exporter mgr module (src/pybind/mgr/prometheus role).

Renders cluster state and the process perf counters in the Prometheus
text exposition format (the scrape payload), optionally served over
HTTP.  Metric names mirror the reference exporter's families:
ceph_osd_up / ceph_osd_in / ceph_osd_weight, ceph_pg_total,
ceph_pool_objects / ceph_pool_bytes, ceph_health_status, plus every
ceph_tpu perf counter as ceph_tpu_<group>_<name>.
"""
from __future__ import annotations

import http.server
import threading
from typing import List, Optional

from ..common.perf_counters import (COUNTER, GAUGE, HISTOGRAM, TIME_AVG,
                                    perf as _perf)
from .module_host import MgrModule


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_le(bound) -> str:
    """Prometheus le label: trim float noise, keep +Inf literal."""
    if isinstance(bound, str):
        return bound
    return repr(float(bound))


class PrometheusModule(MgrModule):
    NAME = "prometheus"

    def __init__(self, host):
        super().__init__(host)
        self._server: Optional[http.server.ThreadingHTTPServer] = None

    # ------------------------------------------------------------ render --
    def render(self) -> str:
        lines: List[str] = []

        def metric(name, help_, type_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {type_}")
            for labels, value in samples:
                if labels:
                    lab = ",".join(f'{k}="{_esc(str(v))}"'
                                   for k, v in labels.items())
                    lines.append(f"{name}{{{lab}}} {value}")
                else:
                    lines.append(f"{name} {value}")

        osd = self.get("osd_stats")
        n = len(osd["up"])
        metric("ceph_osd_up", "OSD up state", "gauge",
               [({"ceph_daemon": f"osd.{i}"}, int(osd["up"][i]))
                for i in range(n)])
        metric("ceph_osd_in", "OSD in state", "gauge",
               [({"ceph_daemon": f"osd.{i}"}, int(osd["in"][i]))
                for i in range(n)])
        metric("ceph_osd_weight", "OSD crush weight (16.16 fixed)",
               "gauge",
               [({"ceph_daemon": f"osd.{i}"}, osd["weight"][i])
                for i in range(n)])
        m = self.get("osd_map")
        metric("ceph_pg_total", "PGs per pool", "gauge",
               [({"pool_id": pid}, pool.pg_num)
                for pid, pool in sorted(m.pools.items())])
        pstats = self.get("pool_stats")
        metric("ceph_pool_objects", "objects per pool", "gauge",
               [({"pool_id": pid}, s["objects"])
                for pid, s in sorted(pstats.items())])
        metric("ceph_pool_bytes", "logical bytes per pool", "gauge",
               [({"pool_id": pid}, s["bytes"])
                for pid, s in sorted(pstats.items())])
        n_down = sum(1 for v in osd["up"] if not v)
        metric("ceph_health_status",
               "0=HEALTH_OK 1=HEALTH_WARN 2=HEALTH_ERR", "gauge",
               [({}, 1 if n_down else 0)])
        # process perf counters (the exporter's daemon-perf families),
        # rendered by DECLARED type: counters stay counters, gauges
        # gauges, TIME_AVG surfaces its long-run average as a gauge,
        # and histograms become full `_bucket`/`_sum`/`_count` families
        # (cumulative buckets; the +Inf bucket equals `_count`)
        for group, counters in sorted(_perf().dump_typed().items()):
            for cname, (typ, value) in sorted(counters.items()):
                safe = f"ceph_tpu_{group}_{cname}".replace(".", "_") \
                    .replace("-", "_")
                help_ = f"perf counter {group}.{cname}"
                if typ == HISTOGRAM:
                    self._render_histogram(lines, safe, help_, value)
                elif typ == TIME_AVG:
                    metric(safe, help_ + " (long-run avg seconds)",
                           "gauge", [({}, value["avgtime"])])
                elif isinstance(value, (int, float)) and \
                        not isinstance(value, bool):
                    metric(safe, help_,
                           "gauge" if typ == GAUGE else "counter",
                           [({}, value)])
        # cluster section (ClusterTelemetry): when a mon with a
        # ClusterStats aggregator is attached, ONE scrape also serves
        # every reporting daemon's families under per-daemon labels
        # plus the bucket-wise merged ceph_cluster_* histograms and
        # quantile gauges — the reference mgr's cluster-wide
        # prometheus view replacing the per-process-only one
        try:
            cs = self.get("cluster_stats")
        except KeyError:
            cs = None
        if cs is not None and cs.daemons():
            lines.append(cs.render_prometheus().rstrip("\n"))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_histogram(lines: List[str], name: str, help_: str,
                          dumped) -> None:
        """One Prometheus histogram family from a PerfHistogram dump
        ({count, sum, buckets: [[le, n], ...]} with non-cumulative
        counts; le ascending, '+Inf' last when populated)."""
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        saw_inf = False
        for le, n in dumped["buckets"]:
            cum += n
            saw_inf = saw_inf or le == "+Inf"
            lines.append(
                f'{name}_bucket{{le="{_fmt_le(le)}"}} {cum}')
        if not saw_inf:
            lines.append(f'{name}_bucket{{le="+Inf"}} '
                         f'{dumped["count"]}')
        lines.append(f'{name}_sum {dumped["sum"]}')
        lines.append(f'{name}_count {dumped["count"]}')

    # -------------------------------------------------------------- http --
    def start_http(self, port: int = 0) -> int:
        """Serve /metrics; returns the bound port."""
        mod = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):             # noqa: N802 (stdlib API)
                if self.path.rstrip("/") in ("", "/metrics",
                                             "/metrics/"):
                    body = mod.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):     # silent
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    def stop_http(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()     # release the listening fd
            self._server = None


def register(host) -> None:
    host.register(PrometheusModule.NAME, PrometheusModule)
