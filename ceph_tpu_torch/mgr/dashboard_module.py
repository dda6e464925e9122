"""Dashboard mgr module (src/pybind/mgr/dashboard role, API slice).

The reference dashboard is a full web UI; its load-bearing layer is
the REST API the UI consumes.  This module serves that JSON API over
HTTP — `/api/health`, `/api/osds`, `/api/pools`, `/api/summary`,
`/api/pgs` (per-PG placement + degraded/undersized state rollup, the
PG page), `/api/perf` (the live perf-counter collection, the daemon
perf panel), `/api/crush` (the `ceph osd tree` view), `/api/config`
(`config show` with per-option provenance) — plus a minimal index
page, so the cluster is observable from a browser/curl without the
prometheus scraper.  Read-only by design: mutations go through the
mon quorum paths (`ceph` CLI / cephadm), not the dashboard.
"""
from __future__ import annotations

import http.server
import json
import threading
from typing import Optional

from .module_host import MgrModule


class DashboardModule(MgrModule):
    NAME = "dashboard"

    def __init__(self, host):
        super().__init__(host)
        self._server: Optional[http.server.ThreadingHTTPServer] = None

    # --------------------------------------------------------------- api --
    def api_health(self) -> dict:
        osd = self.get("osd_stats")
        n_down = sum(1 for v in osd["up"] if not v)
        return {"status": "HEALTH_WARN" if n_down else "HEALTH_OK",
                "checks": ([{"type": "OSD_DOWN",
                             "message": f"{n_down} osds down"}]
                           if n_down else [])}

    def api_osds(self) -> list:
        osd = self.get("osd_stats")
        return [{"id": i, "up": bool(osd["up"][i]),
                 "in": bool(osd["in"][i]),
                 "weight": int(osd["weight"][i])}
                for i in range(len(osd["up"]))]

    def api_pools(self) -> list:
        m = self.get("osd_map")
        stats = self.get("pool_stats")
        out = []
        for pid, pool in sorted(m.pools.items()):
            s = stats.get(pid, {"objects": 0, "bytes": 0})
            out.append({"id": pid, "name": pool.name,
                        "type": int(pool.type),
                        "pg_num": int(pool.pg_num),
                        "size": int(pool.size),
                        "objects": s["objects"],
                        "bytes": s["bytes"]})
        return out

    def api_summary(self) -> dict:
        m = self.get("osd_map")
        return {"epoch": int(m.epoch), "health": self.api_health(),
                "n_osds": int(m.max_osd),
                "n_pools": len(m.pools),
                "mgr_modules": self.host.enabled()}

    def api_pgs(self) -> dict:
        """Per-PG placement + state rollup (the dashboard PG page /
        `ceph pg dump` summary).  The map pipeline filters down OSDs
        to ITEM_NONE holes, so a hole means a mapped member is
        down/unmappable — Ceph's compound `active+undersized+degraded`
        (fewer copies than size exist until recovery re-homes)."""
        from ..placement.crush_map import ITEM_NONE
        dump = self.get("pg_dump")
        pools = {}
        states = {"active+clean": 0, "active+undersized+degraded": 0,
                  "down": 0}
        for pid, d in sorted(dump.items()):
            rows = []
            for pg, ups in enumerate(d["up"]):
                # positions are SHARD slots for EC pools: holes stay
                # in place as null (like `ceph pg dump`'s NONE), so a
                # consumer can tell WHICH shard is missing
                ups = [int(o) for o in ups]
                n_live = sum(1 for o in ups if o != ITEM_NONE)
                if n_live == 0:
                    state = "down"        # no copy mapped anywhere
                elif n_live == len(ups):
                    state = "active+clean"
                else:
                    state = "active+undersized+degraded"
                states[state] += 1
                rows.append({"pg": f"{pid}.{pg}",
                             "up": [None if o == ITEM_NONE else o
                                    for o in ups],
                             "primary": int(d["primary"][pg]),
                             "state": state})
            pools[str(pid)] = rows
        return {"states": states, "pgs": pools}

    def api_perf(self) -> dict:
        """The live perf-counter collection (`perf dump` over HTTP —
        encode/decode dispatch+byte counters, mapper lanes, tier
        promote/flush/evict ops, ...)."""
        from ..common.perf_counters import perf
        return perf().dump()

    def api_crush(self) -> dict:
        """The CRUSH hierarchy (`ceph osd tree` rows + raw text)."""
        m = self.get("osd_map")
        from ..placement.treedump import tree_dump
        text = tree_dump(m.crush)
        return {"tree": text.splitlines()}

    def api_config(self) -> dict:
        """`config show`: every option's value + provenance layer."""
        from ..common.options import config
        return config().dump()

    # -------------------------------------------------------------- http --
    def start_http(self, port: int = 0) -> int:
        mod = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):             # noqa: N802
                routes = {"/api/health": mod.api_health,
                          "/api/osds": mod.api_osds,
                          "/api/pools": mod.api_pools,
                          "/api/summary": mod.api_summary,
                          "/api/pgs": mod.api_pgs,
                          "/api/perf": mod.api_perf,
                          "/api/crush": mod.api_crush,
                          "/api/config": mod.api_config}
                path = self.path.rstrip("/") or "/"
                if path in routes:
                    body = json.dumps(routes[path]()).encode()
                    ctype = "application/json"
                elif path == "/":
                    body = (b"<html><body><h1>ceph_tpu dashboard"
                            b"</h1><ul>" +
                            b"".join(f'<li><a href="{r}">{r}</a></li>'
                                     .encode() for r in routes) +
                            b"</ul></body></html>")
                    ctype = "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    def stop_http(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def register(host) -> None:
    host.register(DashboardModule.NAME, DashboardModule)
