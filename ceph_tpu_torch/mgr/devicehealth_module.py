"""Device-health mgr module (src/pybind/mgr/devicehealth role).

The reference scrapes SMART metrics per device, stores them in a
health pool, and predicts life expectancy; failing devices raise
health warnings and can be preemptively drained.  This cluster model
has no SMART source, so the scrape substitutes the observable health
signals the stores DO expose — up/down flaps, scrub-found
inconsistencies (checksum failures are exactly what a dying disk
produces), and usage — while keeping the reference's surface: metric
history per device, ``life_expectancy``, a health check for devices
predicted to fail, and ``maybe_mark_out`` (the mark-out-ahead-of-
failure behavior behind devicehealth's self_heal option).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .module_host import MgrModule

# life-expectancy buckets (the reference expresses this as a date
# range; buckets keep the semantics without wall-clock coupling)
GOOD, WARNING, FAILING = "good", "warning", "failing"


class DeviceHealthModule(MgrModule):
    NAME = "devicehealth"
    HISTORY = 16                # scrapes retained per device
    FLAP_WARN = 2               # down-transitions before WARNING
    ERROR_FAIL = 1              # scrub errors before FAILING

    def __init__(self, host):
        super().__init__(host)
        # osd id -> ring of scrapes {ts, up, in, errors, objects}
        self.metrics: Dict[int, List[Dict[str, Any]]] = {}
        self._last_up: Dict[int, bool] = {}
        self.flaps: Dict[int, int] = {}
        self.errors: Dict[int, int] = {}
        self.self_heal = False
        self.marked_out: List[int] = []

    # ------------------------------------------------------------ scrape --
    def record_scrub_errors(self, osd_id: int, n: int = 1) -> None:
        """Scrub found inconsistent/unreadable shards on this OSD —
        the strongest dying-media signal this model observes (the
        SMART reallocated-sector analog)."""
        self.errors[osd_id] = self.errors.get(osd_id, 0) + n

    def scrape(self, now: Optional[float] = None) -> None:
        osd = self.get("osd_stats")
        ts = time.time() if now is None else now
        for i, up in enumerate(osd["up"]):
            if self._last_up.get(i, True) and not up:
                self.flaps[i] = self.flaps.get(i, 0) + 1
            self._last_up[i] = bool(up)
            ring = self.metrics.setdefault(i, [])
            ring.append({"ts": ts, "up": bool(up),
                         "in": bool(osd["in"][i]),
                         "errors": self.errors.get(i, 0),
                         "flaps": self.flaps.get(i, 0)})
            del ring[:-self.HISTORY]

    # ---------------------------------------------------------- verdicts --
    def life_expectancy(self, osd_id: int) -> str:
        if self.errors.get(osd_id, 0) >= self.ERROR_FAIL:
            return FAILING
        if self.flaps.get(osd_id, 0) >= self.FLAP_WARN:
            return WARNING
        return GOOD

    def checks(self) -> Dict[str, Dict]:
        """Health checks (DEVICE_HEALTH / DEVICE_HEALTH_IN_USE roles)."""
        failing = [i for i in self.metrics
                   if self.life_expectancy(i) == FAILING]
        warning = [i for i in self.metrics
                   if self.life_expectancy(i) == WARNING]
        out: Dict[str, Dict] = {}
        if failing:
            out["DEVICE_HEALTH_TOOMANY" if len(failing) > 1
                else "DEVICE_HEALTH"] = {
                "severity": "error",
                "message": f"{len(failing)} device(s) predicted to "
                           f"fail: {sorted(failing)}"}
        if warning:
            out.setdefault("DEVICE_HEALTH_WARN", {
                "severity": "warning",
                "message": f"{len(warning)} device(s) degrading: "
                           f"{sorted(warning)}"})
        return out

    def maybe_mark_out(self) -> List[int]:
        """self_heal: mark failing devices out so data re-replicates
        BEFORE the device dies (devicehealth mark_out_threshold)."""
        if not self.self_heal:
            return []
        m = self.get("osd_map")
        newly = []
        for i in list(self.metrics):
            if self.life_expectancy(i) == FAILING and \
                    i not in self.marked_out and \
                    int(m.osd_weight[i]) > 0:
                self.host.mark_osd_out(i)
                self.marked_out.append(i)
                newly.append(i)
        return newly

    # -------------------------------------------------------------- serve --
    def serve_tick(self) -> None:
        self.scrape()
        self.maybe_mark_out()


def register(host) -> None:
    host.register(DeviceHealthModule.NAME, DeviceHealthModule)
