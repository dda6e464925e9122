"""What the metric readers share: quantiles of the window's operations
and the traced window's device numbers."""
from __future__ import annotations

import math
import statistics
from typing import Optional

from . import arith


def latencies(run, *kinds):
    """Seconds of each operation of these kinds that succeeded."""
    return [op["t1"] - op["t0"] for op in run["ops"]
            if op["kind"] in kinds and "error" not in op]


def p50(xs) -> Optional[float]:
    return statistics.median(xs) if xs else None


def p95(xs) -> Optional[float]:
    """Nearest rank: the smallest latency at or above 95% of them."""
    if not xs:
        return None
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def idle_pct(run) -> Optional[float]:
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_s(run, names) -> float:
    t = run["trace"] or {}
    return sum(s for n, s in t.get("kernel_s", {}).items()
               if any(k in n for k in names))


def codec_roofline(run, names) -> Optional[float]:
    return arith.roofline_pct(
        arith.codec_least_s(run["work"].get("codec_bytes", 0)),
        kernel_s(run, names))


def per_gib(count, nbytes) -> Optional[float]:
    return count / (nbytes / 2 ** 30) if nbytes else None
