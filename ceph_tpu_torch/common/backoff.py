"""Deterministic exponential backoff with jitter + a sim-tick clock.

The retry sweeps the thrasher hardens (objecter resends, the remote
client's map-refresh loops, daemon boot) previously slept on bare
linear schedules (``0.05 * (attempt + 1)``) — synchronized retries
from many clients stampede a recovering daemon, and unseeded sleeps
make soak runs unreproducible.  This module is the shared policy:

  * ``ExpBackoff`` — capped exponential delay with DETERMINISTIC
    seeded jitter (full-jitter shape: delay drawn uniformly from
    (1-jitter)*d .. d), so two runs with the same seed sleep the same
    schedule while distinct seeds decorrelate.
  * ``TickClock`` — a simulation clock whose ``sleep`` advances a
    counter instead of the wall (the in-process objecter's clock: its
    retry loop must be instantaneous and deterministic under test).

Reference shape: the OSD's exponential backoff on mon reconnect
(OSD::ms_handle_connect retry ladder) and qa's thrasher timing model.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional


class TickClock:
    """Sim-tick clock: ``sleep`` advances ``now`` without wall time."""

    def __init__(self) -> None:
        self.now = 0.0
        self.sleeps = 0

    def sleep(self, seconds: float) -> None:
        self.now += float(seconds)
        self.sleeps += 1


class ExpBackoff:
    """Capped exponential backoff, deterministically jittered.

    ``delay(attempt)`` is pure given the construction seed and the
    call sequence; ``sleep(attempt)`` applies it through the injected
    sleep function (wall-clock by default, a TickClock in sims).
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 cap: float = 1.0, jitter: float = 0.5,
                 seed: Optional[int] = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if base <= 0 or factor < 1.0 or cap < base:
            raise ValueError("backoff needs base > 0, factor >= 1, "
                             "cap >= base")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay(self, attempt: int) -> float:
        d = min(self.cap, self.base * self.factor ** max(0, attempt))
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        self._sleep(d)
        return d
