"""Op scheduler — dmClock-style QoS queues.

Role of the OSD's OpScheduler (src/osd/scheduler/OpScheduler.{h,cc},
mClockScheduler.cc over the dmclock library): classify incoming ops
(client / background-recovery / background-best-effort, the reference's
op_scheduler_class) and dequeue by mClock tags so every class gets its
RESERVATION (minimum rate), shares leftover capacity by WEIGHT, and
never exceeds its LIMIT.

Compact single-server dmClock: per class (r, w, l) in ops/sec; each op
gets reservation/proportion/limit tags from the class's previous tags;
dequeue picks (1) the earliest eligible reservation tag, else (2) the
smallest proportion tag among classes under their limit.  Virtual time
is a monotonic counter advanced per dequeue, so the scheduler is
deterministic under test while preserving the dmClock invariants.

Per-TENANT client classes (the dmclock multi-client role the
reference drives through osd_mclock_scheduler_client_* per client
profile): class names of the form ``client.<tenant>`` auto-register
on first enqueue with the tenant defaults (or an explicit
``set_qos`` entry), so a gateway's tenant identity — propagated from
S3 auth through the objecter into op dispatch — lands each tenant in
its OWN dmClock class.  Because virtual time advances one unit per
dequeue, a reservation r is a guaranteed FRACTION of dispatch slots
under backlog: a noisy tenant with a huge weight cannot push a
reserved tenant below its r floor (the invariant the serving
harness asserts).
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

CLASS_CLIENT = "client"
CLASS_RECOVERY = "background_recovery"
CLASS_BEST_EFFORT = "background_best_effort"

TENANT_PREFIX = "client."


def tenant_class(tenant: str) -> str:
    """The scheduler class a tenant's client ops dispatch under."""
    return TENANT_PREFIX + str(tenant)


@dataclass(frozen=True)
class QoS:
    """Per-class service parameters (osd_mclock_scheduler_*_res/wgt/lim)."""
    reservation: float           # guaranteed ops per unit time (0 = none)
    weight: float                # share of leftover capacity
    limit: float = float("inf")  # hard cap, ops per unit time


DEFAULT_QOS: Dict[str, QoS] = {
    CLASS_CLIENT: QoS(reservation=1.0, weight=2.0),
    CLASS_RECOVERY: QoS(reservation=0.25, weight=1.0, limit=2.0),
    CLASS_BEST_EFFORT: QoS(reservation=0.0, weight=0.5, limit=1.0),
}


@dataclass
class _Tagged:
    seq: int
    op: Any
    r_tag: float
    p_tag: float
    l_tag: float


class MClockScheduler:
    """enqueue(op, class) / dequeue() with dmClock tag selection.

    ``client.<tenant>`` classes auto-register on first enqueue (the
    dynamic per-tenant client profiles); every other unknown class
    still raises — a typo'd background class is a bug, not a tenant.
    """

    def __init__(self, qos: Optional[Dict[str, QoS]] = None,
                 tenant_default: Optional[QoS] = None):
        self.qos = dict(DEFAULT_QOS)
        if qos:
            self.qos.update(qos)
        # QoS for tenant classes that were never explicitly
        # configured (osd_mclock_scheduler_client_* defaults)
        self.tenant_default = tenant_default or \
            self.qos[CLASS_CLIENT]
        self._queues: Dict[str, List[_Tagged]] = {
            c: [] for c in self.qos}
        self._last: Dict[str, _Tagged] = {}
        self._seq = itertools.count()
        self._vt = 0.0                    # virtual time
        self.stats = {c: 0 for c in self.qos}

    def set_qos(self, klass: str, qos: QoS) -> None:
        """Register or retune one class's (r, w, l) at runtime — the
        `osd_mclock_scheduler_client_*` per-tenant knobs.  Existing
        queue entries keep their tags; new enqueues tag under the
        new parameters."""
        self.qos[klass] = qos
        self._queues.setdefault(klass, [])
        self.stats.setdefault(klass, 0)

    # dynamic tenant classes are bounded: the tenant tag is a
    # caller-supplied label on an authenticated session, and an
    # adversarial client cycling unique tags must not grow the
    # scheduler state without limit — past the cap, unconfigured
    # tenants fold into the plain client class (explicitly
    # set_qos'd tenants never fold; they were configured by the
    # operator)
    MAX_DYNAMIC_TENANTS = 64

    def ensure_class(self, klass: str) -> str:
        """Find-or-register ``klass``; returns the class the op will
        actually dispatch under (tenant classes vivify with the
        tenant default up to MAX_DYNAMIC_TENANTS, then fold to the
        plain client class; any other unknown class raises)."""
        if klass in self.qos:
            return klass
        if not klass.startswith(TENANT_PREFIX):
            raise KeyError(f"unknown scheduler class {klass!r}")
        n_tenants = sum(1 for k in self.qos
                        if k.startswith(TENANT_PREFIX))
        if n_tenants >= self.MAX_DYNAMIC_TENANTS:
            return CLASS_CLIENT
        self.set_qos(klass, self.tenant_default)
        return klass

    def enqueue(self, op: Any, klass: str = CLASS_CLIENT) -> None:
        klass = self.ensure_class(klass)
        q = self.qos[klass]
        prev = self._last.get(klass)
        now = self._vt
        r_tag = now if q.reservation <= 0 else max(
            now, (prev.r_tag + 1.0 / q.reservation) if prev else now)
        # weight 0 is a legal "starved" profile (tenant QoS specs):
        # tags space by a huge-but-finite stride instead of dividing
        # by zero, so the class drains work-conservingly, last
        wgt = max(q.weight, 1e-9)
        p_tag = max(now, (prev.p_tag + 1.0 / wgt) if prev else now)
        l_tag = now if q.limit == float("inf") else max(
            now, (prev.l_tag + 1.0 / q.limit) if prev else now)
        t = _Tagged(next(self._seq), op, r_tag, p_tag, l_tag)
        self._last[klass] = t
        self._queues[klass].append(t)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def dequeue(self) -> Optional[Tuple[str, Any]]:
        """One op by dmClock selection; None when idle."""
        if not len(self):
            return None
        self._vt += 1.0
        now = self._vt
        # phase 1: earliest ELIGIBLE reservation tag (tag <= now)
        best = None
        for klass, q in self._queues.items():
            if not q or self.qos[klass].reservation <= 0:
                continue
            head = q[0]
            if head.r_tag <= now and (
                    best is None or head.r_tag < best[1].r_tag):
                best = (klass, head)
        if best is None:
            # phase 2: smallest proportion tag among under-limit classes
            for klass, q in self._queues.items():
                if not q:
                    continue
                head = q[0]
                if head.l_tag > now:
                    continue             # over limit
                if best is None or head.p_tag < best[1].p_tag:
                    best = (klass, head)
        if best is None:
            # everything over limit: take the earliest limit tag so the
            # queue still drains (work-conserving fallback)
            for klass, q in self._queues.items():
                if not q:
                    continue
                head = q[0]
                if best is None or head.l_tag < best[1].l_tag:
                    best = (klass, head)
        klass, head = best
        self._queues[klass].pop(0)
        self.stats[klass] += 1
        return klass, head.op
