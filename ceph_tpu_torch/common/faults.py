"""Fault injection registry — named faultpoints with seeded schedules.

Role of the reference's scattered injection knobs
(``ms_inject_socket_failures`` in src/common/options.cc consumed by the
messenger, bluestore's read-error injection, the ``kill_osd`` hooks
teuthology's thrashosds drives): ONE process-wide registry of *named*
faultpoints.  Each point is declared exactly once, where its fire site
lives, with a docstring — ``faults.declare("wire.drop_frame", "...")``
— and fire sites ask ``faults.fire("wire.drop_frame", **ctx)``.

Cost contract: a DISARMED faultpoint is a single dict-miss check
(``name not in armed``) — no locks, no rng, no allocation — so fire
sites are safe on the put/get hot path.  Armed points pay one lock +
one schedule evaluation.

Schedules (all deterministic, seeded — the thrasher's reproducibility
contract):

  * ``always``      fire on every evaluation
  * ``one_in``      fire when ``Random(seed).randrange(n) == 0``
                    (the ms_inject_socket_failures shape)
  * ``nth``         fire exactly once, on the nth evaluation
  * ``predicate``   fire when ``predicate(ctx)`` is truthy (API-only;
                    not armable over the admin wire)

An optional ``match={"cmd": "put_shard"}`` filter gates evaluation on
the fire-site context (the "chosen phase" selector for crash/hang
points) and ``count`` bounds total fires.  ``fire()`` returns None
(not armed / schedule says no) or the armed ``params`` dict, so sites
can carry knobs like hang seconds through the registry.

Every fire increments a counter in the ``faults`` perf group (and a
cumulative in-registry tally that survives disarm), so tests prove
injections actually happened: ``perf dump`` / the ``fault_injection``
admin command expose them per daemon (each process owns its registry).

Static closure: cephtpu-lint CTL601 requires every ``faults.fire``
literal to name a declared point; CTL602 bans ``faults.fire`` inside
jit-reachable code (a host-side branch would burn the compiled path).

Partition faults: ``net.partition`` is the cross-layer netsplit
faultpoint (the iptables-drop teuthology uses between daemon hosts).
It is armed with ``groups`` — a list of entity-name lists — and
severs traffic whose ``src`` and ``dst`` context entities fall in
DIFFERENT groups (entities in no group are unaffected).  The
``oneway`` param makes the cut asymmetric: only frames FROM
``groups[0]`` TOWARD the other groups are dropped, the reverse
direction still delivers (half-open links, the nastier real-world
shape).  Arming goes through the normal grammar — the registry builds
the membership predicate itself, so the asok path works:

    fault_injection arm net.partition
        params={"groups": [["osd.0","osd.1"], ["mon","client",...]],
                "oneway": false}

Fire sites ask ``faults.partitioned(src, dst)`` (or fire() with
src/dst ctx); a fire is counted only when the cut actually severed
that (src, dst) pair, so fire counts prove the partition carried.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from .perf_counters import perf as _perf

MODES = ("always", "one_in", "nth", "predicate")


class FaultError(ValueError):
    """Bad declaration/arming (unknown point, bad mode, dup doc)."""


def _partition_predicate(params: Dict[str, Any]) -> Callable:
    """Membership predicate for ``net.partition``: severed iff src and
    dst sit in different groups (oneway: only groups[0] -> others)."""
    try:
        groups = [frozenset(g) for g in params["groups"]]
    except (TypeError, KeyError):
        raise FaultError("net.partition needs groups=[[entity,...],"
                         "...] (lists of entity names)")
    if len(groups) < 2 or any(not g for g in groups):
        raise FaultError("net.partition needs >= 2 non-empty groups")
    oneway = bool(params.get("oneway", False))

    def severed(ctx: Dict[str, Any]) -> bool:
        src, dst = ctx.get("src"), ctx.get("dst")
        gi = next((i for i, g in enumerate(groups) if src in g), None)
        gj = next((i for i, g in enumerate(groups) if dst in g), None)
        if gi is None or gj is None or gi == gj:
            return False          # unlisted or same-side: delivered
        if oneway:
            return gi == 0        # only groups[0] -> others is cut
        return True

    return severed


@dataclass
class _Armed:
    mode: str
    n: int = 0
    seed: int = 0
    count: Optional[int] = None              # max fires; None = unbounded
    predicate: Optional[Callable[[Dict[str, Any]], bool]] = None
    match: Optional[Dict[str, Any]] = None   # ctx filter (phase choice)
    params: Dict[str, Any] = field(default_factory=dict)
    calls: int = 0
    fires: int = 0
    rng: Optional[random.Random] = None


class FaultRegistry:
    """Process-wide faultpoint registry (one per daemon process)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._declared: Dict[str, str] = {}      # name -> docstring
        self._armed: Dict[str, _Armed] = {}
        self._fired: Dict[str, int] = {}         # cumulative, survives disarm
        self._pc = _perf("faults")

    # ------------------------------------------------------- declaration --
    def declare(self, name: str, doc: str) -> None:
        """Declare a faultpoint once, where its fire site lives.
        Idempotent for an identical doc (module re-import); a second
        declaration with a DIFFERENT doc is a name collision."""
        with self._lock:
            existing = self._declared.get(name)
            if existing is not None and existing != doc:
                raise FaultError(
                    f"faultpoint {name!r} already declared with a "
                    f"different docstring")
            self._declared[name] = doc

    def declared(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._declared)

    # ------------------------------------------------------------ arming --
    def arm(self, name: str, mode: str = "always", n: int = 0,
            seed: int = 0, count: Optional[int] = None,
            predicate: Optional[Callable] = None,
            match: Optional[Dict[str, Any]] = None,
            **params: Any) -> None:
        if mode not in MODES:
            raise FaultError(f"unknown fault mode {mode!r}; "
                             f"known: {MODES}")
        if mode == "one_in" and n < 1:
            raise FaultError(f"{name}: one_in needs n >= 1")
        if mode == "nth" and n < 1:
            raise FaultError(f"{name}: nth needs n >= 1")
        if mode == "predicate" and predicate is None:
            raise FaultError(f"{name}: predicate mode needs a callable")
        if match is not None and not isinstance(match, dict):
            # a stringly-typed match (e.g. un-parsed CLI JSON) would
            # poison every subsequent fire with an AttributeError
            raise FaultError(f"{name}: match must be a dict of "
                             f"context key -> expected value, got "
                             f"{type(match).__name__}")
        if name == "net.partition" and predicate is None:
            # partition arming carries groups, not a schedule: the
            # registry builds the membership predicate itself so the
            # asok grammar (which cannot ship callables) arms it
            predicate = _partition_predicate(params)
            mode = "predicate"
        with self._lock:
            if name not in self._declared:
                raise FaultError(
                    f"unknown faultpoint {name!r}; declared: "
                    f"{sorted(self._declared)}")
            self._armed[name] = _Armed(
                mode=mode, n=int(n), seed=int(seed), count=count,
                predicate=predicate, match=match, params=dict(params),
                rng=random.Random(seed))

    def disarm(self, name: Optional[str] = None) -> None:
        """Disarm one point (or all).  Cumulative fire counts persist."""
        with self._lock:
            if name is None:
                self._armed.clear()
            else:
                self._armed.pop(name, None)

    def reset(self) -> None:
        """Disarm everything and zero the cumulative fire tallies
        (test teardown; perf counters are reset separately)."""
        with self._lock:
            self._armed.clear()
            self._fired.clear()

    # ------------------------------------------------------------ firing --
    def fire(self, name: str, **ctx: Any) -> Optional[Dict[str, Any]]:
        """None when disarmed or the schedule says no; the armed params
        dict on a fire.  The disarmed path is one dict-miss check."""
        if name not in self._armed:
            return None
        return self._evaluate(name, ctx)

    def _evaluate(self, name: str,
                  ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        with self._lock:
            a = self._armed.get(name)
            if a is None:                      # raced a disarm
                return None
            if a.match is not None and any(
                    ctx.get(k) != v for k, v in a.match.items()):
                return None                    # wrong phase: not a call
            a.calls += 1
            if a.count is not None and a.fires >= a.count:
                return None
            if a.mode == "always":
                hit = True
            elif a.mode == "one_in":
                hit = a.rng.randrange(a.n) == 0
            elif a.mode == "nth":
                hit = a.calls == a.n
            else:                              # predicate
                hit = bool(a.predicate(ctx))
            if not hit:
                return None
            a.fires += 1
            self._fired[name] = self._fired.get(name, 0) + 1
            params = dict(a.params)
        self._pc.inc(name)                     # fire proof for tests
        return params

    # ------------------------------------------------------------- query --
    def fire_counts(self) -> Dict[str, int]:
        """Cumulative fires per faultpoint (survives disarm)."""
        with self._lock:
            return dict(self._fired)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "declared": dict(self._declared),
                "armed": {
                    name: {"mode": a.mode, "n": a.n, "seed": a.seed,
                           "count": a.count, "match": a.match,
                           "params": dict(a.params),
                           "calls": a.calls, "fires": a.fires}
                    for name, a in sorted(self._armed.items())},
                "fire_counts": dict(self._fired),
            }


_REGISTRY = FaultRegistry()


def registry() -> FaultRegistry:
    return _REGISTRY


# declared HERE (not at a single fire site): the partition cut is a
# cross-layer point — wire frames, in-process queue admission, peer
# heartbeats and quorum traffic all consult the same armed groups
registry().declare(
    "net.partition",
    "sever traffic between named daemon groups (both directions; "
    "params oneway=True cuts only groups[0] -> others) — the "
    "netsplit axis; arm with params={'groups': [[entity,...],...]}; "
    "fires count only actually-severed (src, dst) frames")


# declared HERE like net.partition: the power-loss axes are
# cross-layer points — the BlockDevice shim (cluster/blockdev.py)
# fires them on real store files, and the sim tier (SimOSD.put)
# mirrors the contract on its in-memory store, so one declaration
# covers both fire sites and the asok grammar arms either
registry().declare(
    "device.power_loss",
    "the process browns out AT a barrier (fsync never completes) — "
    "params exit=False raises PowerLoss in-process instead of dying; "
    "a POWER_LOSS marker makes the next boot run fsck(repair)")
registry().declare(
    "device.torn_write",
    "a device write persists only a prefix (params keep=bytes) and "
    "the process dies mid-write — the torn-write half of the "
    "power-loss crash model (params exit=False raises in-process)")
registry().declare(
    "device.lost_write",
    "the device acks a write that never reaches media (firmware "
    "write loss); the process continues — per-block checksums, "
    "fsck and scrub are the detectors")


def declare(name: str, doc: str) -> None:
    _REGISTRY.declare(name, doc)


def arm(name: str, mode: str = "always", **kw: Any) -> None:
    _REGISTRY.arm(name, mode=mode, **kw)


def disarm(name: Optional[str] = None) -> None:
    _REGISTRY.disarm(name)


def reset() -> None:
    _REGISTRY.reset()


def fire_counts() -> Dict[str, int]:
    return _REGISTRY.fire_counts()


def status() -> Dict[str, Any]:
    return _REGISTRY.status()


def fire(name: str, **ctx: Any) -> Optional[Dict[str, Any]]:
    """Module-level fast path: the disarmed case is ONE dict-miss
    check against the singleton's armed table (no method dispatch on
    the registry object, no lock)."""
    if name not in _REGISTRY._armed:
        return None
    return _REGISTRY._evaluate(name, ctx)


def partitioned(src: str, dst: str) -> bool:
    """True when an armed ``net.partition`` severs src -> dst traffic
    (counts a fire).  The disarmed case is one dict-miss check, so
    heartbeat/dispatch hot paths may call this unconditionally."""
    if "net.partition" not in _REGISTRY._armed:
        return False
    return _REGISTRY._evaluate("net.partition",
                               {"src": src, "dst": dst}) is not None


def admin_handler(args: Dict[str, Any]) -> Dict[str, Any]:
    """The ``fault_injection`` admin command (registered on every
    daemon's asok by AdminServer): runtime arm/disarm/status.

        {"prefix": "fault_injection"}                          -> status
        {"prefix": "fault_injection", "action": "arm",
         "name": "wire.drop_frame", "mode": "one_in",
         "n": 5, "seed": 3, "count": 2, "match": {...}}        -> arm
        {"prefix": "fault_injection", "action": "disarm",
         "name": "wire.drop_frame"}          -> disarm (no name: all)

    ``predicate`` mode is API-only: callables do not travel the wire.
    """
    action = args.get("action", "status")
    if action in ("status", "list"):
        return _REGISTRY.status()
    if action == "arm":
        mode = args.get("mode", "always")
        if mode == "predicate":
            raise ValueError("predicate mode is not armable over the "
                             "admin socket (callables don't serialize)")
        kw: Dict[str, Any] = {}
        if args.get("count") is not None:
            kw["count"] = int(args["count"])
        if args.get("match") is not None:
            kw["match"] = dict(args["match"])
        for p, v in (args.get("params") or {}).items():
            kw[p] = v
        _REGISTRY.arm(args["name"], mode=mode,
                      n=int(args.get("n", 0)),
                      seed=int(args.get("seed", 0)), **kw)
        return {"armed": args["name"], "mode": mode}
    if action == "disarm":
        _REGISTRY.disarm(args.get("name"))
        return {"disarmed": args.get("name") or "all"}
    raise ValueError(f"unknown fault_injection action {action!r} "
                     f"(status|list|arm|disarm)")
