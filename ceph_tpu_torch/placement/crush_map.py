"""CRUSH map data model: buckets, rules, tunables.

Python-native equivalent of the reference's `struct crush_map` world
(src/crush/crush.h:354-465) plus the builder math that derives per-algorithm
auxiliary arrays (src/crush/builder.c): straw lengths for STRAW buckets,
prefix sums for LIST buckets, and the interior-node weight tree for TREE
buckets.  The map is a pure value — mapping never mutates it — which is what
makes the batched TPU mapper a pure jitted function of (map, x).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

# bucket algorithms (crush.h:140-190)
BUCKET_UNIFORM = 1
BUCKET_LIST = 2
BUCKET_TREE = 3
BUCKET_STRAW = 4
BUCKET_STRAW2 = 5

ALG_NAMES = {BUCKET_UNIFORM: "uniform", BUCKET_LIST: "list", BUCKET_TREE: "tree",
             BUCKET_STRAW: "straw", BUCKET_STRAW2: "straw2"}
ALG_BY_NAME = {v: k for k, v in ALG_NAMES.items()}

HASH_RJENKINS1 = 0

# rule opcodes (crush.h:55-69)
RULE_NOOP = 0
RULE_TAKE = 1
RULE_CHOOSE_FIRSTN = 2
RULE_CHOOSE_INDEP = 3
RULE_EMIT = 4
RULE_CHOOSELEAF_FIRSTN = 6
RULE_CHOOSELEAF_INDEP = 7
RULE_SET_CHOOSE_TRIES = 8
RULE_SET_CHOOSELEAF_TRIES = 9
RULE_SET_CHOOSE_LOCAL_TRIES = 10
RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
RULE_SET_CHOOSELEAF_VARY_R = 12
RULE_SET_CHOOSELEAF_STABLE = 13

OP_NAMES = {
    RULE_NOOP: "noop", RULE_TAKE: "take", RULE_CHOOSE_FIRSTN: "choose firstn",
    RULE_CHOOSE_INDEP: "choose indep", RULE_EMIT: "emit",
    RULE_CHOOSELEAF_FIRSTN: "chooseleaf firstn", RULE_CHOOSELEAF_INDEP: "chooseleaf indep",
    RULE_SET_CHOOSE_TRIES: "set_choose_tries",
    RULE_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
    RULE_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES: "set_choose_local_fallback_tries",
    RULE_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
    RULE_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
}

ITEM_UNDEF = 0x7FFFFFFE  # crush.h:33
ITEM_NONE = 0x7FFFFFFF   # crush.h:37

WEIGHT_ONE = 0x10000     # 16.16 fixed point 1.0


@dataclass(frozen=True)
class Tunables:
    """Mapping behavior knobs (crush.h:377-447, profiles CrushWrapper.h:144-210)."""
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1
    allowed_bucket_algs: int = (1 << BUCKET_UNIFORM) | (1 << BUCKET_LIST) | \
        (1 << BUCKET_STRAW) | (1 << BUCKET_STRAW2) | (1 << BUCKET_TREE)

    @classmethod
    def profile(cls, name: str) -> "Tunables":
        profiles = {
            "argonaut": dict(choose_local_tries=2, choose_local_fallback_tries=5,
                             choose_total_tries=19, chooseleaf_descend_once=0,
                             chooseleaf_vary_r=0, chooseleaf_stable=0),
            "bobtail": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                            choose_total_tries=50, chooseleaf_descend_once=1,
                            chooseleaf_vary_r=0, chooseleaf_stable=0),
            "firefly": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                            choose_total_tries=50, chooseleaf_descend_once=1,
                            chooseleaf_vary_r=1, chooseleaf_stable=0),
            "hammer": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                           choose_total_tries=50, chooseleaf_descend_once=1,
                           chooseleaf_vary_r=1, chooseleaf_stable=0),
            "jewel": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                          choose_total_tries=50, chooseleaf_descend_once=1,
                          chooseleaf_vary_r=1, chooseleaf_stable=1),
        }
        profiles["legacy"] = profiles["argonaut"]
        profiles["optimal"] = profiles["jewel"]
        profiles["default"] = profiles["jewel"]
        return cls(**profiles[name])


# -------------------------------------------------------------- builders ----

def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _tree_parent(n: int) -> int:
    h = _tree_height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


def tree_left(n: int) -> int:
    return n - (1 << (_tree_height(n) - 1))


def tree_right(n: int) -> int:
    return n + (1 << (_tree_height(n) - 1))


def _calc_tree_depth(size: int) -> int:
    if size == 0:
        return 0
    depth, t = 1, size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


def calc_straws(weights: Sequence[int], version: int) -> List[int]:
    """straw-v1 scaler (builder.c:431-547) — kept for legacy STRAW buckets."""
    size = len(weights)
    # stable reverse-sort by weight, insertion order preserved for equals
    reverse = list(range(size))
    reverse.sort(key=lambda i: (weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        ri = reverse[i]
        if version == 0:
            if weights[ri] == 0:
                straws[ri] = 0
                i += 1
                continue
            straws[ri] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if weights[reverse[i]] == weights[reverse[i - 1]]:
                continue
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            j = i
            while j < size:
                if weights[reverse[j]] == weights[reverse[i]]:
                    numleft -= 1
                else:
                    break
                j += 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
        else:
            if weights[ri] == 0:
                straws[ri] = 0
                i += 1
                numleft -= 1
                continue
            straws[ri] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
    return straws


@dataclass
class Bucket:
    """One interior node of the CRUSH hierarchy (crush.h:229-341)."""
    id: int                      # negative
    alg: int
    type: int                    # user-defined type (0 = device)
    items: List[int]
    weights: List[int]           # 16.16 fixed per item (uniform: weights[0] applies)
    hash: int = HASH_RJENKINS1
    # derived (filled by finalize_derived)
    straws: Optional[List[int]] = None        # STRAW
    sum_weights: Optional[List[int]] = None   # LIST prefix sums
    node_weights: Optional[List[int]] = None  # TREE interior nodes
    num_nodes: int = 0

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        if self.alg == BUCKET_UNIFORM:
            return (self.weights[0] if self.weights else 0) * self.size
        return sum(self.weights)

    def item_weight(self, pos: int) -> int:
        if self.alg == BUCKET_UNIFORM:
            return self.weights[0] if self.weights else 0
        return self.weights[pos]

    def finalize_derived(self, straw_calc_version: int) -> None:
        # derived tables are __u32 in the reference (crush.h
        # crush_bucket_list::sum_weights, crush_bucket_tree::node_weights,
        # crush_bucket_straw::straws, filled by builder.c) — wrap to
        # mod-2^32 HERE so every consumer (scalar oracle, xla mapper,
        # native bridge) sees identical u32 semantics
        if self.alg == BUCKET_LIST:
            acc, sums = 0, []
            for w in self.weights:
                acc = (acc + w) & 0xFFFFFFFF
                sums.append(acc)
            self.sum_weights = sums
        elif self.alg == BUCKET_TREE:
            depth = _calc_tree_depth(self.size)
            self.num_nodes = 1 << depth
            nw = [0] * self.num_nodes
            for i, w in enumerate(self.weights):
                node = ((i + 1) << 1) - 1
                nw[node] = w & 0xFFFFFFFF
                for _ in range(1, depth):
                    node = _tree_parent(node)
                    nw[node] = (nw[node] + w) & 0xFFFFFFFF
            self.node_weights = nw
        elif self.alg == BUCKET_STRAW:
            self.straws = [s & 0xFFFFFFFF
                           for s in calc_straws(self.weights,
                                                straw_calc_version)]


@dataclass
class ChooseArg:
    """Per-bucket positional weight-set override (crush.h choose_args;
    consumed at mapper.c:309-326)."""
    ids: Optional[List[int]] = None
    weight_set: Optional[List[List[int]]] = None  # [position][item] 16.16


@dataclass
class Rule:
    """A compiled placement rule: a list of (op, arg1, arg2) steps."""
    steps: List[Tuple[int, int, int]]
    name: str = ""
    ruleset: int = 0
    type: int = 1          # 1 replicated, 3 erasure (pool semantics)
    min_size: int = 1
    max_size: int = 10


@dataclass
class CrushMap:
    """The full placement policy value.

    `buckets[i]` holds bucket with id `-1-i` (may be None);
    devices are non-negative ids < max_devices.
    """
    buckets: List[Optional[Bucket]] = field(default_factory=list)
    rules: List[Optional[Rule]] = field(default_factory=list)
    tunables: Tunables = field(default_factory=Tunables)
    max_devices: int = 0
    choose_args: Dict[object, List[Optional[ChooseArg]]] = field(default_factory=dict)
    # CrushWrapper-level metadata (names, types, device classes)
    type_names: Dict[int, str] = field(default_factory=dict)
    bucket_names: Dict[int, str] = field(default_factory=dict)
    device_names: Dict[int, str] = field(default_factory=dict)
    device_classes: Dict[int, str] = field(default_factory=dict)
    # (original bucket id, class) -> shadow bucket id (CrushWrapper.h:66
    # class_bucket equivalent; shadow trees are materialized as ordinary
    # buckets so every mapper handles device classes natively)
    class_bucket_ids: Dict[Tuple[int, str], int] = field(default_factory=dict)

    # ------------------------------------------------------------- build ----

    def bucket(self, bid: int) -> Optional[Bucket]:
        idx = -1 - bid
        if idx < 0 or idx >= len(self.buckets):
            return None
        return self.buckets[idx]

    def add_bucket(self, bucket: Bucket) -> int:
        if bucket.id >= 0:
            raise ValueError("bucket ids must be negative")
        idx = -1 - bucket.id
        while len(self.buckets) <= idx:
            self.buckets.append(None)
        if self.buckets[idx] is not None:
            raise ValueError(f"bucket id {bucket.id} already in use")
        self.buckets[idx] = bucket
        return bucket.id

    def next_bucket_id(self) -> int:
        for i, b in enumerate(self.buckets):
            if b is None:
                return -1 - i
        return -1 - len(self.buckets)

    def add_rule(self, rule: Rule, ruleno: int = -1) -> int:
        if ruleno < 0:
            ruleno = len(self.rules)
        while len(self.rules) <= ruleno:
            self.rules.append(None)
        self.rules[ruleno] = rule
        return ruleno

    def finalize(self) -> None:
        """Compute max_devices and per-bucket derived arrays (builder.c:crush_finalize)."""
        maxdev = 0
        for b in self.buckets:
            if b is None:
                continue
            for it in b.items:
                if it >= 0:
                    maxdev = max(maxdev, it + 1)
            b.finalize_derived(self.tunables.straw_calc_version)
        self.max_devices = max(self.max_devices, maxdev)

    def build_class_shadow(self, root_id: int, cls: str,
                           preferred_ids: Optional[Dict[Tuple[int, str],
                                                        int]] = None) -> int:
        """Clone the hierarchy under ``root_id`` keeping only devices of
        device class ``cls`` (CrushWrapper device_class_clone semantics:
        per-class shadow trees that `step take <bucket> class <cls>`
        selects from; reference src/crush/CrushWrapper.h:66 class_bucket,
        CrushWrapper.cc device_class_clone).

        The shadow is materialized as ordinary buckets (same alg/hash,
        filtered items, reweighted interiors), so the scalar and batched
        mappers need no class awareness.  Idempotent per (bucket, class);
        ``preferred_ids`` pins shadow ids (the compiler's `id -N class c`
        lines).
        """
        if self.bucket(root_id) is None:
            raise ValueError(f"no bucket {root_id}")
        prefer = preferred_ids or {}

        def clone(bid: int) -> int:
            key = (bid, cls)
            if key in self.class_bucket_ids:
                return self.class_bucket_ids[key]
            b = self.bucket(bid)
            items: List[int] = []
            weights: List[int] = []
            for pos, it in enumerate(b.items):
                if it >= 0:
                    if self.device_classes.get(it) == cls:
                        items.append(it)
                        weights.append(b.item_weight(pos))
                elif self.bucket(it) is not None:
                    sid = clone(it)
                    sb = self.bucket(sid)
                    items.append(sid)
                    weights.append(sb.weight)
            sid = prefer.get(key)
            if sid is not None and self.bucket(sid) is not None:
                raise ValueError(
                    f"shadow id {sid} for ({bid}, {cls!r}) collides with "
                    "an existing bucket")
            if sid is None:
                sid = self.next_bucket_id()
            shadow = Bucket(id=sid, alg=b.alg, type=b.type, items=items,
                            weights=weights, hash=b.hash)
            shadow.finalize_derived(self.tunables.straw_calc_version)
            self.add_bucket(shadow)
            name = self.bucket_names.get(bid, f"bucket{-1 - bid}")
            self.bucket_names[sid] = f"{name}~{cls}"
            self.class_bucket_ids[key] = sid
            return sid

        return clone(root_id)

    @property
    def max_buckets(self) -> int:
        return len(self.buckets)

    @property
    def max_rules(self) -> int:
        return len(self.rules)

    # -------------------------------------------------------------- spec ----

    @classmethod
    def from_spec(cls, spec: dict) -> "CrushMap":
        """Build from the plain-dict format used by tests/golden vectors."""
        tun = Tunables(**{k: v for k, v in spec.get("tunables", {}).items()
                          if k in Tunables.__dataclass_fields__})
        if "straw_calc_version" not in spec.get("tunables", {}):
            # the golden generator builds via crush_create() which defaults to 0
            tun = replace(tun, straw_calc_version=0)
        m = cls(tunables=tun)
        for b in spec["buckets"]:
            m.add_bucket(Bucket(id=b["id"], alg=b["alg"], type=b["type"],
                                items=list(b["items"]), weights=list(b["weights"]),
                                hash=b.get("hash", HASH_RJENKINS1)))
        rules = spec.get("rules", [])
        for ruleno, r in enumerate(rules):
            if r is None:
                continue
            m.add_rule(Rule(steps=[tuple(s) for s in r["steps"]],
                            name=r.get("name", ""),
                            type=r.get("type", 1),
                            min_size=r.get("min_size", 1),
                            max_size=r.get("max_size", 10)),
                       r.get("id", ruleno))
        m.type_names = {int(k): v
                        for k, v in spec.get("type_names", {}).items()}
        m.bucket_names = {int(k): v
                          for k, v in spec.get("bucket_names", {}).items()}
        m.device_names = {int(k): v
                          for k, v in spec.get("device_names", {}).items()}
        m.device_classes = {int(k): v
                            for k, v in spec.get("device_classes",
                                                 {}).items()}
        m.class_bucket_ids = {(int(e["bucket"]), e["class"]): int(e["shadow"])
                              for e in spec.get("class_bucket_ids", [])}
        for key, entries in spec.get("choose_args", {}).items():
            args: List[Optional[ChooseArg]] = [None] * len(m.buckets)
            for e in entries:
                idx = -1 - int(e["bucket_id"])
                while len(args) <= idx:
                    args.append(None)
                args[idx] = ChooseArg(
                    ids=list(e["ids"]) if e.get("ids") else None,
                    weight_set=[list(row) for row in e["weight_set"]]
                    if e.get("weight_set") else None)
            try:
                k2: object = int(key)
            except (TypeError, ValueError):
                k2 = key
            m.choose_args[k2] = args
        if "num_devices" in spec:
            m.max_devices = max(m.max_devices, int(spec["num_devices"]))
        m.finalize()
        return m

    def to_spec(self) -> dict:
        spec = {
            "tunables": {k: getattr(self.tunables, k)
                         for k in Tunables.__dataclass_fields__},
            "buckets": [
                {"id": b.id, "alg": b.alg, "type": b.type, "hash": b.hash,
                 "items": list(b.items), "weights": list(b.weights)}
                for b in self.buckets if b is not None],
            "rules": [{"id": i, "steps": [list(s) for s in r.steps],
                       "name": r.name, "type": r.type,
                       "min_size": r.min_size, "max_size": r.max_size}
                      for i, r in enumerate(self.rules) if r is not None],
            "num_devices": self.max_devices,
        }
        if self.type_names:
            spec["type_names"] = {str(k): v
                                  for k, v in self.type_names.items()}
        if self.bucket_names:
            spec["bucket_names"] = {str(k): v
                                    for k, v in self.bucket_names.items()}
        if self.device_names:
            spec["device_names"] = {str(k): v
                                    for k, v in self.device_names.items()}
        if self.device_classes:
            spec["device_classes"] = {str(k): v
                                      for k, v in self.device_classes.items()}
        if self.class_bucket_ids:
            spec["class_bucket_ids"] = [
                {"bucket": b, "class": c, "shadow": s}
                for (b, c), s in sorted(self.class_bucket_ids.items())]
        if self.choose_args:
            spec["choose_args"] = {
                str(key): [{"bucket_id": -1 - idx,
                            "weight_set": arg.weight_set,
                            "ids": arg.ids}
                           for idx, arg in enumerate(args)
                           if arg is not None]
                for key, args in self.choose_args.items()}
        return spec
