"""Crushmap text language — compile (text -> CrushMap) and decompile.

The reference ships a boost::spirit grammar + compiler/decompiler pair
(src/crush/grammar.h, src/crush/CrushCompiler.cc) behind
`crushtool -c/-d`.  This is a hand-written recursive-descent reader for
the same language — the wire format users actually edit:

    tunable <name> <value>
    device <num> <name> [class <class>]
    type <num> <name>
    <typename> <bucketname> {
        id <negid> [class <class>]     # shadow ids per device class
        alg uniform|list|tree|straw|straw2
        hash 0
        item <name> [weight <float>] [pos <int>]
    }
    rule <name> {
        id <num>
        type replicated|erasure
        step take <bucket> [class <class>]
        step set_chooseleaf_tries <n>
        step [choose|chooseleaf] [firstn|indep] <n> type <typename>
        step emit
    }
    choose_args <key> { { bucket_id <id> weight_set [ [ ... ] ] ids [..] } }

Weights are 16.16 fixed-point in the map, printed as 5-decimal floats
(the crushtool convention).  `step take <bucket> class <c>` compiles to
the class shadow bucket (CrushWrapper device-class trees,
src/crush/CrushWrapper.h:66) — built on demand by
`crush_map.build_class_shadow`.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .crush_map import (
    ALG_BY_NAME, ALG_NAMES, HASH_RJENKINS1, RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP, RULE_EMIT,
    RULE_SET_CHOOSELEAF_STABLE, RULE_SET_CHOOSELEAF_TRIES,
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, RULE_SET_CHOOSE_LOCAL_TRIES,
    RULE_SET_CHOOSE_TRIES, RULE_SET_CHOOSELEAF_VARY_R, RULE_TAKE,
    Bucket, ChooseArg, CrushMap, Rule, Tunables,
)

_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable",
             "straw_calc_version", "allowed_bucket_algs")

_RULE_TYPES = {1: "replicated", 3: "erasure"}
_RULE_TYPE_IDS = {v: k for k, v in _RULE_TYPES.items()}
# legacy spellings accepted by the reference compiler
_RULE_TYPE_IDS["msr_indep"] = 3


class CompileError(ValueError):
    def __init__(self, msg: str, line: Optional[int] = None):
        super().__init__(f"line {line}: {msg}" if line else msg)
        self.line = line


def _fmt_weight(w: int) -> str:
    return f"{w / 0x10000:.5f}"


def _parse_weight(tok: str, line: int) -> int:
    try:
        v = float(tok)
    except ValueError:
        raise CompileError(f"bad weight {tok!r}", line) from None
    if v < 0:
        raise CompileError(f"negative weight {tok!r}", line)
    return int(round(v * 0x10000))


class _Tokens:
    """Token stream with line tracking; comments stripped."""

    def __init__(self, text: str):
        self.toks: List[Tuple[str, int]] = []
        for ln, raw in enumerate(text.splitlines(), 1):
            body = raw.split("#", 1)[0]
            # brackets/braces are their own tokens
            body = re.sub(r"([{}\[\]])", r" \1 ", body)
            for tok in body.split():
                self.toks.append((tok, ln))
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos][0] if self.pos < len(self.toks) else None

    def line(self) -> int:
        if self.pos < len(self.toks):
            return self.toks[self.pos][1]
        return self.toks[-1][1] if self.toks else 0

    def next(self, what: str = "token") -> str:
        if self.pos >= len(self.toks):
            raise CompileError(f"unexpected end of input, wanted {what}",
                               self.line())
        tok, _ = self.toks[self.pos]
        self.pos += 1
        return tok

    def expect(self, want: str) -> None:
        tok = self.next(repr(want))
        if tok != want:
            raise CompileError(f"expected {want!r}, got {tok!r}",
                               self.toks[self.pos - 1][1])

    def next_int(self, what: str = "integer") -> int:
        tok = self.next(what)
        try:
            return int(tok)
        except ValueError:
            raise CompileError(f"expected {what}, got {tok!r}",
                               self.toks[self.pos - 1][1]) from None


# ------------------------------------------------------------------ compile --

class CrushCompiler:
    """text -> CrushMap (one-shot; use compile_crushmap())."""

    def __init__(self, text: str):
        self.t = _Tokens(text)
        self.map = CrushMap(tunables=Tunables())
        self.tunables: Dict[str, int] = {}
        self.name_to_id: Dict[str, int] = {}
        self.type_by_name: Dict[str, int] = {}
        self.class_ids: Dict[Tuple[int, str], int] = {}  # (bucket, class)

    def compile(self) -> CrushMap:
        while (tok := self.t.peek()) is not None:
            if tok == "tunable":
                self._tunable()
            elif tok == "device":
                self._device()
            elif tok == "type":
                self._type()
            elif tok == "rule":
                self._rule()
            elif tok == "choose_args":
                self._choose_args()
            elif tok in self.type_by_name:
                self._bucket()
            else:
                raise CompileError(f"unknown directive {tok!r}",
                                   self.t.line())
        if self.tunables:
            known = {k: v for k, v in self.tunables.items()
                     if k in Tunables.__dataclass_fields__}
            self.map.tunables = Tunables(**known)
        # build shadows for every declared (bucket, class) pair that no
        # rule forced yet, so declared shadow ids survive a round-trip
        for (bid, cls) in list(self.class_ids):
            if (bid, cls) not in self.map.class_bucket_ids:
                self.map.build_class_shadow(bid, cls,
                                            preferred_ids=self.class_ids)
        self.map.finalize()
        return self.map

    def _tunable(self) -> None:
        self.t.expect("tunable")
        name = self.t.next("tunable name")
        val = self.t.next_int("tunable value")
        if name not in _TUNABLES:
            raise CompileError(f"unknown tunable {name!r}", self.t.line())
        self.tunables[name] = val

    def _device(self) -> None:
        self.t.expect("device")
        num = self.t.next_int("device number")
        name = self.t.next("device name")
        if num < 0:
            raise CompileError("device ids are non-negative", self.t.line())
        self.map.device_names[num] = name
        self.name_to_id[name] = num
        self.map.max_devices = max(self.map.max_devices, num + 1)
        if self.t.peek() == "class":
            self.t.next()
            self.map.device_classes[num] = self.t.next("class name")

    def _type(self) -> None:
        self.t.expect("type")
        num = self.t.next_int("type number")
        name = self.t.next("type name")
        self.map.type_names[num] = name
        self.type_by_name[name] = num

    def _bucket(self) -> None:
        type_name = self.t.next()
        btype = self.type_by_name[type_name]
        name = self.t.next("bucket name")
        if name in self.name_to_id:
            raise CompileError(f"duplicate name {name!r}", self.t.line())
        self.t.expect("{")
        bid: Optional[int] = None
        alg = None
        hash_ = HASH_RJENKINS1
        shadow: Dict[str, int] = {}
        items: List[int] = []
        weights: List[int] = []
        filled: set = set()
        while (tok := self.t.peek()) != "}":
            if tok is None:
                raise CompileError("unterminated bucket", self.t.line())
            if tok == "id":
                self.t.next()
                i = self.t.next_int("bucket id")
                if i >= 0:
                    raise CompileError("bucket ids are negative",
                                       self.t.line())
                if self.t.peek() == "class":
                    self.t.next()
                    shadow[self.t.next("class name")] = i
                else:
                    bid = i
            elif tok == "alg":
                self.t.next()
                alg_name = self.t.next("alg")
                if alg_name not in ALG_BY_NAME:
                    raise CompileError(f"unknown alg {alg_name!r}",
                                       self.t.line())
                alg = ALG_BY_NAME[alg_name]
            elif tok == "hash":
                self.t.next()
                h = self.t.next("hash")
                if h == "rjenkins1":
                    hash_ = 0
                else:
                    try:
                        hash_ = int(h)
                    except ValueError:
                        raise CompileError(f"unknown hash {h!r}",
                                           self.t.line()) from None
            elif tok == "item":
                self.t.next()
                iname = self.t.next("item name")
                if iname not in self.name_to_id:
                    raise CompileError(f"item {iname!r} not defined",
                                       self.t.line())
                iid = self.name_to_id[iname]
                w = 0
                pos = len(items)
                while self.t.peek() in ("weight", "pos"):
                    key = self.t.next()
                    if key == "weight":
                        w = _parse_weight(self.t.next("weight"),
                                          self.t.line())
                    else:
                        pos = self.t.next_int("pos")
                if iid < 0 and w == 0:
                    child = self.map.bucket(iid)
                    w = child.weight if child is not None else 0
                if pos in filled:
                    raise CompileError(f"item pos {pos} used twice",
                                       self.t.line())
                while len(items) <= pos:
                    items.append(0)
                    weights.append(0)
                items[pos] = iid
                weights[pos] = w
                filled.add(pos)
            else:
                raise CompileError(f"unknown bucket field {tok!r}",
                                   self.t.line())
        self.t.expect("}")
        if alg is None:
            raise CompileError(f"bucket {name!r} has no alg", self.t.line())
        if len(filled) != len(items):
            missing = [p for p in range(len(items)) if p not in filled]
            raise CompileError(
                f"bucket {name!r}: item pos {missing} never filled "
                "(phantom slots)", self.t.line())
        if bid is None:
            bid = self.map.next_bucket_id()
        b = Bucket(id=bid, alg=alg, type=btype, items=items,
                   weights=weights, hash=hash_)
        self.map.add_bucket(b)
        self.map.bucket_names[bid] = name
        self.name_to_id[name] = bid
        for cls, sid in shadow.items():
            self.class_ids[(bid, cls)] = sid

    def _rule(self) -> None:
        self.t.expect("rule")
        name = self.t.next("rule name")
        self.t.expect("{")
        ruleno = -1
        rtype = 1
        min_size, max_size = 1, 10
        steps: List[Tuple[int, int, int]] = []
        while (tok := self.t.peek()) != "}":
            if tok is None:
                raise CompileError("unterminated rule", self.t.line())
            if tok in ("id", "ruleset"):      # ruleset = legacy spelling
                self.t.next()
                ruleno = self.t.next_int("rule id")
            elif tok == "type":
                self.t.next()
                tname = self.t.next("rule type")
                if tname not in _RULE_TYPE_IDS:
                    raise CompileError(f"unknown rule type {tname!r}",
                                       self.t.line())
                rtype = _RULE_TYPE_IDS[tname]
            elif tok == "min_size":
                self.t.next()
                min_size = self.t.next_int()
            elif tok == "max_size":
                self.t.next()
                max_size = self.t.next_int()
            elif tok == "step":
                self.t.next()
                steps.append(self._step())
            else:
                raise CompileError(f"unknown rule field {tok!r}",
                                   self.t.line())
        self.t.expect("}")
        rule = Rule(steps=steps, name=name, type=rtype,
                    min_size=min_size, max_size=max_size)
        if ruleno < 0:
            ruleno = self.map.max_rules
        if ruleno < self.map.max_rules and \
                self.map.rules[ruleno] is not None:
            raise CompileError(f"duplicate rule id {ruleno}",
                               self.t.line())
        self.map.add_rule(rule, ruleno)

    def _step(self) -> Tuple[int, int, int]:
        op = self.t.next("step op")
        if op == "take":
            bname = self.t.next("bucket name")
            if bname not in self.name_to_id:
                raise CompileError(f"take: unknown bucket {bname!r}",
                                   self.t.line())
            bid = self.name_to_id[bname]
            if self.t.peek() == "class":
                self.t.next()
                cls = self.t.next("class name")
                bid = self.map.build_class_shadow(
                    bid, cls, preferred_ids=self.class_ids)
            return (RULE_TAKE, bid, 0)
        if op == "emit":
            return (RULE_EMIT, 0, 0)
        if op in ("set_choose_tries", "set_chooseleaf_tries",
                  "set_choose_local_tries",
                  "set_choose_local_fallback_tries",
                  "set_chooseleaf_vary_r", "set_chooseleaf_stable"):
            val = self.t.next_int()
            opcode = {
                "set_choose_tries": RULE_SET_CHOOSE_TRIES,
                "set_chooseleaf_tries": RULE_SET_CHOOSELEAF_TRIES,
                "set_choose_local_tries": RULE_SET_CHOOSE_LOCAL_TRIES,
                "set_choose_local_fallback_tries":
                    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                "set_chooseleaf_vary_r": RULE_SET_CHOOSELEAF_VARY_R,
                "set_chooseleaf_stable": RULE_SET_CHOOSELEAF_STABLE,
            }[op]
            return (opcode, val, 0)
        if op in ("choose", "chooseleaf"):
            mode = self.t.next("firstn|indep")
            if mode not in ("firstn", "indep"):
                raise CompileError(f"expected firstn|indep, got {mode!r}",
                                   self.t.line())
            n = self.t.next_int("count")
            self.t.expect("type")
            tname = self.t.next("type name")
            if tname not in self.type_by_name:
                raise CompileError(f"unknown type {tname!r}", self.t.line())
            ttype = self.type_by_name[tname]
            opcode = {
                ("choose", "firstn"): RULE_CHOOSE_FIRSTN,
                ("choose", "indep"): RULE_CHOOSE_INDEP,
                ("chooseleaf", "firstn"): RULE_CHOOSELEAF_FIRSTN,
                ("chooseleaf", "indep"): RULE_CHOOSELEAF_INDEP,
            }[(op, mode)]
            return (opcode, n, ttype)
        raise CompileError(f"unknown step {op!r}", self.t.line())

    def _choose_args(self) -> None:
        self.t.expect("choose_args")
        key_tok = self.t.next("choose_args key")
        try:
            key: object = int(key_tok)
        except ValueError:
            key = key_tok
        self.t.expect("{")
        args: List[Optional[ChooseArg]] = \
            [None] * len(self.map.buckets)
        while self.t.peek() == "{":
            self.t.next()
            bucket_id = None
            weight_set = None
            ids = None
            while (tok := self.t.peek()) != "}":
                if tok is None:
                    raise CompileError("unterminated choose_args entry",
                                       self.t.line())
                if tok == "bucket_id":
                    self.t.next()
                    bucket_id = self.t.next_int("bucket id")
                elif tok == "weight_set":
                    self.t.next()
                    weight_set = self._weight_set()
                elif tok == "ids":
                    self.t.next()
                    ids = self._int_list()
                else:
                    raise CompileError(
                        f"unknown choose_args field {tok!r}", self.t.line())
            self.t.expect("}")
            if bucket_id is None or bucket_id >= 0:
                raise CompileError("choose_args entry needs bucket_id",
                                   self.t.line())
            idx = -1 - bucket_id
            while len(args) <= idx:
                args.append(None)
            args[idx] = ChooseArg(ids=ids, weight_set=weight_set)
        self.t.expect("}")
        self.map.choose_args[key] = args

    def _weight_set(self) -> List[List[int]]:
        self.t.expect("[")
        out: List[List[int]] = []
        while self.t.peek() == "[":
            self.t.next()
            row: List[int] = []
            while self.t.peek() != "]":
                row.append(_parse_weight(self.t.next("weight"),
                                         self.t.line()))
            self.t.expect("]")
            out.append(row)
        self.t.expect("]")
        return out

    def _int_list(self) -> List[int]:
        self.t.expect("[")
        out: List[int] = []
        while self.t.peek() != "]":
            out.append(self.t.next_int())
        self.t.expect("]")
        return out


def compile_crushmap(text: str) -> CrushMap:
    return CrushCompiler(text).compile()


# ---------------------------------------------------------------- decompile --

def _item_name(cmap: CrushMap, iid: int) -> str:
    if iid >= 0:
        return cmap.device_names.get(iid, f"osd.{iid}")
    return cmap.bucket_names.get(iid, f"bucket{-1 - iid}")


def decompile_crushmap(cmap: CrushMap) -> str:
    """CrushMap -> canonical text (crushtool -d shape); shadow buckets
    (negative ids created for device classes) are folded back into
    `id ... class ...` lines + `step take ... class ...` steps."""
    shadow_ids = getattr(cmap, "class_bucket_ids", {}) or {}
    shadow_rev: Dict[int, Tuple[int, str]] = {
        sid: (bid, cls) for (bid, cls), sid in shadow_ids.items()}
    out: List[str] = ["# begin crush map"]
    for name in _TUNABLES:
        val = getattr(cmap.tunables, name, None)
        if val is not None:
            out.append(f"tunable {name} {val}")
    out.append("")
    out.append("# devices")
    for d in range(cmap.max_devices):
        name = cmap.device_names.get(d, f"osd.{d}")
        cls = cmap.device_classes.get(d)
        out.append(f"device {d} {name}" + (f" class {cls}" if cls else ""))
    out.append("")
    out.append("# types")
    # declare every type referenced by a bucket or a choose step, even
    # when the map carries no names — `-d` output must always recompile
    referenced = {0}
    for b in cmap.buckets:
        if b is not None:
            referenced.add(b.type)
    for rule in cmap.rules:
        if rule is None:
            continue
        for op, a1, a2 in rule.steps:
            if op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                      RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
                referenced.add(a2)
    for num in sorted(referenced | set(cmap.type_names)):
        out.append(f"type {num} "
                   f"{cmap.type_names.get(num, f'type{num}')}")
    out.append("")
    out.append("# buckets")
    # children before parents so the compiler can resolve item names
    emitted: set = set()

    def emit_bucket(b: Bucket) -> None:
        if b.id in emitted or b.id in shadow_rev:
            return
        emitted.add(b.id)
        for iid in b.items:
            if iid < 0:
                child = cmap.bucket(iid)
                if child is not None:
                    emit_bucket(child)
        tname = cmap.type_names.get(b.type, f"type{b.type}")
        out.append(f"{tname} {_item_name(cmap, b.id)} {{")
        out.append(f"\tid {b.id}\t\t# do not change unnecessarily")
        for (bid, cls), sid in sorted(shadow_ids.items()):
            if bid == b.id:
                out.append(f"\tid {sid} class {cls}\t\t"
                           "# do not change unnecessarily")
        out.append(f"\t# weight {_fmt_weight(b.weight)}")
        out.append(f"\talg {ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}" +
                   ("\t# rjenkins1" if b.hash == 0 else ""))
        for pos, (iid, w) in enumerate(zip(b.items, b.weights)):
            wv = b.item_weight(pos)
            out.append(f"\titem {_item_name(cmap, iid)} "
                       f"weight {_fmt_weight(wv)}")
        out.append("}")

    for b in cmap.buckets:
        if b is not None:
            emit_bucket(b)
    out.append("")
    out.append("# rules")
    for ruleno, rule in enumerate(cmap.rules):
        if rule is None:
            continue
        name = rule.name or f"rule-{ruleno}"
        out.append(f"rule {name} {{")
        out.append(f"\tid {ruleno}")
        out.append(f"\ttype {_RULE_TYPES.get(rule.type, 'replicated')}")
        out.append(f"\tmin_size {rule.min_size}")
        out.append(f"\tmax_size {rule.max_size}")
        for op, a1, a2 in rule.steps:
            if op == RULE_TAKE:
                if a1 in shadow_rev:
                    bid, cls = shadow_rev[a1]
                    out.append(f"\tstep take {_item_name(cmap, bid)} "
                               f"class {cls}")
                else:
                    out.append(f"\tstep take {_item_name(cmap, a1)}")
            elif op == RULE_EMIT:
                out.append("\tstep emit")
            elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
                kind = "choose" if op in (RULE_CHOOSE_FIRSTN,
                                          RULE_CHOOSE_INDEP) else "chooseleaf"
                mode = "firstn" if op in (RULE_CHOOSE_FIRSTN,
                                          RULE_CHOOSELEAF_FIRSTN) else "indep"
                tname = cmap.type_names.get(a2, f"type{a2}")
                out.append(f"\tstep {kind} {mode} {a1} type {tname}")
            else:
                opname = {
                    RULE_SET_CHOOSE_TRIES: "set_choose_tries",
                    RULE_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
                    RULE_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
                    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                        "set_choose_local_fallback_tries",
                    RULE_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
                    RULE_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
                }.get(op)
                if opname is None:
                    raise CompileError(f"cannot decompile op {op}")
                out.append(f"\tstep {opname} {a1}")
        out.append("}")
    if cmap.choose_args:
        out.append("")
        for key in sorted(cmap.choose_args, key=str):
            args = cmap.choose_args[key]
            out.append(f"choose_args {key} {{")
            for idx, arg in enumerate(args):
                if arg is None:
                    continue
                out.append("  {")
                out.append(f"    bucket_id {-1 - idx}")
                if arg.weight_set:
                    out.append("    weight_set [")
                    for row in arg.weight_set:
                        vals = " ".join(_fmt_weight(w) for w in row)
                        out.append(f"      [ {vals} ]")
                    out.append("    ]")
                if arg.ids:
                    vals = " ".join(str(i) for i in arg.ids)
                    out.append(f"    ids [ {vals} ]")
                out.append("  }")
            out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"
