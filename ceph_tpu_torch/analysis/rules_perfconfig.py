"""CTL4xx — perf-counter / config registry hygiene.

The runtime halves of these contracts already fail loudly:
``Options.get`` raises OptionError on an unknown key, and the perf
registry makes declared counter types immutable (a typo'd ``set()`` on
a COUNTER raises).  But both only fire when the offending line RUNS — a
misspelled config key on an error path or a tinc/hinc type clash
between two modules can sit untested for months.  These rules find the
same contract breaks across the whole tree at lint time.

  CTL401  config key read/set at a call site but absent from the
          Option table (common/options.py or any register site)
  CTL402  one perf counter key driven with conflicting types
          (inc vs tinc vs hinc vs set) across the tree
  CTL403  perf counter key read (.get) but never updated anywhere
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import astutil
from .core import Finding, ParsedModule, Rule

# receivers accepted as "the options registry" at a read site
_CFG_RECV = {"config()", "_config()", "cfg", "self.cfg", "conf"}
_CFG_METHODS = {"get", "set", "observe", "clear"}

# perf handle method -> allowed counter types ('*' = read)
_PC_METHODS = {
    "inc": ("counter", "gauge"),
    "add_counter": ("counter",),
    "set": ("gauge",),
    "add_gauge": ("gauge",),
    "tinc": ("time_avg",),
    "add_time_avg": ("time_avg",),
    "time": ("time_avg",),
    "hinc": ("histogram",),
    "add_histogram": ("histogram",),
}
_PC_READS = {"get", "type_of", "histogram"}


def _str_arg(call: ast.Call, idx: int = 0) -> Optional[str]:
    if len(call.args) > idx and \
            isinstance(call.args[idx], ast.Constant) and \
            isinstance(call.args[idx].value, str):
        return call.args[idx].value
    return None


class ConfigKeyRule(Rule):
    rule_id = "CTL401"
    name = "config-key-undeclared"
    description = ("config key used at a call site but never declared "
                   "in the Option table")

    def __init__(self) -> None:
        self.declared: Set[str] = set()
        # key -> list of (relpath, line)
        self.reads: Dict[str, List[Tuple[str, int]]] = {}

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = astutil.dotted(node.func)
            # declarations: Option("name", ...) anywhere (incl. tests
            # registering scratch options — evidence counts)
            if fname and fname.rsplit(".", 1)[-1] == "Option":
                key = _str_arg(node)
                if key:
                    self.declared.add(key)
                continue
            if mod.evidence:
                continue
            # reads: config().get("k") / cfg.set("k", v) / _cfg("k")
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _CFG_METHODS:
                try:
                    recv = ast.unparse(node.func.value)
                except Exception:      # pragma: no cover
                    recv = ""
                if recv in _CFG_RECV:
                    key = _str_arg(node)
                    if key:
                        self.reads.setdefault(key, []).append(
                            (mod.relpath, node.lineno))
            elif fname in ("_cfg", "cfg"):
                key = _str_arg(node)
                if key:
                    self.reads.setdefault(key, []).append(
                        (mod.relpath, node.lineno))
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for key in sorted(set(self.reads) - self.declared):
            for path, line in self.reads[key]:
                out.append(Finding(
                    self.rule_id, path, line,
                    f"config key {key!r} is not declared in the "
                    f"Option table (common/options.py) — "
                    f"Options.get would raise OptionError at "
                    f"runtime"))
        return out


class _PerfUsages(ast.NodeVisitor):
    """Collect (group, key, method) perf-counter usages in a module.

    Handles the tree's three binding idioms::

        pc = _perf("crush.mapper"); pc.inc("lanes")
        self._pc = _perf("osd.service"); ... self._pc.hinc(...)
        _perf("op_tracker").inc("slow_ops")
    """

    def __init__(self, aliases: Dict[str, str]):
        self.aliases = aliases
        self.perf_names = {"perf", "_perf"} | {
            local for local, full in aliases.items()
            if full.endswith("perf_counters.perf")}
        self.cls: Optional[str] = None
        self.binds: Dict[Tuple[str, Optional[str], str], str] = {}
        # (group, key, method, line)
        self.usages: List[Tuple[str, str, str, int]] = []

    @classmethod
    def of(cls, mod: ParsedModule) -> List[Tuple[str, str, str, int]]:
        """Per-module usage list, computed once and shared by the
        CTL402/CTL403 rules (same pattern as astutil.hot_functions)."""
        cached = mod._cache.get("perf_usages")
        if cached is None:
            v = cls(astutil.aliases_of(mod))
            v.visit(mod.tree)
            cached = mod._cache["perf_usages"] = v.usages
        return cached

    def _group_of_call(self, call: ast.Call) -> Optional[str]:
        fname = astutil.dotted(call.func)
        if fname is None:
            return None
        if fname.rsplit(".", 1)[-1] in self.perf_names or \
                fname in self.perf_names:
            return _str_arg(call)
        return None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            group = self._group_of_call(node.value)
            if group:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.binds[("name", None, tgt.id)] = group
                    elif isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        self.binds[("self", self.cls,
                                    tgt.attr)] = group
        self.generic_visit(node)

    def _resolve_handle(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Call):
            return self._group_of_call(expr)
        if isinstance(expr, ast.Name):
            return self.binds.get(("name", None, expr.id))
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return self.binds.get(("self", self.cls, expr.attr))
        return None

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and \
                (node.func.attr in _PC_METHODS or
                 node.func.attr in _PC_READS):
            group = self._resolve_handle(node.func.value)
            key = _str_arg(node)
            if group and key:
                self.usages.append((group, key, node.func.attr,
                                    node.lineno))
        self.generic_visit(node)


class PerfTypeRule(Rule):
    rule_id = "CTL402"
    name = "perf-counter-type-conflict"
    description = ("perf counter key driven with conflicting types "
                   "across the tree (inc vs tinc vs hinc vs set)")

    def __init__(self) -> None:
        # (group, key) -> {method: first (path, line, evidence)}
        self.writes: Dict[Tuple[str, str],
                          Dict[str, Tuple[str, int, bool]]] = {}

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        for group, key, method, line in _PerfUsages.of(mod):
            if method in _PC_METHODS:
                self.writes.setdefault((group, key), {}).setdefault(
                    method, (mod.relpath, line, mod.evidence))
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for (group, key), methods in sorted(self.writes.items()):
            allowed = None
            for m in methods:
                types = set(_PC_METHODS[m])
                allowed = types if allowed is None else \
                    allowed & types
            if allowed:
                continue
            # report at a lint-scope site; a conflict confined to
            # evidence modules (tests driving scratch counters) is
            # theirs to fail at runtime, not this gate's to report
            sites = sorted((p, ln) for p, ln, ev in methods.values()
                           if not ev)
            if not sites:
                continue
            used = sorted(methods)
            path, line = sites[0]
            out.append(Finding(
                self.rule_id, path, line,
                f"perf counter {group}.{key} driven as "
                f"{'+'.join(used)} — no single declared type "
                f"satisfies all call sites (the immutable-type "
                f"guard would raise at runtime)"))
        return out


class PerfReadRule(Rule):
    rule_id = "CTL403"
    name = "perf-counter-read-never-written"
    description = ("perf counter key read via .get() but never "
                   "updated anywhere in the tree")

    def __init__(self) -> None:
        self.written: Set[Tuple[str, str]] = set()
        self.reads: Dict[Tuple[str, str],
                         List[Tuple[str, int]]] = {}

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        for group, key, method, line in _PerfUsages.of(mod):
            gk = (group, key)
            if method in _PC_METHODS:
                self.written.add(gk)
            elif not mod.evidence:
                self.reads.setdefault(gk, []).append(
                    (mod.relpath, line))
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for gk in sorted(set(self.reads) - self.written):
            group, key = gk
            for path, line in self.reads[gk]:
                out.append(Finding(
                    self.rule_id, path, line,
                    f"perf counter {group}.{key} is read but no "
                    f"call site ever updates it (stale name after "
                    f"a rename?)"))
        return out


def register(reg) -> None:
    reg.add(ConfigKeyRule.rule_id, ConfigKeyRule)
    reg.add(PerfTypeRule.rule_id, PerfTypeRule)
    reg.add(PerfReadRule.rule_id, PerfReadRule)
