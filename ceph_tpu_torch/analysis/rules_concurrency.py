"""CTL3xx — concurrency: static lock-order checking against the SAME
edge model common/lockdep.py enforces at runtime, plus the raw-lock
ban in daemon-plane modules.

CTL301 extracts every lexically-nested ``with lock:`` pair across the
whole tree into one order graph (outer -> inner) and reports any edge
whose reverse is already reachable — the identical cycle condition
lockdep._before_acquire aborts on at runtime, caught here before the
code ever runs.  Lock identity: a ``LockdepLock("name")`` contributes
its runtime NAME (so the static graph and the runtime graph share a
namespace); a raw threading lock contributes ``module.Class.attr``.
Only with-targets that resolve to a known lock binding participate;
call results (``with self._pg_lock(coll):``) are skipped — identity is
unprovable statically, and the runtime half covers them.

CTL302 flags raw ``threading.Lock/RLock/Condition`` construction in
daemon-plane modules (cluster/ + msg/), which bypasses lockdep
entirely.  Storage engines (bluestore/filestore/kv/wal_kv) are exempt
by design: each owns a single coarse leaf lock on a per-op hot path
where the wrapper's bookkeeping is measurable; common/ is exempt
because lockdep itself and the substrates it is built on live there.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import astutil
from .core import Finding, ParsedModule, Rule

_RAW_CTORS = {"threading.Lock", "threading.RLock",
              "threading.Condition"}
_LOCKDEP_TAIL = "LockdepLock"

# storage engines: single coarse leaf lock each, per-op hot path
_ENGINE_EXEMPT = {"bluestore.py", "filestore.py", "kv.py",
                  "wal_kv.py", "objectstore.py", "blockdev.py",
                  "crashdev.py"}


def _lock_ctor_kind(call: ast.Call,
                    aliases: Dict[str, str]) -> Optional[str]:
    """'raw' | 'lockdep' | None for a constructor call."""
    cn = astutil.resolve(call.func, aliases)
    if cn in _RAW_CTORS:
        return "raw"
    if cn and cn.rsplit(".", 1)[-1] == _LOCKDEP_TAIL:
        return "lockdep"
    return None


class _ModuleLocks(ast.NodeVisitor):
    """Collect lock bindings + lexical with-nesting edges for one
    module."""

    def __init__(self, mod: ParsedModule, aliases: Dict[str, str]):
        self.mod = mod
        self.aliases = aliases
        stem = mod.relpath.rsplit("/", 1)[-1].removesuffix(".py")
        self.stem = stem
        self.cls: Optional[str] = None
        # binding key ('self', cls, attr) or ('name', None, name)
        self.bindings: Dict[Tuple[str, Optional[str], str], str] = {}
        # (outer, inner, line) lexical nesting edges
        self.edges: List[Tuple[str, str, int]] = []
        self.raw_sites: List[Tuple[int, str]] = []
        self._held: List[str] = []

    # ------------------------------------------------------------ binding --
    def _lock_name(self, call: ast.Call, kind: str,
                   attr: str) -> str:
        if kind == "lockdep" and call.args and \
                isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            return call.args[0].value          # runtime lockdep name
        cls = f"{self.cls}." if self.cls else ""
        return f"{self.stem}.{cls}{attr}"

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            kind = _lock_ctor_kind(node.value, self.aliases)
            if kind is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        name = self._lock_name(node.value, kind,
                                               tgt.id)
                        self.bindings[("name", None, tgt.id)] = name
                    elif isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        name = self._lock_name(node.value, kind,
                                               tgt.attr)
                        self.bindings[("self", self.cls,
                                       tgt.attr)] = name
                if kind == "raw":
                    ctor = astutil.resolve(node.value.func,
                                           self.aliases)
                    self.raw_sites.append((node.lineno, ctor))
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    # ------------------------------------------------------------ nesting --
    def _resolve_with(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.bindings.get(("name", None, expr.id))
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return self.bindings.get(("self", self.cls, expr.attr))
        return None

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            lock = self._resolve_with(item.context_expr)
            if lock is None:
                continue
            for held in self._held:
                if held != lock:
                    self.edges.append((held, lock, node.lineno))
            self._held.append(lock)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        # With.items expressions may themselves contain nested nodes
        for item in node.items:
            self.visit(item.context_expr)
        del self._held[len(self._held) - pushed:]


class LockOrderRule(Rule):
    rule_id = "CTL301"
    name = "lock-order-inversion"
    description = ("static with-nesting lock-order inversion (the "
                   "lockdep cycle condition, caught at lint time)")

    def __init__(self) -> None:
        # edge -> first site; graph for reachability
        self.sites: Dict[Tuple[str, str],
                         Tuple[str, int]] = {}
        self.graph: Dict[str, Set[str]] = {}

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()          # tests invert deliberately (lockdep's own)
        aliases = astutil.aliases_of(mod)
        v = _ModuleLocks(mod, aliases)
        v.visit(mod.tree)
        for outer, inner, line in v.edges:
            self.sites.setdefault((outer, inner), (mod.relpath, line))
            self.graph.setdefault(outer, set()).add(inner)
        return ()

    def _reaches(self, src: str, dst: str) -> bool:
        stack, seen = [src], set()
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self.graph.get(cur, ()))
        return False

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        reported: Set[frozenset] = set()
        for (a, b), (path, line) in sorted(self.sites.items()):
            if frozenset((a, b)) in reported:
                continue
            # removing the direct edge a->b, can b still reach a?
            if self._reaches(b, a):
                rev = next((s for (x, y), s in sorted(
                    self.sites.items()) if x == b), ("?", 0))
                out.append(Finding(
                    self.rule_id, path, line,
                    f"lock order inversion: {a!r} -> {b!r} here, but "
                    f"{b!r} -> ... -> {a!r} is recorded elsewhere "
                    f"(e.g. {rev[0]}) — same cycle lockdep would "
                    f"abort on at runtime"))
                reported.add(frozenset((a, b)))
        return out


class RawLockRule(Rule):
    rule_id = "CTL302"
    name = "raw-lock-in-daemon-plane"
    description = ("raw threading.Lock/RLock in a daemon-plane module "
                   "bypasses lockdep — use common.lockdep.LockdepLock")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        parts = mod.parts()
        if mod.evidence or not ({"cluster", "msg"} & set(parts)) or \
                parts[-1] in _ENGINE_EXEMPT:
            return ()
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    _lock_ctor_kind(node, aliases) == "raw":
                ctor = astutil.resolve(node.func, aliases)
                out.append(self.finding(
                    mod, node.lineno,
                    f"{ctor}() in a daemon-plane module bypasses "
                    f"lockdep order checking — use "
                    f"common.lockdep.LockdepLock"))
        return out


def register(reg) -> None:
    reg.add(LockOrderRule.rule_id, LockOrderRule)
    reg.add(RawLockRule.rule_id, RawLockRule)
