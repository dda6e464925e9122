"""Lint core — findings, parsed modules, the rule interface,
``# noqa`` suppression.

A finding's identity for baseline purposes is (rule, path, msg) — line
numbers shift with every edit, so they are display-only.  Messages are
therefore written WITHOUT line numbers in them.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple


class LintError(RuntimeError):
    """Framework-level failure (bad rule registration, bad baseline)."""


@dataclass(frozen=True)
class Finding:
    """One violation: ``path:line: CTL### message``."""
    rule: str
    path: str          # posix relpath from the lint root
    line: int
    msg: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity (line-independent)."""
        return (self.rule, self.path, self.msg)

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path,
                "line": self.line, "msg": self.msg}

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


# `# noqa` (bare: suppress everything) / `# noqa: CTL101[,CTL302] ...`
# (code list: suppress ONLY the named codes — a flake8-style
# `# noqa: E402` must NOT blanket-suppress CTL rules)
_NOQA_RE = re.compile(
    r"#\s*noqa\b(?P<colon>\s*:\s*(?P<codes>[^#]*))?", re.IGNORECASE)
_NOQA_CODE_RE = re.compile(r"[A-Za-z]{1,4}\d{3,4}")


class ParsedModule:
    """One parsed source file handed to every rule.

    ``evidence`` modules (tests/) are scanned so whole-program rules
    see their usages (admin dispatches, perf writes) but rules must
    never REPORT findings located in them.
    """

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.AST, evidence: bool = False):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.evidence = evidence
        self.lines = source.splitlines()
        self._cache: Dict[str, Any] = {}   # shared per-module analyses
        self.program: Optional["Program"] = None   # set by the runner

    def parts(self) -> Tuple[str, ...]:
        return tuple(self.relpath.split("/"))

    def suppressed(self, line: int, rule: str) -> bool:
        """True when the physical line carries a noqa for ``rule``
        (bare ``# noqa`` suppresses every rule)."""
        if not 1 <= line <= len(self.lines):
            return False
        m = _NOQA_RE.search(self.lines[line - 1])
        if m is None:
            return False
        if m.group("colon") is None:
            return True                       # bare `# noqa`
        codes = {c.upper()
                 for c in _NOQA_CODE_RE.findall(m.group("codes"))}
        return rule.upper() in codes


class Program:
    """The whole parsed tree of one lint run — every ParsedModule
    (evidence included) plus a shared cache for cross-module analyses
    (the resolved call graph, the whole-program jit-reachability set).
    Built once per run by the runner and handed to every rule through
    ``Rule.begin``; the cache is what keeps the interprocedural graph
    a one-time cost no matter how many rules walk it."""

    def __init__(self, modules: Dict[str, "ParsedModule"]):
        self.modules = modules
        self._cache: Dict[str, Any] = {}

    def lint_modules(self) -> Iterable["ParsedModule"]:
        """Modules findings may be reported in (evidence excluded)."""
        return (m for m in self.modules.values() if not m.evidence)


def parse_module(path: str, relpath: str,
                 evidence: bool = False) -> Tuple[Optional[ParsedModule],
                                                  Optional[Finding]]:
    """Parse one file; a syntax error is itself a finding (CTL000)."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return None, Finding("CTL000", relpath, e.lineno or 1,
                             f"syntax error: {e.msg}")
    return ParsedModule(path, relpath, source, tree,
                        evidence=evidence), None


class Rule:
    """One lint rule.  Subclasses set the id/name/description and
    implement ``check_module`` (called once per parsed module,
    evidence modules included) and optionally ``finish`` (called once
    after every module was seen — whole-program rules emit there).

    Rules are instantiated fresh per run through the registry, so any
    cross-module state lives on ``self``.
    """

    rule_id = "CTL000"
    name = "base"
    description = ""

    def __init__(self) -> None:
        self.program: Optional[Program] = None

    def begin(self, program: Program) -> None:
        """Called once, before any ``check_module``, with the whole
        parsed tree — whole-program rules keep the handle for
        ``finish`` and for the shared interprocedural graph."""
        self.program = program

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        return ()

    def finish(self) -> Iterable[Finding]:
        return ()

    # ------------------------------------------------------------ helpers --
    def finding(self, mod_or_path, line: int, msg: str) -> Finding:
        relpath = (mod_or_path.relpath
                   if isinstance(mod_or_path, ParsedModule)
                   else mod_or_path)
        return Finding(self.rule_id, relpath, line, msg)


def apply_noqa(findings: Iterable[Finding],
               modules: Dict[str, ParsedModule]
               ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, noqa-suppressed)."""
    kept: List[Finding] = []
    dropped: List[Finding] = []
    for f in findings:
        mod = modules.get(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            dropped.append(f)
        else:
            kept.append(f)
    return kept, dropped
