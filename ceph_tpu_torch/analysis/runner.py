"""Lint runner — walk the tree, run every rule, apply noqa + baseline,
render human or JSON output.

Library entry: ``run(root, ...)``.  CLI entry: ``main(argv)`` — shared
by ``python -m ceph_tpu_torch.tools.lint`` and ``ceph_tpu_torch.tools.
ceph_cli lint``.

Scopes:
  * lint paths (findings reported): ``ceph_tpu_torch/`` + the port's
    root scripts
  * evidence paths (scanned for cross-references only — admin
    dispatches, perf writes, Option declarations): the port's own
    tests (``tests/test_torch_*.py``, ``tests/torch_twin.py``)

A path may be a glob (``tests/test_torch_*.py``).

JSON output shape (``--json``)::

    {"root": str, "count": int,          # unsuppressed findings
     "baselined": int, "noqa": int,
     "findings":       [{rule, path, line, msg} ...],
     "baselined_findings": [...same shape...],
     "stale_baseline": [{rule, path, msg} ...],
     "rules": {rule_id: description}}
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import astutil
from . import baseline as baseline_mod
from .core import Finding, LintError, ParsedModule, Program, \
    apply_noqa, parse_module
from .registry import RuleRegistry

DEFAULT_LINT_PATHS = ("ceph_tpu_torch", "chip_smoke.py",
                      "kernel_timing.py", "k2_variants.py",
                      "placement_profile.py")
DEFAULT_EVIDENCE_PATHS = ("tests/test_torch_*.py", "tests/torch_twin.py")
DEFAULT_BASELINE = os.path.join("ceph_tpu_torch", "tools",
                                "lint_baseline.json")
_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", "data", "golden",
              "node_modules"}


def _exists(root: str, rel: str) -> bool:
    return bool(glob.glob(os.path.join(root, rel)))


def _iter_py(root: str, rel: str) -> Iterable[Tuple[str, str]]:
    if glob.has_magic(rel):
        for top in sorted(glob.glob(os.path.join(root, rel))):
            yield from _iter_py(root, os.path.relpath(top, root))
        return
    top = os.path.join(root, rel)
    if os.path.isfile(top):
        if top.endswith(".py"):
            yield top, os.path.relpath(top, root).replace(os.sep, "/")
        return
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in _SKIP_DIRS)
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                full = os.path.join(dirpath, fname)
                yield full, os.path.relpath(full, root).replace(
                    os.sep, "/")


def _scope_covers(key, select, paths) -> bool:
    """Could a run restricted to ``select`` rules and ``paths`` have
    re-derived this baseline entry?  Entries outside the scope must be
    neither reported as stale nor dropped by --write-baseline."""
    rule, path, _ = key
    if select and not any(rule.upper().startswith(s.upper())
                          for s in select):
        return False
    if paths:
        norm = [p.replace(os.sep, "/").rstrip("/") for p in paths]
        if not any(p in (".", "") or path == p or
                   path.startswith(p + "/") for p in norm):
            return False
    return True


class Result:
    def __init__(self, findings: List[Finding],
                 baselined: List[Finding],
                 noqa: List[Finding],
                 stale_baseline: List[Tuple[str, str, str]],
                 program: Optional[Program] = None):
        self.findings = findings          # unsuppressed
        self.baselined = baselined
        self.noqa = noqa
        self.stale_baseline = stale_baseline
        self.program = program            # the parsed tree (--graph)

    @property
    def all_findings(self) -> List[Finding]:
        return sorted(self.findings + self.baselined,
                      key=lambda f: (f.path, f.line, f.rule))


def run(root: str,
        paths: Optional[Sequence[str]] = None,
        evidence_paths: Optional[Sequence[str]] = None,
        select: Optional[Sequence[str]] = None,
        baseline: Optional[str] = None) -> Result:
    """Run the suite; ``baseline`` is a path or None (no baseline)."""
    root = os.path.abspath(root)
    paths = list(paths) if paths is not None else \
        [p for p in DEFAULT_LINT_PATHS if _exists(root, p)]
    evidence_paths = list(evidence_paths) \
        if evidence_paths is not None else \
        [p for p in DEFAULT_EVIDENCE_PATHS if _exists(root, p)]

    rules = RuleRegistry.instance().create(select)
    modules: Dict[str, ParsedModule] = {}
    findings: List[Finding] = []
    for evidence, rels in ((False, paths), (True, evidence_paths)):
        for rel in rels:
            for full, relpath in _iter_py(root, rel):
                if relpath in modules:
                    continue
                mod, err = parse_module(full, relpath,
                                        evidence=evidence)
                if err is not None:
                    if not evidence:
                        findings.append(err)
                    continue
                modules[relpath] = mod

    # the whole parsed tree: whole-program rules resolve cross-module
    # calls through ONE shared graph cached on this object (built on
    # first use, reused by every rule in the run — the wall-time
    # budget depends on it)
    program = Program(modules)
    for mod in modules.values():
        mod.program = program

    for rule in rules:
        rule.begin(program)
    for mod in modules.values():
        for rule in rules:
            findings.extend(rule.check_module(mod))
    for rule in rules:
        findings.extend(rule.finish())

    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.msg))
    kept, noqa = apply_noqa(findings, modules)
    base = baseline_mod.load(baseline) if baseline else set()
    new, old, stale = baseline_mod.split(kept, base)
    # a scoped run (--select / explicit paths) cannot see findings
    # outside its scope: their baseline entries are not stale
    stale = [k for k in stale if _scope_covers(k, select, paths)]
    return Result(new, old, noqa, stale, program=program)


# ----------------------------------------------------------------- CLI ----

def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="cephtpu-lint",
        description="AST-based static analysis for ceph_tpu_torch "
                    "(device-path, dtype, concurrency, registry "
                    "hygiene)")
    ap.add_argument("paths", nargs="*",
                    help="paths to lint (default: ceph_tpu_torch and "
                         "the port's root scripts)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: autodetect from this "
                         "package's location)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--sarif", action="store_true",
                    help="SARIF 2.1.0 output (the GitHub "
                         "code-scanning schema) — CI uploads it so "
                         "findings annotate the diff inline")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when unsuppressed findings OR stale "
                         "baseline entries exist (the CI gate)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: "
                         f"{DEFAULT_BASELINE}; 'none' disables)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current unsuppressed findings to the "
                         "baseline file and exit")
    ap.add_argument("--select", action="append", default=None,
                    metavar="CTL###",
                    help="run only matching rules (exact id or "
                         "family prefix, repeatable)")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="CTL###", dest="rule",
                    help="family filter, alias of --select "
                         "(`ceph lint --rule CTL8`)")
    ap.add_argument("--graph", default=None, metavar="module.fn",
                    help="dump the whole-program call graph around "
                         "one function (who-reaches-this / "
                         "what-this-reaches) and exit — the triage "
                         "companion for whole-program findings")
    ap.add_argument("--list-rules", action="store_true")
    ns = ap.parse_args(argv)
    if ns.rule:
        ns.select = (ns.select or []) + ns.rule

    if ns.list_rules:
        for rid, meta in RuleRegistry.instance().describe().items():
            out.write(f"{rid}  {meta['name']}: "
                      f"{meta['description']}\n")
        return 0

    root = ns.root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    if ns.baseline == "none":
        bpath = None
    else:
        bpath = os.path.join(root, ns.baseline or DEFAULT_BASELINE)
        if ns.baseline and not os.path.isabs(ns.baseline) and \
                os.path.exists(ns.baseline):
            bpath = os.path.abspath(ns.baseline)

    try:
        if ns.write_baseline:
            res = run(root, paths=ns.paths or None,
                      select=ns.select, baseline=None)
            if bpath is None:
                raise LintError("--write-baseline needs a baseline "
                                "path")
            entries = {f.key() for f in res.findings}
            # scoped rewrite: keep every entry this run could not have
            # re-derived (other families under --select, other paths
            # under explicit path args) — refreshing one slice must
            # not silently drop the rest of the grandfather ledger
            eff_paths = ns.paths or list(DEFAULT_LINT_PATHS)
            entries |= {k for k in baseline_mod.load(bpath)
                        if not _scope_covers(k, ns.select, eff_paths)}
            baseline_mod.save(bpath, entries)
            out.write(f"wrote {len(entries)} finding(s) to "
                      f"{bpath}\n")
            return 0
        if ns.graph is not None:
            return _dump_graph(root, ns, out)
        res = run(root, paths=ns.paths or None, select=ns.select,
                  baseline=bpath)
    except LintError as e:
        out.write(f"lint error: {e}\n")
        return 2

    if ns.sarif:
        out.write(json.dumps(_sarif(res), indent=2) + "\n")
    elif ns.json:
        out.write(json.dumps({
            "root": root,
            "count": len(res.findings),
            "baselined": len(res.baselined),
            "noqa": len(res.noqa),
            "findings": [f.to_json() for f in res.findings],
            "baselined_findings": [f.to_json()
                                   for f in res.baselined],
            "stale_baseline": [
                {"rule": r, "path": p, "msg": m}
                for r, p, m in res.stale_baseline],
            "rules": {rid: meta["description"] for rid, meta in
                      RuleRegistry.instance().describe().items()},
        }, indent=2) + "\n")
    else:
        for f in res.findings:
            out.write(f.render() + "\n")
        for key in res.stale_baseline:
            out.write(f"stale baseline entry (fixed? remove it): "
                      f"{key[0]} {key[1]}: {key[2]}\n")
        out.write(f"{len(res.findings)} finding(s), "
                  f"{len(res.baselined)} baselined, "
                  f"{len(res.noqa)} noqa-suppressed\n")
    if ns.check and (res.findings or res.stale_baseline):
        # stale baseline entries fail the gate too: a suppression
        # whose finding no longer fires anywhere has stopped guarding
        # anything and silently shrinks the gate — remove it
        return 1
    return 0


def _sarif(res: Result) -> dict:
    """SARIF 2.1.0 document (the subset GitHub code scanning
    ingests): one run, the registered rules as tool metadata, every
    unsuppressed finding as an ``error`` result and every baselined
    finding as a ``note`` (visible but non-blocking — mirroring the
    --check gate).  Paths stay repo-relative via SRCROOT so the
    upload action can anchor them to the checkout."""
    from .. import __version__
    described = RuleRegistry.instance().describe()

    def result(f: Finding, level: str) -> dict:
        return {
            "ruleId": f.rule,
            "level": level,
            "message": {"text": f.msg},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }

    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "cephtpu-lint",
                "version": __version__,
                "informationUri":
                    "https://example.invalid/cephtpu-lint",
                "rules": [{
                    "id": rid,
                    "name": meta["name"],
                    "shortDescription": {"text": meta["description"]},
                } for rid, meta in described.items()],
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results":
                [result(f, "error") for f in res.findings] +
                [result(f, "note") for f in res.baselined],
        }],
    }


def _dump_graph(root: str, ns, out) -> int:
    """`--graph module.fn`: resolve the function by dotted-suffix
    match and print its direct callers/callees plus the transitive
    closure sizes — who-reaches-this / what-this-reaches."""
    mods: Dict[str, ParsedModule] = {}
    paths = list(ns.paths) if ns.paths else \
        [p for p in DEFAULT_LINT_PATHS if _exists(root, p)]
    evidence = [p for p in DEFAULT_EVIDENCE_PATHS if _exists(root, p)]
    for ev, rels in ((False, paths), (True, evidence)):
        for rel in rels:
            for full, relpath in _iter_py(root, rel):
                if relpath in mods:
                    continue
                m, err = parse_module(full, relpath, evidence=ev)
                if err is None:
                    mods[relpath] = m
    program = Program(mods)
    for m in mods.values():
        m.program = program
    g = astutil.program_graph(program)
    targets = g.find(ns.graph)
    if not targets:
        out.write(f"--graph: no function matches {ns.graph!r}\n")
        return 2
    for fn in targets:
        mod = g.mod_of[fn]
        out.write(f"{g.qualname(fn)}  "
                  f"({mod.relpath}:{fn.lineno})\n")
        callers = sorted(g.qualname(c) for c in g.callers_of(fn))
        callees = sorted(g.qualname(c) for c in g.callees(fn))
        up = g.reachable([fn], forward=False)
        down = g.reachable([fn], forward=True)
        out.write(f"  reached-by ({len(callers)} direct, "
                  f"{len(up)} transitive):\n")
        for q in callers:
            out.write(f"    < {q}\n")
        out.write(f"  reaches ({len(callees)} direct, "
                  f"{len(down)} transitive):\n")
        for q in callees:
            out.write(f"    > {q}\n")
    return 0


if __name__ == "__main__":      # pragma: no cover
    raise SystemExit(main())
