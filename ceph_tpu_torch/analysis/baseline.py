"""Checked-in finding baseline — the deliberate-exception ledger.

Findings whose (rule, path, msg) key appears in the baseline file are
reported as "baselined" instead of failing ``--check``: the workflow
for a violation that is intentional is either an inline
``# noqa: CTL###`` (preferred — the justification lives next to the
code) or, for whole-finding grandfathering, one baseline entry.  The
file is JSON, sorted, and small by policy (the lint gate test caps
it), so every entry is reviewable in a diff.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, LintError

Key = Tuple[str, str, str]


def load(path: str) -> Set[Key]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return set()
    except json.JSONDecodeError as e:
        raise LintError(f"{path}: bad baseline json: {e}") from e
    if not isinstance(data, dict) or \
            not isinstance(data.get("findings"), list):
        raise LintError(f"{path}: expected {{'findings': [...]}}")
    out: Set[Key] = set()
    for entry in data["findings"]:
        try:
            out.add((entry["rule"], entry["path"], entry["msg"]))
        except (TypeError, KeyError) as e:
            raise LintError(
                f"{path}: baseline entry needs rule/path/msg: "
                f"{entry!r}") from e
    return out


def save(path: str, findings: Iterable) -> None:
    """Accepts Findings or raw (rule, path, msg) keys."""
    entries = sorted({f.key() if isinstance(f, Finding) else tuple(f)
                      for f in findings})
    data = {
        "comment": "cephtpu-lint baseline: deliberate exceptions "
                   "only. Prefer inline '# noqa: CTL###' with a "
                   "justification; regenerate via "
                   "python -m ceph_tpu_torch.tools.lint "
                   "--write-baseline.",
        "findings": [{"rule": r, "path": p, "msg": m}
                     for r, p, m in entries],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def split(findings: Iterable[Finding], baseline: Set[Key]
          ) -> Tuple[List[Finding], List[Finding], List[Key]]:
    """(new, baselined, stale-baseline-entries)."""
    new: List[Finding] = []
    old: List[Finding] = []
    seen: Set[Key] = set()
    for f in findings:
        if f.key() in baseline:
            old.append(f)
            seen.add(f.key())
        else:
            new.append(f)
    stale = sorted(baseline - seen)
    return new, old, stale
