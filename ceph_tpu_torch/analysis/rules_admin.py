"""CTL5xx — admin-command registry hygiene.

The admin socket is a string-keyed dispatch seam (common/admin.py):
``AdminServer.register("prefix", handler)`` on one side,
``{"prefix": "..."}`` requests on the other.  Nothing ties the two
ends together until a human runs the command — a renamed registration
turns every caller into ``unknown command`` replies, and a command
nobody dispatches is dead weight on the daemon surface.  These rules
close the loop statically:

  CTL501  a literal prefix dispatched somewhere in the package that no
          register site declares
  CTL502  a registered prefix that no dispatch site (package, scripts,
          tools, OR tests — tests count as the command's exercise)
          ever names

Dispatch evidence: dict literals carrying a ``"prefix"`` key, plus
module-level ``*_COMMANDS`` string tuples (the CLI's advertised
surface, tools/ceph_cli.py).  Register evidence: two-argument
``.register("prefix", handler)`` calls — the arity plus literal first
argument distinguishes admin registrations from the EC/mgr/cls
registries that share the method name.

The WIRE protocol's twin closure (``{"cmd": ...}`` sends vs daemon
dispatch arms) is the CTL8xx family (rules_protocol.py) — same
two-sided dead-surface/unreachable-command model, applied to the
messenger seam instead of the admin socket.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, ParsedModule, Rule


def _collect(mod: ParsedModule):
    """(registered, dispatched) literal prefixes with sites — computed
    once per module and shared by CTL501/CTL502."""
    cached = mod._cache.get("admin_prefixes")
    if cached is not None:
        return cached
    registered: Dict[str, Tuple[str, int]] = {}
    dispatched: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "register" and \
                len(node.args) == 2 and not node.keywords and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            registered.setdefault(node.args[0].value,
                                  (mod.relpath, node.lineno))
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and \
                        k.value == "prefix" and \
                        isinstance(v, ast.Constant) and \
                        isinstance(v.value, str):
                    dispatched.setdefault(v.value,
                                          (mod.relpath, node.lineno))
        elif isinstance(node, ast.Assign) and \
                len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.endswith("COMMANDS") and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and \
                        isinstance(e.value, str):
                    dispatched.setdefault(e.value,
                                          (mod.relpath, node.lineno))
    mod._cache["admin_prefixes"] = (registered, dispatched)
    return registered, dispatched


class _AdminBase(Rule):
    def __init__(self) -> None:
        self.registered: Dict[str, Tuple[str, int]] = {}
        self.dispatched: Dict[str, Tuple[str, int]] = {}
        self.pkg_registered: Dict[str, Tuple[str, int]] = {}
        self.pkg_dispatched: Dict[str, Tuple[str, int]] = {}

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        reg, disp = _collect(mod)
        for k, site in reg.items():
            self.registered.setdefault(k, site)
            if not mod.evidence:
                self.pkg_registered.setdefault(k, site)
        for k, site in disp.items():
            self.dispatched.setdefault(k, site)
            if not mod.evidence:
                self.pkg_dispatched.setdefault(k, site)
        return ()


class UnregisteredDispatchRule(_AdminBase):
    rule_id = "CTL501"
    name = "admin-dispatch-unregistered"
    description = ("admin command dispatched by prefix but never "
                   "registered on any AdminServer")

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for prefix in sorted(set(self.pkg_dispatched) -
                             set(self.registered)):
            path, line = self.pkg_dispatched[prefix]
            out.append(Finding(
                self.rule_id, path, line,
                f"admin command {prefix!r} is dispatched here but no "
                f"AdminServer.register() declares it — every caller "
                f"gets an 'unknown command' reply"))
        return out


class UndispatchedRegisterRule(_AdminBase):
    rule_id = "CTL502"
    name = "admin-register-undispatched"
    description = ("admin command registered but never dispatched by "
                   "any caller, CLI surface, or test")

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for prefix in sorted(set(self.pkg_registered) -
                             set(self.dispatched)):
            path, line = self.pkg_registered[prefix]
            out.append(Finding(
                self.rule_id, path, line,
                f"admin command {prefix!r} is registered but nothing "
                f"(CLI, scripts, tests) ever dispatches it — dead "
                f"surface or missing coverage"))
        return out


def register(reg) -> None:
    reg.add(UnregisteredDispatchRule.rule_id,
            UnregisteredDispatchRule)
    reg.add(UndispatchedRegisterRule.rule_id,
            UndispatchedRegisterRule)
