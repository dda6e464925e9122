"""CTL8xx — wire-protocol contract closure.

Five daemons speak a ~60-command dict protocol over the messenger,
dispatched by ad-hoc ``if cmd == "...":`` arms (cluster/daemon.py)
— a string-keyed seam with NOTHING tying the two ends together, the
exact surface the reference guards with ceph-dencoder +
ceph-object-corpus round-trip checks.  The failure modes are all
silent: a typo'd command earns an IOError (or nothing) at runtime
under exactly the failure scenario nobody tests; a mutating command
that skips the (session, seq) stamping chokepoint silently loses the
at-most-once replay guarantee; a sender that omits a field the
handler subscripts is a KeyError INSIDE the daemon, surfaced to the
client as a generic wire error.  These rules close the protocol
statically, whole-program:

  CTL801  protocol surface closure — every literal ``cmd`` sent from
          client//cluster//rgw/ has a dispatch arm somewhere
          (``cmd == "X"`` or a literal membership test), and every
          arm is sent/exercised by SOMETHING (package, tools,
          scripts, or tests) — a handled-but-never-sent arm is dead
          protocol surface
  CTL802  at-most-once closure — every send of a MUTATING command
          (the daemon's ``_REPLAY_CMDS`` contract, read from the
          tree itself) reaches the messenger through a
          (session, seq)-stamping chokepoint (``osd_call`` /
          ``call_async`` / ``aio_osd_call`` / the daemon's
          ``_peer_req``) or carries an explicit ``session`` stamp
  CTL803  typed-encoding field agreement — keys a sender builds into
          a literal cmd dict must cover every key the handler arm
          SUBSCRIPTS (``req["k"]``; ``req.get`` is optional by
          construction): a short send is a silent KeyError inside
          the daemon
  CTL804  faultpoint grammar closure — every faultpoint name armed
          over the asok ``fault_injection`` grammar or
          ``faults.arm()`` is declared, and every name is declared
          EXACTLY once (a second declare site is doc drift waiting
          to collide at runtime); fire-site closure stays CTL601

Senders are anchored on the send callables (``call`` / ``osd_call``
/ ``call_async`` / ``aio_osd_call`` / ``mon_call`` / ``_peer_req`` /
``_peer_call`` / ``_osd_probe``) with a dict-literal request —
directly or through one ``tracer.stamp(...)`` wrapper.  Handlers are
any function assigning ``<var> = <param>["cmd"]`` (the dispatch
idiom).  Tests count as exercise evidence but never carry findings.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Finding, ParsedModule, Rule
from .rules_faults import _faults_recv
from . import astutil

_SEND_ATTRS = frozenset((
    "call", "osd_call", "call_async", "aio_osd_call", "mon_call",
    "_peer_req", "_peer_call", "_osd_probe"))

# chokepoints that stamp (session, seq) centrally on mutating cmds:
# AsyncObjecter.call_async (osd_call/aio_osd_call route through it)
# and OSDDaemon._peer_req (the daemon's peer-send seam)
_STAMP_CHOKEPOINTS = frozenset((
    "osd_call", "call_async", "aio_osd_call", "_peer_req"))

# the at-most-once contract set when the tree declares none (fixture
# trees); a real tree's _REPLAY_CMDS assignments override this
_DEFAULT_MUTATING = frozenset((
    "put_shard", "put_object", "delete_shard", "delete_object",
    "setattr_shard", "copy_from", "exec_cls"))

_SCOPE_DIRS = frozenset(("client", "cluster", "rgw"))


def _in_scope(mod: ParsedModule) -> bool:
    parts = mod.relpath.replace("\\", "/").split("/")[:-1]
    return any(p in _SCOPE_DIRS for p in parts)


class _Send:
    __slots__ = ("attr", "cmd", "keys", "complete", "has_session",
                 "lineno")

    def __init__(self, attr: str, cmd: Optional[str],
                 keys: Set[str], complete: bool,
                 has_session: bool, lineno: int):
        self.attr = attr
        self.cmd = cmd
        self.keys = keys
        self.complete = complete
        self.has_session = has_session
        self.lineno = lineno


class _Arm:
    __slots__ = ("cmd", "lineno", "required", "fn_name")

    def __init__(self, cmd: str, lineno: int,
                 required: Set[str], fn_name: str):
        self.cmd = cmd
        self.lineno = lineno
        self.required = required
        self.fn_name = fn_name


def _req_dict(call: ast.Call) -> Optional[ast.Dict]:
    """The request dict literal of a send call: a direct Dict
    argument, or a Dict inside ONE wrapping call (the
    ``tracer.stamp({...})`` shape)."""
    for arg in call.args:
        if isinstance(arg, ast.Dict):
            return arg
        if isinstance(arg, ast.Call):
            for inner in arg.args:
                if isinstance(inner, ast.Dict):
                    return inner
    return None


def _dict_shape(d: ast.Dict) -> Tuple[Optional[str], Set[str], bool]:
    """(literal cmd, literal keys, keys-complete) of a request dict.
    ``**spread`` entries or computed keys make the key set open
    (complete=False): CTL803 then stays quiet rather than guessing."""
    cmd = None
    keys: Set[str] = set()
    complete = True
    for k, v in zip(d.keys, d.values):
        if k is None or not isinstance(k, ast.Constant) or \
                not isinstance(k.value, str):
            complete = False
            continue
        keys.add(k.value)
        if k.value == "cmd":
            if isinstance(v, ast.Constant) and \
                    isinstance(v.value, str):
                cmd = v.value
    return cmd, keys, complete


def _collect(mod: ParsedModule):
    """Per-module protocol facts, computed once and shared by every
    CTL8xx rule (the rules_admin/_faults pattern)."""
    cached = mod._cache.get("protocol")
    if cached is not None:
        return cached
    sends: List[_Send] = []
    arms: List[_Arm] = []
    handled: Set[str] = set()
    exercised: Set[str] = set()
    mutating: Set[str] = set()
    for node in ast.walk(mod.tree):
        # literal {"cmd": "X"} ANYWHERE is exercise evidence (tests
        # poking handlers directly, faultpoint match filters, ...)
        if isinstance(node, ast.Dict):
            cmd, _keys, _c = _dict_shape(node)
            if cmd is not None:
                exercised.add(cmd)
            continue
        # the tree's own at-most-once contract declaration
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "_REPLAY_CMDS":
            v = node.value
            if isinstance(v, ast.Call) and v.args:
                v = v.args[0]
            if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                for e in v.elts:
                    if isinstance(e, ast.Constant) and \
                            isinstance(e.value, str):
                        mutating.add(e.value)
            continue
        if not isinstance(node, ast.Call):
            continue
        # a string constant passed DIRECTLY as a call argument is
        # exercise evidence too: parameterized request constructors
        # (``self._shard0_probe(oid, "stat_shard")``) send cmds the
        # dict-literal scan cannot see.  Container literals (the
        # _TRACKED_CMDS-style frozensets) deliberately do NOT count.
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Constant) and \
                    isinstance(a.value, str):
                exercised.add(a.value)
        name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name)
                  else None)
        if name in _SEND_ATTRS:
            d = _req_dict(node)
            if d is not None:
                cmd, keys, complete = _dict_shape(d)
                sends.append(_Send(name, cmd, keys, complete,
                                   "session" in keys, d.lineno))
    # handler arms: any function assigning <var> = <param>["cmd"]
    for fn, _cls in astutil.walk_functions(mod.tree):
        params = {a.arg for a in fn.args.posonlyargs + fn.args.args}
        cmd_var = req_var = None
        for node in fn.body:
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Subscript) and \
                    isinstance(node.value.value, ast.Name) and \
                    node.value.value.id in params and \
                    isinstance(node.value.slice, ast.Constant) and \
                    node.value.slice.value == "cmd":
                cmd_var = node.targets[0].id
                req_var = node.value.value.id
                break
        if cmd_var is None:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            for cmp in ast.walk(node.test):
                if not (isinstance(cmp, ast.Compare) and
                        isinstance(cmp.left, ast.Name) and
                        cmp.left.id == cmd_var and
                        len(cmp.ops) == 1):
                    continue
                rhs = cmp.comparators[0]
                if isinstance(cmp.ops[0], ast.Eq) and \
                        isinstance(rhs, ast.Constant) and \
                        isinstance(rhs.value, str):
                    required: Set[str] = set()
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Subscript) and \
                                isinstance(sub.value, ast.Name) and \
                                sub.value.id == req_var and \
                                isinstance(sub.ctx, ast.Load) and \
                                isinstance(sub.slice, ast.Constant) \
                                and isinstance(sub.slice.value, str):
                            required.add(sub.slice.value)
                    required.discard("cmd")
                    arms.append(_Arm(rhs.value, node.lineno,
                                     required, fn.name))
                    handled.add(rhs.value)
                elif isinstance(cmp.ops[0], ast.In) and \
                        isinstance(rhs, (ast.Tuple, ast.List,
                                         ast.Set)):
                    for e in rhs.elts:
                        if isinstance(e, ast.Constant) and \
                                isinstance(e.value, str):
                            handled.add(e.value)
    cached = (sends, arms, handled, exercised, mutating)
    mod._cache["protocol"] = cached
    return cached


class _ProtocolBase(Rule):
    def __init__(self) -> None:
        super().__init__()
        # (mod, send) for reportable scope; global cross-reference
        self.scope_sends: List[Tuple[ParsedModule, _Send]] = []
        self.arms: List[Tuple[ParsedModule, _Arm]] = []
        self.handled: Set[str] = set()
        self.sent_or_exercised: Set[str] = set()
        self.mutating: Set[str] = set()

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        sends, arms, handled, exercised, mutating = _collect(mod)
        self.handled.update(handled)
        self.sent_or_exercised.update(exercised)
        self.sent_or_exercised.update(
            s.cmd for s in sends if s.cmd is not None)
        self.mutating.update(mutating)
        if not mod.evidence:
            self.arms.extend((mod, a) for a in arms)
            if _in_scope(mod):
                self.scope_sends.extend((mod, s) for s in sends)
        return ()


class ProtocolClosureRule(_ProtocolBase):
    rule_id = "CTL801"
    name = "wire-cmd-closure"
    description = ("wire cmd sent with no dispatch arm anywhere "
                   "(silent 'unknown command' under the one scenario "
                   "nobody tests), or a dispatch arm nothing ever "
                   "sends — dead protocol surface")

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for mod, s in self.scope_sends:
            if s.cmd is not None and s.cmd not in self.handled:
                out.append(self.finding(
                    mod, s.lineno,
                    f"wire cmd {s.cmd!r} is sent here but no daemon/"
                    f"mon dispatch arm handles it — the send can "
                    f"only ever fail"))
        for mod, a in self.arms:
            if a.cmd not in self.sent_or_exercised:
                out.append(self.finding(
                    mod, a.lineno,
                    f"dispatch arm for {a.cmd!r} in {a.fn_name}() is "
                    f"handled but never sent by any client, tool, "
                    f"script, or test — dead protocol surface (or "
                    f"missing coverage)"))
        return out


class MutatingStampRule(_ProtocolBase):
    rule_id = "CTL802"
    name = "wire-mutation-unstamped"
    description = ("mutating wire cmd sent outside the (session, seq)"
                   "-stamping chokepoints (osd_call / call_async / "
                   "aio_osd_call / _peer_req) with no explicit "
                   "session stamp: the at-most-once replay contract "
                   "is silently absent on this path")

    def finish(self) -> Iterable[Finding]:
        mutating = self.mutating or set(_DEFAULT_MUTATING)
        out: List[Finding] = []
        for mod, s in self.scope_sends:
            if s.cmd in mutating and \
                    s.attr not in _STAMP_CHOKEPOINTS and \
                    not s.has_session:
                out.append(self.finding(
                    mod, s.lineno,
                    f"mutating cmd {s.cmd!r} sent through raw "
                    f"{s.attr}() without a (session, seq) stamp — a "
                    f"reconnect retry can apply it twice; route "
                    f"through osd_call/call_async/_peer_req or stamp "
                    f"explicitly"))
        return out


class FieldAgreementRule(_ProtocolBase):
    rule_id = "CTL803"
    name = "wire-field-agreement"
    description = ("literal cmd dict omits a key EVERY handler arm "
                   "of that cmd subscripts (req['k']) — a silent "
                   "KeyError inside the daemon; req.get() keys are "
                   "optional by construction")

    def finish(self) -> Iterable[Finding]:
        by_cmd: Dict[str, List[Set[str]]] = {}
        for _mod, a in self.arms:
            by_cmd.setdefault(a.cmd, []).append(a.required)
        out: List[Finding] = []
        for mod, s in self.scope_sends:
            if s.cmd is None or not s.complete:
                continue
            reqs = by_cmd.get(s.cmd)
            if not reqs:
                continue
            # a send is broken only when EVERY arm of the cmd has a
            # req[...] key the sender omits (multi-daemon cmds:
            # satisfying one daemon's arm is legitimate); report the
            # closest arm's missing keys as the minimal fix
            missings = [r - s.keys for r in reqs]
            if all(missings):
                best = min(missings,
                           key=lambda m: (len(m), sorted(m)))
                out.append(self.finding(
                    mod, s.lineno,
                    f"cmd {s.cmd!r} sent without key(s) "
                    f"{sorted(best)} that the handler arm reads "
                    f"with req[...] — this send is a guaranteed "
                    f"KeyError inside the daemon"))
        return out


class FaultpointGrammarRule(Rule):
    rule_id = "CTL804"
    name = "faultpoint-grammar-closure"
    description = ("faultpoint name armed (faults.arm / asok "
                   "fault_injection grammar) but never declared, or "
                   "declared more than once — the registry contract "
                   "is one declare site per name, where the fire "
                   "lives")

    def __init__(self) -> None:
        super().__init__()
        self.declares: Dict[str, List[Tuple[str, int]]] = {}
        self.armed: Dict[str, List[Tuple[str, int]]] = {}
        self.evidence_declares: Set[str] = set()

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        aliases = astutil.aliases_of(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                # asok grammar: {"prefix": "fault_injection",
                #                "name": "X", ...}
                kv = {k.value: v for k, v in zip(node.keys,
                                                 node.values)
                      if isinstance(k, ast.Constant)}
                pref = kv.get("prefix")
                nm = kv.get("name")
                if isinstance(pref, ast.Constant) and \
                        pref.value == "fault_injection" and \
                        isinstance(nm, ast.Constant) and \
                        isinstance(nm.value, str) and \
                        not mod.evidence:
                    self.armed.setdefault(nm.value, []).append(
                        (mod.relpath, node.lineno))
                continue
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr not in ("declare", "arm"):
                continue
            if not _faults_recv(node.func.value, aliases):
                continue
            if not (node.args and
                    isinstance(node.args[0], ast.Constant) and
                    isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if node.func.attr == "declare":
                if mod.evidence:
                    self.evidence_declares.add(name)
                else:
                    self.declares.setdefault(name, []).append(
                        (mod.relpath, node.lineno))
            elif not mod.evidence:
                self.armed.setdefault(name, []).append(
                    (mod.relpath, node.lineno))
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for name, sites in sorted(self.declares.items()):
            for path, line in sites[1:]:
                out.append(Finding(
                    self.rule_id, path, line,
                    f"faultpoint {name!r} declared more than once "
                    f"(first at {sites[0][0]}) — one declare site "
                    f"per name, next to its fire"))
        known = set(self.declares) | self.evidence_declares
        for name, sites in sorted(self.armed.items()):
            if name in known:
                continue
            for path, line in sites:
                out.append(Finding(
                    self.rule_id, path, line,
                    f"faultpoint {name!r} is armed here but no "
                    f"faults.declare() site declares it — arming "
                    f"raises FaultError at runtime"))
        return out


def register(reg) -> None:
    reg.add(ProtocolClosureRule.rule_id, ProtocolClosureRule)
    reg.add(MutatingStampRule.rule_id, MutatingStampRule)
    reg.add(FieldAgreementRule.rule_id, FieldAgreementRule)
    reg.add(FaultpointGrammarRule.rule_id, FaultpointGrammarRule)
