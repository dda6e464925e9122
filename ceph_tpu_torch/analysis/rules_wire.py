"""CTL1xx wire hot-path rules — CTL130: copy-introducing patterns;
CTL131: reply-direction re-scans outside the combine chokepoint.

ZeroWire made the wire data path zero-copy end to end:
payload buffers cross the client, the frames, the receive path and
the store as memoryviews, and every byte pays for integrity exactly
once.  The regression class this rule polices is the quiet
re-introduction of a payload materialization on that path —

  * ``bytes(data)`` / ``bytes(payload)`` — a full duplicate of the
    buffer the spine worked to keep as a view;
  * ``b"".join(...)`` — the meta+data concatenation the
    scatter-gather frame layout (MSG_REQ_SG) exists to avoid;
  * ``meta + data``-style ``+`` concatenation of payload buffers.

Scope — the wire hot path: every function in ``msg/wire.py`` /
``msg/shm_ring.py`` / ``cluster/async_objecter.py``, plus the
objecter fan-out in ``client/``: functions that submit to the async
core (``call_async`` / ``aio_osd_call`` / ``osd_call``) and, over the
whole-program graph (precise edges), every ``client/`` helper
such a fan-out reaches — a copy inside a helper is the same cost
wearing a wrapper.  Counted legacy paths and fault-injection joins
carry ``# noqa: CTL130`` with justification; everything else must
stay view-clean.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from . import astutil
from .core import Finding, ParsedModule, Rule

# buffer-bearing names: flagging is restricted to these so the rule
# targets PAYLOAD materializations, not every bytes() in sight
_PAYLOAD_NAMES = frozenset((
    "data", "payload", "body", "buf", "chunk", "shard_bytes",
    "frame_bytes"))

# submits into the async wire core — the objecter fan-out roots
_SUBMIT_CALLS = frozenset(("call_async", "aio_osd_call", "osd_call",
                           "submit", "try_submit", "ring_put"))


def _is_payload(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id in _PAYLOAD_NAMES
    if isinstance(node, ast.Subscript):
        return _is_payload(node.value)
    return False


def _copy_patterns(fn: ast.AST) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == "bytes" and \
                    len(node.args) == 1 and _is_payload(node.args[0]):
                out.append((node.lineno,
                            "bytes() materializes a payload buffer"))
            elif isinstance(f, ast.Attribute) and f.attr == "join" \
                    and isinstance(f.value, ast.Constant) \
                    and isinstance(f.value.value, bytes):
                out.append((node.lineno,
                            "b''.join concatenates payload buffers "
                            "(the scatter-gather frame exists to "
                            "avoid this)"))
        elif isinstance(node, ast.BinOp) and \
                isinstance(node.op, ast.Add) and \
                (_is_payload(node.left) or _is_payload(node.right)):
            out.append((node.lineno,
                        "+ concatenation of payload buffers"))
    return out


def _submits_to_wire(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SUBMIT_CALLS:
            return True
    return False


class WireCopyRule(Rule):
    rule_id = "CTL130"
    name = "wire-hot-path-copy"
    description = ("copy-introducing pattern (bytes(payload) / "
                   "b''.join / + concatenation of payload buffers) "
                   "on the zero-copy wire hot path — msg/ framing, "
                   "the async objecter, and the client fan-out "
                   "(interprocedural over the whole-program graph)")

    def __init__(self) -> None:
        super().__init__()
        # (mod, fn) in scope; client fan-out roots resolved in finish
        self._wire_fns: List[Tuple[ParsedModule, ast.AST]] = []
        self._client_roots: List[Tuple[ParsedModule, ast.AST]] = []
        self._client_mods: List[ParsedModule] = []

    @staticmethod
    def _relnorm(mod: ParsedModule) -> str:
        return mod.relpath.replace("\\", "/")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        rel = self._relnorm(mod)
        dirs, base = rel.split("/")[:-1], rel.split("/")[-1]
        if "msg" in dirs or base == "async_objecter.py":
            for fn, _cls in astutil.walk_functions(mod.tree):
                self._wire_fns.append((mod, fn))
            return ()
        if "client" in dirs:
            self._client_mods.append(mod)
            for fn, _cls in astutil.walk_functions(mod.tree):
                if _submits_to_wire(fn):
                    self._client_roots.append((mod, fn))
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()

        def report(mod: ParsedModule, fn: ast.AST, line: int,
                   msg: str, via: str = "") -> None:
            key = (mod.relpath, line)
            if key in seen or mod.suppressed(line, self.rule_id):
                return
            seen.add(key)
            name = getattr(fn, "name", "?")
            out.append(Finding(
                self.rule_id, mod.relpath, line,
                f"{msg} in wire hot-path function '{name}'{via} — "
                f"keep payload buffers as views end to end "
                f"(memoryview / scatter-gather parts)"))

        for mod, fn in self._wire_fns:
            for line, msg in _copy_patterns(fn):
                report(mod, fn, line, msg)
        # client fan-out: the root functions themselves, plus every
        # client/ helper they reach over the precise program graph
        graph = astutil.program_graph(self.program) \
            if self.program is not None else None
        client_fn_owner = {}
        for mod in self._client_mods:
            for fn, _cls in astutil.walk_functions(mod.tree):
                client_fn_owner[id(fn)] = (mod, fn)
        for mod, fn in self._client_roots:
            targets = [(mod, fn)]
            if graph is not None:
                for g in graph.reachable([fn]):
                    owner = client_fn_owner.get(id(g))
                    if owner is not None and g is not fn:
                        targets.append(owner)
            for tmod, tfn in targets:
                via = "" if tfn is fn else \
                    f" (reached from '{getattr(fn, 'name', '?')}')"
                for line, msg in _copy_patterns(tfn):
                    report(tmod, tfn, line, msg, via)
        return out


# ---------------------------------------------------------- CTL131 ---
# RingReply deleted the reply lane's send-side scan: a bulk
# reply's sub-crcs are already TRUSTED (BlueStore blob csums adopted at
# receive verify), so the frame crc is a crc32_combine fold, never a
# rescan.  The regression class: a reply-building function that calls
# zlib.crc32 / Csums.scan on payload bytes anyway — the silent
# double-scan.  Folding functions (they call crc32_combine /
# combine_series — the sanctioned chokepoint) are exempt; counted
# fallbacks carry # noqa: CTL131 with justification.

_COMBINE_CALLS = frozenset(("crc32_combine", "combine_series"))
_SCAN_ATTRS = frozenset(("crc32", "scan"))


def _references_reply(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and \
                node.attr.startswith("MSG_REPLY"):
            return True
        if isinstance(node, ast.Name) and \
                node.id.startswith("MSG_REPLY"):
            return True
    return False


def _sends_frames(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            (f.id if isinstance(f, ast.Name) else "")
        if name in ("prepare_frame", "put"):
            return True
    return False


def _calls_combine(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            (f.id if isinstance(f, ast.Name) else "")
        if name in _COMBINE_CALLS:
            return True
    return False


def _rescan_patterns(fn: ast.AST) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SCAN_ATTRS \
                and node.args and _is_payload(node.args[0]):
            what = "zlib.crc32" if f.attr == "crc32" else "Csums.scan"
            out.append((node.lineno,
                        f"{what}() re-scans payload bytes"))
    return out


class WireReplyRescanRule(Rule):
    rule_id = "CTL131"
    name = "reply-direction-rescan"
    description = ("reply-direction send that re-scans payload bytes "
                   "(zlib.crc32 / Csums.scan) outside the "
                   "crc32_combine chokepoint — trusted sub-crcs from "
                   "the store side table must FOLD into the frame "
                   "crc, never trigger a second traversal "
                   "(interprocedural over the whole-program graph)")

    def __init__(self) -> None:
        super().__init__()
        self._roots: List[Tuple[ParsedModule, ast.AST]] = []
        self._scope_mods: List[ParsedModule] = []

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        rel = mod.relpath.replace("\\", "/")
        dirs = rel.split("/")[:-1]
        if "msg" in dirs or "cluster" in dirs:
            self._scope_mods.append(mod)
            for fn, _cls in astutil.walk_functions(mod.tree):
                if _references_reply(fn) and _sends_frames(fn):
                    self._roots.append((mod, fn))
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()
        owner = {}
        for mod in self._scope_mods:
            for fn, _cls in astutil.walk_functions(mod.tree):
                owner[id(fn)] = (mod, fn)
        graph = astutil.program_graph(self.program) \
            if self.program is not None else None

        def report(mod: ParsedModule, fn: ast.AST, line: int,
                   msg: str, via: str) -> None:
            key = (mod.relpath, line)
            if key in seen or mod.suppressed(line, self.rule_id):
                return
            seen.add(key)
            name = getattr(fn, "name", "?")
            out.append(Finding(
                self.rule_id, mod.relpath, line,
                f"{msg} on the reply send path in '{name}'{via} — "
                f"trusted csums fold via crc32_combine at the "
                f"chokepoint; a rescan here is the double-scan the "
                f"reply lane exists to delete"))

        for mod, fn in self._roots:
            targets = [(mod, fn)]
            if graph is not None:
                for g in graph.reachable([fn]):
                    o = owner.get(id(g))
                    if o is not None and g is not fn:
                        targets.append(o)
            for tmod, tfn in targets:
                if _calls_combine(tfn):
                    continue          # the sanctioned fold chokepoint
                via = "" if tfn is fn else \
                    f" (reached from '{getattr(fn, 'name', '?')}')"
                for line, msg in _rescan_patterns(tfn):
                    report(tmod, tfn, line, msg, via)
        return out


def register(reg) -> None:
    reg.add("CTL130", WireCopyRule)
    reg.add("CTL131", WireReplyRescanRule)
