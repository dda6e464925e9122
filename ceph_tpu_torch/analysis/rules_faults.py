"""CTL6xx — faultpoint registry closure.

The fault-injection registry (common/faults.py) is a string-keyed
dispatch seam like the admin registry: ``faults.declare("name", doc)``
on one side, ``faults.fire("name", ...)`` on the other, and nothing
ties them together until a thrash run arms the point.  A typo'd fire
name silently never fires (the dict-miss fast path eats it), which is
the worst failure mode a fault-injection system can have — the soak
"passes" while injecting nothing.  And a ``faults.fire`` inside code a
CUDA graph captures is a host-side branch in a replayed program: it
runs once, at capture, and bakes that one outcome into every replay.

  CTL601  a literal ``faults.fire("name")`` whose name no
          ``faults.declare("name", ...)`` site declares
  CTL602  ``faults.fire`` in the capture set: inside a
          ``with torch.cuda.graph(...)`` block, or reachable from one or
          from a callable handed to ``make_graphed_callables``
          (analysis/astutil.py)
  CTL603  catch-and-discard of IOError/OSError into a constant
          default in client//rgw//msg/ — the ``Bucket._read_index``
          lost-object bug class: a transient wire/device error
          swallowed into ``{}`` reads as "object absent" and the
          next metadata WRITE rebuilds from the fabricated default
  CTL604  direct write-capable ``open()`` / ``os.write`` /
          ``os.pwrite`` / ``os.rename`` / ... in a BlockDevice-owned
          store module (cluster/{bluestore,wal_kv,filestore}.py) —
          bytes that bypass the barrier API are invisible to the
          CrashDev recorder, so the crash-state enumeration silently
          proves nothing about them (exactly the bug class that
          invalidates the power-loss harness)
  CTL605  a sync-agent apply path that persists a replication marker
          (advance/commit/save × marker/applied/position/cursor/
          state) while an async submission's completion is still
          unresolved — the acked-then-lost ordering bug: a crash
          between the marker write and the apply's completion makes
          the peer skip an entry it never actually applied.  Marker
          calls resolve through the whole-program graph, so a
          one-hop wrapper around the persist helper is still caught
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import astutil, shardspec
from .core import Finding, ParsedModule, Rule


def _faults_recv(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """True when the attribute receiver is the faults module/registry
    (``faults.fire``, an aliased import, or ``faults.registry()``)."""
    r = astutil.resolve(node, aliases)
    if r is not None and (r == "faults" or r.endswith(".faults") or
                          r.endswith("faults.registry")):
        return True
    # registry() call receiver: faults.registry().fire(...)
    if isinstance(node, ast.Call):
        rc = astutil.resolve(node.func, aliases)
        return rc is not None and rc.endswith("registry")
    return False


def _collect(mod: ParsedModule):
    """(declared, fired) literal faultpoint names with sites — once
    per module, shared by CTL601/CTL602 (the rules_admin pattern)."""
    cached = mod._cache.get("faultpoints")
    if cached is not None:
        return cached
    aliases = astutil.aliases_of(mod)
    declared: Dict[str, Tuple[str, int]] = {}
    fired: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in ("declare", "fire", "arm"):
            continue
        if not _faults_recv(node.func.value, aliases):
            continue
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        name = node.args[0].value
        if node.func.attr == "declare":
            declared.setdefault(name, (mod.relpath, node.lineno))
        elif node.func.attr == "fire":
            fired.setdefault(name, (mod.relpath, node.lineno))
    mod._cache["faultpoints"] = (declared, fired)
    return declared, fired


class UndeclaredFireRule(Rule):
    rule_id = "CTL601"
    name = "faultpoint-fire-undeclared"
    description = ("faults.fire() names a faultpoint no "
                   "faults.declare() site declares — the dict-miss "
                   "fast path silently never fires it")

    def __init__(self) -> None:
        self.declared: Set[str] = set()
        self.fired: Dict[str, List[Tuple[str, int]]] = {}

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        declared, fired = _collect(mod)
        self.declared.update(declared)       # evidence declares count
        if not mod.evidence:
            for name, site in fired.items():
                self.fired.setdefault(name, []).append(site)
        return ()

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for name in sorted(set(self.fired) - self.declared):
            for path, line in self.fired[name]:
                out.append(Finding(
                    self.rule_id, path, line,
                    f"faultpoint {name!r} is fired here but no "
                    f"faults.declare() site declares it — arming "
                    f"raises and the fire is a silent no-op"))
        return out


class FireInCaptureRule(Rule):
    rule_id = "CTL602"
    name = "faultpoint-fire-in-capture"
    description = ("faults.fire() in code a CUDA graph captures: the "
                   "host branch runs once, at capture, and never on "
                   "replay (bakes one outcome in)")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        # the capture set comes through the shared DeviceContext
        # (analysis/shardspec.py), the same one CTL1002 reads, so the
        # families cannot disagree on what a graph captures
        from .rules_shard import capture_units
        astutil._own_program(mod)
        units = capture_units(shardspec.device_context(mod.program), mod)
        if not units:
            return ()
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        seen: Set[int] = set()               # nested-unit dedup
        for fname, nodes, _scope in units:
            for node in nodes:
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "fire" and \
                        _faults_recv(node.func.value, aliases) and \
                        node.lineno not in seen:
                    seen.add(node.lineno)
                    out.append(self.finding(
                        mod, node.lineno,
                        f"faults.fire() inside graph-captured "
                        f"{fname}() — the branch runs once at capture "
                        f"and never on replay; inject at the dispatch "
                        f"boundary instead"))
        return out


# directories whose modules face the wire/device error domain: a
# swallowed transient error there is user-visible data loss, not a
# local inconvenience
_IO_DIRS = ("client", "rgw", "msg")

# exception names that cover IOError/OSError when caught
_IO_EXC_NAMES = ("IOError", "OSError", "EnvironmentError",
                 "Exception", "BaseException", "WireError",
                 "WireClosed", "ConnectionError", "TimeoutError")


def _catches_io(handler: ast.ExceptHandler) -> bool:
    """Does this handler swallow IOError/OSError (directly, via a
    tuple, via a broad Exception/BaseException, or bare except)?"""
    t = handler.type
    if t is None:
        return True                           # bare except
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in types:
        name = e.id if isinstance(e, ast.Name) else (
            e.attr if isinstance(e, ast.Attribute) else None)
        if name in _IO_EXC_NAMES:
            return True
    return False


def _const_expr(e: Optional[ast.AST]) -> bool:
    """A literal/constant default: the fabricated value the swallow
    substitutes for real state ({} / [] / None / 0 / "" / ...)."""
    if e is None or isinstance(e, ast.Constant):
        return True
    if isinstance(e, (ast.List, ast.Tuple, ast.Set)):
        return all(_const_expr(x) for x in e.elts)
    if isinstance(e, ast.Dict):
        return all(_const_expr(k) for k in e.keys if k is not None) \
            and all(_const_expr(v) for v in e.values)
    if isinstance(e, ast.UnaryOp):
        return _const_expr(e.operand)
    return False


class SwallowedIOErrorRule(Rule):
    rule_id = "CTL603"
    name = "ioerror-swallowed-to-default"
    description = ("except IOError/OSError handler returns a constant "
                   "default in client//rgw//msg/ — a transient error "
                   "fabricates 'absent' state (the _read_index "
                   "lost-object bug class); retry with backoff, "
                   "re-raise, or suppress with # noqa: CTL603")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        parts = mod.relpath.replace("\\", "/").split("/")[:-1]
        if not any(p in _IO_DIRS for p in parts):
            return ()
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _catches_io(node):
                continue
            body = node.body
            if len(body) == 1 and isinstance(body[0], ast.Return) \
                    and _const_expr(body[0].value):
                out.append(self.finding(
                    mod, node.lineno,
                    "IOError/OSError swallowed into a constant "
                    "default return — a transient wire/device error "
                    "now reads as 'absent' state (the _read_index "
                    "lost-object class); retry with "
                    "common/backoff.ExpBackoff, raise, or justify "
                    "with # noqa: CTL603"))
        return out


# the BlockDevice-owned store modules: every byte they persist must
# cross cluster/blockdev.py's barrier-recording API, or the CrashDev
# crash-state recorder is blind to it.  blockdev.py itself is the
# one place raw I/O is legitimate (it IS the door).
_STORE_MODULES = frozenset(("bluestore.py", "wal_kv.py",
                            "filestore.py"))

# os-level write-capable calls a store module must not make directly
_RAW_OS_WRITERS = frozenset((
    "os.write", "os.pwrite", "os.writev", "os.pwritev",
    "os.rename", "os.replace", "os.truncate", "os.ftruncate",
    "os.unlink", "os.remove", "os.fsync", "os.fdatasync"))


def _open_write_mode(call: ast.Call) -> Optional[str]:
    """The literal mode string of an ``open()`` call when it enables
    writing ('w'/'a'/'x'/'+'), else None.  A read-only or
    mode-omitted open is fine — the recorder only needs WRITES."""
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and any(c in mode for c in "wax+"):
        return mode
    return None


class StoreBypassRule(Rule):
    rule_id = "CTL604"
    name = "store-write-bypasses-blockdev"
    description = ("write-capable open()/os.write/os.pwrite/os.rename"
                   "/... in a BlockDevice-owned store module — bytes "
                   "that bypass the barrier API are invisible to the "
                   "CrashDev crash-state recorder, so power-loss "
                   "enumeration proves nothing about them")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        parts = mod.relpath.replace("\\", "/").split("/")
        if "cluster" not in parts[:-1] or \
                parts[-1] not in _STORE_MODULES:
            return ()
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and \
                    node.func.id == "open":
                m = _open_write_mode(node)
                if m is not None:
                    out.append(self.finding(
                        mod, node.lineno,
                        f"open(..., {m!r}) in a BlockDevice-owned "
                        f"store module bypasses the barrier API — "
                        f"the crash-state recorder never sees these "
                        f"bytes; use cluster.blockdev.BlockDevice"))
                continue
            r = astutil.resolve(node.func, aliases)
            if r in _RAW_OS_WRITERS:
                out.append(self.finding(
                    mod, node.lineno,
                    f"{r}() in a BlockDevice-owned store module "
                    f"bypasses the barrier API — route it through "
                    f"cluster.blockdev (BlockDevice / replace / "
                    f"unlink) so CrashDev can enumerate its "
                    f"crash states"))
        return out


# the replication-agent layer: modules under rgw/ plus any module
# whose name says it is a sync/replication agent — the only place a
# "persisted marker" means "the peer will never resend this entry"
_SYNC_DIRS = ("rgw",)

# a call persists a replication marker when its name pairs a commit
# verb with a marker noun (_advance_applied, _save_state,
# commit_marker, update_position, ...)
_MARKER_VERBS = ("advance", "commit", "persist", "save", "update",
                 "bump", "store")
_MARKER_NOUNS = ("marker", "applied", "position", "cursor", "state")

# completion-resolving calls: any of these settles outstanding async
# submissions (the AioCompletion surface + concurrent.futures')
_RESOLVERS = ("result", "wait_for_complete", "wait", "gather",
              "as_completed")


def _is_marker_name(name: Optional[str]) -> bool:
    if not name:
        return False
    n = name.lower()
    return any(v in n for v in _MARKER_VERBS) and \
        any(s in n for s in _MARKER_NOUNS)


class MarkerBeforeCompletionRule(Rule):
    rule_id = "CTL605"
    name = "marker-advanced-before-completion"
    description = ("sync-agent apply path persists a replication "
                   "marker while an async submission's completion is "
                   "unresolved — a crash between the marker write and "
                   "the apply's completion loses the entry forever "
                   "(the acked-then-lost ordering bug)")

    def _marker_call(self, mod: ParsedModule, cls: Optional[str],
                     call: ast.Call) -> Optional[str]:
        """The marker-persist name this call reaches, or None.  Direct
        name match first; otherwise resolve one wrapper hop through
        the whole-program graph (a helper whose own name is bland but
        which calls the persist helper is the same commit point)."""
        f = call.func
        direct = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if _is_marker_name(direct):
            return direct
        if mod.program is None:
            return None
        graph = astutil.program_graph(mod.program)
        for fn in graph.resolve_call(mod, cls, call, precise=True):
            if _is_marker_name(getattr(fn, "name", None)):
                return fn.name
            for callee in graph.callees(fn):
                if _is_marker_name(getattr(callee, "name", None)):
                    return f"{fn.name} -> {callee.name}"
        return None

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        rp = mod.relpath.replace("\\", "/")
        parts = rp.split("/")
        if not (any(p in _SYNC_DIRS for p in parts[:-1]) or
                "sync" in parts[-1]):
            return ()
        out: List[Finding] = []
        for fn, cls in astutil.walk_functions(mod.tree):
            out.extend(self._check_fn(mod, cls, fn))
        return out

    def _check_fn(self, mod: ParsedModule, cls: Optional[str],
                  fn: ast.AST) -> Iterable[Finding]:
        """Linearize the function's calls by source line and simulate:
        a ``.submit(...)`` opens a pending completion, any resolver
        call settles ALL pending (gathers are batch-shaped), and a
        marker persist while something is pending is the finding.
        Statement order approximates control flow — exactly right for
        the submit -> persist -> gather loop shape the bug takes."""
        events: List[Tuple[int, str, Optional[str]]] = []
        plain: List[ast.Call] = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if attr == "submit" or (attr or "").startswith("aio_"):
                events.append((node.lineno, "submit", attr))
                continue
            if attr in _RESOLVERS:
                events.append((node.lineno, "resolve", attr))
                continue
            plain.append(node)
        if any(k == "submit" for _, k, _ in events):
            # only a function that actually opens completions can
            # order a marker ahead of one — graph-resolve its other
            # calls; everything else skips the whole-program walk
            for node in plain:
                name = self._marker_call(mod, cls, node)
                if name is not None:
                    events.append((node.lineno, "marker", name))
        events.sort()
        pending = 0
        out: List[Finding] = []
        for lineno, kind, name in events:
            if kind == "submit":
                pending += 1
            elif kind == "resolve":
                pending = 0
            elif kind == "marker" and pending:
                out.append(self.finding(
                    mod, lineno,
                    f"{name}() persists a replication marker while "
                    f"{pending} async submission(s) are still "
                    f"unresolved — a crash here acks an entry whose "
                    f"apply never completed (peer will skip it "
                    f"forever); gather/.result() the completions "
                    f"first, then advance the marker"))
        return out


def register(reg) -> None:
    reg.add(UndeclaredFireRule.rule_id, UndeclaredFireRule)
    reg.add(FireInCaptureRule.rule_id, FireInCaptureRule)
    reg.add(SwallowedIOErrorRule.rule_id, SwallowedIOErrorRule)
    reg.add(StoreBypassRule.rule_id, StoreBypassRule)
    reg.add(MarkerBeforeCompletionRule.rule_id,
            MarkerBeforeCompletionRule)
