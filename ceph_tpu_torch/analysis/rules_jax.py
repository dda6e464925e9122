"""CTL1xx — device-path hygiene for the port (the torch counterparts of
the reference's JAX hot-path rules), the messenger and recovery loops.

The card only stays busy while the host keeps launching: one stray
host sync on a device path drains the launch queue and parks the host
until the card is idle, one Python branch on a tensor's value is the
same sync in disguise, and one kernel library (or ``torch.compile``
wrapper) built per call pays its build on every invocation.  These
rules walk the device-path set (analysis/astutil.py: the functions
that launch a kernel entry of a loaded library, the port twins of the
reference's jitted functions, and everything they reach) and flag
exactly those three classes.

  CTL101  host sync inside device-path code: ``.item()``,
          ``.tolist()``, ``.cpu()``, ``.numpy()``,
          ``torch.cuda.synchronize()`` / Event or Stream
          ``.synchronize()``, ``int()``/``float()``/``bool()`` of a
          tensor, ``np.*`` on a tensor
  CTL102  Python control flow on a tensor's value inside device-path
          code (``if t.any():``, ``while (x > 0).sum():``) — an
          implicit sync per call
  CTL103  a kernel library (``ops/_build.load``, ``ctypes.CDLL``,
          ``torch.utils.cpp_extension.load``) or ``torch.compile``
          built and called in one expression, or built without a cache
          inside device-path code
  CTL110  blocking socket / wait call reachable from messenger
          CALLBACK context — completion callbacks (``cb=`` /
          ``set_complete_callback`` / ``add_done_callback``) run on
          a stream's reader thread (cluster/async_objecter.py), so a
          callback that blocks on a connect RTT or a future stalls
          every completion pipelined behind it.  Work handed to an
          engine via ``.submit(...)`` is deferred off the callback
          thread and exempt (that is the sanctioned escape hatch).
  CTL120  per-shard blocking wire round trip inside a loop in a
          recovery/backfill function (cluster// client//): a
          recovery sweep that fetches or pushes one shard per blocking
          ``osd_call``/``_peer_req``/``.call`` pays an RTT per shard.
          Submit-all-then-gather (``call_async`` + ``gather``) and
          bulk scatter-gather frames (``get_objects``/``put_objects``)
          are the sanctioned shapes and exempt.

CTL110 and CTL120 are the reference's rules unchanged.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import astutil, shardspec
from .core import Finding, ParsedModule, Rule

# method calls that force a device->host readback of a tensor
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_CASTS = ("int", "float", "bool")
# constructors of a compiled callable or a kernel library
_BUILDERS = {"torch.compile", "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
            "torch.utils.cpp_extension.load",
            "torch.utils.cpp_extension.load_inline"}
_CACHE_DECORATORS = {"functools.lru_cache", "functools.cache",
                     "lru_cache", "cache"}


def host_sync(node: ast.Call, aliases: Dict[str, str],
              env: Dict[str, ast.AST], params: Set[str]
              ) -> Optional[str]:
    """The host-sync form a call takes, as a short text, else None
    (shared by CTL101 and CTL1003)."""
    f = node.func
    cn = astutil.resolve(f, aliases)
    if cn == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_ATTRS:
            return f".{f.attr}()"
        if f.attr == "synchronize":
            return ".synchronize()"
    if isinstance(f, ast.Name) and f.id in _CASTS and \
            len(node.args) == 1 and not node.keywords and \
            astutil.tensor_valued(node.args[0], aliases, env, params):
        return f"{f.id}() of a tensor"
    if cn and cn.split(".")[0] == "numpy" and any(
            astutil.tensor_valued(a, aliases, env, params)
            for a in node.args):
        return f"host numpy call {cn}() on a tensor"
    return None


class HostSyncRule(Rule):
    rule_id = "CTL101"
    name = "device-host-sync"
    description = ("host sync (.item()/.tolist()/.cpu()/.numpy(), "
                   "synchronize(), int()/float()/bool() or np.* of a "
                   "tensor) inside device-path code")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        info = astutil.hot_functions(mod)
        if not info.hot:
            return ()
        aliases = astutil.aliases_of(mod)
        # every sync form on one line, reported once (nested-hot and
        # ``.cpu().numpy()`` chains dedup)
        forms: Dict[int, Set[str]] = {}
        for fn in info.hot:
            env = astutil.fn_env(fn)
            params = astutil.tensor_params(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    what = host_sync(node, aliases, env, params)
                    if what is not None:
                        forms.setdefault(node.lineno, set()).add(what)
        return [self.finding(
            mod, line,
            f"{', '.join(sorted(whats))} inside device-path code forces "
            f"a host sync (the host waits for the card to drain)")
            for line, whats in sorted(forms.items())]


class TensorBranchRule(Rule):
    rule_id = "CTL102"
    name = "device-tensor-branch"
    description = ("Python if/while/assert on a tensor's value inside "
                   "device-path code: an implicit host sync per call "
                   "(keep the choice on the card: torch.where)")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        info = astutil.hot_functions(mod)
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        seen: Set[int] = set()
        for fn in info.hot:
            env = astutil.fn_env(fn)
            params = astutil.tensor_params(fn)
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While, ast.Assert,
                                         ast.IfExp)):
                    continue
                if node.lineno in seen or not astutil.tensor_valued(
                        node.test, aliases, env, params):
                    continue
                seen.add(node.lineno)
                kind = "if" if isinstance(node, ast.IfExp) \
                    else type(node).__name__.lower()
                out.append(self.finding(
                    mod, node.lineno,
                    f"Python {kind} on a tensor value in device-path "
                    f"{getattr(fn, 'name', '<fn>')}() — an implicit "
                    f"host sync per call (keep the choice on the card "
                    f"with torch.where, or read the value once at the "
                    f"boundary)"))
        return out


def _built_by(call: ast.AST, aliases: Dict[str, str],
                mod: ParsedModule, cls: Optional[str]) -> Optional[str]:
    """What a call builds with (a _BUILDERS name, or the kernel
    loader ``ops/_build.load``), else None."""
    if not isinstance(call, ast.Call):
        return None
    cn = astutil.resolve(call.func, aliases)
    if cn in _BUILDERS:
        return cn
    g = astutil.program_graph(mod.program)
    for fn in g.resolve_call(mod, cls, call, precise=True):
        if astutil._is_loader(g, fn):
            return "_build.load"
    return None


class BuildPerCallRule(Rule):
    rule_id = "CTL103"
    name = "device-build-per-call"
    description = ("kernel library / ctypes.CDLL / torch.compile built "
                   "and called in one expression, or built without a "
                   "cache inside device-path code: a fresh build (or "
                   "load) per invocation")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        astutil._own_program(mod)
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        seen: Set[int] = set()

        def emit(line: int, msg: str) -> None:
            if line not in seen:
                seen.add(line)
                out.append(self.finding(mod, line, msg))

        def visit(node: ast.AST, cls: Optional[str]) -> None:
            for ch in ast.iter_child_nodes(node):
                if isinstance(ch, ast.Call):
                    inner = ch.func.value \
                        if isinstance(ch.func, ast.Attribute) \
                        else ch.func
                    b = _built_by(inner, aliases, mod, cls)
                    if b is not None:
                        emit(ch.lineno,
                             f"{b}(...) built and called in one "
                             f"expression — a fresh build (or load) on "
                             f"every call; hoist the built callable to "
                             f"module/instance scope")
                visit(ch, ch.name if isinstance(ch, ast.ClassDef)
                      else cls)

        visit(mod.tree, None)
        hot = astutil.hot_functions(mod).hot
        for fn in hot:
            if any(astutil.resolve(d.func if isinstance(d, ast.Call)
                                   else d, aliases)
                   in _CACHE_DECORATORS for d in fn.decorator_list):
                continue
            cached: Set[int] = set()
            for node in ast.walk(fn):
                # a build stored into a subscript or attribute is a
                # cache fill (``_libs[name] = ctypes.CDLL(...)``)
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, (ast.Subscript, ast.Attribute))
                        for t in node.targets):
                    cached.update(id(n) for n in ast.walk(node.value))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in cached:
                    continue
                cn = astutil.resolve(node.func, aliases)
                if cn in _BUILDERS:
                    emit(node.lineno,
                         f"{cn}() inside device-path "
                         f"{getattr(fn, 'name', '<fn>')}() with no "
                         f"cache — a fresh build per call; cache the "
                         f"result (functools.lru_cache or a module "
                         f"dict)")
        return out


# socket / future verbs that park the calling thread; in callback
# context (a stream's reader thread) each one stalls every completion
# pipelined behind it
_BLOCKING_ATTRS = {
    "connect", "accept", "recv", "recv_into", "recvfrom", "sendall",
    "sendmsg", "makefile", "create_connection", "result",
    "wait_for_complete",
}
# deferral verbs: a callable handed to X.submit(...) runs on the
# engine's workers, NOT in callback context
_DEFER_ATTRS = {"submit"}
# registration sites whose callable argument becomes callback-context
# (cb= / set_complete_callback / add_done_callback) are collected by
# the shared ShardCheck DeviceContext in analysis/shardspec.py


class CallbackBlockingRule(Rule):
    rule_id = "CTL110"
    name = "msgr-callback-blocking"
    description = ("blocking socket/wait call reachable from "
                   "messenger callback context (cb= / done-callback "
                   "functions run on stream reader threads) — "
                   "whole-program: the callback may be registered "
                   "in one module and block in another")

    @staticmethod
    def _own_calls(fn: ast.AST) -> List[ast.Call]:
        """Call nodes executed IN ``fn``'s own frame: nested
        def/lambda bodies are excluded (they only run if called or
        registered themselves), and argument subtrees of deferral
        calls (``X.submit(...)``) are excluded — they execute on the
        engine, not in callback context."""
        out: List[ast.Call] = []

        def visit(n: ast.AST) -> None:
            for ch in ast.iter_child_nodes(n):
                if isinstance(ch, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(ch, ast.Call):
                    out.append(ch)
                    if isinstance(ch.func, ast.Attribute) and \
                            ch.func.attr in _DEFER_ATTRS:
                        visit(ch.func)      # receiver still runs here
                        continue            # args are deferred
                visit(ch)

        visit(fn)
        return out

    def finish(self) -> Iterable[Finding]:
        # callback ROOT collection lives on the shared ShardCheck
        # DeviceContext (analysis/shardspec.py) — one tree walk feeds
        # this rule AND the CTL10xx shard_map site collection, so the
        # reachability families share a single per-run computation
        roots = shardspec.device_context(self.program).callback_roots
        if not roots:
            return ()
        graph = astutil.program_graph(self.program)
        # callback-context reachability over the resolved
        # cross-module graph, own-frame calls only (deferred
        # arguments escape callback context by design)
        origin = {fn: name for fn, (name, _m, _c) in roots.items()}
        ctx = {fn: (m, c) for fn, (_n, m, c) in roots.items()}
        work = list(roots)
        while work:
            fn = work.pop()
            mod, cls = ctx[fn]
            for call in self._own_calls(fn):
                for tgt in graph.resolve_call(mod, cls, call):
                    tmod = graph.mod_of[tgt]
                    if tgt not in origin and not tmod.evidence:
                        origin[tgt] = origin[fn]
                        ctx[tgt] = (tmod, graph.cls_of[tgt])
                        work.append(tgt)

        out: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()
        for fn in origin:
            mod, _cls = ctx[fn]
            aliases = astutil.aliases_of(mod)
            for call in self._own_calls(fn):
                msg = None
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in _BLOCKING_ATTRS:
                    msg = (f".{call.func.attr}() blocks in messenger "
                           f"callback context (reachable from "
                           f"callback {origin[fn]!r}) — defer it via "
                           f"the completion engine's submit()")
                else:
                    cn = astutil.resolve(call.func, aliases)
                    if cn == "time.sleep":
                        msg = (f"time.sleep() in messenger callback "
                               f"context (reachable from callback "
                               f"{origin[fn]!r}) stalls every "
                               f"completion behind it")
                if msg and (mod.relpath, call.lineno, msg) not in seen:
                    seen.add((mod.relpath, call.lineno, msg))
                    out.append(self.finding(mod, call.lineno, msg))
        return out


# per-shard data-transfer commands: one of these inside a blocking
# loop is an RTT per shard; control-plane commands (pg_info,
# recover_pg, reserve_recovery, ...) and the bulk frames
# (get_objects/put_objects/delete_objects) are per-PG and exempt
_PER_SHARD_CMDS = frozenset((
    "get_shard", "put_shard", "getattr_shard", "setattr_shard",
    "digest_shard", "stat_shard", "delete_shard"))

# blocking senders; the async submission path (call_async) is exempt
_BLOCKING_SEND_ATTRS = frozenset(("call", "osd_call", "_peer_req"))

_RECOVERY_FN_RE = re.compile(r"recover|backfill")


class RecoveryShardLoopRule(Rule):
    rule_id = "CTL120"
    name = "recovery-per-shard-blocking-loop"
    description = ("per-shard blocking wire round trip inside a loop "
                   "on a recovery/backfill path — use submit-all-"
                   "then-gather (call_async + gather) or a bulk "
                   "scatter-gather frame")

    @staticmethod
    def _req_cmd(call: ast.Call):
        """The literal ``cmd`` value of a request dict anywhere in
        the call's argument tree (dicts may ride a tracer.stamp()
        wrapper or a variable is invisible — literal-only, the same
        bar CTL701 sets)."""
        for node in ast.walk(call):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "cmd" \
                        and isinstance(v, ast.Constant):
                    return v.value
        return None

    def __init__(self) -> None:
        super().__init__()
        # whole-program site dedup: a helper reachable from recovery
        # loops in SEVERAL modules must report once, at one site
        self.seen: Set[Tuple[str, int]] = set()

    @staticmethod
    def _in_scope(mod: ParsedModule) -> bool:
        parts = mod.parts()
        return "cluster" in parts or "client" in parts

    def _direct_hits(self, fn_name: str, root: ast.AST,
                     mod: ParsedModule, out: List[Finding],
                     seen: Set[Tuple[str, int]],
                     via: str = "") -> None:
        for call in ast.walk(root):
            if not isinstance(call, ast.Call) or \
                    not isinstance(call.func, ast.Attribute):
                continue
            if call.func.attr not in _BLOCKING_SEND_ATTRS:
                continue
            cmd = self._req_cmd(call)
            if cmd not in _PER_SHARD_CMDS:
                continue
            if (mod.relpath, call.lineno) in seen:
                continue
            seen.add((mod.relpath, call.lineno))
            out.append(self.finding(
                mod, call.lineno,
                f"blocking {cmd!r} round trip inside a loop "
                f"in recovery path {fn_name!r}{via}: one RTT per "
                f"shard is the wire-recovery floor — submit "
                f"the sweep async (call_async + gather) or "
                f"ship a bulk get_objects/put_objects frame"))

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence or not self._in_scope(mod):
            return ()
        graph = astutil.program_graph(mod.program)
        out: List[Finding] = []
        seen = self.seen
        for fn, cls in astutil.walk_functions(mod.tree):
            if not _RECOVERY_FN_RE.search(fn.name):
                continue
            for loop in ast.walk(fn):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                # sends lexically inside the loop
                self._direct_hits(fn.name, loop, mod, out, seen)
                # whole-program: a helper CALLED from the loop that
                # performs the per-shard blocking send pays the same
                # RTT per iteration — follow PRECISE edges only
                # (self-methods, local names, resolved imports;
                # ambiguous obj.attr fallback edges would drag in
                # every same-named function) and stop at the wire
                # layer itself (the send primitives' own bodies are
                # engine internals, not callers' loop shapes)
                helpers: Set[ast.AST] = set()
                work: List[ast.AST] = []
                for call in ast.walk(loop):
                    if isinstance(call, ast.Call):
                        work.extend(graph.resolve_call(
                            mod, cls, call, precise=True))
                while work:
                    h = work.pop()
                    if h in helpers or \
                            h.name in _BLOCKING_SEND_ATTRS:
                        continue
                    helpers.add(h)
                    for call in ast.walk(h):
                        if isinstance(call, ast.Call):
                            work.extend(graph.resolve_call(
                                graph.mod_of[h], graph.cls_of[h],
                                call, precise=True))
                for h in helpers:
                    hmod = graph.mod_of[h]
                    if hmod.evidence or not self._in_scope(hmod):
                        continue
                    # recovery-named helpers are NOT skipped: their
                    # own check only covers sends inside their own
                    # loops, while a straight-line per-shard send in
                    # a helper called from THIS loop still pays an
                    # RTT per iteration (site dedup prevents double
                    # reports)
                    self._direct_hits(
                        fn.name, h, hmod, out, seen,
                        via=f" (via helper {h.name!r})")
        return out


def register(reg) -> None:
    reg.add(HostSyncRule.rule_id, HostSyncRule)
    reg.add(TensorBranchRule.rule_id, TensorBranchRule)
    reg.add(BuildPerCallRule.rule_id, BuildPerCallRule)
    reg.add(CallbackBlockingRule.rule_id, CallbackBlockingRule)
    reg.add(RecoveryShardLoopRule.rule_id, RecoveryShardLoopRule)
