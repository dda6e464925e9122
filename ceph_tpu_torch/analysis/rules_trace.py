"""CTL7xx — trace-context propagation closure (ClusterTelemetry).

Cross-process tracing only works if every hop carries the trace
context forward: the objecter/AsyncObjecter chokepoints stamp
``(trace_id, span_id)`` into every request they send (``tctx`` in
the typed meta of MSG_REQ / MSG_REQ_SG frames), and daemons link
their stage spans under it.  The failure mode is SILENT: a wire send
or dispatch fan-out site that builds its own request dict and ships
it through a raw connection never propagates the context, the trace
simply has a hole where that hop's spans should be, and nobody
notices until a slow op's flame trace dead-ends mid-cluster — the
silent-trace-gap bug class (the v1 sweep found 11 real gaps: the
client's snapset/digest/recovery sends and every daemon peer_req).

  CTL701  a raw wire send (``<conn>.call({...})`` / ``_peer_req(n,
          {...})``) in cluster//client/ whose request names a
          DATA-PATH command but neither passed through
          ``tracer.stamp(...)`` nor carries a ``tctx`` key

CTLint v2 promotes the check to the whole-program graph; three send
shapes are covered:

  * the dict literal passed directly to the raw send (v1);
  * a dict literal bound to a LOCAL NAME first and sent later in the
    same function (``req = {...}; conn.call(req)``) — clean when the
    function stamps the name in between (``req = stamp(req)`` /
    ``req["tctx"] = ...``);
  * a dict literal handed to a WRAPPER function that forwards its
    parameter to a raw send (resolved through the import-aware call
    graph, wrapper-of-wrapper included) — the hop that v1 could not
    see because the send lives one module away.

Sends through the stamping chokepoints (``osd_call`` /
``call_async`` / ``aio_osd_call``) are exempt — AsyncObjecter.
call_async stamps centrally — as is any wrapper that itself stamps
(calls ``*.stamp(...)`` or assigns a ``tctx`` key) before sending.
Control traffic (maps, pings, boots, mon commands) is exempt: only
the tracked data-path commands carry op traces.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import astutil
from .core import Finding, ParsedModule, Rule

# the tracked wire data-path commands (cluster/daemon.py
# _TRACKED_CMDS): the ops whose traces an operator hunts
_DATA_CMDS = frozenset((
    "put_shard", "get_shard", "delete_shard", "setattr_shard",
    "getattr_shard", "stat_shard", "digest_shard", "copy_from",
    "put_object", "delete_object", "exec_cls"))

# raw send callables that do NOT stamp centrally; osd_call /
# call_async route through AsyncObjecter's stamping and are exempt
_RAW_SENDS = frozenset(("call", "_peer_req"))

# chokepoint names that must never be treated as gap wrappers even
# though their bodies forward to a raw send: they stamp centrally
# (call_async) or route through something that does (osd_call ->
# aio.call -> call_async)
_CHOKEPOINT_FNS = frozenset(("osd_call", "aio_osd_call",
                             "call_async", "mon_call"))

_SCOPE_DIRS = frozenset(("cluster", "client"))


def _in_scope(mod: ParsedModule) -> bool:
    parts = mod.relpath.replace("\\", "/").split("/")[:-1]
    return any(p in _SCOPE_DIRS for p in parts)


def _data_cmd_of(node: ast.AST):
    """The constant data-path command name of a dict-literal request,
    or None (non-dict, computed cmd, control command)."""
    if not isinstance(node, ast.Dict):
        return None
    cmd = None
    has_tctx = False
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and
                isinstance(k.value, str)):
            continue
        if k.value == "cmd" and isinstance(v, ast.Constant) and \
                isinstance(v.value, str):
            cmd = v.value
        elif k.value == "tctx":
            has_tctx = True
    if cmd in _DATA_CMDS and not has_tctx:
        return cmd
    return None


def _send_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _fn_stamps(fn: ast.AST) -> bool:
    """Does this function stamp a request itself?  True for a
    ``*.stamp(...)`` call or a ``x["tctx"] = ...`` assignment
    anywhere in the body — the AsyncObjecter.call_async shape."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = _send_name(node)
            if name == "stamp":
                return True
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.slice, ast.Constant) and \
                        tgt.slice.value == "tctx":
                    return True
    return False


def _param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


class TraceGapRule(Rule):
    rule_id = "CTL701"
    name = "wire-send-without-trace-context"
    description = ("raw wire send / dispatch fan-out builds a "
                   "data-path request without propagating the active "
                   "trace context (the silent-trace-gap bug class): "
                   "wrap the request in tracer.stamp(...) or route "
                   "through the stamping chokepoints — checked over "
                   "the whole-program graph (wrapper sends included)")

    def __init__(self) -> None:
        super().__init__()
        self.mods: List[ParsedModule] = []

    # ------------------------------------------------------- wrappers --
    def _raw_wrappers(self, graph) -> Dict[ast.AST, Set[int]]:
        """fn -> positions of parameters forwarded (transitively) to
        a raw send.  A function that stamps internally, or bears a
        chokepoint name, is never a gap wrapper."""
        wrappers: Dict[ast.AST, Set[int]] = {}
        candidates = []
        for fn, mod in ((f, graph.mod_of[f]) for f in graph.mod_of):
            if mod.evidence or not _in_scope(mod):
                continue
            if fn.name in _CHOKEPOINT_FNS or \
                    not isinstance(fn, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                continue
            if _fn_stamps(fn):
                continue
            candidates.append(fn)
        changed = True
        while changed:
            changed = False
            for fn in candidates:
                mod = graph.mod_of[fn]
                cls = graph.cls_of[fn]
                params = _param_names(fn)
                fwd: Set[int] = set(wrappers.get(fn, set()))
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    positions: Set[int] = set()
                    name = _send_name(call)
                    if name in _RAW_SENDS:
                        positions = set(range(len(call.args)))
                    else:
                        for tgt in graph.resolve_call(mod, cls, call):
                            for i in wrappers.get(tgt, ()):
                                # account for the bound self arg of
                                # method calls: wrapper param i is
                                # caller arg i-1 when the target is a
                                # method invoked via attribute access
                                off = 1 if (graph.cls_of[tgt] and
                                            isinstance(call.func,
                                                       ast.Attribute)
                                            ) else 0
                                positions.add(i - off)
                    for pos in positions:
                        if not 0 <= pos < len(call.args):
                            continue
                        a = call.args[pos]
                        if isinstance(a, ast.Name) and \
                                a.id in params:
                            idx = params.index(a.id)
                            if idx not in fwd:
                                fwd.add(idx)
                                changed = True
                if fwd:
                    wrappers[fn] = fwd
        return wrappers

    # ------------------------------------------------------ collection --
    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if not mod.evidence and _in_scope(mod):
            self.mods.append(mod)
        return ()

    def finish(self) -> Iterable[Finding]:
        graph = astutil.program_graph(self.program)
        wrappers = self._raw_wrappers(graph)
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()

        def emit(mod: ParsedModule, node: ast.AST, cmd: str,
                 how: str) -> None:
            if (mod.relpath, node.lineno) in seen:
                return
            seen.add((mod.relpath, node.lineno))
            out.append(self.finding(
                mod, node.lineno,
                f"data-path request {cmd!r} {how} without trace "
                f"propagation — wrap it in tracer.stamp(...) (or "
                f"carry 'tctx') so the receiving daemon's spans "
                f"link into the op's trace instead of leaving a "
                f"silent gap"))

        for mod in self.mods:
            for fn, cls in astutil.walk_functions(mod.tree):
                # local names bound to an unstamped data-cmd dict,
                # minus names the function later stamps
                bound: Dict[str, Tuple[ast.AST, str]] = {}
                stamped: Set[str] = set()
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) and \
                            len(node.targets) == 1 and \
                            isinstance(node.targets[0], ast.Name):
                        cmd = _data_cmd_of(node.value)
                        if cmd is not None:
                            bound[node.targets[0].id] = \
                                (node.value, cmd)
                        elif isinstance(node.value, ast.Call):
                            # req = stamp(req) / req = dict(req, ...)
                            stamped.add(node.targets[0].id)
                    elif isinstance(node, ast.Assign):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Subscript) and \
                                    isinstance(tgt.value, ast.Name) \
                                    and isinstance(tgt.slice,
                                                   ast.Constant) \
                                    and tgt.slice.value == "tctx":
                                stamped.add(tgt.value.id)
                    elif isinstance(node, ast.Call) and \
                            _send_name(node) == "stamp":
                        for a in node.args:
                            if isinstance(a, ast.Name):
                                stamped.add(a.id)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    name = _send_name(node)
                    if name in _RAW_SENDS:
                        for arg in node.args:
                            cmd = _data_cmd_of(arg)
                            if cmd is not None:
                                emit(mod, arg, cmd,
                                     "sent over a raw connection")
                            elif isinstance(arg, ast.Name) and \
                                    arg.id in bound and \
                                    arg.id not in stamped:
                                emit(mod, node,
                                     bound[arg.id][1],
                                     "sent over a raw connection")
                        continue
                    # wrapper send: the dict rides a parameter that
                    # the callee (possibly in another module)
                    # forwards to a raw send
                    for tgt in graph.resolve_call(mod, cls, node):
                        fwd = wrappers.get(tgt)
                        if not fwd:
                            continue
                        off = 1 if (graph.cls_of[tgt] and
                                    isinstance(node.func,
                                               ast.Attribute)) else 0
                        for i in fwd:
                            pos = i - off
                            if not 0 <= pos < len(node.args):
                                continue
                            arg = node.args[pos]
                            cmd = _data_cmd_of(arg)
                            if cmd is not None:
                                emit(mod, arg, cmd,
                                     f"handed to raw-send wrapper "
                                     f"{tgt.name!r}")
        return out


_PERF_FACTORIES = frozenset(("perf", "_perf"))
_PC_MUTATORS = frozenset(("inc", "set", "tinc", "hinc"))
_HISTORY_MODULE = "mgr/metrics_history.py"


def _perf_group_of(node: ast.AST) -> Optional[str]:
    """The constant group name when ``node`` is ``perf("g")`` /
    ``_perf("g")``, else None."""
    if isinstance(node, ast.Call) and \
            _send_name(node) in _PERF_FACTORIES and node.args and \
            isinstance(node.args[0], ast.Constant) and \
            isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


class RateCounterMonotonicRule(Rule):
    rule_id = "CTL702"
    name = "rate-counter-not-monotonic"
    description = ("a perf counter the metrics-history rate layer "
                   "queries (mgr/metrics_history.py RATE_COUNTERS) "
                   "must be MONOTONIC at its declaration site: only "
                   "``.inc()`` may ever touch it — a ``.set()`` "
                   "retype feeds a gauge into the delta pipeline and "
                   "every derived rate is silently garbage; each "
                   "listed counter also needs at least one inc site "
                   "(the declaration), or the history ring records "
                   "nothing")

    # ----------------------------------------------------- contract --
    def _rate_pairs(self) -> Tuple[List[Tuple[str, str]],
                                   Optional[ParsedModule], int]:
        """The (group, key) pairs of the RATE_COUNTERS literal in
        mgr/metrics_history.py, plus the module and the literal's
        line (anchor for missing-inc findings)."""
        for mod in self.program.modules.values():
            if not mod.relpath.replace("\\", "/") \
                    .endswith(_HISTORY_MODULE):
                continue
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Assign) and
                        len(node.targets) == 1 and
                        isinstance(node.targets[0], ast.Name) and
                        node.targets[0].id == "RATE_COUNTERS"):
                    continue
                pairs: List[Tuple[str, str]] = []
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for el in node.value.elts:
                        if isinstance(el, (ast.Tuple, ast.List)) and \
                                len(el.elts) == 2 and all(
                                    isinstance(c, ast.Constant) and
                                    isinstance(c.value, str)
                                    for c in el.elts):
                            pairs.append((el.elts[0].value,
                                          el.elts[1].value))
                return pairs, mod, node.lineno
        return [], None, 0

    # ------------------------------------------------------- bindings --
    @staticmethod
    def _attr_groups(mods: Iterable[ParsedModule]) -> Dict[str, str]:
        """``self.X = _perf("g")`` sites across the tree: attribute
        name -> group (the class-attr receiver shape, e.g. daemon.py
        ``self._pc_io = _perf("osd.io")``)."""
        out: Dict[str, str] = {}
        for mod in mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assign) and \
                        len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Attribute):
                    g = _perf_group_of(node.value)
                    if g is not None:
                        out[node.targets[0].attr] = g
        return out

    def finish(self) -> Iterable[Finding]:
        pairs, hist_mod, decl_line = self._rate_pairs()
        if not pairs:
            return ()
        rate_set = set(pairs)
        mods = [m for m in self.program.lint_modules()]
        attr_groups = self._attr_groups(mods)
        inc_seen: Set[Tuple[str, str]] = set()
        out: List[Finding] = []
        for mod in mods:
            for fn, _cls in astutil.walk_functions(mod.tree):
                local: Dict[str, str] = {}
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) and \
                            len(node.targets) == 1 and \
                            isinstance(node.targets[0], ast.Name):
                        g = _perf_group_of(node.value)
                        if g is not None:
                            local[node.targets[0].id] = g
                for node in ast.walk(fn):
                    if not (isinstance(node, ast.Call) and
                            isinstance(node.func, ast.Attribute) and
                            node.func.attr in _PC_MUTATORS and
                            node.args and
                            isinstance(node.args[0], ast.Constant) and
                            isinstance(node.args[0].value, str)):
                        continue
                    recv = node.func.value
                    group = _perf_group_of(recv)
                    if group is None and isinstance(recv, ast.Name):
                        group = local.get(recv.id)
                    if group is None and \
                            isinstance(recv, ast.Attribute):
                        group = attr_groups.get(recv.attr)
                    if group is None:
                        continue
                    key = node.args[0].value
                    if (group, key) not in rate_set:
                        continue
                    if node.func.attr == "inc":
                        inc_seen.add((group, key))
                    else:
                        out.append(self.finding(
                            mod, node.lineno,
                            f"history rate counter "
                            f"{group}.{key} updated via "
                            f".{node.func.attr}() — RATE_COUNTERS "
                            f"entries must be monotonic (inc-only); "
                            f"a gauge in the delta pipeline yields "
                            f"garbage rates silently"))
        if hist_mod is not None:
            for group, key in pairs:
                if (group, key) not in inc_seen:
                    out.append(self.finding(
                        hist_mod, decl_line,
                        f"RATE_COUNTERS lists {group}.{key} but no "
                        f".inc() declaration site exists in the "
                        f"tree — the history/rate layer would query "
                        f"a counter nothing increments"))
        return out


def register(reg) -> None:
    reg.add("CTL701", TraceGapRule)
    reg.add("CTL702", RateCounterMonotonicRule)
