"""CTL10xx — static checks of the mesh legs and collectives, in the
port's spelling (``torch.distributed`` and ``parallel/mesh.py``).

The reference checks its ``shard_map`` bodies and their named mesh
axes; the port runs one Python leg per mesh cell (``run_cells`` /
``map_lanes``) and crosses ranks through ``torch.distributed``.  Nothing
checks a peer, a group, a split count or a rank branch until the fleet
runs on several ranks — one process on the CPU runs the broken program
fine.  These rules interpret the facts of analysis/shardspec.py
(riding the whole-program ``ProgramGraph``) and close that gap
statically:

  CTL1001  group/peer closure — a collective reachable from a mesh leg
           takes its group and peer from the mesh (a literal peer rank,
           or a group built outside parallel/mesh.py, is flagged), and
           a literal rank list handed to ``new_group`` outside
           parallel/mesh.py is flagged tree-wide
  CTL1002  capture-time side effects — host-state mutation (perf
           counter incs, self attr/dict mutation, appends to captured
           host lists, logging/print) in code a CUDA graph captures
           runs ONCE, at capture, and never on replay
  CTL1003  per-cell host sync — ``.item()``/``.cpu()``/``.numpy()``/
           ``synchronize()``/``int()`` of a tensor/``np.*`` on a tensor
           inside a mesh leg (CTL101 reports the legs' device-path
           functions; this rule the rest of each leg)
  CTL1004  split discipline — a leg splits (``chunk``/``tensor_split``)
           by the mesh's cell count, never by a literal
  CTL1005  unreduced accounting — a leg returning a per-cell reduction
           that its caller never sums over the cells (``mesh.psum`` /
           ``all_reduce``) reads one cell's partial as the cluster
           total; plus a literal ``P2POp`` list must not repeat a
           destination or a source
  CTL1006  rank-branch divergence — a collective under a branch on
           ``dist.get_rank()`` or ``parallel.multihost.process_index()``
           runs on some ranks only, and the ranks that enter it wait
           for the others for ever (the multi-rank deadlock)
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import astutil, shardspec
from .core import Finding, ParsedModule, Rule
from .rules_jax import host_sync


def _sorted_reach(ctx, site) -> List[ast.AST]:
    return sorted(
        site.reach,
        key=lambda f: (ctx.mod_of(f, site).relpath,
                       getattr(f, "lineno", 0)))


def _int_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, int) and not isinstance(node.value, bool)


def _builds_group(node: Optional[ast.AST], env: Dict[str, ast.AST],
                  aliases: Dict[str, str]) -> bool:
    """``node`` is a new_group(...) call, or a name bound to one."""
    seen: Set[str] = set()
    while isinstance(node, ast.Name) and node.id in env \
            and node.id not in seen:
        seen.add(node.id)
        node = env[node.id]
    return isinstance(node, ast.Call) and \
        astutil.resolve(node.func, aliases) in shardspec.NEW_GROUP


class GroupClosureRule(Rule):
    rule_id = "CTL1001"
    name = "shard-group-closure"
    description = ("collective reachable from a mesh leg takes a "
                   "literal peer rank or a group built outside "
                   "parallel/mesh.py, or a literal rank list is handed "
                   "to new_group outside parallel/mesh.py (a wrong peer "
                   "surfaces only on a real multi-rank fleet)")

    def finish(self) -> Iterable[Finding]:
        ctx = shardspec.device_context(self.program)
        out: List[Finding] = []
        emitted: Set[Tuple[str, int, str]] = set()

        def emit(mod, line: int, msg: str) -> None:
            key = (mod.relpath, line, msg)
            if key not in emitted:
                emitted.add(key)
                out.append(self.finding(mod, line, msg))

        # literal rank lists, tree-wide
        for mod in self.program.lint_modules():
            if shardspec.is_mesh_module(mod.relpath) or \
                    "new_group" not in mod.source:
                continue
            aliases = astutil.aliases_of(mod)
            for fn, _cls in [(mod.tree, None)] + list(
                    astutil.walk_functions(mod.tree)):
                fname = getattr(fn, "name", "<module>")
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    cn = astutil.resolve(call.func, aliases)
                    if cn not in shardspec.NEW_GROUP:
                        continue
                    ranks = call.args[0] if call.args else None
                    for kw in call.keywords:
                        if kw.arg == "ranks":
                            ranks = kw.value
                    if isinstance(ranks, (ast.List, ast.Tuple)) and \
                            ranks.elts and all(_int_const(e)
                                               for e in ranks.elts):
                        vals = [e.value for e in ranks.elts]
                        emit(mod, call.lineno,
                             f"hardcoded rank list {vals} in "
                             f"{cn.rsplit('.', 1)[-1]}() inside "
                             f"{fname}() — build groups from the mesh's "
                             f"cells in parallel/mesh.py so a resized "
                             f"fleet is one edit")
        # peers and groups of the collectives each leg reaches
        for site in ctx.sites:
            for fn in _sorted_reach(ctx, site):
                mod = ctx.mod_of(fn, site)
                if mod.evidence or shardspec.is_mesh_module(mod.relpath):
                    continue
                aliases = astutil.aliases_of(mod)
                env = {**shardspec.mod_env(mod),
                       **(astutil.fn_env(fn)
                          if not isinstance(fn, ast.Lambda) else {})}
                fname = getattr(fn, "name", "<lambda>")
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    cn = astutil.resolve(call.func, aliases)
                    if cn in shardspec.COLLECTIVES:
                        idx = shardspec.COLLECTIVES[cn]
                    elif cn == shardspec.P2P_OP:
                        idx = 2
                    else:
                        continue
                    tail = cn.rsplit(".", 1)[-1]
                    for peer in shardspec.peer_nodes(call, idx):
                        if _int_const(peer):
                            emit(mod, call.lineno,
                                 f"hardcoded peer rank {peer.value} in "
                                 f"dist.{tail}() inside {fname}(), "
                                 f"reachable from the leg at "
                                 f"{site.where()} — take the peer from "
                                 f"the mesh's cells (mesh.cell(i).rank)")
                    for kw in call.keywords:
                        if kw.arg == "group" and \
                                _builds_group(kw.value, env, aliases):
                            emit(mod, call.lineno,
                                 f"dist.{tail}() inside {fname}(), "
                                 f"reachable from the leg at "
                                 f"{site.where()}, runs over a group "
                                 f"built outside parallel/mesh.py — "
                                 f"take the group from the mesh")
        return out


# mutating container/profiling verbs whose receiver is host state
_MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "write", "put",
}
# perf-counter verbs: host state even through a local handle
_COUNTER_MUTATORS = {"inc", "tinc", "hinc"}
_LOG_ATTRS = {"debug", "info", "warning", "warn", "error",
              "exception", "critical", "log"}
_LOG_RECV = {"logger", "log", "_log", "_logger", "LOG"}


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Nodes executed in ``fn``'s own frame — nested def/lambda bodies
    excluded (they are hot in their own right only if reached)."""
    work = list(ast.iter_child_nodes(fn))
    while work:
        n = work.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            work.extend(ast.iter_child_nodes(n))


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound inside ``fn`` (params, assignments, loop/with
    targets, comprehensions) MINUS global/nonlocal declarations —
    mutation of anything else escapes the trace."""
    out: Set[str] = set()
    a = fn.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        out.add(p.arg)
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)
    escaped: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            escaped.update(node.names)
            continue
        tgts: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            tgts = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                               ast.For, ast.AsyncFor)):
            tgts = [node.target]
        elif isinstance(node, ast.NamedExpr):
            tgts = [node.target]
        elif isinstance(node, (ast.withitem,)):
            if node.optional_vars is not None:
                tgts = [node.optional_vars]
        elif isinstance(node, ast.comprehension):
            tgts = [node.target]
        elif isinstance(node, (ast.FunctionDef,
                               ast.AsyncFunctionDef)) and node is not fn:
            out.add(node.name)
        for t in tgts:
            # only a bare Name (possibly inside tuple/list
            # destructuring) BINDS — `counts["k"] = 1` mutates the
            # existing object and must not make `counts` look local
            work2 = [t]
            while work2:
                n = work2.pop()
                if isinstance(n, ast.Name):
                    out.add(n.id)
                elif isinstance(n, (ast.Tuple, ast.List)):
                    work2.extend(n.elts)
                elif isinstance(n, ast.Starred):
                    work2.append(n.value)
    return out - escaped


def _root_name(node: ast.AST) -> Optional[str]:
    """The leftmost Name of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None



def _region_nodes(region: ast.AST) -> Iterable[ast.AST]:
    """Nodes of a capture ``with`` block's body, nested def/lambda
    bodies excluded."""
    work = list(region.body)
    while work:
        n = work.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            work.extend(ast.iter_child_nodes(n))


def capture_units(ctx, mod) -> List[Tuple[str, Iterable[ast.AST],
                                          Optional[ast.AST]]]:
    """(name, own nodes, scope function) for every capture-set function
    and capture region of ``mod`` (shared by CTL1002 and CTL602)."""
    units: List[Tuple[str, Iterable[ast.AST], Optional[ast.AST]]] = []
    for fn in sorted(ctx.capture_in(mod),
                     key=lambda f: getattr(f, "lineno", 0)):
        units.append((getattr(fn, "name", "<fn>"), list(_own_nodes(fn)),
                      fn))
    for rmod, scope, region in ctx.capture.regions:
        if rmod is mod:
            units.append((getattr(scope, "name", "<module>"),
                          list(_region_nodes(region)), scope))
    return units


class CaptureTimeEffectRule(Rule):
    rule_id = "CTL1002"
    name = "shard-capture-time-effect"
    description = ("host-state mutation (perf counter inc, self "
                   "attr/dict mutation, append to a captured list, "
                   "logging/print) in code a CUDA graph captures — it "
                   "runs ONCE, at capture, so every count and log of "
                   "the replays silently lies")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        ctx = shardspec.device_context(mod.program)
        units = capture_units(ctx, mod)
        if not units:
            return ()
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        seen: Set[Tuple[int, str]] = set()

        def emit(line: int, msg: str) -> None:
            if (line, msg) not in seen:
                seen.add((line, msg))
                out.append(self.finding(mod, line, msg))

        for fname, nodes, scope in units:
            local = _local_names(scope) if scope is not None else set()
            env = astutil.fn_env(scope) if scope is not None else {}
            params = astutil.tensor_params(scope) \
                if scope is not None else set()

            def host_chain(node: ast.AST) -> Optional[str]:
                """Dotted text when the chain roots in host state."""
                root = _root_name(node)
                if root is None:
                    return None
                base = node
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if astutil.tensor_valued(base, aliases, env, params):
                    return None           # a tensor write is captured
                if root in ("self", "cls") or root not in local:
                    return astutil.dotted(node) or root
                return None

            for node in nodes:
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    tgts = node.targets \
                        if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in tgts:
                        if not isinstance(t, (ast.Attribute,
                                              ast.Subscript)):
                            continue
                        chain = host_chain(t)
                        if chain:
                            emit(node.lineno,
                                 f"mutation of host state "
                                 f"'{chain}' in graph-captured "
                                 f"{fname}() happens once at capture, "
                                 f"not per replay — hoist it out of "
                                 f"the captured region or keep the "
                                 f"value in a tensor")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id == "print":
                    emit(node.lineno,
                         f"print() in graph-captured {fname}() runs "
                         f"once at capture — the replays print nothing")
                    continue
                if isinstance(f, ast.Attribute):
                    recv = f.value
                    if f.attr in _COUNTER_MUTATORS:
                        emit(node.lineno,
                             f".{f.attr}() perf-counter write in "
                             f"graph-captured {fname}() counts the "
                             f"capture, not the replays — move it to "
                             f"the replay site")
                        continue
                    if f.attr in _MUTATORS:
                        chain = host_chain(recv)
                        if chain:
                            emit(node.lineno,
                                 f".{f.attr}() on captured host "
                                 f"state '{chain}' in graph-captured "
                                 f"{fname}() mutates once at capture — "
                                 f"every replay silently skips it")
                        continue
                    if f.attr in _LOG_ATTRS:
                        rn = astutil.resolve(recv, aliases)
                        root = _root_name(recv)
                        if (rn and rn.split(".")[0] == "logging") or \
                                root in _LOG_RECV:
                            emit(node.lineno,
                                 f"logging call in graph-captured "
                                 f"{fname}() fires once at capture — "
                                 f"log at the replay site")
        return out


class LegHostSyncRule(Rule):
    rule_id = "CTL1003"
    name = "shard-per-cell-sync"
    description = ("host sync (.item()/.cpu()/.numpy()/synchronize()/"
                   "int() or np.* of a tensor) inside a mesh leg — "
                   "each cell round-trips to the host per dispatch")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence:
            return ()
        ctx = shardspec.device_context(mod.program)
        here = [(fn, sites) for fn, sites in ctx.shard_fns.items()
                if ctx.mod_of(fn, sites[0]) is mod
                and fn not in ctx.hot]      # CTL101 reports those
        if not here:
            return ()
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        seen: Set[Tuple[int, str]] = set()
        for fn, sites in sorted(
                here, key=lambda p: getattr(p[0], "lineno", 0)):
            fname = getattr(fn, "name", "<lambda>")
            lam = isinstance(fn, ast.Lambda)
            env = astutil.fn_env(fn) if not lam else {}
            params = astutil.tensor_params(fn) if not lam else set()
            site = min(sites, key=lambda s: (s.mod.relpath, s.lineno))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                what = host_sync(node, aliases, env, params)
                if what is None:
                    continue
                msg = (f"{what} inside {fname}(), a leg of the cell "
                       f"run at {site.where()} — each cell "
                       f"round-trips to the host per dispatch")
                if (node.lineno, msg) not in seen:
                    seen.add((node.lineno, msg))
                    out.append(self.finding(mod, node.lineno, msg))
        return out


_SPLITS = {"chunk", "tensor_split"}


class SplitDisciplineRule(Rule):
    rule_id = "CTL1004"
    name = "shard-split-discipline"
    description = ("a mesh leg (or the function that runs it) splits "
                   "by a literal count instead of the mesh's cell "
                   "count — a resized mesh silently mis-splits")

    def finish(self) -> Iterable[Finding]:
        ctx = shardspec.device_context(self.program)
        out: List[Finding] = []
        emitted: Set[Tuple[str, int]] = set()
        for site in ctx.sites:
            scopes = [(site.mod, b) for b in site.bodies] + \
                ([(site.mod, site.enclosing)]
                 if site.enclosing is not None else [])
            for smod, scope in scopes:
                smod = ctx.mod_of(scope, site) or smod
                if smod.evidence:
                    continue
                aliases = astutil.aliases_of(smod)
                fname = getattr(scope, "name", "<lambda>")
                for call in ast.walk(scope):
                    if not isinstance(call, ast.Call):
                        continue
                    cn = astutil.resolve(call.func, aliases) or ""
                    tail = cn.rsplit(".", 1)[-1]
                    if tail not in _SPLITS:
                        continue
                    if cn.startswith("torch."):
                        count = call.args[1] if len(call.args) > 1 \
                            else None
                    elif isinstance(call.func, ast.Attribute):
                        count = call.args[0] if call.args else None
                    else:
                        continue
                    for kw in call.keywords:
                        if kw.arg in ("chunks", "sections",
                                      "indices_or_sections"):
                            count = kw.value
                    if count is None or not _int_const(count) or \
                            count.value < 2:
                        continue
                    if (smod.relpath, call.lineno) in emitted:
                        continue
                    emitted.add((smod.relpath, call.lineno))
                    out.append(self.finding(
                        smod, call.lineno,
                        f"{tail}() by a literal {count.value} in "
                        f"{fname}() at the cell run {site.where()} — "
                        f"split by the mesh's cell count (mesh.size / "
                        f"split.blocks) so a resized mesh stays right"))
        return out


_REDUCTIONS = {"sum", "mean", "max", "min", "prod", "count_nonzero",
               "nansum", "nanmean", "average", "any", "all"}
# the sums over cells: mesh.psum, all_reduce, or a host sum
_CELL_SUMS = {"psum", "all_reduce", "all_reduce_sum", "sum",
              "reduce", "reduce_scatter", "reduce_scatter_tensor"}


def _call_names(expr: ast.AST, env: Dict[str, ast.AST],
                aliases: Dict[str, str]) -> Set[str]:
    """Resolved callee names in ``expr``, expanded through local
    single assignments (sees through ``rows = psum(...)``)."""
    names: Set[str] = set()
    seen: Set[str] = set()
    work: List[ast.AST] = [expr]
    while work:
        e = work.pop()
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                cn = astutil.resolve(n.func, aliases)
                if cn:
                    names.add(cn)
            elif isinstance(n, ast.Name) and n.id in env \
                    and n.id not in seen:
                seen.add(n.id)
                work.append(env[n.id])
    return names


def _p2p_pairs(node: ast.AST, aliases: Dict[str, str]
               ) -> Optional[List[Tuple[str, int]]]:
    """(op tail, literal peer) per element of a literal P2POp list,
    else None."""
    if not isinstance(node, (ast.List, ast.Tuple)) or not node.elts:
        return None
    pairs: List[Tuple[str, int]] = []
    for e in node.elts:
        if not (isinstance(e, ast.Call) and
                astutil.resolve(e.func, aliases) == shardspec.P2P_OP):
            return None
        peers = shardspec.peer_nodes(e, 2)
        op = astutil.resolve(e.args[0], aliases) if e.args else None
        if op is None or len(peers) != 1 or not _int_const(peers[0]):
            return None
        pairs.append((op.rsplit(".", 1)[-1], peers[0].value))
    return pairs


class UnreducedAccountingRule(Rule):
    rule_id = "CTL1005"
    name = "shard-unreduced-accounting"
    description = ("a mesh leg returns a per-cell reduction that the "
                   "function running it never sums over the cells "
                   "(mesh.psum / all_reduce) — one cell's partial reads "
                   "as the cluster total; also flags literal P2POp "
                   "lists that repeat a destination or a source")

    def finish(self) -> Iterable[Finding]:
        ctx = shardspec.device_context(self.program)
        g = ctx.graph
        out: List[Finding] = []
        emitted: Set[Tuple[str, int, str]] = set()

        def emit(mod, line: int, msg: str) -> None:
            key = (mod.relpath, line, msg)
            if key not in emitted:
                emitted.add(key)
                out.append(self.finding(mod, line, msg))

        def tail_of(call: ast.Call) -> Optional[str]:
            d = astutil.dotted(call.func)
            return d.rsplit(".", 1)[-1] if d else None

        def sums_cells(site) -> bool:
            """Does the function running the leg (its own frame, or
            what it calls outside the leg) sum over the cells?"""
            encl = site.enclosing
            if encl is None:
                return False
            cls = g.cls_of.get(encl)
            tgts: Set[ast.AST] = set()
            for call in _own_nodes(encl):
                if isinstance(call, ast.Call):
                    if tail_of(call) in _CELL_SUMS:
                        return True
                    tgts.update(g.resolve_call(site.mod, cls, call))
            scope = (tgts | g.reachable(tgts)) - set(site.bodies)
            return any(isinstance(c, ast.Call) and
                       tail_of(c) in _CELL_SUMS
                       for fn in scope for c in _own_nodes(fn))

        for site in ctx.sites:
            body = next((b for b in site.bodies
                         if isinstance(b, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))),
                        None)
            if body is None:
                continue
            bmod = ctx.mod_of(body, site)
            if bmod.evidence:
                continue
            aliases = astutil.aliases_of(bmod)
            env = astutil.fn_env(body)
            for ret in _own_nodes(body):
                if not isinstance(ret, ast.Return) or \
                        ret.value is None:
                    continue
                elems = ret.value.elts \
                    if isinstance(ret.value, ast.Tuple) \
                    else [ret.value]
                for i, e in enumerate(elems):
                    names = _call_names(e, env, aliases)
                    tails = {n.rsplit(".", 1)[-1] for n in names}
                    if not tails & _REDUCTIONS:
                        continue
                    if sums_cells(site):
                        continue
                    emit(bmod, ret.lineno,
                         f"leg {body.name}() returns a per-cell "
                         f"reduction at position {i} and "
                         f"{site.enclosing_name}() never sums it over "
                         f"the cells (mesh.psum / dist.all_reduce) at "
                         f"the cell run {site.where()} — one cell's "
                         f"partial reads as the cluster total")
        # literal P2POp lists, tree-wide (a list inside a nested def is
        # seen from every enclosing function: report it once)
        p2p_seen: Set[Tuple[str, int]] = set()
        for mod in self.program.lint_modules():
            if "P2POp" not in mod.source:
                continue
            aliases = astutil.aliases_of(mod)
            for fn, _cls in astutil.walk_functions(mod.tree):
                for node in ast.walk(fn):
                    if not isinstance(node, (ast.List, ast.Tuple)):
                        continue
                    if (mod.relpath, node.lineno) in p2p_seen:
                        continue
                    pairs = _p2p_pairs(node, aliases)
                    if pairs is None:
                        continue
                    p2p_seen.add((mod.relpath, node.lineno))
                    for op, what in (("isend", "destination"),
                                     ("irecv", "source")):
                        peers = [p for o, p in pairs if o == op]
                        if len(set(peers)) != len(peers):
                            emit(mod, node.lineno,
                                 f"P2POp list in {fn.name}() repeats "
                                 f"a {what} — a ring exchange must "
                                 f"send to and receive from each peer "
                                 f"once, or a block is dropped or "
                                 f"overwritten")
        return out


class RankBranchDivergenceRule(Rule):
    rule_id = "CTL1006"
    name = "shard-rank-branch-divergence"
    description = ("collective under a branch on dist.get_rank() or "
                   "parallel.multihost.process_index() — the ranks "
                   "that enter it wait for ever on the ranks that do "
                   "not (the multi-rank deadlock); run the collective "
                   "on every rank and branch on its result")

    def begin(self, program) -> None:
        super().begin(program)
        self._collective_fns: Optional[Set[ast.AST]] = None

    def _reaching(self) -> Set[ast.AST]:
        """Functions that run a collective, directly or through
        callees (precise call edges only)."""
        if self._collective_fns is not None:
            return self._collective_fns
        g = astutil.program_graph(self.program)
        # each lint function's own calls, walked once: (call, tail)
        calls: Dict[ast.AST, List[Tuple[ast.Call, str]]] = {}
        direct: Set[ast.AST] = set()
        for fn in g.mod_of:
            mod = g.mod_of[fn]
            if mod.evidence:
                continue
            aliases = astutil.aliases_of(mod)
            own = calls[fn] = []
            for call in _own_nodes(fn):
                if not isinstance(call, ast.Call):
                    continue
                if shardspec.collective_name(call, aliases):
                    direct.add(fn)
                d = astutil.dotted(call.func)
                if d:
                    own.append((call, d.rsplit(".", 1)[-1]))
        # callers, to a fixed point, over precise edges only
        out = set(direct)
        while True:
            names = {f.name for f in out}
            grown = False
            for fn, own in calls.items():
                if fn in out:
                    continue
                mod, cls = g.mod_of[fn], g.cls_of[fn]
                if any(tail in names and set(g.resolve_call(
                        mod, cls, call, precise=True)) & out
                       for call, tail in own):
                    out.add(fn)
                    grown = True
            if not grown:
                break
        self._collective_fns = out
        return out

    def finish(self) -> Iterable[Finding]:
        g = astutil.program_graph(self.program)
        out: List[Finding] = []
        for mod in self.program.lint_modules():
            if not any(t in mod.source for t in shardspec.RANK_READ_TAILS):
                continue
            aliases = astutil.aliases_of(mod)
            for fn, cls in astutil.walk_functions(mod.tree):
                env = astutil.fn_env(fn)
                for node in _own_nodes(fn):
                    if not isinstance(node, (ast.If, ast.While)):
                        continue
                    if not self._on_rank(node.test, env, aliases):
                        continue
                    hit = self._collective_in(node, mod, cls, aliases,
                                              g)
                    if hit is None:
                        continue
                    out.append(self.finding(
                        mod, node.lineno,
                        f"{hit} under a branch on the process rank in "
                        f"{fn.name}() — the ranks that take the other "
                        f"branch never join it and the fleet deadlocks; "
                        f"run the collective on every rank and branch "
                        f"on its result"))
        return out

    @staticmethod
    def _on_rank(test: ast.AST, env: Dict[str, ast.AST],
                 aliases: Dict[str, str]) -> bool:
        seen: Set[str] = set()
        work = [test]
        while work:
            e = work.pop()
            for n in ast.walk(e):
                if shardspec.is_rank_read(n, aliases):
                    return True
                if isinstance(n, ast.Name) and n.id in env \
                        and n.id not in seen:
                    seen.add(n.id)
                    work.append(env[n.id])
        return False

    def _collective_in(self, branch: ast.AST, mod, cls, aliases,
                       g) -> Optional[str]:
        reaching = self._reaching()
        for stmt in list(branch.body) + list(branch.orelse):
            for call in ast.walk(stmt):
                if not isinstance(call, ast.Call):
                    continue
                cn = shardspec.collective_name(call, aliases)
                if cn:
                    return f"dist.{cn.rsplit('.', 1)[-1]}()"
                for tgt in g.resolve_call(mod, cls, call, precise=True):
                    if tgt in reaching:
                        return (f"{tgt.name}() (which runs a "
                                f"collective)")
        return None


def register(reg) -> None:
    reg.add(GroupClosureRule.rule_id, GroupClosureRule)
    reg.add(CaptureTimeEffectRule.rule_id, CaptureTimeEffectRule)
    reg.add(LegHostSyncRule.rule_id, LegHostSyncRule)
    reg.add(SplitDisciplineRule.rule_id, SplitDisciplineRule)
    reg.add(UnreducedAccountingRule.rule_id, UnreducedAccountingRule)
    reg.add(RankBranchDivergenceRule.rule_id,
            RankBranchDivergenceRule)
