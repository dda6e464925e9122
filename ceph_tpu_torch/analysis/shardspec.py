"""The mesh model the CTL10xx rules (analysis/rules_shard.py) interpret,
in the port's spelling: ``torch.distributed`` and ``parallel/mesh.py``.

The reference pins every collective to a named mesh axis inside a
``shard_map`` body.  The port runs one Python leg per mesh cell
(``parallel/mesh.run_cells(mesh, fn)`` / ``map_lanes(mesh, fn, ...)``)
and crosses ranks through ``torch.distributed`` (``all_reduce``,
``all_gather_into_tensor``, ``batch_isend_irecv`` over ``P2POp``s), with
its groups and peers taken from the mesh's cells.  Nothing checks a
peer, a group or a split count until the fleet runs on several ranks.
This module builds, once per lint run, the whole-program facts those
checks need:

  * **leg sites** — every ``run_cells`` / ``map_lanes`` call with its
    leg body resolved (a lambda, a nested ``def`` of an enclosing scope,
    then the ``ProgramGraph``), its enclosing function, and the
    transitive closure of the body over the resolved call graph (the
    set CTL1001/CTL1003 walk);
  * **collective sites** — the canonical ``torch.distributed`` calls
    that cross ranks, with the argument that names their peer;
  * **device context** — the device-path and capture sets, shared
    VERBATIM with CTL1xx/CTL6xx via ``astutil._program_hot`` and
    ``astutil.capture_set``, plus the messenger-callback roots CTL110
    consumes — so every rule family agrees on one reachability
    computation per run.

Everything is cached on ``Program._cache['device_ctx']``; rules call
:func:`device_context` and share the single instance.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from . import astutil

# canonical collective spellings -> positional index of the peer
# (src/dst) argument, None when the collective spans the whole group
COLLECTIVES: Dict[str, Optional[int]] = {
    "torch.distributed.all_reduce": None,
    "torch.distributed.all_gather": None,
    "torch.distributed.all_gather_into_tensor": None,
    "torch.distributed.all_gather_object": None,
    "torch.distributed.reduce_scatter": None,
    "torch.distributed.reduce_scatter_tensor": None,
    "torch.distributed.all_to_all": None,
    "torch.distributed.all_to_all_single": None,
    "torch.distributed.broadcast": 1,
    "torch.distributed.reduce": 1,
    "torch.distributed.gather": None,
    "torch.distributed.scatter": None,
    "torch.distributed.barrier": None,
    "torch.distributed.batch_isend_irecv": None,
    "torch.distributed.send": 1,
    "torch.distributed.recv": 1,
    "torch.distributed.isend": 1,
    "torch.distributed.irecv": 1,
}
_PEER_KWARGS = ("dst", "src", "peer", "group_dst", "group_src")
P2P_OP = "torch.distributed.P2POp"
NEW_GROUP = {"torch.distributed.new_group",
             "torch.distributed.new_subgroups_by_enumeration"}
# leg runners of parallel/mesh.py: name -> positional index of the leg
LEG_RUNNERS = {"run_cells": 1, "map_lanes": 1}
# rank reads: torch.distributed's own and parallel/multihost's twin
RANK_READS = {"torch.distributed.get_rank"}
RANK_READ_TAILS = {"get_rank", "process_index"}
# text a module must hold for _scan_module to find anything in it
_SCAN_MARKERS = tuple(LEG_RUNNERS) + ("cb=", "set_complete_callback",
                                      "add_done_callback")


def is_mesh_module(relpath: str) -> bool:
    """The module(s) that build groups and peers: ``parallel/mesh.py``
    (or any ``mesh.py``); everyone else takes them from a mesh."""
    return relpath.replace("\\", "/").rsplit("/", 1)[-1] == "mesh.py"


def mod_env(mod) -> Dict[str, ast.AST]:
    """Module-level simple assignments (``GROUP = new_group(...)``)."""
    cached = mod._cache.get("shard_mod_env")
    if cached is not None:
        return cached
    env: Dict[str, ast.AST] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            env[node.targets[0].id] = node.value
    mod._cache["shard_mod_env"] = env
    return env


def collective_name(call: ast.Call, aliases: Dict[str, str]
                    ) -> Optional[str]:
    cn = astutil.resolve(call.func, aliases)
    return cn if cn in COLLECTIVES else None


def peer_nodes(call: ast.Call, idx: Optional[int]) -> List[ast.AST]:
    """The peer argument expression(s) of a collective or P2POp call."""
    out: List[ast.AST] = []
    if idx is not None and len(call.args) > idx:
        out.append(call.args[idx])
    out.extend(kw.value for kw in call.keywords
               if kw.arg in _PEER_KWARGS)
    return out


def is_rank_read(call: ast.AST, aliases: Dict[str, str]) -> bool:
    if not isinstance(call, ast.Call):
        return False
    cn = astutil.resolve(call.func, aliases)
    if cn in RANK_READS:
        return True
    d = astutil.dotted(call.func)
    return d is not None and d.rsplit(".", 1)[-1] in RANK_READ_TAILS


# --------------------------------------------------------------- context --

class LegSite:
    """One statically-collected ``run_cells`` / ``map_lanes`` call."""

    def __init__(self, mod, call: ast.Call,
                 enclosing: Optional[ast.AST],
                 bodies: List[ast.AST], reach: Set[ast.AST]) -> None:
        self.mod = mod
        self.call = call
        self.lineno = call.lineno
        self.enclosing = enclosing    # FunctionDef or None (module)
        self.bodies = bodies          # FunctionDef / Lambda nodes
        self.reach = reach            # bodies + transitive callees

    @property
    def enclosing_name(self) -> str:
        return self.enclosing.name if self.enclosing is not None \
            else "<module>"

    def where(self) -> str:
        return f"{self.enclosing_name}() ({self.mod.relpath})"


class DeviceContext:
    """The once-per-run shared reachability + mesh facts (see module
    docstring).  CTL602, CTL110 and every CTL10xx rule read this; the
    device-path set is the SAME object ``astutil.hot_functions``
    slices, so the families cannot disagree."""

    def __init__(self, program) -> None:
        self.program = program
        self.graph = astutil.program_graph(program)
        hot = astutil._program_hot(program)
        self.hot: Set[ast.AST] = hot.hot
        self.direct = hot.direct
        self.capture = astutil.capture_set(program)
        self.sites: List[LegSite] = []
        # root callable -> (origin name, ParsedModule, enclosing cls)
        self.callback_roots: Dict[ast.AST, tuple] = {}
        self._reach_cache: Dict[ast.AST, Set[ast.AST]] = {}
        for mod in program.modules.values():
            # only a module that names a leg runner or registers a
            # callback can hold a site (a cheap text test first)
            if not mod.evidence and any(t in mod.source
                                        for t in _SCAN_MARKERS):
                self._scan_module(mod)
        # fn -> leg sites whose bodies reach it
        self.shard_fns: Dict[ast.AST, List[LegSite]] = {}
        for site in self.sites:
            for fn in site.reach:
                self.shard_fns.setdefault(fn, []).append(site)

    # ------------------------------------------------------- hot slices --
    def hot_in(self, mod) -> Set[ast.AST]:
        """Device-path functions OF one module."""
        return astutil.hot_functions(mod).hot

    def capture_in(self, mod) -> Set[ast.AST]:
        """Capture-set functions OF one module."""
        return {fn for fn in self.capture.fns
                if self.graph.mod_of.get(fn) is mod}

    def mod_of(self, fn: ast.AST, site: Optional[LegSite] = None):
        """Owning module of a reached callable; a Lambda body is not
        in the graph index and belongs to its site's module."""
        mod = self.graph.mod_of.get(fn)
        if mod is None and site is not None:
            return site.mod
        return mod

    # ---------------------------------------------------------- sites --
    def _resolve_bodies(self, mod, cls: Optional[str],
                        stack: List[ast.AST],
                        arg: ast.AST) -> List[ast.AST]:
        if isinstance(arg, ast.Lambda):
            return [arg]
        # innermost enclosing scope first: the data-plane idiom is a
        # nested `def cell(i, c)` right next to its run_cells call
        if isinstance(arg, ast.Name):
            for encl in reversed(stack):
                hits = [n for n in ast.walk(encl)
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and n.name == arg.id and n is not encl]
                if hits:
                    return hits
        return self.graph.resolve_ref(mod, cls, arg)

    def _site_reach(self, mod, cls: Optional[str],
                    bodies: List[ast.AST]) -> Set[ast.AST]:
        reach: Set[ast.AST] = set()
        roots: List[ast.AST] = []
        for b in bodies:
            reach.add(b)
            if b in self.graph.mod_of:
                roots.append(b)
            else:                         # Lambda: resolve its calls
                for call in ast.walk(b):
                    if isinstance(call, ast.Call):
                        roots.extend(self.graph.resolve_call(
                            mod, cls, call))
        for b in roots:
            if b in self._reach_cache:
                reach |= self._reach_cache[b]
                continue
            sub = {b} | {f for f in self.graph.reachable([b])
                         if not self.graph.mod_of[f].evidence}
            self._reach_cache[b] = sub
            reach |= sub
        return reach

    def _scan_module(self, mod) -> None:
        graph = self.graph

        def note_cb(v: ast.AST, cls) -> None:
            """CTL110 messenger-callback root."""
            if isinstance(v, ast.Lambda):
                self.callback_roots.setdefault(
                    v, ("<lambda callback>", mod, cls))
            else:
                for fn in graph.resolve_ref(mod, cls, v):
                    tmod = graph.mod_of[fn]
                    if not tmod.evidence:
                        self.callback_roots.setdefault(
                            fn, (fn.name, tmod, graph.cls_of[fn]))

        def note_site(call: ast.Call, idx: int, cls,
                      stack: List[ast.AST]) -> None:
            arg = call.args[idx] if len(call.args) > idx else None
            for kw in call.keywords:
                if kw.arg == "fn":
                    arg = kw.value
            bodies = self._resolve_bodies(mod, cls, stack, arg) \
                if arg is not None else []
            self.sites.append(LegSite(
                mod, call, stack[-1] if stack else None, bodies,
                self._site_reach(mod, cls, bodies)))

        def visit(node: ast.AST, cls,
                  stack: List[ast.AST]) -> None:
            for ch in ast.iter_child_nodes(node):
                ncls = ch.name if isinstance(ch, ast.ClassDef) else cls
                nstack = stack + [ch] if isinstance(
                    ch, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    else stack
                if isinstance(ch, ast.Call):
                    d = astutil.dotted(ch.func)
                    tail = d.rsplit(".", 1)[-1] if d else None
                    if tail in LEG_RUNNERS:
                        note_site(ch, LEG_RUNNERS[tail], cls, stack)
                    for kw in ch.keywords:
                        if kw.arg == "cb":
                            note_cb(kw.value, cls)
                    if isinstance(ch.func, ast.Attribute) and \
                            ch.func.attr in ("set_complete_callback",
                                             "add_done_callback") \
                            and ch.args:
                        note_cb(ch.args[0], cls)
                visit(ch, ncls, nstack)

        visit(mod.tree, None, [])


def device_context(program) -> DeviceContext:
    """The per-run shared context (built once, cached on Program)."""
    ctx = program._cache.get("device_ctx")
    if ctx is None:
        ctx = program._cache["device_ctx"] = DeviceContext(program)
    return ctx
