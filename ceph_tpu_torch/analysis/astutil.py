"""Shared AST analyses: import-alias-aware name resolution, the
whole-program interprocedural call graph, and the two reachability
sets the device rules key off.

Two resolution tiers coexist (CTLint v2):

  * **Precise, cross-module** — ``ProgramGraph`` resolves
    ``from x import f`` / ``import pkg.mod as m`` (absolute AND
    relative forms), ``self._method`` against the enclosing class,
    and ``module.func`` attribute calls against the imported module's
    top-level functions, across every file of the run.  Built once
    per run and cached on the ``Program``, shared by all rules.
  * **Module-local, name-based fallback** — when resolution is
    ambiguous (an attribute call on an arbitrary object,
    ``dt.bucket_row(...)``), the graph falls back to the idiom:
    every same-module function NAMED ``bucket_row`` is a candidate
    callee.  Cheap, deterministic, and right for this codebase's
    helpers-next-to-entry-points layout — and it means the widened
    graph can only ADD reachability, never silently lose it.

The port has no jit, so the reference's one traced ("hot") set
becomes two, each closed over callees to a fixed point:

  * the **device-path set** — code that runs on the host around the
    card's work, where a host sync stalls the launch pipeline.  Its
    roots are (a) every function that calls or hands on a kernel entry
    (``lib.ceph_*``) of a library ``ops/_build.load`` returned,
    (b) :data:`DEVICE_ROOTS`, the port twin of every function the
    reference jits, and (c) the dispatch boundary: a function that
    calls an (a) or (b) root of its own module (it prepares the
    operands and reads the result back, where the readbacks sit);
  * the **capture set** — code inside a ``with torch.cuda.graph(...)``
    block or handed to ``torch.cuda.make_graphed_callables``: its host
    work runs once, at capture, and never on replay.

A module parsed outside a run (no ``Program``) is given a one-module
program of its own.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

# canonical (post-alias) spellings
PARTIAL_NAMES = {"functools.partial", "partial"}
# a CUDA graph capture region: ``with torch.cuda.graph(g): ...``
GRAPH_CAPTURE_NAMES = {"torch.cuda.graph"}
# callables whose first argument (a callable or a tuple of them) is
# captured into CUDA graphs
GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables"}
# the kernel-library loader: ``load`` of a module at this relpath tail
KERNEL_LOADER = ("ops/_build.py", "load")
# a kernel entry of a loaded library: ``lib.ceph_xor_matmul_w32``
KERNEL_ENTRY_PREFIX = "ceph_"

# The port twin of every function the reference jits (its
# ``@jax.jit`` / ``jax.jit(f)`` targets in ``ceph_tpu/``), the one list
# of them: reference qualname -> port qualname.  The reference's
# ``placement.fast_mapper._approx_numer_f32`` has no twin: the port's
# fast mapper evaluates the exact log table and never the f32
# approximation, so it is not listed.
DEVICE_ROOTS: Tuple[Tuple[str, str], ...] = (
    ("ceph_tpu.ops.crc32_gf2.kern",
     "ceph_tpu_torch.ops.crc32_gf2.crc32_blocks_plain"),
    ("ceph_tpu.ops.gf_jax.bitplane_matmul",
     "ceph_tpu_torch.ops.gf_jax.bitplane_matmul"),
    ("ceph_tpu.ops.gf_pallas._bitplane_matmul_pallas",
     "ceph_tpu_torch.ops.gf_pallas._launch"),
    ("ceph_tpu.ops.ragged_fused.fn",
     "ceph_tpu_torch.ops.ragged_fused.fused_block_math"),
    ("ceph_tpu.ops.xor_kernel._xor_matmul_pallas",
     "ceph_tpu_torch.ops.xor_kernel._launch"),
    ("ceph_tpu.ops.xor_kernel._xor_matmul_xla",
     "ceph_tpu_torch.ops.xor_kernel._combine_torch"),
    ("ceph_tpu.parallel.mesh.step",
     "ceph_tpu_torch.parallel.mesh._step"),
    ("ceph_tpu.placement.fast_mapper.FastMapper.fn",
     "ceph_tpu_torch.placement.fast_mapper.FastMapper._trace"),
    ("ceph_tpu.placement.xla_mapper.XlaMapper.fn",
     "ceph_tpu_torch.placement.xla_mapper.XlaMapper._trace_rule"),
)


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """local name -> canonical dotted prefix, e.g. {'_jax': 'jax',
    'jnp': 'jax.numpy', 'lax': 'jax.lax', 'np': 'numpy',
    'jit': 'jax.jit'}."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Alias-normalized dotted name ('_jax.jit' -> 'jax.jit')."""
    d = dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _tail(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def aliases_of(mod) -> Dict[str, str]:
    """Per-module ``import_aliases``, computed once and cached —
    every rule shares one pass instead of re-walking the imports."""
    cached = mod._cache.get("aliases")
    if cached is None:
        cached = mod._cache["aliases"] = import_aliases(mod.tree)
    return cached


def module_dotted(relpath: str) -> str:
    """'ceph_tpu/cluster/daemon.py' -> 'ceph_tpu.cluster.daemon';
    a package ``__init__.py`` maps to the package itself."""
    parts = relpath.rsplit(".", 1)[0].split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def program_aliases_of(mod) -> Dict[str, str]:
    """local name -> ABSOLUTE dotted import target, with relative
    imports (``from .objectstore import T`` / ``from ..common import
    tracer as _trace``) anchored at the module's package path.  The
    cross-module half of name resolution; ``import_aliases`` stays
    the canonical-spelling half (jax/np normalization)."""
    cached = mod._cache.get("prog_aliases")
    if cached is not None:
        return cached
    mparts = [p for p in module_dotted(mod.relpath).split(".") if p]
    is_pkg = mod.relpath.endswith("__init__.py")
    pkg = mparts if is_pkg else mparts[:-1]
    out: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                drop = node.level - 1
                if drop > len(pkg):
                    continue                  # beyond the lint root
                anchor = pkg[:len(pkg) - drop] if drop else pkg
                base = ".".join(anchor + ([node.module]
                                          if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = \
                    f"{base}.{a.name}" if base else a.name
    mod._cache["prog_aliases"] = out
    return out


def _partial_aliases(mod) -> Dict[str, str]:
    """name -> callee name for ``g = functools.partial(f, ...)``."""
    cached = mod._cache.get("partial_aliases")
    if cached is not None:
        return cached
    aliases = aliases_of(mod)
    out: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call) \
                and resolve(node.value.func, aliases) in PARTIAL_NAMES \
                and node.value.args:
            base = dotted(node.value.args[0])
            if base:
                out[node.targets[0].id] = _tail(base)
    mod._cache["partial_aliases"] = out
    return out


class ProgramGraph:
    """The whole-tree, import-resolving call graph (CTLint v2).

    Resolution order for a call / function reference in module M,
    enclosing class C:

      1. ``self.x`` / ``cls.x``     -> method ``x`` of C in M (precise);
                                       no such method: module-local
                                       name fallback
      2. bare ``f``                 -> function named ``f`` in M, else
                                       the ``from x import f`` target's
                                       top-level ``f`` (cross-module)
      3. ``m.f`` / ``pkg.m.f``      -> top-level ``f`` of the imported
                                       in-tree module ``m`` (precise;
                                       a resolved module WITHOUT such a
                                       function is a miss, not a
                                       fallback — it is a class or
                                       dynamic attribute)
      4. anything else (``obj.f``)  -> module-local name fallback:
                                       every function in M named ``f``

    ``functools.partial`` rebindings resolve through their base
    callable first.  Evidence modules participate in the indexes (so
    --graph can answer questions about them) but never in the hot
    set.
    """

    def __init__(self, program) -> None:
        self.program = program
        self.mod_of: Dict[ast.AST, object] = {}
        self.cls_of: Dict[ast.AST, Optional[str]] = {}
        # (relpath, name) -> fns; (relpath, cls, name) -> methods;
        # (dotted module, name) -> top-level fns
        self.local: Dict[Tuple[str, str], List[ast.AST]] = {}
        self.methods: Dict[Tuple[str, Optional[str], str],
                           List[ast.AST]] = {}
        self.top: Dict[Tuple[str, str], List[ast.AST]] = {}
        self.mod_dotted: Dict[str, object] = {}
        self._edges: Dict[ast.AST, Set[ast.AST]] = {}
        self._redges: Optional[Dict[ast.AST, Set[ast.AST]]] = None
        for mod in program.modules.values():
            dn = module_dotted(mod.relpath)
            self.mod_dotted.setdefault(dn, mod)
            for fn, cls in walk_functions(mod.tree):
                self.mod_of[fn] = mod
                self.cls_of[fn] = cls
                self.local.setdefault((mod.relpath, fn.name),
                                      []).append(fn)
                self.methods.setdefault((mod.relpath, cls, fn.name),
                                        []).append(fn)
                if cls is None:
                    self.top.setdefault((dn, fn.name), []).append(fn)

    # --------------------------------------------------------- naming --
    def qualname(self, fn: ast.AST) -> str:
        mod = self.mod_of[fn]
        cls = self.cls_of[fn]
        dn = module_dotted(mod.relpath)
        mid = f"{cls}." if cls else ""
        return f"{dn}.{mid}{fn.name}"

    def find(self, pattern: str) -> List[ast.AST]:
        """Functions matching a dotted pattern: the last part names
        the function, the rest must appear in the qualified name in
        order — so 'daemon._recover_pg' matches
        'ceph_tpu.cluster.daemon.OSDDaemon._recover_pg' without the
        caller knowing the class."""
        pat = pattern.split(".")
        out = []
        for fn in self.mod_of:
            q = self.qualname(fn).split(".")
            if q[-1] != pat[-1]:
                continue
            i = 0
            for part in q[:-1]:
                if i < len(pat) - 1 and part == pat[i]:
                    i += 1
            if i == len(pat) - 1:
                out.append(fn)
        return sorted(out, key=self.qualname)

    # ----------------------------------------------------- resolution --
    def resolve_call(self, mod, cls: Optional[str], call: ast.Call,
                     precise: bool = False) -> List[ast.AST]:
        """Callee candidates.  ``precise=True`` drops the ambiguous
        module-local name fallback (an attribute call on an arbitrary
        object resolves to NOTHING instead of every same-named local
        function) — for traversals where an over-approximate edge is
        worse than a missed one."""
        d = dotted(call.func)
        if d is None:
            return []
        return self._resolve(mod, cls, d, precise)

    def resolve_ref(self, mod, cls: Optional[str],
                    node: ast.AST) -> List[ast.AST]:
        """A function-OBJECT reference (jit(f) argument, ``cb=f``
        registration) rather than a call."""
        d = dotted(node)
        if d is None:
            return []
        return self._resolve(mod, cls, d, False)

    def _resolve(self, mod, cls: Optional[str], d: str,
                 precise: bool) -> List[ast.AST]:
        parts = d.split(".")
        pa = _partial_aliases(mod)
        if len(parts) == 2 and parts[0] in ("self", "cls"):
            name = pa.get(parts[1], parts[1])
            if cls is not None:
                hit = self.methods.get((mod.relpath, cls, name))
                if hit:
                    return list(hit)
            if precise:
                return []
            return list(self.local.get((mod.relpath, name), ()))
        if len(parts) == 1:
            name = pa.get(parts[0], parts[0])
            hit = self.local.get((mod.relpath, name))
            if hit:
                return list(hit)
            tgt = program_aliases_of(mod).get(name)
            if tgt and "." in tgt:
                mn, _, fname = tgt.rpartition(".")
                if mn in self.mod_dotted:
                    return list(self.top.get((mn, fname), ()))
            return []
        head = program_aliases_of(mod).get(parts[0])
        if head:
            mn = ".".join([head] + parts[1:-1])
            if mn in self.mod_dotted:
                return list(self.top.get((mn, parts[-1]), ()))
        if precise:
            return []
        name = pa.get(parts[-1], parts[-1])
        return list(self.local.get((mod.relpath, name), ()))

    # ----------------------------------------------------------- edges --
    def callees(self, fn: ast.AST) -> Set[ast.AST]:
        """Resolved direct callees of ``fn`` (cached)."""
        cached = self._edges.get(fn)
        if cached is not None:
            return cached
        mod = self.mod_of[fn]
        cls = self.cls_of[fn]
        out: Set[ast.AST] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                out.update(self.resolve_call(mod, cls, node))
        out.discard(fn)
        self._edges[fn] = out
        return out

    def callers_of(self, fn: ast.AST) -> Set[ast.AST]:
        if self._redges is None:
            redges: Dict[ast.AST, Set[ast.AST]] = {}
            for f in self.mod_of:
                for tgt in self.callees(f):
                    redges.setdefault(tgt, set()).add(f)
            self._redges = redges
        return self._redges.get(fn, set())

    def reachable(self, roots, forward: bool = True) -> Set[ast.AST]:
        """Transitive closure from ``roots`` (roots excluded unless
        re-reached) over resolved call edges."""
        step = self.callees if forward else self.callers_of
        seen: Set[ast.AST] = set()
        work = list(roots)
        while work:
            for nxt in step(work.pop()):
                if nxt not in seen:
                    seen.add(nxt)
                    work.append(nxt)
        return seen


def program_graph(program) -> ProgramGraph:
    """The per-run shared graph (built once, cached on Program)."""
    g = program._cache.get("graph")
    if g is None:
        g = program._cache["graph"] = ProgramGraph(program)
    return g


class HotInfo:
    """Device-path result for one module (or the whole program).

    ``hot``     — FunctionDefs on the device path (roots + everything
                  they reach).
    ``direct``  — the roots, mapped to why each is one: ``"kernel"``
                  (calls or hands on a kernel entry of a loaded
                  library), ``"twin"`` (listed in DEVICE_ROOTS) or
                  ``"dispatch"`` (calls a root of its own module).
    """

    def __init__(self) -> None:
        self.hot: Set[ast.AST] = set()
        self.direct: Dict[ast.AST, str] = {}


class CaptureInfo:
    """The capture set: ``fns`` are the functions called from a CUDA
    graph capture region (or handed to make_graphed_callables) and
    everything they reach; ``regions`` are the capture ``with`` blocks
    themselves, as (module, enclosing function or None, With node)."""

    def __init__(self) -> None:
        self.fns: Set[ast.AST] = set()
        self.regions: List[Tuple[object, Optional[ast.AST],
                                 ast.AST]] = []


def _own_program(mod):
    """The Program a module belongs to; a module parsed outside a run
    gets a one-module program of its own."""
    program = getattr(mod, "program", None)
    if program is None:
        from .core import Program
        program = Program({mod.relpath: mod})
        mod.program = program
    return program


def _is_loader(g: "ProgramGraph", fn: ast.AST) -> bool:
    mod = g.mod_of.get(fn)
    return mod is not None and fn.name == KERNEL_LOADER[1] and \
        g.cls_of[fn] is None and \
        ("/" + mod.relpath).endswith("/" + KERNEL_LOADER[0])


def _loader_fns(g: "ProgramGraph") -> Set[ast.AST]:
    """``ops/_build.load`` plus every function that returns what it
    returned (``def _lib(): lib = _build.load(...); ...; return lib``)."""
    base = {fn for fn in g.mod_of if _is_loader(g, fn)}
    out = set(base)
    if not base:
        return out
    # only a module that names the loader's module can call it
    stem = KERNEL_LOADER[0].rsplit("/", 1)[-1][:-len(".py")]
    for fn in g.mod_of:
        mod = g.mod_of[fn]
        if fn in out or mod.evidence or stem not in mod.source:
            continue
        cls = g.cls_of[fn]
        bound: Set[str] = set()
        direct = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    set(g.resolve_call(mod, cls, node.value,
                                       precise=True)) & base:
                bound.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            if isinstance(node, ast.Return) and node.value is not None:
                v = node.value
                if isinstance(v, ast.Name) and v.id in bound:
                    direct = True
                elif isinstance(v, ast.Call) and set(g.resolve_call(
                        mod, cls, v, precise=True)) & base:
                    direct = True
        if direct:
            out.add(fn)
    return out


def _kernel_entry_uses(g: "ProgramGraph", fn: ast.AST,
                       loaders: Set[ast.AST]) -> List[ast.AST]:
    """``lib.ceph_*`` nodes in ``fn`` that are called or handed on as
    an argument, ``lib`` a loaded kernel library (a loader call, or a
    name bound to one in ``fn``).  Attribute stores on the entry
    (``lib.ceph_x.argtypes = ...``) are declarations, not uses."""
    mod, cls = g.mod_of[fn], g.cls_of[fn]

    def is_lib(expr: ast.AST, names: Set[str]) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in names
        return isinstance(expr, ast.Call) and bool(
            set(g.resolve_call(mod, cls, expr, precise=True)) & loaders)

    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and is_lib(node.value, set()):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    out: List[ast.AST] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        for e in [node.func] + list(node.args):
            if isinstance(e, ast.Attribute) and \
                    e.attr.startswith(KERNEL_ENTRY_PREFIX) and \
                    is_lib(e.value, names):
                out.append(e)
    return out


def _close(g: "ProgramGraph", members: Set[ast.AST]) -> None:
    """Grow ``members`` over resolved callees to a fixed point
    (evidence modules never join)."""
    work = list(members)
    while work:
        fn = work.pop()
        for tgt in g.callees(fn):
            if tgt not in members and not g.mod_of[tgt].evidence:
                members.add(tgt)
                work.append(tgt)


def _program_hot(program) -> HotInfo:
    """The whole-program device-path set: roots from every lint module
    (kernel-entry users, DEVICE_ROOTS twins, their dispatch boundary),
    propagated to a fixed point over the resolved cross-module call
    graph.  Evidence modules contribute neither roots nor members."""
    cached = program._cache.get("hot")
    if cached is not None:
        return cached
    g = program_graph(program)
    info = HotInfo()
    loaders = _loader_fns(g)
    twins = {port for _ref, port in DEVICE_ROOTS}
    # a kernel entry use names an entry (``.ceph_``) and a loader, in
    # the module's text (a cheap test before the walk)
    names = {fn.name for fn in loaders}
    entry_mods = {m.relpath for m in program.modules.values()
                  if loaders and not m.evidence and
                  "." + KERNEL_ENTRY_PREFIX in m.source and
                  any(n in m.source for n in names)}
    for fn in g.mod_of:
        mod = g.mod_of[fn]
        if mod.evidence:
            continue
        if g.qualname(fn) in twins:
            info.direct.setdefault(fn, "twin")
        elif fn not in loaders and mod.relpath in entry_mods and \
                _kernel_entry_uses(g, fn, loaders):
            info.direct.setdefault(fn, "kernel")
    # (c) the dispatch boundary: a same-module direct caller of a root
    # (the entry that prepares its operands and reads its result back)
    by_mod: Dict[str, Set[ast.AST]] = {}
    for root in info.direct:
        by_mod.setdefault(g.mod_of[root].relpath, set()).add(root)
    for relpath, roots in by_mod.items():
        for fn, _cls in walk_functions(program.modules[relpath].tree):
            if fn not in info.direct and fn not in loaders and \
                    g.callees(fn) & roots:
                info.direct.setdefault(fn, "dispatch")
    info.hot = set(info.direct)
    _close(g, info.hot)
    program._cache["hot"] = info
    return info


def _graphed_args(call: ast.Call) -> List[ast.AST]:
    """The callables a make_graphed_callables call captures: its first
    argument, or each element of it when it is a tuple/list."""
    if not call.args:
        return []
    a = call.args[0]
    return list(a.elts) if isinstance(a, (ast.Tuple, ast.List)) else [a]


def capture_set(program) -> CaptureInfo:
    """The whole-program capture set (cached on the Program)."""
    cached = program._cache.get("capture")
    if cached is not None:
        return cached
    g = program_graph(program)
    info = CaptureInfo()
    for mod in program.modules.values():
        # a capture names ``graph`` (torch.cuda.graph or
        # make_graphed_callables) in its module's text
        if mod.evidence or "graph" not in mod.source:
            continue
        aliases = aliases_of(mod)

        def visit(node: ast.AST, cls: Optional[str],
                  fn: Optional[ast.AST]) -> None:
            for ch in ast.iter_child_nodes(node):
                ncls = ch.name if isinstance(ch, ast.ClassDef) else cls
                nfn = ch if isinstance(
                    ch, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
                if isinstance(ch, (ast.With, ast.AsyncWith)) and any(
                        isinstance(it.context_expr, ast.Call) and
                        resolve(it.context_expr.func, aliases)
                        in GRAPH_CAPTURE_NAMES for it in ch.items):
                    info.regions.append((mod, fn, ch))
                    for stmt in ch.body:
                        for call in ast.walk(stmt):
                            if isinstance(call, ast.Call):
                                info.fns.update(
                                    t for t in g.resolve_call(
                                        mod, cls, call)
                                    if not g.mod_of[t].evidence)
                if isinstance(ch, ast.Call) and \
                        resolve(ch.func, aliases) in GRAPHED_CALLABLES:
                    for a in _graphed_args(ch):
                        info.fns.update(
                            t for t in g.resolve_ref(mod, cls, a)
                            if not g.mod_of[t].evidence)
                visit(ch, ncls, nfn)

        visit(mod.tree, None, None)
    _close(g, info.fns)
    program._cache["capture"] = info
    return info


def hot_functions(mod) -> HotInfo:
    """The device-path set, per module (cached): the PER-MODULE SLICE
    of the whole-program closure."""
    cached = mod._cache.get("hot")
    if cached is not None:
        return cached
    program = _own_program(mod)
    g = program_graph(program)
    ph = _program_hot(program)
    info = HotInfo()
    info.hot = {fn for fn in ph.hot if g.mod_of.get(fn) is mod}
    info.direct = {fn: why for fn, why in ph.direct.items()
                   if g.mod_of.get(fn) is mod}
    mod._cache["hot"] = info
    return info


# ------------------------------------------------------ tensor values --

# torch calls whose result is not a tensor (metadata, devices, modes)
_TORCH_NOT_TENSOR = {
    "device", "Size", "dtype", "is_tensor", "is_floating_point",
    "get_default_dtype", "set_num_threads", "get_num_threads",
    "manual_seed", "Generator", "iinfo", "finfo", "no_grad",
    "inference_mode", "promote_types", "result_type", "numel",
}
# tensor methods whose result is a tensor that holds device VALUES
# (reductions and comparisons); ``.shape`` / ``.numel()`` / ``.dim()``
# are host metadata and never make an expression tensor-valued
_VALUE_METHODS = {
    "any", "all", "sum", "max", "min", "prod", "mean", "amax", "amin",
    "count_nonzero", "nonzero", "eq", "ne", "gt", "lt", "ge", "le",
    "equal", "allclose", "isnan", "isinf", "argmax", "argmin",
    "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "abs", "clone", "contiguous", "to",
    "view", "reshape", "narrow", "flatten", "masked_select",
}


def fn_env(fn: ast.AST) -> Dict[str, ast.AST]:
    """name -> last simple ``name = expr`` assignment inside ``fn``."""
    env: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            env[node.targets[0].id] = node.value
    return env


def tensor_params(fn: ast.AST) -> Set[str]:
    """Parameters annotated ``torch.Tensor`` (or ``Tensor``)."""
    a = fn.args
    out: Set[str] = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        ann = p.annotation
        if ann is None:
            continue
        d = dotted(ann) if not isinstance(ann, ast.Constant) else \
            str(ann.value)
        if d and d.rsplit(".", 1)[-1] == "Tensor":
            out.add(p.arg)
    return out


def tensor_valued(node: ast.AST, aliases: Dict[str, str],
                  env: Dict[str, ast.AST], params: Set[str],
                  _seen: Optional[Set[str]] = None) -> bool:
    """Statically, does ``node`` evaluate to a tensor that holds device
    values?  A torch call (not metadata), a value method on anything
    (``.sum()``, ``.any()``, ``.max()``...), a subscript, comparison or
    arithmetic of one, a ``torch.Tensor``-annotated parameter, or a
    local name last bound to one.  Casts (``int(...)``) and metadata
    (``.shape``, ``.numel()``) end the value."""
    seen = _seen if _seen is not None else set()

    def rec(n: ast.AST) -> bool:
        return tensor_valued(n, aliases, env, params, seen)

    if isinstance(node, ast.Name):
        if node.id in params:
            return True
        if node.id in env and node.id not in seen:
            seen.add(node.id)
            return rec(env[node.id])
        return False
    if isinstance(node, ast.Call):
        cn = resolve(node.func, aliases)
        if cn and cn.startswith("torch.") and \
                not cn.startswith(("torch.cuda.", "torch.distributed.",
                                   "torch.backends.")):
            return cn.rsplit(".", 1)[-1] not in _TORCH_NOT_TENSOR
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _VALUE_METHODS:
            return True
        return False
    if isinstance(node, ast.Subscript):
        return rec(node.value)
    if isinstance(node, ast.Compare):
        return any(rec(e) for e in [node.left] + node.comparators)
    if isinstance(node, ast.BinOp):
        return rec(node.left) or rec(node.right)
    if isinstance(node, ast.UnaryOp):
        return rec(node.operand)
    if isinstance(node, ast.BoolOp):
        return any(rec(v) for v in node.values)
    return False


def walk_functions(tree: ast.AST
                   ) -> Iterator[Tuple[ast.AST, Optional[str]]]:
    """Yield (FunctionDef, enclosing class name) pairs, in pre-order.
    The list is computed once per tree and kept on it: every rule walks
    every module's functions, the run's most repeated traversal."""
    got = getattr(tree, "_ctl_functions", None)
    if got is None:
        got = []
        stack: List[Tuple[ast.AST, Optional[str]]] = [(tree, None)]
        while stack:
            node, cls = stack.pop()
            if node is not tree and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                got.append((node, cls))
            for child in reversed(list(ast.iter_child_nodes(node))):
                stack.append((child, child.name if isinstance(
                    child, ast.ClassDef) else cls))
        tree._ctl_functions = got
    return iter(got)
