"""CTL2xx — GF(2^8) / CRUSH dtype invariants, in torch's spelling.

"Accelerating XOR-based Erasure Coding using Program Optimization
Techniques" measures exactly this failure class: XOR/GF throughput is
dominated by keeping the math in the narrow integer domain, and one
silently-widened dtype (uint8 -> int32/int64) multiplies the moved
bytes.  In the port the hazard is torch's defaults: ``torch.arange(n)``
materializes int64 and ``torch.zeros(n)`` float32 unless told
otherwise, and ``torch.as_tensor(caller_data)`` in ops/ inherits
whatever dtype the caller happened to hold (``torch.from_numpy`` the
numpy array's, int64 for a default numpy integer array).

  CTL201  implicit-dtype torch constructor (arange/zeros/ones/empty/
          full) in ops/ or placement/
  CTL202  torch.as_tensor/torch.tensor of a bare function parameter
          without dtype= in ops/, or torch.from_numpy of one with no
          dtype pin after it (GF math ingesting caller-typed data)
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List

from . import astutil
from .core import Finding, ParsedModule, Rule

# torch's constructors take dtype by keyword only
_CTORS = {"torch.arange", "torch.zeros", "torch.ones", "torch.empty",
          "torch.full"}
_INGEST = {"torch.as_tensor", "torch.tensor"}
_FROM_NUMPY = "torch.from_numpy"
# a dtype pin chained on a tensor: ``.to(torch.uint8)``, ``.view(...)``,
# ``.byte()``, ...
_PIN_METHODS = {"to", "view", "type", "byte", "char", "short", "int",
                "long", "float", "double", "bool", "half"}


def _has_dtype(call: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in call.keywords)


class ImplicitDtypeRule(Rule):
    rule_id = "CTL201"
    name = "gf-implicit-dtype"
    description = ("torch.arange/zeros/ones/empty/full without dtype= "
                   "on the GF/CRUSH data path takes torch's int64/"
                   "float32 defaults")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        parts = mod.parts()
        if mod.evidence or not ({"ops", "placement"} & set(parts)):
            return ()
        aliases = astutil.aliases_of(mod)
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cn = astutil.resolve(node.func, aliases)
            if cn in _CTORS and not _has_dtype(node):
                out.append(self.finding(
                    mod, node.lineno,
                    f"{cn}() without dtype= materializes torch's "
                    f"int64/float32 default (a widened operand moves "
                    f"4-8x the bytes) — pin the dtype"))
        return out


def _parents(tree: ast.AST) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for ch in ast.iter_child_nodes(node):
            out[id(ch)] = node
    return out


class UnpinnedIngestRule(Rule):
    rule_id = "CTL202"
    name = "gf-unpinned-ingest"
    description = ("torch.as_tensor/tensor(param) without dtype, or "
                   "torch.from_numpy(param) with no dtype pin, in ops/: "
                   "GF math silently runs in the caller's dtype")

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence or "ops" not in mod.parts():
            return ()
        aliases = astutil.aliases_of(mod)
        parent = _parents(mod.tree)
        out: List[Finding] = []
        seen = set()                      # nested-function walk dedup
        for fn, _cls in astutil.walk_functions(mod.tree):
            params = {p.arg for p in fn.args.posonlyargs + fn.args.args}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                cn = astutil.resolve(node.func, aliases)
                if cn not in _INGEST and cn != _FROM_NUMPY:
                    continue
                if not (len(node.args) == 1 and
                        isinstance(node.args[0], ast.Name) and
                        node.args[0].id in params) or \
                        (node.lineno, node.args[0].id) in seen:
                    continue
                name = node.args[0].id
                if cn in _INGEST:
                    if _has_dtype(node):
                        continue
                    msg = (f"{cn}({name}) without dtype= ingests "
                           f"caller-typed data into GF math (uint8 work "
                           f"silently widens to int32/int64) — pin the "
                           f"contract dtype")
                else:
                    up = parent.get(id(node))
                    if isinstance(up, ast.Attribute) and \
                            up.attr in _PIN_METHODS and \
                            isinstance(parent.get(id(up)), ast.Call):
                        continue
                    msg = (f"torch.from_numpy({name}) with no dtype pin "
                           f"after it ingests the caller's numpy dtype "
                           f"into GF math — chain .to(<contract dtype>)")
                seen.add((node.lineno, name))
                out.append(self.finding(mod, node.lineno, msg))
        return out


def register(reg) -> None:
    reg.add(ImplicitDtypeRule.rule_id, ImplicitDtypeRule)
    reg.add(UnpinnedIngestRule.rule_id, UnpinnedIngestRule)
