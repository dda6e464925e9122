"""CTL9xx — serving-path rules.

CTL901 polices the hot-bucket serialization class S3Serve's index
sharding retired: a FULL-index read (the ``_read_index``-shaped
whole-object JSON load that merges every shard) on a PER-REQUEST
gateway path in ``rgw/``.  Before sharding, every put/get/delete
deserialized — and every index write re-serialized — the entire
bucket's key table through one RADOS object: one hot bucket
serialized all its writers on a single omap-object RMW and made
per-request cost O(bucket).  After sharding, per-request ops must
touch only the key's shard (``_read_index_shard``); the whole-index
merge is legitimate ONLY on listing / reshard / admin surfaces.

The rule is interprocedural over the whole-program graph
(precise edges): a per-request op that reaches ``_read_index``
through a helper is the same bug wearing a wrapper.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from . import astutil
from .core import Finding, ParsedModule, Rule

# the per-request gateway surface (RGWOp verbs): listing is excluded
# by design — ListObjects IS the shard-merge
_REQUEST_OPS = frozenset((
    "put_object", "get_object", "head_object", "delete_object",
    "upload_part", "initiate_multipart", "complete_multipart",
    "abort_multipart"))

_FULL_INDEX_READERS = frozenset(("_read_index",))


def _in_rgw(mod: ParsedModule) -> bool:
    parts = mod.relpath.replace("\\", "/").split("/")[:-1]
    return "rgw" in parts


class FullIndexReadRule(Rule):
    rule_id = "CTL901"
    name = "rgw-full-index-read-on-request-path"
    description = ("per-request gateway op reads the FULL bucket "
                   "index (_read_index whole-object load) instead of "
                   "the key's shard — the hot-bucket serialization "
                   "class index sharding exists to retire; merge all "
                   "shards only on listing/reshard/admin surfaces")

    def __init__(self) -> None:
        super().__init__()
        # (mod, fn, cls) request-op definitions found in rgw/
        self._roots: List[Tuple[ParsedModule, ast.AST]] = []

    def check_module(self, mod: ParsedModule) -> Iterable[Finding]:
        if mod.evidence or not _in_rgw(mod):
            return ()
        for fn, _cls in astutil.walk_functions(mod.tree):
            if fn.name in _REQUEST_OPS:
                self._roots.append((mod, fn))
        return ()

    @staticmethod
    def _full_read_call(fn: ast.AST) -> int:
        """Line of a direct ``*._read_index()`` call inside ``fn``,
        or 0."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _FULL_INDEX_READERS:
                return node.lineno
        return 0

    def finish(self) -> Iterable[Finding]:
        out: List[Finding] = []
        graph = astutil.program_graph(self.program) \
            if self.program is not None else None
        for mod, fn in self._roots:
            line = self._full_read_call(fn)
            via = ""
            if not line and graph is not None:
                # interprocedural: the request op REACHES a function
                # that does the full-index read (precise edges only —
                # name-fallback edges would drown rgw/ in noise)
                seen: Set[ast.AST] = graph.reachable([fn])
                for g in seen:
                    if g is fn:
                        continue
                    if getattr(g, "name", "") in _FULL_INDEX_READERS:
                        continue       # the reader itself is legal
                    inner = self._full_read_call(g)
                    if inner:
                        line = fn.lineno
                        via = f" (via {getattr(g, 'name', '?')}())"
                        break
            if line:
                out.append(self.finding(
                    mod, line,
                    f"per-request op {fn.name}() loads the FULL "
                    f"bucket index{via} — one hot bucket serializes "
                    f"every writer and pays O(bucket) per request; "
                    f"read only the key's shard "
                    f"(_read_index_shard)"))
        return out


def register(reg) -> None:
    reg.add(FullIndexReadRule.rule_id, FullIndexReadRule)
