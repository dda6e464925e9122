"""MDSMap — the multi-MDS cluster map (ranks + subtree authority).

The role of the reference's MDSMap (src/mds/MDSMap.h: which ranks are
in/active, max_mds) plus the subtree-authority table the reference
keeps distributed in each CDir's subtree auth (src/mds/MDCache.cc
subtree map, displayed by `ceph mds dump`): here it is one explicit,
durable table {normalized dir path -> rank} with longest-prefix
resolution, persisted in the metadata pool ("mdsmap" object, the
MDSMonitor-held map's role collapsed onto the pool — the repo's mon
quorum governs OSD/pool maps; the fs-internal map rides the same
replicated storage).

Authority resolution: a path is served by the rank owning its longest
matching subtree prefix; "/" is always present and owned by rank 0
unless delegated, so resolution is total.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

MDSMAP_OID = "mdsmap"


def normalize(path: str) -> str:
    parts = [p for p in path.split("/") if p]
    return "/" + "/".join(parts)


class MDSMap:
    """Durable rank/subtree-authority map."""

    def __init__(self, meta_ioctx, n_ranks: int = 1):
        self.meta = meta_ioctx
        self.epoch = 1
        self.n_ranks = n_ranks
        self.subtrees: Dict[str, int] = {"/": 0}
        self._load_or_create()

    # ----------------------------------------------------------- persist --
    def _load_or_create(self) -> None:
        try:
            blob = self.meta.read(MDSMAP_OID)
        except KeyError:
            # ObjectNotFound only: a transient pool error must NOT
            # fall into the create branch and clobber the durable map
            self._save()
            return
        d = json.loads(bytes(blob).decode())
        self.epoch = d["epoch"]
        # ranks may grow across restarts (max_mds raised); never shrink
        # below what the stored subtree table references
        self.n_ranks = max(self.n_ranks, d["n_ranks"])
        self.subtrees = {k: int(v) for k, v in d["subtrees"].items()}

    def _save(self) -> None:
        self.meta.write_full(MDSMAP_OID, json.dumps(
            {"epoch": self.epoch, "n_ranks": self.n_ranks,
             "subtrees": self.subtrees}).encode())

    # --------------------------------------------------------- authority --
    def auth_rank(self, path: str) -> int:
        """Longest-prefix subtree match (total: '/' always resolves)."""
        p = normalize(path)
        best, best_len = 0, -1
        for prefix, rank in self.subtrees.items():
            if p == prefix or prefix == "/" or \
                    p.startswith(prefix + "/"):
                if len(prefix) > best_len:
                    best, best_len = rank, len(prefix)
        return best

    def set_auth(self, path: str, rank: int) -> None:
        """Delegate a subtree to `rank` (bumps the epoch, durable)."""
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"no such rank {rank}")
        p = normalize(path)
        self.subtrees[p] = rank
        # absorb now-redundant deeper entries owned by the same rank
        for sub in [s for s in self.subtrees
                    if s != p and s.startswith(p + "/")
                    and self.subtrees[s] == rank]:
            del self.subtrees[sub]
        self.epoch += 1
        self._save()

    def subtrees_of(self, rank: int) -> List[str]:
        return sorted(p for p, r in self.subtrees.items() if r == rank)

    def reload(self) -> None:
        self._load_or_create()
