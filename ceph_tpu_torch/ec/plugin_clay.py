"""The 'clay' codec — Coupled-LAYer MSR regenerating code.

Re-creates the behavior of the reference CLAY plugin
(src/erasure-code/clay/ErasureCodeClay.{h,cc}; Clay codes, FAST'18):
an (k, m, d) code whose chunks split into q^t sub-chunks
(q = d-k+1, t = (k+m+nu)/q, nu pads the node grid,
ErasureCodeClay.cc:271-296) arranged on a q x t node grid.  Stored
("coupled") sub-chunks relate to an uncoupled MDS layer through 2x2
pairwise transforms (the PFT, a k=2/m=2 scalar codec): node (x,y) in
plane z pairs with node (z_y, y) in the reflected plane z_sw
(ErasureCodeClay.cc:781-871).  Encode/decode walk planes in
intersection-score order, converting between coupled and uncoupled
symbols and MDS-decoding each plane (decode_layered,
ErasureCodeClay.cc:647-712).

Single-failure repair reads only the q^(t-1) "dot" planes of the lost
node from d helpers — the minimum-bandwidth property
(minimum_to_repair/get_repair_subchunks, ErasureCodeClay.cc:325-377;
repair_one_lost_chunk, :462-645).

Sub-chunk payloads are numpy arrays [sub_chunk_no, sc_size]; the MDS and
PFT layers default to the batched 'jax' codec.

Port of ``ceph_tpu/ec/plugin_clay.py``.  The CLAY codec is built on the
caller's device (the package default when None) and builds ``mds`` and
``pft`` on that same device: with the default ``jax`` plugin
(layout=bytes) every PFT solve and every per-plane MDS decode is one
call of kernel K2 on a CUDA device, plane by plane as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .. import resolve_device
from .base import CHUNK_ALIGN, ErasureCodeBase
from .interface import ErasureCodeError, ErasureCodeProfile, SubChunkPlan

DEFAULT_K, DEFAULT_M = 4, 2


class ErasureCodeClay(ErasureCodeBase):
    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)

    def init(self, profile: ErasureCodeProfile) -> None:
        from .registry import ErasureCodePluginRegistry
        reg = ErasureCodePluginRegistry.instance()
        k = self.profile_int(profile, "k", DEFAULT_K, minimum=2)
        m = self.profile_int(profile, "m", DEFAULT_M, minimum=1)
        d = self.profile_int(profile, "d", k + m - 1)
        if not (k + 1 <= d + 1 and k <= d <= k + m - 1):
            raise ErasureCodeError(
                f"clay requires k <= d <= k+m-1, got k={k} m={m} d={d}")
        scalar = profile.get("scalar_mds", "jax")
        if scalar not in ("jax", "jerasure", "isa"):
            raise ErasureCodeError(
                f"clay scalar_mds must be jax|jerasure|isa, got {scalar!r}")
        self.k, self.m, self.d = k, m, d
        self.q = d - k + 1
        self.nu = (self.q - (k + m) % self.q) % self.q
        if k + m + self.nu > 254:
            raise ErasureCodeError("clay k+m+nu must be <= 254")
        self.t = (k + m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t
        technique = profile.get("technique", "reed_sol_van")
        self.mds = reg.factory(scalar, {
            "k": str(k + self.nu), "m": str(m), "technique": technique},
            device=self.device)
        self.pft = reg.factory(scalar, {
            "k": "2", "m": "2", "technique": technique},
            device=self.device)
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "clay")
        self._profile.update(k=str(k), m=str(m), d=str(d))

    # ------------------------------------------------------------ layout --
    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        align = self.k * self.sub_chunk_no * CHUNK_ALIGN
        padded = -(-stripe_width // align) * align
        return padded // self.k

    def _plane_vector(self, z: int) -> List[int]:
        zv = [0] * self.t
        for i in range(self.t):
            zv[self.t - 1 - i] = z % self.q
            z //= self.q
        return zv

    def _pair(self, x: int, y: int, z: int, zv: List[int]) -> Tuple[int, int]:
        """(node_sw, z_sw): the coupled partner of (x,y) in plane z."""
        node_sw = y * self.q + zv[y]
        z_sw = z + (x - zv[y]) * self.q ** (self.t - 1 - y)
        return node_sw, z_sw

    # --------------------------------------------------------- PFT solve --
    def _pft_solve(self, known: Dict[int, np.ndarray],
                   want: List[int]) -> List[np.ndarray]:
        """Solve the 2x2 pairwise transform: positions 0,1 = coupled pair
        (data), 2,3 = uncoupled pair (parity of the k=2 scalar code)."""
        avail = sorted(known)
        out = self.pft.decode_chunks(
            avail, np.stack([known[i] for i in avail]), sorted(want))
        order = {w: i for i, w in enumerate(sorted(want))}
        return [out[order[w]] for w in want]

    @staticmethod
    def _canon(x: int, x_sw: int) -> Tuple[int, int, int, int]:
        """Canonical PFT position order (i0..i3): position 0 belongs to
        the larger-x member (the i-swap at ErasureCodeClay.cc:789-794)."""
        if x_sw > x:
            return 1, 0, 3, 2
        return 0, 1, 2, 3

    # ------------------------------------------------------------ encode --
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data = np.asarray(data_chunks, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data.shape[0]}")
        chunk = data.shape[1]
        if chunk % self.sub_chunk_no:
            raise ErasureCodeError(
                f"chunk size {chunk} not divisible by sub_chunk_no "
                f"{self.sub_chunk_no} (use get_chunk_size)")
        sc = chunk // self.sub_chunk_no
        nodes: Dict[int, np.ndarray] = {}
        for i in range(self.k):
            nodes[i] = data[i].reshape(self.sub_chunk_no, sc).copy()
        for i in range(self.k, self.k + self.nu):
            nodes[i] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        parity_nodes = list(range(self.k + self.nu, self.q * self.t))
        for i in parity_nodes:
            nodes[i] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        self._decode_layered(set(parity_nodes), nodes, sc)
        return np.stack([nodes[i].reshape(chunk) for i in parity_nodes])

    # ------------------------------------------------------------ decode --
    def decode_chunks(self, available_ids: Sequence[int],
                      chunks: np.ndarray, erased_ids: Sequence[int]
                      ) -> np.ndarray:
        chunk = chunks.shape[-1]
        if chunk % self.sub_chunk_no:
            raise ErasureCodeError("chunk size not divisible by sub chunks")
        sc = chunk // self.sub_chunk_no
        to_node = lambda i: i if i < self.k else i + self.nu
        nodes: Dict[int, np.ndarray] = {}
        for idx, cid in enumerate(available_ids):
            nodes[to_node(cid)] = np.asarray(
                chunks[idx], dtype=np.uint8).reshape(
                    self.sub_chunk_no, sc).copy()
        for i in range(self.k, self.k + self.nu):
            nodes[i] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        erased_nodes = {to_node(i) for i in erased_ids}
        if len(erased_nodes) > self.m:
            raise ErasureCodeError(
                f"clay cannot recover {len(erased_nodes)} > m={self.m}")
        for i in erased_nodes:
            nodes[i] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        # any remaining unknown nodes (not provided, not wanted) also count
        for i in range(self.q * self.t):
            if i not in nodes:
                erased_nodes.add(i)
                nodes[i] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        if len(erased_nodes) > self.m:
            raise ErasureCodeError(
                f"need at least {self.q * self.t - self.nu - self.m} chunks")
        self._decode_layered(set(erased_nodes), nodes, sc)
        return np.stack([nodes[to_node(i)].reshape(chunk)
                         for i in sorted(erased_ids)])

    # --------------------------------------------------- layered decoder --
    def _decode_layered(self, erased: Set[int], nodes: Dict[int, np.ndarray],
                        sc: int) -> None:
        """(decode_layered, ErasureCodeClay.cc:647-712)"""
        q, t = self.q, self.t
        # pad erasures to exactly m with unused parity-region nodes
        i = self.k + self.nu
        while len(erased) < self.m and i < q * t:
            erased.add(i)
            i += 1
        if len(erased) != self.m:
            raise ErasureCodeError("clay: erasure count exceeds m")
        U = {n: np.zeros_like(nodes[n]) for n in range(q * t)}
        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        zvs = [self._plane_vector(z) for z in range(self.sub_chunk_no)]
        for z in range(self.sub_chunk_no):
            order[z] = sum(1 for n in erased if n % q == zvs[z][n // q])
        max_iscore = len({n // q for n in erased})
        for iscore in range(max_iscore + 1):
            planes = [z for z in range(self.sub_chunk_no)
                      if order[z] == iscore]
            for z in planes:
                self._decode_erasures(erased, z, zvs[z], nodes, U)
            for z in planes:
                zv = zvs[z]
                for n in sorted(erased):
                    x, y = n % q, n // q
                    node_sw, z_sw = self._pair(x, y, z, zv)
                    if zv[y] != x:
                        i0, i1, i2, i3 = self._canon(x, zv[y])
                        if node_sw not in erased:
                            # type-1: pair survives
                            (c_xy,) = self._pft_solve(
                                {i1: nodes[node_sw][z_sw],
                                 i2: U[n][z]}, [i0])
                            nodes[n][z] = c_xy
                        elif zv[y] < x:
                            # both pair members erased: one joint solve
                            c0, c1 = self._pft_solve(
                                {2: U[n][z], 3: U[node_sw][z_sw]}, [0, 1])
                            nodes[n][z] = c0
                            nodes[node_sw][z_sw] = c1
                    else:
                        nodes[n][z] = U[n][z]

    def _decode_erasures(self, erased: Set[int], z: int, zv: List[int],
                         nodes: Dict[int, np.ndarray],
                         U: Dict[int, np.ndarray]) -> None:
        """(decode_erasures, ErasureCodeClay.cc:714-741)"""
        q, t = self.q, self.t
        for x in range(q):
            for y in range(t):
                n = y * q + x
                if n in erased:
                    continue
                node_sw, z_sw = self._pair(x, y, z, zv)
                if zv[y] == x:
                    U[n][z] = nodes[n][z]
                elif zv[y] < x or node_sw in erased:
                    i0, i1, i2, i3 = self._canon(x, zv[y])
                    u_xy, u_sw = self._pft_solve(
                        {i0: nodes[n][z], i1: nodes[node_sw][z_sw]},
                        [i2, i3])
                    U[n][z] = u_xy
                    U[node_sw][z_sw] = u_sw
        self._decode_uncoupled(erased, z, U)

    def _decode_uncoupled(self, erased: Set[int], z: int,
                          U: Dict[int, np.ndarray]) -> None:
        """Per-plane MDS decode across nodes (ErasureCodeClay.cc:743-761)."""
        avail = [n for n in range(self.q * self.t) if n not in erased]
        rebuilt = self.mds.decode_chunks(
            avail, np.stack([U[n][z] for n in avail]), sorted(erased))
        for i, n in enumerate(sorted(erased)):
            U[n][z] = rebuilt[i]

    # ------------------------------------------------------- repair path --
    def is_repair(self, want_to_read: Set[int],
                  available: Set[int]) -> bool:
        """(ErasureCodeClay.cc:304-323)"""
        if want_to_read <= available:
            return False
        if len(want_to_read) != 1:
            return False
        (i,) = want_to_read
        lost = i if i < self.k else i + self.nu
        for x in range(self.q):
            node = (lost // self.q) * self.q + x
            node = node if node < self.k else node - self.nu
            if node != i and 0 <= node < self.k + self.m and \
                    node not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> List[Tuple[int, int]]:
        """Sub-chunk (offset, count) ranges helpers must read
        (ErasureCodeClay.cc:363-377)."""
        y, x = lost_node // self.q, lost_node % self.q
        seq = self.q ** (self.t - 1 - y)
        out = []
        index = x * seq
        for _ in range(self.q ** y):
            out.append((index, seq))
            index += self.q * seq
        return out

    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> SubChunkPlan:
        if self.is_repair(want_to_read, available):
            (i,) = want_to_read
            lost = i if i < self.k else i + self.nu
            ranges = self.get_repair_subchunks(lost)
            plan: SubChunkPlan = {}
            for j in range(self.q):
                if j == lost % self.q:
                    continue
                rep = (lost // self.q) * self.q + j
                rep = rep if rep < self.k else rep - self.nu
                if 0 <= rep < self.k + self.m and rep in available:
                    plan[rep] = list(ranges)
            for c in sorted(available):
                if len(plan) >= self.d:
                    break
                plan.setdefault(c, list(ranges))
            if len(plan) != self.d:
                raise ErasureCodeError("clay repair needs d helpers")
            return plan
        return super().minimum_to_decode(want_to_read, available)

    def repair(self, want_id: int, helper_data: Dict[int, np.ndarray],
               chunk_size: int) -> np.ndarray:
        """Minimum-bandwidth single-chunk repair: helpers supply ONLY the
        repair sub-chunk ranges (repair_one_lost_chunk,
        ErasureCodeClay.cc:462-645)."""
        q, t = self.q, self.t
        if chunk_size % self.sub_chunk_no:
            raise ErasureCodeError("chunk_size not divisible by sub chunks")
        sc = chunk_size // self.sub_chunk_no
        repair_subchunks = self.sub_chunk_no // q
        lost = want_id if want_id < self.k else want_id + self.nu
        ranges = self.get_repair_subchunks(lost)
        repair_planes = [z for (off, cnt) in ranges
                         for z in range(off, off + cnt)]
        plane_ind = {z: i for i, z in enumerate(repair_planes)}
        to_node = lambda i: i if i < self.k else i + self.nu

        helpers: Dict[int, np.ndarray] = {}
        for cid, buf in helper_data.items():
            buf = np.asarray(buf, dtype=np.uint8).reshape(
                repair_subchunks, sc)
            helpers[to_node(cid)] = buf
        for i in range(self.k, self.k + self.nu):
            helpers[i] = np.zeros((repair_subchunks, sc), dtype=np.uint8)
        aloof = {n for n in range(q * t)
                 if n != lost and n not in helpers}
        recovered = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        U = {n: np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
             for n in range(q * t)}
        # erasures for the per-plane MDS: the lost node's whole column +
        # aloof nodes
        erasures = {lost - lost % q + i for i in range(q)} | aloof
        if len(erasures) > self.m:
            raise ErasureCodeError("clay repair: too many unknown nodes")
        zero = np.zeros(sc, dtype=np.uint8)

        def plane_order(z):
            zv = self._plane_vector(z)
            return sum(1 for n in ({lost} | aloof)
                       if n % q == zv[n // q])

        by_order: Dict[int, List[int]] = {}
        for z in repair_planes:
            by_order.setdefault(plane_order(z), []).append(z)
        for order in sorted(by_order):
            for z in by_order[order]:
                zv = self._plane_vector(z)
                for y in range(t):
                    for x in range(q):
                        n = y * q + x
                        if n in erasures:
                            continue
                        node_sw, z_sw = self._pair(x, y, z, zv)
                        i0, i1, i2, i3 = self._canon(x, zv[y])
                        if node_sw in aloof:
                            (u,) = self._pft_solve(
                                {i0: helpers[n][plane_ind[z]],
                                 i3: U[node_sw][z_sw]}, [i2])
                            U[n][z] = u
                        elif zv[y] != x:
                            (u,) = self._pft_solve(
                                {i0: helpers[n][plane_ind[z]],
                                 i1: helpers[node_sw][plane_ind[z_sw]]},
                                [i2])
                            U[n][z] = u
                        else:
                            U[n][z] = helpers[n][plane_ind[z]]
                self._decode_uncoupled(erasures, z, U)
                for n in sorted(erasures):
                    x, y = n % q, n // q
                    node_sw, z_sw = self._pair(x, y, z, zv)
                    i0, i1, i2, i3 = self._canon(x, zv[y])
                    if n in aloof:
                        continue
                    if x == zv[y]:
                        recovered[z] = U[n][z]
                    else:
                        # helper in the lost column: reconstruct the LOST
                        # node's coupled symbol at the reflected plane
                        (c_sw,) = self._pft_solve(
                            {i0: helpers[n][plane_ind[z]],
                             i2: U[n][z]}, [i1])
                        recovered[z_sw] = c_sw
        return recovered.reshape(chunk_size)


def _factory(profile: ErasureCodeProfile, device=None):
    codec = ErasureCodeClay(device)
    codec.init(profile)
    return codec


def register(registry) -> None:
    registry.add("clay", _factory)
