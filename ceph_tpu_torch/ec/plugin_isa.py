"""The 'isa' codec — the reference's throughput-baseline RS variant.

Mirrors the option surface and fast paths of the reference ISA-L plugin
(src/erasure-code/isa/ErasureCodeIsa.cc): technique ``reed_sol_van`` uses
the gf_gen_rs_matrix construction, ``cauchy`` uses gf_gen_cauchy1
(ErasureCodeIsa.cc:385-387); decode of a single data erasure with all
parities intact short-circuits to a pure region XOR when m == 1 or the
first parity row is all-ones (the xor_op fast path, ErasureCodeIsa.cc:152-210);
inverted decode matrices are LRU-cached per erasure signature
(ErasureCodeIsaTableCache.h:35-63 — here via MatrixCodec's cache).

This NumPy implementation doubles as the honest CPU baseline the
device plugin is benchmarked against (BASELINE.md config #2).

Port of ``ceph_tpu/ec/plugin_isa.py``: the codec is built on the
caller's device (the package default when None) and computes on the
host, as the reference's does.
"""
from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..ops import gf
from .interface import ErasureCodeError, ErasureCodeProfile
from .matrix_codec import MatrixCodec

DEFAULT_K = 7
DEFAULT_M = 3


class ErasureCodeIsa(MatrixCodec):
    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique", "reed_sol_van")
        k = self.profile_int(profile, "k", DEFAULT_K, minimum=1)
        m = self.profile_int(profile, "m", DEFAULT_M, minimum=1)
        if k + m > 255:
            raise ErasureCodeError("isa requires k+m <= 255 (w=8)")
        if technique == "reed_sol_van":
            # the rs construction is not guaranteed MDS for m > 2; the
            # reference plugin inherits the same ISA-L caveat
            parity = gf.isa_rs_parity(k, m)
        elif technique == "cauchy":
            parity = gf.isa_cauchy_parity(k, m)
        else:
            raise ErasureCodeError(
                f"isa technique must be reed_sol_van|cauchy, got "
                f"{technique!r}")
        self.set_matrix(parity, 8)
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "isa")
        self._profile["technique"] = technique
        self._profile.update(k=str(k), m=str(m))

    # ------------------------------------------------------ XOR fast path --
    def _xor_decodable(self, available_ids, erased_ids) -> bool:
        """Single data erasure + parity row of ones available → pure XOR."""
        if len(erased_ids) != 1:
            return False
        (e,) = erased_ids
        if e >= self.k:
            return False
        have = set(available_ids)
        return self.k in have and all(
            i in have for i in range(self.k) if i != e) and \
            bool(np.all(self.parity[0] == 1))

    def decode_chunks(self, available_ids, chunks, erased_ids):
        erased = sorted(erased_ids)
        if self._xor_decodable(available_ids, erased):
            (e,) = erased
            order = list(available_ids)
            acc = np.zeros_like(np.asarray(chunks[0], dtype=np.uint8))
            for c in [i for i in range(self.k) if i != e] + [self.k]:
                acc ^= np.asarray(chunks[order.index(c)], dtype=np.uint8)
            return acc[None, :]
        return super().decode_chunks(available_ids, chunks, erased)


def _factory(profile: ErasureCodeProfile, device=None):
    codec = ErasureCodeIsa(device)
    codec.init(profile)
    return codec


def register(registry) -> None:
    registry.add("isa", _factory)
