"""The 'jax' codec of the port — batched erasure coding on the card.

Port of ``ceph_tpu/ec/plugin_jax.py``.  The class keeps its name and
registers as ``jax`` so that one profile dict drives both packages; the
matrices (``parity``, ``decode_matrix``) are the reference's.

  * ``layout=bitsliced``: jerasure-packet layout — each chunk is 8 plane
    regions and one GF(2^8) symbol is bit-sliced across them
    (jerasure_schedule_encode packets,
    src/erasure-code/jerasure/ErasureCodeJerasure.cc:162,274).  Every
    stripe operation is one call of kernel K1, ops/xor_kernel.py.
  * ``layout=bytes`` (the default when a profile names none): classic
    byte-symbol layout — chunk byte t is one GF(2^8) symbol; parity bytes
    match jerasure/ISA-L matrix techniques.  Every stripe operation is
    one call of kernel K2, ops/gf_pallas.py, on a CUDA tensor, and its
    plain version (ops/gf_jax.py) on a CPU tensor.  ``ec_kernel=xla``
    names the plain version: the codec refuses it for a CUDA tensor,
    because the plain version never runs on the card.

Data follows its tensor: the device entry points compute on the device
of the tensor they are given; NumPy input goes to the codec's device
(the package default, ``cuda`` unless the caller asked for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..common.perf_counters import perf as _perf
from ..ops import gf, gf_jax, gf_pallas
from .interface import ErasureCodeError, ErasureCodeProfile
from .matrix_codec import MatrixCodec

DEFAULT_K = 8
DEFAULT_M = 3

TECHNIQUES = ("reed_sol_van", "cauchy", "cauchy_good", "isa_rs")
LAYOUTS = ("bytes", "bitsliced")


def _data_plane():
    """The sharded cluster data plane, or None (parallel_data_plane
    off, or fewer than two cells).  Resolved per dispatch so a runtime
    config flip takes effect immediately."""
    from ..parallel.data_plane import plane
    return plane()

_NP = {torch.uint8: np.uint8, torch.int32: np.int32}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ErasureCodeJax(MatrixCodec):
    """RS/Cauchy codec whose stripe math executes on the card."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique", "reed_sol_van")
        k = self.profile_int(profile, "k", DEFAULT_K, minimum=1)
        m = self.profile_int(profile, "m", DEFAULT_M, minimum=1)
        w = self.profile_int(profile, "w", 8)
        if w != 8:
            raise ErasureCodeError("jax codec runs in GF(2^8); w must be 8")
        if k + m > 256:
            raise ErasureCodeError("k+m must be <= 256 for w=8")
        if technique == "reed_sol_van":
            parity = gf.vandermonde_parity(k, m)
        elif technique == "cauchy":
            parity = gf.isa_cauchy_parity(k, m)
        elif technique == "cauchy_good":
            parity = gf.cauchy_good_parity(k, m)
        elif technique == "isa_rs":
            parity = gf.isa_rs_parity(k, m)
        else:
            raise ErasureCodeError(
                f"technique={technique!r} not in {TECHNIQUES}")
        layout = profile.get("layout", "bytes")
        if layout not in LAYOUTS:
            raise ErasureCodeError(f"layout={layout!r} not in {LAYOUTS}")
        self.layout = layout
        self.set_matrix(parity, 8)
        self._pc = _perf("ec.jax")       # cached group handle (hot path)
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "jax")
        self._profile["technique"] = technique
        self._profile["layout"] = layout
        self._profile.update(k=str(k), m=str(m))

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        """A tensor stays where it is; host data goes to the codec's
        device."""
        if isinstance(x, torch.Tensor):
            if x.dtype != dtype:
                raise ErasureCodeError(f"expected {dtype}, got {x.dtype}")
            return x
        return torch.as_tensor(np.ascontiguousarray(x, dtype=_NP[dtype]),
                               device=self.device)

    # ----------------------------------------------------------- encode ---
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        return _host(self.encode_chunks_device(data_chunks))

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        return _host(self.encode_chunks_device(data))

    def _matmul(self, matrix, data: torch.Tensor) -> torch.Tensor:
        """Byte-layout product: K2 for a CUDA tensor, the plain version
        for a CPU tensor (``ec_kernel``: auto and pallas both mean the
        wrapper's dispatch; xla asks for the plain version, which exists
        only on the CPU)."""
        from ..common.options import config
        mode = config().get("ec_kernel")
        if mode == "xla":
            if data.device.type != "cpu":
                raise ErasureCodeError(
                    "ec_kernel=xla names the plain GF(2^8) product, which "
                    "never runs on the card; use ec_kernel=auto")
            return gf_jax.gf8_matmul(matrix, data)
        return gf_pallas.bitplane_matmul(gf.gf8_bitmatrix(matrix),
                                         data.contiguous())

    def _plane_matmul(self, gf_matrix, data: torch.Tensor) -> torch.Tensor:
        """[..., n, L] uint8 chunks -> [..., rows, L] through K1
        (reshape-only layout moves)."""
        from ..ops import xor_kernel
        masks = xor_kernel.masks_to_device(gf.gf8_bitmatrix(gf_matrix),
                                           data.device)
        n, L = data.shape[-2], data.shape[-1]
        if L % 32:
            raise ErasureCodeError(
                f"bitsliced layout needs chunk size % 32 == 0, got {L}")
        planes = data.reshape(tuple(data.shape[:-2]) + (8 * n, L // 8))
        out = xor_kernel.xor_matmul(masks, planes)
        r = out.shape[-2] // 8
        return out.reshape(tuple(out.shape[:-2]) + (r, L))

    def encode_chunks_device(self, data) -> torch.Tensor:
        """[..., k, L] uint8 -> [..., m, L] uint8, on the device."""
        data = self._tensor(data, torch.uint8)
        if data.shape[-2] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data.shape[-2]}")
        pc = self._pc
        pc.inc("encode_dispatches")
        pc.inc("encode_bytes", int(data.numel()))
        if self.layout == "bitsliced":
            return self._plane_matmul(self.parity, data)
        return self._matmul(self.parity, data)

    # ------------------------------------------------ word-domain (i32) ---
    # The bitsliced at-rest format IS int32 plane words (32 GF(2) lanes
    # per word).  These entry points take/return [.., n, W] int32 (W =
    # chunk_bytes/4): region boundaries are word-aligned (chunk % 32 ==
    # 0), so the plane view is a pure word-domain reshape — how the
    # cluster's device data plane runs (cluster/device_store.py).

    def encode_words_device(self, words) -> torch.Tensor:
        """[.., k, W] int32 -> [.., m, W] int32, on the device."""
        from ..ops import xor_kernel
        if self.layout != "bitsliced":
            raise ErasureCodeError(
                "word-domain encode requires layout=bitsliced")
        words = self._tensor(words, torch.int32)
        if words.shape[-2] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {words.shape[-2]}")
        W = words.shape[-1]
        if (W * 4) % 32:
            raise ErasureCodeError(
                f"bitsliced layout needs chunk size % 32 == 0, "
                f"got {W * 4}")
        masks = xor_kernel.masks_to_device(gf.gf8_bitmatrix(self.parity),
                                           words.device)
        lead = tuple(words.shape[:-2])
        planes = words.reshape(lead + (8 * self.k, W // 8))
        pc = self._pc
        pc.inc("encode_dispatches")
        pc.inc("encode_bytes", 4 * int(words.numel()))
        dp = _data_plane()
        if dp is not None:
            # sharded data plane: stripes split across the mesh, the
            # same masked-XOR contraction per cell (bit-identical)
            out = dp.xor_matmul_w32(masks, planes, kind="put")
        else:
            out = xor_kernel.xor_matmul_w32(masks, planes)
        return out.reshape(lead + (self.m, W))

    def decode_words_device(self, available_ids, words,
                            erased_ids) -> torch.Tensor:
        """words [.., n_avail, W] int32 for one erasure signature ->
        [.., n_erased, W] int32 on the device (the recovery matrix is a
        mask operand: new signatures reuse the kernel)."""
        from ..ops import xor_kernel
        if self.layout != "bitsliced":
            raise ErasureCodeError(
                "word-domain decode requires layout=bitsliced")
        words = self._tensor(words, torch.int32)
        erased = sorted(erased_ids)
        if not erased:
            return torch.zeros(tuple(words.shape[:-2]) +
                               (0, words.shape[-1]),
                               dtype=words.dtype, device=words.device)
        W = words.shape[-1]
        if (W * 4) % 32:
            raise ErasureCodeError(
                f"bitsliced layout needs chunk size % 32 == 0, "
                f"got {W * 4}")
        pc = self._pc
        pc.inc("decode_dispatches")
        pc.inc("decode_bytes", 4 * int(words.numel()))
        R, dev = self._select_rows(available_ids, erased, words)
        masks = xor_kernel.masks_to_device(gf.gf8_bitmatrix(R),
                                           words.device)
        lead = tuple(dev.shape[:-2])
        planes = dev.reshape(lead + (8 * dev.shape[-2], W // 8))
        dp = _data_plane()
        if dp is not None:
            # one sharded dispatch per signature group: the lost
            # stripes split across the mesh, accounting psums back
            out = dp.xor_matmul_w32(masks, planes, kind="decode")
        else:
            out = xor_kernel.xor_matmul_w32(masks, planes)
        return out.reshape(lead + (len(erased), W))

    def _select_rows(self, available_ids, erased, chunks: torch.Tensor):
        """Decode matrix + the used-row subset of ``chunks`` (shared by
        both decode domains)."""
        R, used = self.decode_matrix(available_ids, erased)
        order = list(available_ids)
        sel = [order.index(c) for c in used]
        if sel != list(range(len(order))):
            chunks = torch.stack([chunks[..., i, :] for i in sel], dim=-2)
        return R, chunks

    # ----------------------------------------------------------- decode ---
    def decode_chunks(self, available_ids, chunks, erased_ids):
        return _host(
            self.decode_chunks_device(available_ids, chunks, erased_ids))

    def decode_chunks_batch(self, available_ids, chunks, erased_ids):
        return _host(
            self.decode_chunks_device(available_ids, chunks, erased_ids))

    def decode_chunks_device(self, available_ids, chunks,
                             erased_ids) -> torch.Tensor:
        """chunks [..., n_avail, L] uint8 for one erasure signature shared
        by the whole batch -> [..., n_erased, L] uint8 on the device."""
        chunks = self._tensor(chunks, torch.uint8)
        erased = sorted(erased_ids)
        if not erased:
            return torch.zeros(tuple(chunks.shape[:-2]) +
                               (0, chunks.shape[-1]),
                               dtype=torch.uint8, device=chunks.device)
        pc = self._pc
        pc.inc("decode_dispatches")
        pc.inc("decode_bytes", int(chunks.numel()))
        pc.set("decode_cache_hits", self._cache.hits)
        pc.set("decode_cache_misses", self._cache.misses)
        R, rows = self._select_rows(available_ids, erased, chunks)
        if self.layout == "bitsliced":
            return self._plane_matmul(R, rows)
        return self._matmul(R, rows)


def _factory(profile: ErasureCodeProfile, device=None):
    codec = ErasureCodeJax(device)
    codec.init(profile)
    return codec


def register(registry) -> None:
    registry.add("jax", _factory)
