"""Compressor plugins — the second dlopen-plugin family.

The reference ships compressors behind the same plugin pattern as the
EC codecs (src/compressor/ + src/common/PluginRegistry.cc: zlib,
snappy, zstd, lz4 selected by name, used by BlueStore and messenger
on-wire compression).  Same seam here: a registry keyed by name with a
factory, a conformance surface (compress/decompress + name), and the
algorithms Python ships natively (zlib, lzma, bz2, zstd when
available) — raising cleanly for ones this build lacks, like the
reference does for plugins compiled out.
"""
from __future__ import annotations

import bz2
import lzma
import threading
import zlib
from typing import Callable, Dict, Optional


class CompressorError(RuntimeError):
    pass


class Compressor:
    """Plugin surface (reference: src/compressor/Compressor.h)."""
    name = "none"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes) -> bytes:
        raise NotImplementedError


class _Zlib(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise CompressorError(f"zlib: {e}") from e


class _Lzma(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data)

    def decompress(self, data: bytes) -> bytes:
        try:
            return lzma.decompress(data)
        except lzma.LZMAError as e:
            raise CompressorError(f"lzma: {e}") from e


class _Bz2(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data)

    def decompress(self, data: bytes) -> bytes:
        try:
            return bz2.decompress(data)
        except (OSError, ValueError) as e:
            raise CompressorError(f"bz2: {e}") from e


class _Zstd(Compressor):
    name = "zstd"

    def __init__(self):
        try:
            import zstandard
        except ImportError as e:
            raise CompressorError(
                "zstd support not built (zstandard module missing)") from e
        self._mod = zstandard

    def compress(self, data: bytes) -> bytes:
        return self._mod.ZstdCompressor().compress(data)

    def decompress(self, data: bytes) -> bytes:
        return self._mod.ZstdDecompressor().decompress(data)


class CompressorRegistry:
    """PluginRegistry analog: name -> factory, lazy instantiation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._factories: Dict[str, Callable[[], Compressor]] = {}
        self.add("zlib", _Zlib)
        self.add("lzma", _Lzma)
        self.add("bz2", _Bz2)
        self.add("zstd", _Zstd)

    def add(self, name: str, factory: Callable[[], Compressor]) -> None:
        with self._lock:
            if name in self._factories:
                raise CompressorError(f"compressor {name!r} already "
                                      "registered")
            self._factories[name] = factory

    def factory(self, name: str) -> Compressor:
        with self._lock:
            f = self._factories.get(name)
        if f is None:
            raise CompressorError(
                f"unknown compressor {name!r} "
                f"(have {sorted(self._factories)})")
        return f()

    def names(self):
        with self._lock:
            return sorted(self._factories)


_registry: Optional[CompressorRegistry] = None
_registry_lock = threading.Lock()


def compressors() -> CompressorRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = CompressorRegistry()
        return _registry
