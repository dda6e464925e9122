"""Erasure-code subsystem — the reference's six codec plugins behind one
registry, and the device data paths on the port's kernels: K1
(``ops/xor_kernel.py``) for the bitsliced ``jax`` layout and the
jerasure bitmatrix techniques, K2 (``ops/gf_pallas.py``) for the byte
layout that LRC's layers and CLAY's inner codecs use."""
from .interface import ErasureCodeInterface, ErasureCodeProfile  # noqa: F401
from .registry import ErasureCodePluginRegistry, instance  # noqa: F401
