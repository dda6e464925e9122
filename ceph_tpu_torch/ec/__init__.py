"""Erasure-code subsystem — codecs, plugin registry, and the device data
path on the masked-XOR kernel (``ops/xor_kernel.py``)."""
from .interface import ErasureCodeInterface, ErasureCodeProfile  # noqa: F401
from .registry import ErasureCodePluginRegistry, instance  # noqa: F401
