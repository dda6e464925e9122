"""ceph_tpu_torch — the PyTorch/CUDA port of ``ceph_tpu``.

Mirrors ``ceph_tpu``'s layout (``ceph_tpu/X/y.py`` ->
``ceph_tpu_torch/X/y.py``) and holds itself bit-identical to it; the
device work runs on one NVIDIA Hopper card through kernels written for
it in ``csrc/`` (K1 ``xor_matmul.cu``, K2 ``gf_bitplane.cu``, K3
``ragged_fused.cu``).  The package imports ``torch`` and NumPy, never
JAX and nothing of ``ceph_tpu``: the NumPy-only modules it needs are
kept here as copies (``common/{options,perf_counters,faults,lockdep,
tracer,op_tracker,jit_profile,crcutil,auth,compressor}.py``,
``ops/{gf,gf2}.py``, ``ec/{interface,base,table_cache,
matrix_codec}.py``, ``placement/{crush_map,lntable,builder,
scalar_mapper}.py``, ``msg/{encoding,queue,scheduler,dispatcher,
shm_ring}.py``, ``msg/wire.py`` but for its receive verify,
``cluster/{pg_heat,objectstore,pglog,ec_rmw,osd_service,blockdev,kv,
wal_kv,bluestore}.py`` and ``native_bridge.py``, which builds
``native/*.cpp`` into ``build/native/``).

Device policy: entry points run on the card.  The package default device
is ``cuda``; a caller asks for the CPU explicitly, with
``set_default_device("cpu")`` or a ``device=`` argument.  Without a card
and without that request an entry point raises — it never falls back to
the CPU on its own.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

_default_device = "cuda"


def set_default_device(device) -> None:
    """Set the device entry points use when no ``device=`` is given."""
    global _default_device
    _default_device = str(torch.device(device))


def default_device() -> str:
    return _default_device


def resolve_device(device=None) -> torch.device:
    """``device`` (or the package default) as a ``torch.device``;
    raises when it names CUDA and no card is present."""
    dev = torch.device(device if device is not None else _default_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ceph_tpu_torch: no CUDA device is available; ask for the "
            "CPU explicitly with device='cpu' or "
            "ceph_tpu_torch.set_default_device('cpu')")
    return dev
