"""Multi-process data-plane boot: the single-process part.

Port of ``ceph_tpu/parallel/multihost.py``.  The reference joins a
``jax.distributed`` fleet, one process per host, and spans the data
plane's mesh over every host's devices.  The port's multi-GPU plane
(``torch.distributed`` over NCCL) is not written yet (ROADMAP queue A,
item 7), so this module keeps only what a single process answers, the
answers the reference gives while its fleet is inactive:

* :func:`process_index` is 0, :func:`process_count` is 1,
  :func:`is_active` is False and :func:`host_label` is ``host0``;
* :func:`stripe_order` is the identity order.

:func:`ensure_initialized`, :func:`global_mesh_2d`, :func:`host_of_chip`
and :func:`stripe_order` on an active fleet raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

_active = False        # a fleet is joined: never, until the plane is ported

_NOT_PORTED = ("the multi-process data plane is not ported yet "
               "(ROADMAP queue A, item 7)")


def ensure_initialized() -> bool:
    """Join the fleet: raises, the plane is not ported."""
    raise NotImplementedError(_NOT_PORTED)


def is_active() -> bool:
    """Whether this process is part of a live multi-process plane."""
    return _active


def process_index() -> int:
    """This process's rank: 0, the single-process answer."""
    if _active:
        raise NotImplementedError(_NOT_PORTED)
    return 0


def process_count() -> int:
    """Fleet size: 1, the single-process answer."""
    if _active:
        raise NotImplementedError(_NOT_PORTED)
    return 1


def host_label(idx: Optional[int] = None) -> str:
    """Stable per-host daemon label for the cluster_stats rollup
    (``host<rank>``)."""
    return f"host{process_index() if idx is None else int(idx)}"


def global_mesh_2d(n_stripe: Optional[int] = None):
    """The fleet-wide (stripe, shard) mesh: raises, not ported."""
    raise NotImplementedError(_NOT_PORTED)


def host_of_chip(mesh, flat: int) -> int:
    """Which process owns a mesh position: raises, not ported."""
    raise NotImplementedError(_NOT_PORTED)


def stripe_order(targets: Sequence, host_of=None) -> List[int]:
    """Submission order for a shard fan-out: the identity order on a
    single host (the fan-out byte for byte); an active fleet's
    round-robin across hosts raises, not ported."""
    if _active:
        raise NotImplementedError(_NOT_PORTED)
    return list(range(len(targets)))
