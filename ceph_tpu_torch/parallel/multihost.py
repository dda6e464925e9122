"""Multi-process data-plane boot, and the legs that cross ranks.

Port of ``ceph_tpu/parallel/multihost.py``.  One process per host joins
a fleet and the data plane's mesh spans every host's cells: the STRIPE
axis gets one row per process (by default), the SHARD axis stays each
host's local cells, and every sharded dispatch of ``data_plane`` runs on
every rank, each computing its own cells, with the cross-rank legs
riding ``torch.distributed``: NCCL while the package default device is
CUDA, gloo on the CPU.

Boot: every process calls :func:`ensure_initialized` with its rank;
rank 0 serves the rendezvous at ``multihost_coordinator`` (host:port).
Configuration comes from the options registry with environment
overrides for launchers::

    CEPH_TPU_COORDINATOR   overrides multihost_coordinator
    CEPH_TPU_NUM_PROCESSES overrides multihost_processes
    CEPH_TPU_PROCESS_ID    overrides multihost_process_id

Fallback rule: with no coordinator configured — the default — or fewer
than 2 processes, :func:`ensure_initialized` is a no-op returning False,
``process_index()/process_count()`` report (0, 1), and every
single-process path is unchanged.

The cross-rank helpers (:func:`all_reduce_sum`, :func:`all_gather_cells`,
:func:`exchange`) work on whatever default process group is up.  NCCL
wants one device per rank: a rank with several local cells runs them
from its first cell's device and copies the result to the others.
"""
from __future__ import annotations

import datetime
import os
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..common.options import OptionError, config

_lock = threading.Lock()
_initialized = False   # ensure_initialized ran (either outcome)
_active = False        # this process joined a fleet

ENV_COORDINATOR = "CEPH_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "CEPH_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "CEPH_TPU_PROCESS_ID"

# how long a rank waits for the others at the rendezvous and in a
# collective before it raises
TIMEOUT_S = 120


def _spec() -> Tuple[str, int, int]:
    """Resolve (coordinator, num_processes, process_id) — env wins
    over the options registry; '' / 0 / -1 mean unset."""
    coord, procs, pid = "", 0, -1
    cfg = config()
    try:
        coord = str(cfg.get("multihost_coordinator") or "")
    except OptionError:
        pass
    try:
        procs = int(cfg.get("multihost_processes") or 0)
    except OptionError:
        pass
    try:
        pid = int(cfg.get("multihost_process_id"))
    except OptionError:
        pass
    coord = os.environ.get(ENV_COORDINATOR, coord)
    if os.environ.get(ENV_NUM_PROCESSES):
        procs = int(os.environ[ENV_NUM_PROCESSES])
    if os.environ.get(ENV_PROCESS_ID) is not None \
            and os.environ.get(ENV_PROCESS_ID, "") != "":
        pid = int(os.environ[ENV_PROCESS_ID])
    return coord, procs, pid


def backend() -> str:
    """The process group's backend for the package default device."""
    from .. import default_device
    return "nccl" if torch.device(default_device()).type == "cuda" \
        else "gloo"


def ensure_initialized() -> bool:
    """Join the fleet if a coordinator is configured; no-op fallback
    otherwise.  Idempotent; returns whether the multi-process plane
    is active."""
    global _initialized, _active
    import torch.distributed as dist
    with _lock:
        if _initialized:
            return _active
        coord, procs, pid = _spec()
        if not coord or procs < 2 or pid < 0:
            _initialized = True
            return False
        dist.init_process_group(
            backend=backend(), init_method=f"tcp://{coord}",
            world_size=procs, rank=pid,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _initialized = True
        _active = True
    # the plane's layout depends on the fleet shape: drop any plane
    # resolved before the fleet came up
    from . import data_plane
    data_plane._invalidate_resolution()
    return True


def is_active() -> bool:
    """Whether this process is part of a live multi-process plane."""
    return _active


def process_index() -> int:
    """This process's rank (0 when single-process)."""
    if not _active:
        return 0
    import torch.distributed as dist
    return int(dist.get_rank())


def process_count() -> int:
    """Fleet size (1 when single-process)."""
    if not _active:
        return 1
    import torch.distributed as dist
    return int(dist.get_world_size())


def host_label(idx: Optional[int] = None) -> str:
    """Stable per-host daemon label for the cluster_stats rollup
    (``host<rank>``)."""
    return f"host{process_index() if idx is None else int(idx)}"


def global_mesh_2d(n_stripe: Optional[int] = None):
    """The fleet-wide (stripe, shard) mesh: every rank's cells, one
    stripe row per rank by default, so each host's local cells form one
    shard row.  Single-process: one row over the local cells."""
    from .mesh import global_devices, make_mesh_2d
    rows = n_stripe or process_count()
    return make_mesh_2d(rows, devices=global_devices())


def host_of_chip(mesh, flat: int) -> int:
    """Which process owns flat mesh position ``flat``."""
    return int(mesh.cell(flat).rank)


def stripe_order(targets: Sequence, host_of=None) -> List[int]:
    """Submission order for a cross-host shard fan-out: indices into
    ``targets`` interleaved round-robin across hosts.  Single-host (or
    no host resolver): the identity order.  ``host_of`` maps a target to
    its host rank; the default uses the target's affine cell on the
    resolved plane."""
    idxs = list(range(len(targets)))
    if not _active:
        return idxs
    if host_of is None:
        from .data_plane import plane
        p = plane()
        if p is None:
            return idxs

        def host_of(t):  # noqa: F811 — deliberate default binding
            return host_of_chip(p.mesh, p.chip_of(int(t)))
    buckets: dict = {}
    for i in idxs:
        buckets.setdefault(int(host_of(targets[i])), []).append(i)
    if len(buckets) < 2:
        return idxs
    order: List[int] = []
    queues = [buckets[h] for h in sorted(buckets)]
    while any(queues):
        for q in queues:
            if q:
                order.append(q.pop(0))
    return order


def shutdown() -> None:
    """Leave the fleet; safe when inactive."""
    global _initialized, _active
    import torch.distributed as dist
    with _lock:
        if _active and dist.is_initialized():
            dist.destroy_process_group()
        _initialized = False
        _active = False
    from . import data_plane
    data_plane._invalidate_resolution()


# ------------------------------------------------------- cross-rank legs --

def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The psum leg: ``t`` summed over every rank (a new tensor)."""
    import torch.distributed as dist
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_gather_cells(blocks: Sequence[torch.Tensor],
                     device) -> torch.Tensor:
    """The tiled all-gather leg: this rank's cell blocks (equal shapes),
    stacked on ``device`` (the rank's first cell's), gathered from every
    rank in rank order -> [world * len(blocks), *block]."""
    import torch.distributed as dist
    mine = torch.stack([b.to(device) for b in blocks]).contiguous()
    out = torch.empty((dist.get_world_size() * mine.shape[0],) +
                      tuple(mine.shape[1:]), dtype=mine.dtype,
                      device=mine.device)
    dist.all_gather_into_tensor(out, mine)
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """The ring's point-to-point leg: every (tensor, peer rank) of
    ``sends`` goes out and every buffer of ``recvs`` is filled from its
    peer, in one ``batch_isend_irecv``.  Messages between two ranks pair
    in the order both sides list them."""
    import torch.distributed as dist
    ops = [dist.P2POp(dist.isend, t.contiguous(), int(peer))
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, int(peer)) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
