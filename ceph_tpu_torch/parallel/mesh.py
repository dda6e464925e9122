"""Device meshes and the sharded encode steps.

Port of ``ceph_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` and lets XLA place collectives; the port keeps its
names and its model (one program over every cell of the mesh, the
batch axes split over the cells) in PyTorch's idiom:

  * a **cell** is one position of the mesh: the rank that owns it and
    the ``torch.device`` it computes on.  A mesh may repeat a device, so
    one card can hold a mesh of several cells (the reference's mesh
    holds distinct devices: ROADMAP section C records the divergence);
  * a **split** names the mesh axes an operand's leading axis is cut
    over (row-major over their cells), replicated over the rest — the
    ``NamedSharding`` of the reference;
  * every cell runs its block through the port's own dispatching entry
    (``ops/xor_kernel``, ``ops/gf_pallas``): a CUDA cell launches the
    kernel, a CPU cell runs the plain version;
  * legs inside a process are tensor operations between the cells'
    tensors (``narrow``, an int64 sum for psum, ``torch.cat`` for the
    tiled all-gather); legs that cross ranks go through
    ``parallel/multihost.py`` (``torch.distributed``).

The device list a mesh resolves by itself (:func:`local_devices`) is the
package default device's: every CUDA device when it is ``cuda``, else
the CPU, each repeated ``cells_per_device`` times.  That count is 1, so
one card or a plain CPU process resolves one cell and leaves the data
plane off, as the reference does on one device; the tests set it to 8,
the twin of the reference conftest's 8 forced host devices.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

# The shared axis-name vocabulary: every split in the port names its
# axes through these constants.  SHARD_AXIS is the 1-D stripe/PG batch
# axis; STRIPE_AXIS the outer (multi-process) axis of the 2-D mesh.
SHARD_AXIS = "shard"
STRIPE_AXIS = "stripe"
MESH_AXES: Tuple[str, str] = (STRIPE_AXIS, SHARD_AXIS)

# cells per device when a mesh resolves its own device list
cells_per_device = 1


class Cell(NamedTuple):
    """One mesh position: the rank that owns it and its device."""
    rank: int
    device: torch.device


def local_devices() -> List[torch.device]:
    """This process's cell devices: the package default device's kind
    (every CUDA device, or the CPU), each ``cells_per_device`` times.
    Raises when the default is CUDA and no card is present."""
    from .. import resolve_device
    dev = resolve_device()
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    return [d for d in devs for _ in range(int(cells_per_device))]


def global_devices() -> List[Cell]:
    """Every rank's cells, rank-major (the twin of ``jax.devices()``):
    each rank of a fleet holds the same local device list."""
    from .multihost import process_count
    local = local_devices()
    return [Cell(r, d) for r in range(process_count()) for d in local]


def _as_cell(x) -> Cell:
    if isinstance(x, Cell):
        return x
    from .multihost import process_index
    return Cell(process_index(), torch.device(x))


class Mesh:
    """A grid of cells: ``devices`` is an object ndarray of :class:`Cell`
    shaped ``(n,)`` or ``(rows, cols)``, ``axis_names`` names its axes."""

    def __init__(self, cells: np.ndarray, axis_names: Sequence[str]):
        if cells.ndim != len(axis_names):
            raise ValueError(f"{cells.ndim}-D cells for axes {axis_names}")
        self.devices = cells
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def cell(self, flat: int) -> Cell:
        return self.devices.flat[int(flat)]

    def local_cells(self) -> List[int]:
        """Flat positions of the cells this process owns."""
        from .multihost import process_index
        me = process_index()
        return [i for i, c in enumerate(self.devices.flat) if c.rank == me]


def _cells(arr) -> np.ndarray:
    out = np.empty(len(arr), dtype=object)
    for i, c in enumerate(arr):
        out[i] = _as_cell(c)
    return out


def _pick_devices(n_devices: Optional[int],
                  devices_: Optional[Sequence]) -> Sequence:
    """The cell list: ``devices_`` as given, else
    :func:`global_devices`, cut to ``n_devices``."""
    devs = list(devices_) if devices_ is not None else global_devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return devs


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the stripe/PG batch axis.  ``devices`` may list
    cells or devices, and may repeat a device."""
    return Mesh(_cells(_pick_devices(n_devices, devices)), (SHARD_AXIS,))


def make_mesh_2d(n_stripe: int, n_shard: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """Named 2-D (stripe, shard) mesh: the cell list reshaped row-major
    into ``n_stripe`` rows of ``n_shard`` cells.  ``n_shard=None`` infers
    the column count, with a clear divisibility error."""
    if n_stripe < 1:
        raise ValueError(f"n_stripe must be >= 1, got {n_stripe}")
    if n_shard is None:
        devs = list(devices) if devices is not None \
            else global_devices()
        if len(devs) % n_stripe:
            raise ValueError(
                f"cannot split {len(devs)} device(s) into {n_stripe} "
                f"stripe row(s): {len(devs)} % {n_stripe} != 0 — pick "
                f"a stripe count that divides the device count, or "
                f"pass n_shard explicitly")
        n_shard = len(devs) // n_stripe
        devices = devs
    total = n_stripe * n_shard
    devs = _pick_devices(total, devices)
    grid = _cells(devs).reshape(n_stripe, n_shard)
    return Mesh(grid, MESH_AXES)


class Split(NamedTuple):
    """How an operand lies on a mesh: its leading axis cut over ``axes``
    (row-major over their cells), replicated over the other axes;
    ``axes == ()`` replicates it on every cell."""
    mesh: Mesh
    axes: Tuple[str, ...]

    @property
    def blocks(self) -> int:
        """How many blocks the leading axis is cut into."""
        return int(np.prod([self.mesh.shape[a] for a in self.axes]))

    def block_of(self, flat: int) -> int:
        """The block the cell at ``flat`` holds."""
        idx = np.unravel_index(int(flat), self.mesh.devices.shape)
        pos = [idx[self.mesh.axis_names.index(a)] for a in self.axes]
        dims = [self.mesh.shape[a] for a in self.axes]
        return int(np.ravel_multi_index(pos, dims)) if dims else 0


def batch_sharding(mesh: Mesh) -> Split:
    """Split the leading (stripe/PG) axis over SHARD; replicate the rest."""
    return Split(mesh, (SHARD_AXIS,))


def replicated_sharding(mesh: Mesh) -> Split:
    return Split(mesh, ())


def lane_shardings(mesh: Mesh) -> Tuple[Split, Split]:
    """(batch, replicated) splits of a data-plane lane, keyed off the
    mesh's own axis names: the batch cuts over ALL axes row-major (one
    lane block per flat mesh position), so a (r, c) mesh splits a sweep
    r*c ways exactly like the flat cell list."""
    return Split(mesh, tuple(mesh.axis_names)), Split(mesh, ())


def mesh_cache_key(mesh: Mesh):
    """Stable key for a mesh: its cells (rank and device), grid shape and
    axis names — never ``id(mesh)``."""
    return (tuple(mesh.devices.flat), mesh.devices.shape, mesh.axis_names)


# ------------------------------------------------------------ cell runs --

def run_cells(mesh: Mesh, fn: Callable[[int, Cell], Tuple[torch.Tensor, ...]]
              ) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """``fn(flat, cell)`` for every cell this process owns, each on its
    own device; returns {flat: outputs}."""
    return {i: tuple(fn(i, mesh.cell(i))) for i in mesh.local_cells()}


def gather_cells(mesh: Mesh, outs: Dict[int, Tuple[torch.Tensor, ...]],
                 device) -> List[Tuple[torch.Tensor, ...]]:
    """Every cell's outputs in flat order on ``device``: this process's
    from ``outs``, the other ranks' through ``multihost.all_gather_cells``
    (a fleet must give every rank the same number of cells, and every
    cell outputs of one shape)."""
    from . import multihost
    device = torch.device(device)
    if len(outs) == mesh.size:
        return [tuple(t.to(device) for t in outs[i])
                for i in range(mesh.size)]
    by_rank: Dict[int, List[int]] = {}
    for i, c in enumerate(mesh.devices.flat):
        by_rank.setdefault(c.rank, []).append(i)
    mine = sorted(outs)
    full: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * mesh.size
    n_out = len(next(iter(outs.values())))
    for j in range(n_out):
        stacked = multihost.all_gather_cells(
            [outs[i][j] for i in mine], mesh.cell(mine[0]).device)
        for r, pos in sorted(by_rank.items()):
            if len(pos) != len(mine):
                raise ValueError(
                    f"rank {r} owns {len(pos)} cells, this rank "
                    f"{len(mine)}: the fleet's ranks must hold equal rows")
            for q, i in enumerate(pos):
                got = stacked[r * len(mine) + q].to(device)
                full[i] = (full[i] or ()) + (got,)
    return full


def psum(mesh: Mesh, partials: Dict[int, torch.Tensor],
         cells: Sequence[int]) -> torch.Tensor:
    """Sum of the ``partials`` of the cells at ``cells`` (one per block
    the reduction covers), as an int64 scalar on this process's first
    cell's device, left there unread: this rank's own cells are summed
    in the process and a fleet adds the ranks with ``all_reduce``."""
    from . import multihost
    dev = mesh.cell(mesh.local_cells()[0]).device
    want = set(cells)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for i, t in partials.items():
        if i in want:
            total = total + t.to(dev, torch.int64)
    if multihost.is_active():
        total = multihost.all_reduce_sum(total)
    return total


def map_lanes(mesh: Mesh, fn: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                               ...]],
              lanes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The lane sweep over a mesh: ``lanes`` [N] (N a multiple of the
    mesh size) cut flat, row-major, into one block per cell
    (``lane_shardings``); each cell maps its block with ``fn`` on its own
    device; a fleet all-gathers the other ranks' blocks.  Returns ``fn``'s
    outputs concatenated on ``lanes``' device."""
    n = int(lanes.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} lanes do not split over {mesh.size} cells")
    per = n // mesh.size
    split, _ = lane_shardings(mesh)
    outs = run_cells(mesh, lambda i, c: fn(
        lanes.narrow(0, split.block_of(i) * per, per).to(c.device)))
    full = gather_cells(mesh, outs, lanes.device)
    return tuple(torch.cat([f[j] for f in full])
                 for j in range(len(full[0])))


# ------------------------------------------------------ distributed steps --

def _step(mesh: Mesh, kernel, op, data: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sharded step: ``op`` replicated, ``data`` [B, ...] cut over
    the batch split (SHARD); each cell runs ``kernel(op, block)`` on its
    own device, and the byte counter is the psum over one replica of the
    int64 sum of the data's VALUES (the reference's ``jnp.sum(d.astype(
    int64))``).  Returns (out [B, ...] on data's device, total)."""
    split = batch_sharding(mesh)
    B = int(data.shape[0])
    if B % split.blocks:
        raise ValueError(f"batch {B} does not split over {split.blocks} "
                         f"shard columns")
    per = B // split.blocks

    def cell(i, c):
        block = data.narrow(0, split.block_of(i) * per, per).to(c.device)
        return kernel(op, block), block.sum(dtype=torch.int64)

    outs = run_cells(mesh, cell)
    # one replica: every cell of a 1-D mesh, stripe row 0 of a 2-D one
    replica = range(mesh.devices.shape[-1])
    total = psum(mesh, {i: o[1] for i, o in outs.items()}, replica)
    full = gather_cells(mesh, {i: o[:1] for i, o in outs.items()},
                        data.device)
    rep = {}
    for i, f in enumerate(full):
        rep.setdefault(split.block_of(i), f[0])
    return torch.cat([rep[b] for b in range(split.blocks)]), total


def distributed_encode_step(mesh: Mesh, bitmat, data: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sharded GF(2^8) encode step: stripes split over the mesh's
    shard columns, each cell's parity through ``gf_pallas.bitplane_matmul``
    (kernel K2 on a CUDA cell — the reference runs its plain XLA math
    here, the port launches the kernel), plus the psum byte counter.

    bitmat [8m, 8k] 0/1 host array, data [B, k, L] uint8 ->
    (parity [B, m, L], total)."""
    from ..ops import gf_pallas
    bm = np.ascontiguousarray(
        # the K2 wrapper takes the bit-matrix as a host array
        bitmat.cpu().numpy() if isinstance(bitmat,  # noqa: CTL101
                                           torch.Tensor)
        else bitmat, dtype=np.uint8)
    return _step(mesh, gf_pallas.bitplane_matmul, bm, data)


def distributed_xor_encode_step(mesh: Mesh, masks, words
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded masked-XOR encode: words [B, C, W] int32 split over the
    shard columns, masks [R, C] replicated; each cell through
    ``xor_kernel.xor_matmul_w32`` (kernel K1 on a CUDA cell).  Returns
    (parity planes [B, R, W], psum byte counter)."""
    from ..ops import xor_kernel
    words = xor_kernel._as_tensor(words, torch.int32, np.int32)
    masks = (masks.to(torch.int32) if isinstance(masks, torch.Tensor)
             else torch.as_tensor(np.asarray(masks, dtype=np.int32)))
    return _step(mesh, lambda op, d: xor_kernel.xor_matmul_w32(
        op.to(d.device), d), masks, words)
