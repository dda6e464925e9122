"""ShardedDataPlane — the cluster hot loops sharded over a mesh of cells.

Port of ``ceph_tpu/parallel/data_plane.py``.  ``parallel/mesh.py``
shards the raw kernels; this module shards the *system*: the batched put
encode, the degraded-get / recovery decode (signature-grouped
masked-XOR), the fused ragged encode and the million-PG remap sweep all
dispatch over a mesh, with the cluster-wide accounting riding a psum.

Mesh layouts (``parallel_data_plane_stripes``):

  * 1-D ``(shard,)`` (default): the stripe/PG batch axis splits over
    every cell; masks replicate.
  * 2-D ``(stripe, shard)`` (stripes >= 2, or one stripe row per rank
    under the multi-process plane, parallel/multihost.py): the batch
    splits over the STRIPE rows while the k+m output shards (the
    masked-XOR contraction's R rows) split over the SHARD columns.  The
    row counter psums along STRIPE, rebuilt shards gather along SHARD
    (each stripe row assembles its k+m) then along STRIPE, and
    ``ppermute_shift`` runs the flat ring over both axes row-major.

Every cell runs its block through the port's dispatching entry
(``ops/xor_kernel.xor_matmul_w32`` for K1, ``ops/gf_pallas`` for K3), so
a CUDA cell launches the kernel and a CPU cell runs the plain version.
Legs inside a process are tensor operations between the cells' tensors;
legs across ranks go through ``multihost``.  Results are bit-identical
to the unsharded kernel on any layout: the contraction is pure AND/XOR,
a split changes the layout and never a value, and padding rows and
columns are zeros sliced off before return.  Every result comes back as
one contiguous tensor on the operand's device.

Wiring (all behind the ``parallel_data_plane`` option, default off):
``ec/plugin_jax.py`` routes ``encode_words_device`` /
``decode_words_device`` through :meth:`ShardedDataPlane.xor_matmul_w32`;
``cluster/simulator.py`` runs the recovery sweep's rebuild through
:meth:`ShardedDataPlane.rebuild_collective`; ``cluster/osdmap.py`` hands
the plane's mesh to ``map_batch``; ``ops/ragged_fused.py`` sends its
pool through :meth:`ShardedDataPlane.fused_ragged`;
``cluster/ec_backend.py`` and ``cluster/device_store.py`` account
sub-writes and staging per cell by OSD-shard -> cell affinity.

Observability: per-cell counters land in the ``dataplane`` perf group
(``shard<i>.put_stripes`` / ``..._bytes``, ``decode_*``, ``recover_*``,
``map_lanes``, ``staged_*``, ``subwrites``, and ``r<row>c<col>.*`` on
the 2-D mesh), equal to the reference's for the same dispatches, and
every sharded dispatch tags the calling thread's tracked op with a
``dispatched_mesh`` event.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.op_tracker import mark_active as _mark_active
from ..common.options import OptionError, config
from ..common.perf_counters import perf as _perf

# hot-path enablement cache: the staging/accounting probes run per shard
# put, so the layered-registry walk must not happen per call
_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def enabled() -> bool:
    """Cheap cached read of the ``parallel_data_plane`` option."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                cfg = config()
                try:
                    val = bool(cfg.get("parallel_data_plane"))
                except OptionError:
                    val = False

                def _refresh(_name, value):
                    global _enabled
                    # serialized with init: a set() firing between
                    # our observe() and the publish below must not be
                    # clobbered by the stale initial read
                    with _enabled_lock:
                        _enabled = bool(value)

                try:
                    cfg.observe("parallel_data_plane", _refresh)
                except OptionError:
                    pass
                if _enabled is None:
                    _enabled = val
    return _enabled


def _operand(x, device=None) -> torch.Tensor:
    """An int32 operand: a tensor keeps its device (and is cast), NumPy
    goes to ``device`` (the package default when None)."""
    from .. import resolve_device
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.as_tensor(np.asarray(x).astype(np.int32),
                           device=resolve_device(device))


def _pad0(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with ``n`` zero slices appended along ``dim``."""
    if not n:
        return t
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


class ShardedDataPlane:
    """Owns a mesh and executes the cluster hot loops sharded over it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_shards = int(mesh.size)
        self._pc = _perf("dataplane")
        # a 1-axis mesh is the 1-D plane; a 2-axis mesh the (stripe,
        # shard) plane, even at (1, n)
        self.is_2d = len(mesh.axis_names) == 2
        if self.is_2d:
            self.n_rows, self.n_cols = (int(mesh.devices.shape[0]),
                                        int(mesh.devices.shape[1]))
        else:
            self.n_rows, self.n_cols = 1, self.n_shards
        # flat positions of the cells THIS process owns: every rank runs
        # each dispatch and accounts only its own cells, so the mgr's
        # mesh_rollup sums the ranks without double counting
        self._local_cells = frozenset(mesh.local_cells())
        # the latest dispatch's psum scalar, left on the device unread:
        # psum_probe() reads it
        self.last_psum = None

    # ------------------------------------------------------------ affinity --
    def chip_of(self, osd_id: int) -> int:
        """OSD-shard -> cell affinity: a stable modulo keyed on the OSD
        id, so the partition survives map churn."""
        return int(osd_id) % self.n_shards

    def coords_of(self, flat: int) -> Tuple[int, int]:
        """Flat mesh position -> (stripe_row, shard_col), row-major."""
        return divmod(int(flat), self.n_cols)

    def _prefixes(self, flat: int) -> Tuple[str, ...]:
        """Counter key prefixes of one cell: ``r<row>c<col>`` on the 2-D
        mesh plus the ``shard<flat>`` alias, always written."""
        if self.is_2d:
            r, c = self.coords_of(flat)
            return (f"shard{flat}", f"r{r}c{c}")
        return (f"shard{flat}",)

    # ------------------------------------------------------------- packing --
    def _prepare(self, masks, words):
        """Shared operand packing: validate, flatten the leading axes and
        pad with zeros (zero masks and zero words give zero outputs,
        sliced off before return).  1-D: the batch pads to the mesh
        size.  2-D: the batch pads to the STRIPE row count and the mask
        rows (the k+m output shards) to the SHARD column count."""
        words = _operand(words)
        masks = _operand(masks, words.device).to(words.device)
        lead = tuple(words.shape[:-2])
        C, W = words.shape[-2:]
        per_batch = masks.dim() > 2
        if per_batch and tuple(masks.shape[:-2]) != lead:
            raise ValueError(
                f"mask batch {tuple(masks.shape[:-2])} != data batch {lead}")
        if masks.shape[-1] != C:
            raise ValueError(
                f"masks contract {masks.shape[-1]} columns, data has "
                f"{C} planes")
        R = int(masks.shape[-2])
        B = int(np.prod(lead)) if lead else 1
        w3 = words.reshape(B, C, W)
        m3 = masks.reshape(B, R, C) if per_batch else masks
        bpad = (-B) % (self.n_rows if self.is_2d else self.n_shards)
        rpad = ((-R) % self.n_cols) if self.is_2d else 0
        w3 = _pad0(w3, 0, bpad)
        if per_batch:
            m3 = _pad0(m3, 0, bpad)
        m3 = _pad0(m3, m3.dim() - 2, rpad)
        return m3, w3, lead, per_batch, B, R, W, C, bpad, rpad

    def _xor_cells(self, m3, w3, per_batch):
        """Each cell's masked-XOR block on its own device: 1-D, cell i
        takes batch block i (and its masks when per batch); 2-D, cell
        (r, c) takes stripe block r against mask rows block c.  Returns
        {flat: (out block, rows)} for this rank's cells."""
        Bp, Rp = int(w3.shape[0]), int(m3.shape[-2])
        per = Bp // (self.n_rows if self.is_2d else self.n_shards)
        rc = Rp // self.n_cols if self.is_2d else Rp
        from ..ops import xor_kernel

        def cell(i, c):
            r, col = self.coords_of(i) if self.is_2d else (i, 0)
            w = w3.narrow(0, r * per, per)
            m = m3.narrow(0, r * per, per) if per_batch else m3
            m = m.narrow(m.dim() - 2, col * rc, rc)
            dev = c.device
            out = xor_kernel.xor_matmul_w32(m.to(dev).contiguous(),
                                            w.to(dev).contiguous())
            return out, torch.full((), per, dtype=torch.int64, device=dev)

        from .mesh import run_cells
        return run_cells(self.mesh, cell)

    def _psum_rows(self, outs) -> torch.Tensor:
        """The row counter: psum over SHARD (1-D) or along STRIPE over
        one shard column (2-D) — the padded batch total either way."""
        from .mesh import psum
        cells = range(self.n_shards) if not self.is_2d else \
            range(0, self.n_shards, self.n_cols)
        return psum(self.mesh, {i: o[1] for i, o in outs.items()}, cells)

    def _assemble(self, outs, device) -> torch.Tensor:
        """The gathered result on ``device``: every cell's block (other
        ranks' through the all-gather), cut along SHARD (2-D: each stripe
        row's k+m columns) then along STRIPE."""
        from .mesh import gather_cells
        full = [f[0] for f in gather_cells(
            self.mesh, {i: o[:1] for i, o in outs.items()}, device)]
        if not self.is_2d:
            return torch.cat(full)
        rows = [torch.cat(full[r * self.n_cols:(r + 1) * self.n_cols],
                          dim=1) for r in range(self.n_rows)]
        return torch.cat(rows)

    @staticmethod
    def _trim(out, lead, B, R, W) -> torch.Tensor:
        out = out[:B, :R]
        return out.reshape(lead + (R, W)).contiguous() if lead else \
            out.reshape(R, W).contiguous()

    # ------------------------------------------------------------- dispatch --
    def _sharded(self, masks, words, kind: str):
        """One masked-XOR dispatch over the cells: the psum left on the
        device (its value is the padded row count, which the counter
        records; psum_probe() verifies it) and the result gathered onto
        the words' device.  Returns (result, padded rows, padded mask
        rows)."""
        (m3, w3, lead, per_batch, B, R, W, C,
         bpad, rpad) = self._prepare(masks, words)
        outs = self._xor_cells(m3, w3, per_batch)
        self.last_psum = self._psum_rows(outs)
        self.account(kind, B, 4 * C * W, padded_rows=B + bpad)
        out = self._trim(self._assemble(outs, w3.device), lead, B, R, W)
        return out, B + bpad, R + rpad

    def xor_matmul_w32(self, masks, words, kind: str = "encode"):
        """Drop-in for ``ops.xor_kernel.xor_matmul_w32``, sharded over
        the mesh.  masks [R, C] (replicated over stripe rows; R split
        over shard columns on the 2-D mesh) or [..., R, C] matching
        ``words``'s leading axes (per-stripe signatures); words [..., C,
        W] int32 -> [..., R, W] on the words' device, bit-identical to
        the single-device kernel on every layout."""
        return self._sharded(masks, words, kind)[0]

    def rebuild_collective(self, masks, words, kind: str = "recover"):
        """The recovery dispatch: the operands and result of
        :meth:`xor_matmul_w32`, with the rebuilt rows all-gathered
        (across ranks, the fleet's all-gather) into one tensor on the
        words' device, where the simulator's OSDs read their shards; on
        one card that is every cell's device.  On the 2-D mesh the
        gather runs per axis and the per-axis row counters record both
        legs."""
        out, rows, cols = self._sharded(masks, words, kind)
        self._pc.inc("allgather_rows", rows)
        if self.is_2d:
            self._pc.inc("allgather_rows_stripe", rows)
            self._pc.inc("allgather_rows_shard", cols)
        return out

    def ppermute_shift(self, arr, shift: int = 1):
        """Rotate a batch ``shift`` mesh positions along the ring, block
        by block (each cell's whole slice moves; flat row-major over
        both axes on the 2-D mesh).  The leading axis must be a mesh
        multiple.  Inside a process a block moves with ``.to(dst)``;
        across ranks through ``multihost.exchange``."""
        from .. import resolve_device
        from . import multihost
        from .mesh import gather_cells
        x = arr if isinstance(arr, torch.Tensor) else \
            torch.as_tensor(np.asarray(arr), device=resolve_device())
        n = self.n_shards
        if int(x.shape[0]) % n:
            raise ValueError(
                f"ppermute batch {x.shape[0]} not a multiple of "
                f"{n} mesh positions")
        shift = int(shift) % n
        per = int(x.shape[0]) // n
        mine = self._local_cells
        cell = self.mesh.cell
        outs: Dict[int, Tuple[torch.Tensor]] = {}
        sends, recvs = [], []
        for j in sorted(mine):
            src, dst = (j - shift) % n, (j + shift) % n
            if src in mine:
                outs[j] = (x.narrow(0, src * per, per).to(cell(j).device),)
            else:
                buf = torch.empty((per,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=cell(j).device)
                recvs.append((buf, cell(src).rank))
                outs[j] = (buf,)
            if dst not in mine:
                sends.append((x.narrow(0, j * per, per).to(cell(j).device),
                              cell(dst).rank))
        if sends or recvs:
            multihost.exchange(sends, recvs)
        self._pc.inc("ppermute_rows", int(x.shape[0]))
        full = gather_cells(self.mesh, outs, x.device)
        return torch.cat([f[0] for f in full])

    def fused_ragged(self, bitmat_np: np.ndarray, pool, tile: int):
        """Sharded fused ragged encode + crc (K3): the block pool [G, k,
        T] splits over STRIPE rows (2-D) or the shard axis (1-D), the
        bit-matrix replicates, and every cell runs
        ``gf_pallas.fused_ragged_matmul`` on its block (on the 2-D mesh
        each shard column of a row computes the row's block, as the
        reference's replicated split does).  Zero pad blocks in, zero
        parity and the crc of a zero block out, sliced off.  Returns
        (parity [G, m, T] uint8, data crcs [G, k], parity crcs [G, m]
        int64 holding uint32) on the pool's device."""
        from .. import resolve_device
        from ..ops import gf_pallas
        from .mesh import gather_cells, run_cells
        p = pool if isinstance(pool, torch.Tensor) else \
            torch.as_tensor(np.asarray(pool, dtype=np.uint8),
                            device=resolve_device())
        G, k, T = (int(p.shape[0]), int(p.shape[1]), int(p.shape[2]))
        if T != int(tile):
            raise ValueError(f"pool blocks are {T} B, tile is {tile}")
        m = int(np.asarray(bitmat_np).shape[0]) // 8
        rows = self.n_rows if self.is_2d else self.n_shards
        gpad = (-G) % rows
        p3 = _pad0(p, 0, gpad)
        per = (G + gpad) // rows

        def cell(i, c):
            r = self.coords_of(i)[0] if self.is_2d else i
            block = p3.narrow(0, r * per, per).to(c.device).contiguous()
            return gf_pallas.fused_ragged_matmul(bitmat_np, block)

        full = gather_cells(self.mesh, run_cells(self.mesh, cell), p.device)
        first = range(0, self.n_shards, self.n_cols) if self.is_2d else \
            range(self.n_shards)
        parity, dcrc, pcrc = (torch.cat([full[i][j] for i in first])[:G]
                              for j in range(3))
        self.account("ragged", G, (k + m) * T, padded_rows=G + gpad)
        return parity, dcrc, pcrc

    def psum_probe(self) -> Optional[int]:
        """Read back the latest dispatch's psum (one host sync, on
        demand; the dispatch path never reads it)."""
        return None if self.last_psum is None else int(self.last_psum)

    # ----------------------------------------------------------- accounting --
    def account(self, kind: str, rows: int, row_bytes: int,
                padded_rows: Optional[int] = None) -> None:
        """Per-cell accounting for one sharded dispatch: the batch splits
        contiguously over the mesh (1-D) or over STRIPE rows (2-D, where
        every shard column of a row counts the row's stripes, so per-cell
        ``*_bytes`` over-count a stripe row against the 1-D total by
        design).  Map sweeps split flat on any layout.  Only this
        process's cells are counted.  ``psum_rows`` records the padded
        total the psum reduces to."""
        pc = self._pc
        pc.inc("dispatches")
        pc.inc(f"{kind}_dispatches")
        if padded_rows is not None:
            pc.inc("psum_rows", padded_rows)
        total = padded_rows if padded_rows is not None else rows
        unit = "lanes" if kind == "map" else "stripes"
        if self.is_2d and kind != "map":
            per = -(-total // self.n_rows)
            for r in range(self.n_rows):
                real = max(0, min(per, rows - r * per))
                if real <= 0:
                    continue
                for c in range(self.n_cols):
                    flat = r * self.n_cols + c
                    if flat not in self._local_cells:
                        continue
                    for pfx in self._prefixes(flat):
                        pc.inc(f"{pfx}.{kind}_{unit}", real)
                        pc.inc(f"{pfx}.{kind}_bytes",
                               real * row_bytes)
        else:
            per = -(-total // self.n_shards)
            for i in range(self.n_shards):
                real = max(0, min(per, rows - i * per))
                if real > 0 and i in self._local_cells:
                    for pfx in self._prefixes(i):
                        pc.inc(f"{pfx}.{kind}_{unit}", real)
                        pc.inc(f"{pfx}.{kind}_bytes",
                               real * row_bytes)
        _mark_active("dispatched_mesh", kind=kind,
                     shards=self.n_shards, rows=rows)

    def account_landed(self, target_osd: int, rows: int,
                       row_bytes: int) -> None:
        """One rebuilt shard landed on ``target_osd``'s affine cell."""
        chip = self.chip_of(target_osd)
        if chip not in self._local_cells:
            return
        for pfx in self._prefixes(chip):
            self._pc.inc(f"{pfx}.recover_landed")
            self._pc.inc(f"{pfx}.recover_landed_bytes", rows * row_bytes)

    def account_subwrite(self, target_osd: int) -> None:
        """One EC sub-write headed to ``target_osd``, on its affine cell."""
        chip = self.chip_of(target_osd)
        if chip not in self._local_cells:
            return
        for pfx in self._prefixes(chip):
            self._pc.inc(f"{pfx}.subwrites")

    def account_staged(self, osd_or_shard: int, nbytes: int) -> None:
        """One shard staged into a device partition, attributed by
        OSD-shard -> cell affinity."""
        chip = self.chip_of(osd_or_shard)
        if chip not in self._local_cells:
            return
        for pfx in self._prefixes(chip):
            self._pc.inc(f"{pfx}.staged_entries")
            self._pc.inc(f"{pfx}.staged_bytes", int(nbytes))

    def stats(self) -> Dict:
        return self._pc.dump()


_planes: Dict[Tuple, ShardedDataPlane] = {}
_planes_lock = threading.Lock()
# resolved-plane cache: plane() runs on per-shard hot paths, so the
# option walk and the device list must not repeat per call.  Options
# invalidate it through observers; what the port can also change at run
# time (the package default device, the cells per device, the fleet) is
# part of the cache's key.
_resolved: Optional[ShardedDataPlane] = None
_resolved_valid = False
_resolved_for: Optional[Tuple] = None
_resolve_gen = 0
_observing_devices = False


def _invalidate_resolution(_name=None, _value=None) -> None:
    global _resolved_valid, _resolve_gen
    _resolve_gen += 1
    _resolved_valid = False


def _context() -> Tuple:
    from .. import default_device
    from . import mesh as _mesh
    from .multihost import is_active
    return (default_device(), int(_mesh.cells_per_device), is_active())


def plane() -> Optional[ShardedDataPlane]:
    """The process-wide data plane, or None when the option is off or
    fewer than two cells resolve (one card, or the CPU with one cell per
    device, falls through to the plain path).

    Layout: ``parallel_data_plane_stripes`` >= 2 reshapes the cells
    row-major into a (stripes, n // stripes) 2-D mesh; 0/1 keeps the
    1-D mesh, unless the multi-process plane is active, where the
    stripe axis defaults to one row per rank.  A stripe count that does
    not divide the cell count disables the plane rather than failing
    the caller mid-put.  With the option on and the package default on
    CUDA, no card raises."""
    global _resolved, _resolved_valid, _observing_devices, _resolved_for
    if not enabled():
        return None
    ctx = _context()
    if _resolved_valid and _resolved_for == ctx:
        return _resolved
    if not _observing_devices:
        obs = 0
        for opt in ("parallel_data_plane_devices",
                    "parallel_data_plane_stripes"):
            try:
                config().observe(opt, _invalidate_resolution)
                obs += 1
            except OptionError:
                pass
        _observing_devices = obs == 2
    gen = _resolve_gen
    from .mesh import global_devices, make_mesh, make_mesh_2d
    cells = global_devices()
    n_avail = len(cells)
    want = 0
    try:
        want = int(config().get("parallel_data_plane_devices"))
    except OptionError:
        pass
    stripes = 0
    try:
        stripes = int(config().get("parallel_data_plane_stripes"))
    except OptionError:
        pass
    from .multihost import is_active, process_count
    if stripes <= 1 and is_active():
        stripes = process_count()
    n = want or n_avail
    if n < 2 or n_avail < n:
        p = None
    elif stripes >= 2 and n % stripes:
        p = None
    else:
        key = (tuple(cells[:n]), stripes if stripes >= 2 else 0)
        with _planes_lock:
            p = _planes.get(key)
            if p is None:
                mesh = make_mesh_2d(stripes, n // stripes,
                                    devices=cells[:n]) \
                    if stripes >= 2 else make_mesh(n, devices=cells)
                p = _planes[key] = ShardedDataPlane(mesh)
    if gen == _resolve_gen:
        # publish only if no invalidation raced the resolution
        _resolved, _resolved_valid, _resolved_for = p, True, ctx
    return p
