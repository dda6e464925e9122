#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ceph_tpu_torch``) on one card and check it.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. build every kernel of ``ceph_tpu_torch/csrc`` (K1 ``xor_matmul.cu``,
     K2 ``gf_bitplane.cu``, K3 ``ragged_fused.cu``) with nvcc for sm_90a
     (one nvcc per source, started together) and print ptxas's
     registers, shared memory and spills;
  2. hold each kernel bit-identical to its plain PyTorch version on the
     card at the main path's shapes (K1: RS(8,3) encode, a 3-erasure
     decode, a per-stripe-signature rebuild, a ragged word count, and
     phase 10's encodes [512 | 16 | 8, 64, 32768] and 2-erasure decode
     [8, 64, 32768] -> 16 at 1 MiB chunks; K2: the
     per-object put [4, 8, 131072], the batched encode [128, 8, 131072],
     a 3-erasure decode, a ragged L = 131071, a random 20-row bit-matrix
     over 32 data rows, a data pointer one byte off alignment and
     L = 13; K3: a 512-block chunk of
     the ZeroWire pool (RS(4,2)), RS(8,3), k + m = 20 with a random
     bit-matrix, a 1-byte, an exact-block and a block + 1 object, a
     513-block RS(4,2) pool one byte off 16-byte alignment, and its crc
     leg alone (m = 0) at block sizes 1, 64, 512, 4096, 4097 and 65536
     and at phase 10's flush batch (22,528 blocks), durable-put batch
     (45,056) and 1 MiB reply frame (256);
     and the erasure-code plugins' shapes: K1 at the liber8tion (w = 8),
     liberation (w = 7) and blaum_roth (w = 6) encodes and 2-erasure
     decodes, K2 at LRC k=4 m=2 l=3's global [1, 4, 131072] -> 2 and local
     [1, 3, 131072] -> 1 layers and CLAY(8,4,11)'s pft [1, 2, 2048] -> 2
     and mds [1, 8, 2048] -> 4 calls);
  3. the EC data path through ECBackend: an RS(8,3) layout=bitsliced pool,
     1 MiB stripes, 128 objects of 4 MiB put in one ingest batch onto 16
     OSD device caches, 3 OSDs killed, every object read back (degraded
     reads decode in signature groups) and every lost shard rebuilt with
     one mask per stripe, all compared on the card;
  4. the placement sweep (BASELINE configs #3 and #5): a 1,000-host x
     10-OSD straw2 map, CHOOSELEAF_FIRSTN host, 3 replicas;
     ``OSDMap.map_pgs_batch`` over 2^20 PGs, then 100 OSDs out and the
     remap through both ``map_pgs_batch`` and ``map_batch_delta``; every
     lane of both sweeps held against the native C++ mapper;
  5. general placement, the per-lane mapper outside the fast subset: a
     10,000-OSD map made before straw2 (25 racks x 40 hosts x 10 OSDs,
     every bucket ``alg straw``, straw_calc_version 1, the hammer
     tunables) written as crushmap text and compiled by the port's
     compiler; a 3-replica pool (CHOOSELEAF_FIRSTN host) and an EC 4+2
     pool (CHOOSE_INDEP 3 rack, then CHOOSELEAF_INDEP 2 host) of 2^20
     PGs each through ``OSDMap.map_pgs_batch``, 100 OSDs out, both
     remapped and the replicated pool through ``map_batch_delta``; every
     lane against the native C++ mapper, no out OSD keeping a PG, no lane
     recomputed on the host, the general trace counted as run; then each
     legacy algorithm alone (the golden uniform, list, tree and straw
     maps, the mixed-algorithm hierarchy and a tree whose root node
     weighs 3 x 2^31) at 65,536 lanes against the native mapper;
  6. the cluster step: a 32-host x 4-OSD map (TAKE root, CHOOSELEAF_INDEP
     host, EMIT), one ClusterSim per RS(8,3) pool (pg_num 256,
     stripe_unit 128 KiB): the default bitsliced pool (HBM-staged, K1) and
     a layout=bytes pool (host tier, K2), one after the other: put_many of
     64 x 4 MiB objects, 3 OSDs of the first object's up set killed, every
     object read, the three marked out, recover_all, every object read
     again, map_pgs_batch before and after; the byte pool's K2 launches
     are counted by shape in each phase;
  7. the ZeroWire ingest path of the wire tier: 1,024 objects of the
     S3Serve mixed-size profile (zipf(1.3) x 1 KiB, clipped to
     [1 B, 1 MiB], RS(4,2)) through ``ragged_fused.encode`` on the card
     (K3: parity and per-4 KiB crcs in one pass), every shard sent as a
     scatter-gather frame with its csums folded in (crc mode, session
     key) over a socket pair, verified on receipt on the card (K3's crc
     leg, ``wire_device_crc=auto``), committed into one BlueStore per
     shard position with the verified csums as blob csums, read back
     with its trusted csums as a reply frame verified on the card, and
     one frame with a flipped bit rejected; parity held to K2, every
     sub-crc to zlib, every byte read back, and the scan counters to
     "no full block scanned on the host";
  8. the erasure-code plugins through the port's registry on the card:
     (a) the 21 configs of the non-regression corpus (every jerasure
     technique, isa, shec, lrc, clay and the jax codec) encoded on the
     card and held byte for byte to tests/golden/ec_corpus.npz; (b) one
     ClusterSim pool per plugin on the cluster step's map (stripe_unit
     128 KiB, 4 MiB objects): jerasure liber8tion k=6 m=2 (K1), lrc k=4
     m=2 l=3 and clay k=8 m=4 d=11 (K2, through their inner ``jax``
     codecs), 64 objects each, and jerasure cauchy_good k=6 m=3, isa k=8
     m=3 and shec k=4 m=3 c=2 (host NumPy, no kernel), 16 objects each:
     put_many, two OSDs of the first object's up set killed, every object
     read, both marked out, recover_all (CLAY through its sub-chunk
     repair), every object read again; every byte compared, the
     launches counted per step and shape;
  9. time each kernel beside its bound and its plain version: device time
     from launches captured in one CUDA graph and replayed between CUDA
     events, and the wrapper's call time from back-to-back calls between
     CUDA events (host work included); K2 also beside its launch floor,
     an empty kernel at K2's grid replayed the same way;
 10. the process cluster (bench.py's ``bench_process_cluster``):
     ``tools/vstart`` starts one mon and 12 OSD daemon processes, each
     asked for the CPU (``--device cpu``), with an RS(8,3) bitsliced pool
     (pg_num 32, 1 MiB stripe unit, BlueStore); a ``RemoteCluster`` in
     this process, its codec on the card, runs a staged
     ``put_many_from_device`` of 16 x 256 MiB objects twice (a 4 GiB
     payload made on the card; 5.5 GiB of shards staged in HBM, held to
     the CPU plain encode), a ``flush_staged`` of one 64 MiB object
     (readback, K3 crc-leg csums, socket commit; the daemons' shards
     held to the CPU plain encode), a durable ``put_many`` of 16 x 4 MiB,
     ``kill9`` of two shard holders with their staged entries evicted,
     ``get_many_to_device`` and ``get`` of every durable object,
     ``out`` and ``recover_ec_pool``, and every object read again, every
     byte compared; no daemon may hold a CUDA context (none listed by
     ``nvidia-smi --query-compute-apps``, none with a ``/dev/nvidia*``
     descriptor open), and no host crc scan in this process may cover a
     full 4 KiB block;
 11. the failure pipeline and the block tier on the cluster step's map
     (32 hosts x 4 OSDs) with a 3-replica pool (pg_num 2,048) and an
     RS(8,3) bitsliced pool (pg_num 512), about 100 PG replicas an OSD,
     4 MiB objects: (a) two ``Thrasher`` soaks on the card (seed 0
     kill/revive, seed 1 netsplit; 32 objects a pool, 8 cycles), every
     invariant held; (b) a 256 MiB RBD image in the EC pool written whole
     in 4 MiB writes, 256 seeded 4 KiB random writes, snapshot, protect,
     clone, flatten, an unaligned shrink, every byte of image and clone
     against a host oracle; rbd-mirror of a 64 MiB journaled image onto a
     second ClusterSim on the card (16 x 4 MiB and 64 x 4 KiB writes,
     replay, a second replay and a trim applying nothing); neorados's 64
     concurrent 4 MiB writes and reads; (c) ``calc_pg_upmaps`` on the
     replicated pool through the card's mapper and the balancer advisor,
     both equal to the same calls on a CPU copy of the map, the deviation
     falling, every upmap keeping one replica a host, no lane on the host;
 12. the sharded data plane on the card, over a mesh of 4 cells of
     ``cuda:0`` (1-D) and a 2 x 2 mesh: (a) ``entry.cluster_sharded`` at
     phase 6's size (RS(8,3) bitsliced, 32 hosts x 4 OSDs, pg_num 256,
     64 x 4 MiB objects, 3 OSDs killed then out), plane off then on,
     every byte, the recovery stats and the up sets equal, every cell's
     put stripes above 0, K1 launched once per cell per plane dispatch,
     the psum read back equal to the padded rows; (b) the ZeroWire pool
     through ``fused_ragged``, equal to one unsharded K3 launch, K3 once
     per cell; (c) ``distributed_encode_step`` at [128, 8, 131072] (K2)
     and ``distributed_xor_encode_step`` at [512, 64, 4096] (K1), equal
     to the unsharded kernel, with their byte counters; (d) phase 4's
     2^20-PG sweep through ``map_pgs_batch`` on the 4-cell mesh, equal to
     phase 4's; (e) ``multihost``'s all_reduce and all-gather on CUDA
     tensors at the rebuild's output shape in a one-rank NCCL group the
     smoke starts and destroys.  Each kernel's time per cell is printed
     beside the unsharded launch, then the whole smoke's wall time.

Around each path of phases 3, 6, 7, each pool of phase 8, each step of
phases 10 and 11 and each run of phase 12 the kernels' launch counts are
set to 0 just before and read just after: K1's must equal the bitsliced
paths' dispatches (phase 11: the ec.jax dispatches plus the rebuild
dispatches; phase 12: those of the plane-off run, and the cells times
the plane's dispatches of the plane-on run) and the bitmatrix pool's
codec dispatches (``bitmatrix_codec``'s counts), K2's the byte pool's
and the layered pools' ``ec.jax`` encode + decode dispatches (phase 12:
one a cell of each distributed step), K3's the ZeroWire path's encode
launches plus its device crc dispatches (phase 10: the device crc
dispatches alone; phase 12: one a cell); the host pools launch nothing,
and no plain version may run.  The placement phases 4 and 5 and phase
12's sweep run no kernel; phase 5 and phase 12's sweep fail if a count
moves.  Earlier lines print
the card (``nvidia-smi --query-gpu=name,power.limit``), the numbers as
JSON, and the ``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import ceph_tpu_torch
from ceph_tpu_torch.cluster import device_store, simulator
from ceph_tpu_torch.cluster.device_store import DeviceShardCache, \
    assemble_object
from ceph_tpu_torch.cluster.ec_backend import ECBackend, ObjectGeom, ShardIO
from ceph_tpu_torch.ec import bitmatrix_codec, instance
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.ops import (_build, crc32_gf2, gf, gf2, gf_jax, gf_pallas,
                                ragged_fused, xor_kernel)

SEED = 20261016
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit logic ops/s: 132 SMs x 64 INT32 lanes (H100 white paper) x the
# 1.98 GHz clock the data sheet's 67 TFLOP/s FP32 implies
# (132 x 128 x 2 x 1.98e9); one LOP3 per mask-AND-XOR step
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# shared-memory table lookups/s: one 32-lane wavefront per clock per SM
# (32 banks x 4 B = 128 B/clock/SM, H100 white paper) at the same clock
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9

K, M = 8, 3
N_OSDS = 16
N_PGS = 16
POOL = 1

# the ZeroWire path: RS(4,2) over the S3Serve mixed-size profile
ZW_K, ZW_M = 4, 2
ZW_OBJECTS = 1024
STORE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "zerowire")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------- helpers --

def random_words(shape, gen, device):
    """Random int32 words on ``device`` from a seeded generator."""
    n = 1
    for s in shape:
        n *= s
    u8 = torch.randint(0, 256, (4 * n,), dtype=torch.uint8, device=device,
                       generator=gen)
    return u8.view(torch.int32).reshape(shape)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    runs, between two CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean DEVICE milliseconds of ``fn`` (a kernel wrapper call): ``iters``
    calls captured in one CUDA graph and replayed between two CUDA
    events, so the wrapper's host time between launches is not counted
    (back-to-back calls of a wrapper whose host work outlasts its kernel
    measure the host instead; ``cuda_ms`` reports that time)."""
    fn()
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def k1_bound(B: int, Bm: int, R: int, C: int, W: int):
    """(bound_ms, bound_by, bytes, ops) of one K1 call: every input read
    once, every output written once; one LOP3 per mask-AND-XOR step."""
    nbytes = 4 * (B * C * W + B * R * W + Bm * R * C)
    ops = B * R * C * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def k2_bound(B: int, k: int, m: int, L: int):
    """(bound_ms, bound_by, bytes, lookups) of one K2 call: every data
    byte read once, every output byte written once, the [8m, 8k] int8
    bit-matrix read once; one shared-memory table lookup per GF(2^8)
    byte product (B*m*k*L)."""
    nbytes = B * k * L + B * m * L + 64 * m * k
    ops = B * m * k * L
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SMEM_LOOKUPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def rebuild_masks(codec, missing, avail, n: int, m: int):
    """Full-width [8m, 8n] mask table of one erasure signature: the
    decode bit-matrix placed on the columns of the shards it reads, zero
    elsewhere (one table per stripe rebuilds a batch of mixed
    signatures in one K1 call)."""
    R, used = codec.decode_matrix(list(avail), list(missing))
    small = gf.gf8_bitmatrix(R)
    big = np.zeros((8 * m, 8 * n), dtype=np.uint8)
    for jj, c in enumerate(used):
        big[:8 * len(missing), 8 * c:8 * c + 8] = small[:, 8 * jj:8 * jj + 8]
    return gf2.bitmatrix_masks(big)


class CacheShardIO(ShardIO):
    """ShardIO over one DeviceShardCache per OSD.  PG p keeps shard j on
    OSD (p + j) % n_osds, standing in for CRUSH until placement is
    ported; a killed OSD's cache is dropped."""

    def __init__(self, n_osds: int, n_pgs: int, n: int):
        self.caches = {o: DeviceShardCache(o) for o in range(n_osds)}
        self.ups = {p: [(p + j) % n_osds for j in range(n)]
                    for p in range(n_pgs)}
        self.attrs = {}
        self.down = set()

    def up_set(self, pg):
        return list(self.ups[pg])

    def fanout(self, writes):
        done = []
        for w in writes:
            if w.target in self.down:
                continue
            self.caches[w.target].put((POOL, w.pg, w.name, w.shard),
                                      w.ref, None)
            self.attrs[(w.pg, w.name, w.shard)] = w.attrs
            done.append(w)
        return done

    def purge_shard(self, pg, shard, name, keep_target):
        for o, c in self.caches.items():
            if o != keep_target:
                c.evict((POOL, pg, name, shard))

    def get_shard_ref(self, pg, shard, name):
        osd = self.ups[pg][shard]
        if osd in self.down:
            return None
        return self.caches[osd].get((POOL, pg, name, shard), None)

    def get_shard_bytes(self, pg, shard, name):
        return None              # staged mode: the device copy only

    def getattr(self, pg, name, shard, key):
        if self.ups[pg][shard] in self.down:
            return None
        return self.attrs.get((pg, name, shard), {}).get(key)

    def kill(self, osd: int) -> None:
        self.down.add(osd)
        self.caches[osd].clear()


# --------------------------------------------------------------- phases --

def build_kernels(card: str) -> dict:
    t0 = time.perf_counter()
    _build.build_all()
    wall = time.perf_counter() - t0
    info = {"phase": "build", "sources": _build.sources(),
            "wall_s": wall,
            "nvcc_s": {n: v["seconds"] for n, v in _build.build_log.items()},
            "gpu": card}
    emit(info)
    for name, v in _build.build_log.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{e['entry']} {e['registers']} registers, {e['smem']} B static "
            f"smem, {e['spill_stores']}/{e['spill_loads']} B spill "
            f"stores/loads" for e in v["ptxas"]), flush=True)
    return info


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def kernel_checks(device, shapes) -> dict:
    """K1 against its plain version on ``device`` at each named shape:
    {name: (masks, words)}.  Returns {name: max_abs_err}; fails on any
    difference."""
    errs = {}
    for name, (masks, words) in shapes.items():
        got = xor_kernel.xor_matmul_w32(masks, words)
        m3 = masks if masks.dim() == 3 else masks[None]
        want = xor_kernel._combine_torch(m3, words)
        sync(device)
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        errs[name] = err
        emit({"phase": "kernel_check", "kernel": "xor_matmul_w32",
              "shape": name, "masks": list(masks.shape),
              "words": list(words.shape), "max_abs_err": err,
              "dynamic_smem_bytes": xor_kernel.smem_bytes(
                  masks.shape[-2], masks.shape[-1])[0]})
        if err != 0 or not torch.equal(got, want):
            fail(f"K1 differs from its plain version at {name}")
    return errs


def k2_shapes(device, gen):
    """K2's main-path shapes: the byte pool's per-object put [4, 8, 131072]
    (a 4 MiB object is 4 stripes of 8 x 128 KiB), the batched encode
    [128, 8, 131072], a 3-erasure decode of one object and a ragged
    L = 131071; and its edges: a random bit-matrix of 20 output rows over
    32 data rows (two passes, paired row groups) at L = 4097, a data
    pointer one byte off alignment, and L = 13.  {name: (bitmat, data)}."""
    enc = gf.gf8_bitmatrix(gf.vandermonde_parity(K, M))
    G = gf.generator_matrix(gf.vandermonde_parity(K, M))
    erased = [1, 4, 9]
    avail = [c for c in range(K + M) if c not in erased][:K]
    dec = gf.gf8_bitmatrix(gf.gf_matmul(G[erased],
                                        gf.gf_gaussian_inverse(G[avail])))
    wide = np.random.default_rng(SEED).integers(0, 2, size=(160, 256),
                                                dtype=np.uint8)

    def data(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=device, generator=gen)

    shapes = {"put": (enc, data((4, K, 131072))),
              "encode": (enc, data((128, K, 131072))),
              "decode": (dec, data((4, K, 131072))),
              "ragged": (enc, data((4, K, 131071)))}
    flat = data((2 * K * 4096 + 1,))
    shapes.update({"wide": (wide, data((3, 32, 4097))),
                   "unaligned": (enc, flat[1:].view(2, K, 4096)),
                   "tiny": (enc, data((3, K, 13)))})
    return shapes


def k2_checks(device, shapes) -> dict:
    """K2 against its plain version on the card at each shape; fails on
    any difference.  Returns {name: max_abs_err}."""
    errs = {}
    for name, (bitmat, data) in shapes.items():
        got = gf_pallas.bitplane_matmul(bitmat, data)
        want = gf_jax.bitplane_matmul(
            torch.as_tensor(bitmat, device=device), data)
        sync(device)
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        errs[name] = err
        m, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
        emit({"phase": "kernel_check", "kernel": "gf_bitplane",
              "shape": name, "bitmat": list(bitmat.shape),
              "data": list(data.shape), "out": list(got.shape),
              "max_abs_err": err,
              "dynamic_smem_bytes": gf_pallas.smem_bytes(m, k)[0]})
        if err != 0 or not torch.equal(got, want):
            fail(f"K2 differs from its plain version at {name}")
    return errs


def k1_shapes(device, codec, gen):
    """The main path's K1 shapes at full size: encode [512, 64, 4096]
    (shared masks), a 3-erasure decode (one signature), a rebuild
    [512, 88, 4096] with its own full-width masks per stripe, a ragged
    W = 4095, the process cluster's encodes and 2-erasure decode at 1 MiB
    chunks, and phase 11's encodes and 1- and 2-erasure decodes at 4 KiB
    stripe units."""
    n = K + M
    enc_masks = torch.as_tensor(
        gf2.bitmatrix_masks(gf.gf8_bitmatrix(codec.parity)), device=device)
    R, used = codec.decode_matrix([0, 2, 3, 5, 6, 7, 8, 10], [1, 4, 9])
    dec_masks = torch.as_tensor(
        gf2.bitmatrix_masks(gf.gf8_bitmatrix(R)), device=device)
    rng = np.random.default_rng(SEED)
    T = 512
    tabs = []
    for _ in range(T):
        lost = sorted(rng.choice(n, size=int(rng.integers(1, M + 1)),
                                 replace=False).tolist())
        avail = [c for c in range(n) if c not in lost]
        tabs.append(rebuild_masks(codec, lost, avail, n, M))
    rb_masks = torch.as_tensor(np.stack(tabs), device=device)
    # the process cluster's (phase 10) shapes: 1 MiB chunks are 8 planes
    # of 32,768 words; the staged put encodes 16 x 32 stripes in one
    # call, the durable put 16 one-stripe objects, the flush object 8
    # stripes, and a degraded read decodes a 2-erasure signature
    R2, _ = codec.decode_matrix([0, 2, 3, 4, 5, 6, 7, 8], [1, 9])
    dec2 = torch.as_tensor(gf2.bitmatrix_masks(gf.gf8_bitmatrix(R2)),
                           device=device)
    pcW = PC_SU // 32
    pc = {"pc_put": (enc_masks, random_words(
              (PC_OBJECTS * pc_stripes(PC_OBJ_BYTES), 8 * K, pcW), gen,
              device)),
          "pc_durable_put": (enc_masks, random_words(
              (PC_OBJECTS, 8 * K, pcW), gen, device)),
          "pc_flush_put": (enc_masks, random_words(
              (pc_stripes(PC_FLUSH_BYTES), 8 * K, pcW), gen, device)),
          "pc_decode": (dec2, random_words(
              (pc_stripes(PC_FLUSH_BYTES), 8 * K, pcW), gen, device))}
    # phase 11's shapes: 4 KiB stripe units are 8 planes of 128 words;
    # an object's put encodes 128 stripes, a small write 1 or 2, the
    # journal's batched writes up to 171, and degraded reads decode one
    # or two erasures of 128 stripes
    R1, _ = codec.decode_matrix([0, 1, 2, 4, 5, 6, 7, 8], [3])
    dec1 = torch.as_tensor(gf2.bitmatrix_masks(gf.gf8_bitmatrix(R1)),
                           device=device)
    p11 = {f"p11_encode_{B}": (enc_masks, random_words((B, 8 * K, 128),
                                                        gen, device))
           for B in (128, 1, 2, 171)}
    p11.update({
        "p11_decode_1": (dec1, random_words((128, 8 * K, 128), gen, device)),
        "p11_decode_2": (dec2, random_words((128, 8 * K, 128), gen,
                                            device))})
    return {**pc, **p11,
        "encode": (enc_masks, random_words((512, 8 * K, 4096), gen,
                                           device)),
        "decode": (dec_masks, random_words((32, 8 * K, 4096), gen,
                                           device)),
        "rebuild": (rb_masks, random_words((T, 8 * n, 4096), gen,
                                           device)),
        "ragged": (enc_masks, random_words((16, 8 * K, 4095), gen,
                                           device)),
    }


def run_slice(device, gen, n_objects: int, obj_bytes: int,
              stripe_unit: int) -> dict:
    """Put, degraded read and per-stripe rebuild of ``n_objects`` objects
    through the port's entry points; every byte verified on the device.
    Returns the phase timings and the K1 dispatches the path made."""
    codec = instance().factory(
        "jax", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "layout": "bitsliced"}, device=device)
    n = K + M
    io = CacheShardIO(N_OSDS, N_PGS, n)
    be = ECBackend(codec, io)
    names = [f"obj{i:04d}" for i in range(n_objects)]
    pg_of = {nm: i % N_PGS for i, nm in enumerate(names)}
    S, U = be.batch_geometry([obj_bytes] * n_objects, stripe_unit)
    geom = ObjectGeom(obj_bytes, S, U)
    W = geom.W
    payload = random_words((n_objects * S, K, W), gen, device)
    sync(device)

    # ---- put: one encode dispatch, fan-out to the OSD caches
    t0 = time.perf_counter()
    writes = be.encode_to_writes(pg_of, names, payload, geom, durable=False)
    acked = be.submit(writes)
    sync(device)
    t_put = time.perf_counter() - t0
    if len(acked) != n_objects or any(len(v) != n for v in acked.values()):
        fail("put: not every shard of every object committed")
    orig = {(w.name, w.shard): w.ref for w in writes}

    # ---- kill 3 OSDs: PG 0 loses data shards 0, 1 and parity shard 9
    killed = [io.ups[0][0], io.ups[0][1], io.ups[0][9]]
    for osd in killed:
        io.kill(osd)
    lost_of = {nm: [c for c in range(n) if io.ups[pg_of[nm]][c] in io.down]
               for nm in names}
    sigs = set()
    for nm in names:
        have = [c for c in range(n) if c not in lost_of[nm]]
        plan, missing = be.plan(have)
        if missing:
            sigs.add((tuple(plan), tuple(missing)))

    # ---- degraded read of every object, compared on the device
    t0 = time.perf_counter()
    outs = be.read_many_words([(pg_of[nm], nm, geom) for nm in names])
    sync(device)
    t_read = time.perf_counter() - t0
    for i, out in enumerate(outs):
        if not torch.equal(out, payload[i * S:(i + 1) * S]):
            fail(f"read: {names[i]} differs from its payload")

    # ---- rebuild every lost shard: one full-width mask table per stripe
    t0 = time.perf_counter()
    victims = [nm for nm in names if lost_of[nm]]
    tabs, blocks = {}, []
    masks_h = np.empty((len(victims) * S, 8 * M, 8 * n), dtype=np.int32)
    for j, nm in enumerate(victims):
        lost = tuple(lost_of[nm])
        avail = tuple(c for c in range(n) if c not in lost)
        if lost not in tabs:
            tabs[lost] = rebuild_masks(codec, lost, avail, n, M)
        masks_h[j * S:(j + 1) * S] = tabs[lost]
        refs = [io.get_shard_ref(pg_of[nm], c, nm) for c in range(n)]
        zeros = torch.zeros((S, len(lost), W), dtype=torch.int32,
                            device=device)
        blocks.append(assemble_object(refs, zeros, S, W))
    T = len(victims) * S
    full = torch.cat(blocks).reshape(T, 8 * n, W // 8)
    masks_d = torch.as_tensor(masks_h, device=device)
    rebuilt = xor_kernel.xor_matmul_w32(masks_d, full).reshape(T, M, W)
    sync(device)
    t_rebuild = time.perf_counter() - t0
    for j, nm in enumerate(victims):
        for r, c in enumerate(lost_of[nm]):
            ref = orig[(nm, c)]
            want = ref.buf[ref.s0:ref.s1, ref.idx]
            if not torch.equal(rebuilt[j * S:(j + 1) * S, r], want):
                fail(f"rebuild: {nm} shard {c} differs from the original")

    return {"objects": n_objects, "object_bytes": obj_bytes, "S": S,
            "U": U, "killed_osds": killed,
            "degraded_objects": sum(
                1 for nm in names if any(c < K for c in lost_of[nm])),
            "read_groups": len(sigs), "rebuild_stripes": T,
            "rebuild_masks": list(masks_d.shape),
            "rebuild_words": list(full.shape),
            "dispatches": 1 + len(sigs) + 1,
            "put_s": t_put, "read_s": t_read, "rebuild_s": t_rebuild}


def native_rows(nm, xs, result_max: int, weights,
                ruleno: int = 0) -> np.ndarray:
    """The native C++ mapper over ``xs`` on every CPU core (each ctypes
    call releases the GIL; the mapper keeps no shared state)."""
    n = os.cpu_count() or 1
    parts = np.array_split(np.asarray(xs), n)
    with ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(
            lambda p: nm.map_batch(ruleno, p, result_max, weights), parts))
    return np.concatenate(outs)


def compact(raw: np.ndarray, none: int) -> np.ndarray:
    """A replicated pool's up rows: NONE holes moved to the end."""
    order = np.argsort(raw == none, axis=1, kind="stable")
    return np.take_along_axis(raw, order, axis=1)


def sweep_map(device, n_pgs: int):
    """Phase 4's map: 1,000 hosts x 10 OSDs, straw2, CHOOSELEAF_FIRSTN
    host, one 3-replica pool of ``n_pgs`` PGs.  Returns (cmap, osdmap)."""
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, POOL_REPLICATED
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_EMIT, RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=1000, osds_per_host=10)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="sweep", type=POOL_REPLICATED, size=3,
                       pg_num=n_pgs, crush_rule=0))
    return cmap, om


def placement_sweep(device, n_pgs: int = 1 << 20, n_out: int = 100) -> dict:
    """BASELINE configs #3 and #5 on the port: map every PG of a 2^20-PG
    pool on the 10,000-OSD map, mark ``n_out`` OSDs out, remap through
    map_pgs_batch and map_batch_delta; every lane against the native
    mapper.  ``_up0`` holds the first sweep's up sets for phase 12."""
    from ceph_tpu_torch.native_bridge import NativeMapper
    from ceph_tpu_torch.placement.crush_map import ITEM_NONE
    cmap, om = sweep_map(device, n_pgs)
    pool = om.pools[1]
    pps = pool.raw_pg_to_pps_batch(np.arange(n_pgs))
    nm = NativeMapper(cmap)
    pc = perf("crush.mapper")

    def fallback():
        return pc.dump().get("fallback_lanes", 0)

    torch.cuda.reset_peak_memory_stats()
    f0 = fallback()
    t0 = time.perf_counter()
    up0, _ = om.map_pgs_batch(1)
    sync(device)
    t_full0 = time.perf_counter() - t0
    inc0 = fallback() - f0
    w0 = om.osd_weight[:cmap.max_devices].copy()
    t0 = time.perf_counter()
    raw0 = native_rows(nm, pps, 3, w0)
    t_native0 = time.perf_counter() - t0
    if not np.array_equal(up0, compact(raw0, ITEM_NONE)):
        fail("placement: the 2^20-PG sweep differs from the native mapper")

    outs = np.random.default_rng(SEED).choice(cmap.max_devices, n_out,
                                              replace=False)
    for o in outs:
        om.mark_out(int(o))
    w1 = om.osd_weight[:cmap.max_devices].copy()
    f0 = fallback()
    t0 = time.perf_counter()
    up1, _ = om.map_pgs_batch(1)
    sync(device)
    t_full1 = time.perf_counter() - t0
    inc1 = fallback() - f0
    # firstn rows fill left to right, so with every OSD up the up rows
    # ARE the raw CRUSH rows (checked against the native mapper above)
    f0 = fallback()
    t0 = time.perf_counter()
    delta = om._batched_mapper().map_batch_delta(0, pps, 3, w0, w1, up0)
    t_delta = time.perf_counter() - t0
    inc_delta = fallback() - f0
    t0 = time.perf_counter()
    raw1 = native_rows(nm, pps, 3, w1)
    t_native1 = time.perf_counter() - t0
    if not np.array_equal(up1, compact(raw1, ITEM_NONE)):
        fail("placement: the remap sweep differs from the native mapper")
    if not np.array_equal(delta, raw1):
        fail("placement: map_batch_delta differs from the native mapper")
    if np.isin(up1, outs).any():
        fail("placement: an out OSD kept a PG")
    moved = int((up1 != up0).any(axis=1).sum())
    return {"osds": cmap.max_devices, "hosts": 1000, "pgs": n_pgs,
            "replicas": 3, "out_osds": n_out,
            "map_pgs_batch_s": t_full0, "remap_map_pgs_batch_s": t_full1,
            "remap_delta_s": t_delta,
            "delta_affected_lanes": int(np.isin(up0, outs).any(axis=1).sum()),
            "pgs_moved": moved,
            "incomplete_lanes": inc0, "remap_incomplete_lanes": inc1,
            "delta_incomplete_lanes": inc_delta,
            "incomplete_share": inc0 / n_pgs,
            "native_lanes_checked": 3 * n_pgs,
            "native_s": t_native0 + t_native1,
            "native_threads": os.cpu_count(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "_up0": up0}


# the general-placement cluster: a 10,000-OSD map made before straw2
# existed and never converted (every bucket straw v1, hammer tunables)
GP_RACKS, GP_HOSTS, GP_OSDS = 25, 40, 10
GP_LANES = 1 << 16        # lanes of each legacy-algorithm map


def straw_cluster_text(seed: int = SEED) -> str:
    """Crushmap text: root default -> 25 racks -> 40 hosts each -> 10 OSDs
    each, OSD weights seeded in [0.5, 2.0], alg straw everywhere with
    straw_calc_version 1, the hammer tunables; rule 0 replicates over
    hosts, rule 1 places an EC 4+2 pool as 3 racks x 2 hosts."""
    rng = np.random.default_rng(seed)
    n = GP_RACKS * GP_HOSTS * GP_OSDS
    lines = ["tunable choose_local_tries 0",
             "tunable choose_local_fallback_tries 0",
             "tunable choose_total_tries 50",
             "tunable chooseleaf_descend_once 1",
             "tunable chooseleaf_vary_r 1",
             "tunable chooseleaf_stable 0",
             "tunable straw_calc_version 1", ""]
    lines += [f"device {i} osd.{i}" for i in range(n)]
    lines += ["", "type 0 osd", "type 1 host", "type 3 rack",
              "type 10 root", ""]
    weights = 0.5 + 1.5 * rng.random(n)
    bid = -1
    racks = []
    for r in range(GP_RACKS):
        hosts = []
        for h in range(GP_HOSTS):
            name = f"host-{r}-{h}"
            lines += [f"host {name} {{", f"    id {bid}", "    alg straw",
                      "    hash 0"]
            base = (r * GP_HOSTS + h) * GP_OSDS
            lines += [f"    item osd.{i} weight {weights[i]:.5f}"
                      for i in range(base, base + GP_OSDS)]
            lines.append("}")
            hosts.append(name)
            bid -= 1
        lines += [f"rack rack-{r} {{", f"    id {bid}", "    alg straw",
                  "    hash 0"] + [f"    item {h}" for h in hosts] + ["}"]
        racks.append(f"rack-{r}")
        bid -= 1
    lines += ["root default {", f"    id {bid}", "    alg straw",
              "    hash 0"] + [f"    item {r}" for r in racks] + ["}", ""]
    lines += ["rule replicated_rule {", "    id 0", "    type replicated",
              "    step take default", "    step chooseleaf firstn 0 type host",
              "    step emit", "}",
              "rule ec42_rack_host {", "    id 1", "    type erasure",
              "    step take default", "    step choose indep 3 type rack",
              "    step chooseleaf indep 2 type host", "    step emit", "}"]
    return "\n".join(lines) + "\n"


def legacy_maps():
    """(name, map, result_max) for each legacy algorithm alone: the golden
    maps 5-8 (flat uniform, list, tree, straw), the mixed-algorithm
    hierarchy of the reference's legacy tests, and a flat tree whose
    root node weighs 3 x 2^31 (the u64 draw's range)."""
    from ceph_tpu_torch.placement.crush_map import (
        BUCKET_LIST, BUCKET_STRAW, BUCKET_STRAW2, BUCKET_TREE,
        BUCKET_UNIFORM, RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
        RULE_TAKE, Bucket, CrushMap, Rule, Tunables, WEIGHT_ONE)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "golden",
                           "crush_vectors.json")) as f:
        specs = json.load(f)["specs"]
    out = [(specs[i]["name"], CrushMap.from_spec(specs[i]), 3)
           for i in range(5, 9)]
    rng = np.random.default_rng(7)
    m = CrushMap(tunables=Tunables.profile("jewel"))
    algs = [BUCKET_UNIFORM, BUCKET_LIST, BUCKET_TREE, BUCKET_STRAW,
            BUCKET_STRAW2, BUCKET_LIST]
    host_w = []
    for h, alg in enumerate(algs):
        items = list(range(3 * h, 3 * h + 3))
        if alg == BUCKET_UNIFORM:
            w, bw = [WEIGHT_ONE], 3 * WEIGHT_ONE
        else:
            w = [int(WEIGHT_ONE * (0.5 + rng.random())) for _ in items]
            bw = sum(w)
        m.add_bucket(Bucket(id=-(h + 1), alg=alg, type=1, items=items,
                            weights=w))
        host_w.append(bw)
    m.add_bucket(Bucket(id=-7, alg=BUCKET_STRAW2, type=10,
                        items=[-(h + 1) for h in range(6)], weights=host_w))
    m.finalize()
    for op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
        m.add_rule(Rule(steps=[(RULE_TAKE, -7, 0), (op, 0, 1),
                               (RULE_EMIT, 0, 0)]))
    out.append(("mixed_algorithms", m, 3))
    t = CrushMap(tunables=Tunables.profile("jewel"))
    t.add_bucket(Bucket(id=-1, alg=BUCKET_TREE, type=10,
                        items=list(range(48)),
                        weights=[1 << 26] * 47 + [3 << 24]))
    t.finalize()
    if max(t.buckets[0].node_weights) < 1 << 31:
        fail("general placement: the big tree map is under 2^31")
    for op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP):
        t.add_rule(Rule(steps=[(RULE_TAKE, -1, 0), (op, 0, 0),
                               (RULE_EMIT, 0, 0)]))
    out.append(("tree_node_weights_past_2_31", t, 4))
    return out


def general_placement(device, n_pgs: int = 1 << 20,
                      n_out: int = 100) -> dict:
    """The general per-lane mapper on the card: a straw-bucket 10,000-OSD
    map compiled from crushmap text, a 3-replica pool and a rack-then-host
    EC 4+2 pool of ``n_pgs`` PGs each, ``n_out`` OSDs out, the remap of
    both and the replicated pool's map_batch_delta; every lane against
    the native mapper; then each legacy algorithm alone at 65,536 lanes."""
    from ceph_tpu_torch.cluster.osdmap import (OSDMap, PGPool, POOL_ERASURE,
                                               POOL_REPLICATED)
    from ceph_tpu_torch.native_bridge import NativeMapper
    from ceph_tpu_torch.placement.compiler import compile_crushmap
    from ceph_tpu_torch.placement.crush_map import ITEM_NONE, WEIGHT_ONE
    from ceph_tpu_torch.placement.xla_mapper import XlaMapper
    from ceph_tpu_torch.common.options import config
    pc = perf("crush.mapper")

    def stat(key):
        v = pc.dump().get(key, 0)
        return v["sum"] if isinstance(v, dict) else v

    t0 = time.perf_counter()
    cmap = compile_crushmap(straw_cluster_text())
    t_compile = time.perf_counter() - t0
    if cmap.max_devices != GP_RACKS * GP_HOSTS * GP_OSDS or \
            any(b is not None and b.alg != 4 for b in cmap.buckets):
        fail("general placement: the compiled map is not the straw cluster")
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                       pg_num=n_pgs, crush_rule=0))
    om.add_pool(PGPool(id=2, name="ec42", type=POOL_ERASURE, size=6,
                       pg_num=n_pgs, crush_rule=1))
    nm = NativeMapper(cmap)
    f0, u0, g0 = stat("fallback_lanes"), stat("fast_unsupported_rules"), \
        stat("general_map_s")
    k0 = (xor_kernel.launches, gf_pallas.launches, gf_pallas.fused_launches)
    torch.cuda.reset_peak_memory_stats()
    times, native_s, ups = {}, 0.0, {}
    pps = {pid: om.pools[pid].raw_pg_to_pps_batch(np.arange(n_pgs))
           for pid in (1, 2)}

    def sweep(tag, pid, weights):
        nonlocal native_s
        t0 = time.perf_counter()
        up, _ = om.map_pgs_batch(pid)
        sync(device)
        times[tag] = time.perf_counter() - t0
        size = om.pools[pid].size
        t0 = time.perf_counter()
        raw = native_rows(nm, pps[pid], size, weights, ruleno=pid - 1)
        native_s += time.perf_counter() - t0
        # the replicated pool's up rows close their holes; the EC rows
        # keep them in place (positional shards)
        want = compact(raw, ITEM_NONE) if pid == 1 else raw
        if not np.array_equal(up, want):
            bad = int((up != want).any(axis=1).sum())
            fail(f"general placement: {tag} differs from the native mapper "
                 f"on {bad} PGs")
        ups[tag] = up
        return raw

    w0 = om.osd_weight[:cmap.max_devices].copy()
    raw_rep0 = sweep("replicated", 1, w0)
    sweep("ec42", 2, w0)
    outs = np.random.default_rng(SEED + 1).choice(cmap.max_devices, n_out,
                                                  replace=False)
    for o in outs:
        om.mark_out(int(o))
    w1 = om.osd_weight[:cmap.max_devices].copy()
    sweep("replicated_remap", 1, w1)
    sweep("ec42_remap", 2, w1)
    t0 = time.perf_counter()
    delta = om._batched_mapper().map_batch_delta(0, pps[1], 3, w0, w1,
                                                 raw_rep0)
    times["replicated_delta"] = time.perf_counter() - t0
    if not np.array_equal(delta, native_rows(nm, pps[1], 3, w1)):
        fail("general placement: map_batch_delta differs from the native "
             "mapper")
    for tag in ("replicated_remap", "ec42_remap"):
        if np.isin(ups[tag], outs).any():
            fail(f"general placement: an out OSD kept a PG ({tag})")
    peak = torch.cuda.max_memory_allocated()
    moved = {p: int((ups[p + "_remap"] != ups[p]).any(axis=1).sum())
             for p in ("replicated", "ec42")}

    # each legacy algorithm alone, against the native mapper
    legacy = {}
    xs = np.random.default_rng(SEED + 2).integers(0, 1 << 32, GP_LANES)
    for name, m, rm in legacy_maps():
        mapper = XlaMapper(m, device=device)
        nml = NativeMapper(m)
        wl = [WEIGHT_ONE] * m.max_devices
        for i in range(0, m.max_devices, 5):
            wl[i] = 0
        for ruleno in range(len(m.rules)):
            t0 = time.perf_counter()
            got = mapper.map_batch(ruleno, xs, rm, wl)
            dt_s = time.perf_counter() - t0
            if not np.array_equal(got, native_rows(nml, xs, rm, wl,
                                                   ruleno=ruleno)):
                fail(f"general placement: {name} rule {ruleno} differs "
                     "from the native mapper")
            legacy[f"{name}/rule{ruleno}"] = dt_s

    k1 = (xor_kernel.launches, gf_pallas.launches, gf_pallas.fused_launches)
    fallback = stat("fallback_lanes") - f0
    unsupported = stat("fast_unsupported_rules") - u0
    general_s = stat("general_map_s") - g0
    if fallback:
        fail(f"general placement: {fallback} lanes went to the host")
    if unsupported < 1 or general_s <= 0:
        fail("general placement: the general trace did not run "
             f"(fast_unsupported_rules {unsupported}, general_map_s "
             f"{general_s})")
    if k1 != k0:
        fail("general placement: a kernel launched on the placement path")
    cap = int(config().get("mapper_max_lanes_per_call"))
    return {"osds": cmap.max_devices, "racks": GP_RACKS,
            "hosts": GP_RACKS * GP_HOSTS, "alg": "straw",
            "compile_text_s": t_compile, "pgs_per_pool": n_pgs,
            "out_osds": n_out, "sweep_s": times, "lanes_per_sweep": n_pgs,
            "chunks_per_sweep": -(-n_pgs // cap), "lanes_per_chunk": cap,
            "general_map_s": general_s,
            "fast_unsupported_rules": unsupported,
            "fallback_lanes": fallback, "pgs_moved": moved,
            "native_lanes_checked": 5 * n_pgs, "native_s": native_s,
            "native_threads": os.cpu_count(),
            "max_memory_allocated": peak,
            "legacy_lanes": GP_LANES, "legacy_map_batch_s": legacy}


@contextlib.contextmanager
def launch_shapes(seen):
    """Sets every kernel's launch count to 0, then, while the block runs,
    calls ``seen(kernel, key)`` at each K1, K2 or K3 launch ("k1", "k2"
    or "k3"; ``key`` is the operand's shape and the output rows,
    "B,C,W->R") through a pass-through around the wrapper's launch.  The
    launch functions are restored on the way out."""
    k1, k2, k3 = xor_kernel._launch, gf_pallas._launch, \
        gf_pallas._launch_fused

    def observed_k1(m3, w3, per_batch):
        seen("k1", ",".join(map(str, w3.shape)) + f"->{m3.shape[1]}")
        return k1(m3, w3, per_batch)

    def observed_k2(bm, d3, m):
        seen("k2", ",".join(map(str, d3.shape)) + f"->{m}")
        return k2(bm, d3, m)

    def observed_k3(bm, pool):
        seen("k3", ",".join(map(str, pool.shape)) + f"->{bm.shape[0] // 8}")
        return k3(bm, pool)

    xor_kernel.launches = gf_pallas.launches = gf_pallas.fused_launches = 0
    xor_kernel._launch, gf_pallas._launch, gf_pallas._launch_fused = \
        observed_k1, observed_k2, observed_k3
    try:
        yield
    finally:
        xor_kernel._launch, gf_pallas._launch, gf_pallas._launch_fused = \
            k1, k2, k3


def counters():
    """(K1 launches, K2 launches, K1 plain runs, K2 plain runs, ec.jax
    encode + decode dispatches, the rebuild sweep's K1 dispatches)."""
    d = perf("ec.jax").dump()
    return (xor_kernel.launches, gf_pallas.launches, xor_kernel.plain_runs,
            gf_pallas.plain_runs,
            d.get("encode_dispatches", 0) + d.get("decode_dispatches", 0),
            simulator.rebuild_dispatches)


def cluster_step(device, layout: str, n_objects: int = 64,
                 obj_bytes: int = 4 << 20) -> dict:
    """One RS(8,3) pool's cluster step on the card (phase 6).  Returns the
    phase wall times, the recovery stats and the kernel accounting read
    around this pool's phases alone."""
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ceph_tpu_torch.cluster.simulator import ClusterSim
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        ITEM_NONE, RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=32, osds_per_host=4)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name=f"ec-{layout}", type=POOL_ERASURE,
                       size=K + M, pg_num=256, crush_rule=0,
                       erasure_code_profile="p", stripe_unit=128 << 10))
    sim = ClusterSim(om, device=device)
    prof = {"plugin": "jax", "k": str(K), "m": str(M),
            "technique": "reed_sol_van"}
    if layout == "bytes":
        prof["layout"] = "bytes"         # else the cluster default
    sim.create_ec_profile("p", prof)
    codec = sim.codec_for(om.pools[1])
    if codec.layout != layout:
        fail(f"cluster step: pool layout {codec.layout}, wanted {layout}")
    rng = np.random.default_rng(SEED)
    names = [f"{layout}{i:03d}" for i in range(n_objects)]
    datas = [rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes()
             for _ in names]
    times = {}
    phase_launches = {}
    # K2's launch shapes per phase ("B,k,L->m": launches)
    k2_shapes_seen = {}
    phase_now = ["put_many"]

    def seen(kernel, key):
        if kernel == "k2":
            h = k2_shapes_seen.setdefault(phase_now[0], {})
            h[key] = h.get(key, 0) + 1

    def mark(phase):
        phase_launches[phase] = [xor_kernel.launches, gf_pallas.launches]

    sync(device)
    c0 = counters()
    try:
        with launch_shapes(seen):
            t0 = time.perf_counter()
            up0, _ = om.map_pgs_batch(1)
            times["map_pgs_batch_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            placed = sim.put_many(1, names, datas)
            sync(device)
            times["put_many_s"] = time.perf_counter() - t0
            mark("put_many")
            if any(len(p) != K + M for p in placed.values()):
                fail(f"cluster step ({layout}): a shard did not land")
            pool = om.pools[1]
            up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
            victims = [o for o in up if o != ITEM_NONE][:M]
            for v in victims:
                sim.kill_osd(v)
            phase_now[0] = "degraded_get"
            t0 = time.perf_counter()
            gets = [sim.get(1, nm) for nm in names]
            times["degraded_get_s"] = time.perf_counter() - t0
            mark("degraded_get")
            if gets != datas:
                fail(f"cluster step ({layout}): a degraded read differs")
            for v in victims:
                sim.out_osd(v)
            phase_now[0] = "recover_all"
            t0 = time.perf_counter()
            rec = sim.recover_all(1)
            sync(device)
            times["recover_all_s"] = time.perf_counter() - t0
            mark("recover_all")
            t0 = time.perf_counter()
            up1, _ = om.map_pgs_batch(1)
            times["remap_s"] = time.perf_counter() - t0
            phase_now[0] = "get_after_recovery"
            t0 = time.perf_counter()
            gets2 = [sim.get(1, nm) for nm in names]
            times["get_after_recovery_s"] = time.perf_counter() - t0
            mark("get_after_recovery")
            if gets2 != datas:
                fail(f"cluster step ({layout}): a read after recovery "
                     f"differs")
    finally:
        sim.shutdown()
    _, _, p1, p2, disp, rebuild = (b - a for a, b in zip(c0, counters()))
    k1, k2 = xor_kernel.launches, gf_pallas.launches
    if rec["shards_rebuilt"] <= 0:
        fail(f"cluster step ({layout}): recovery rebuilt nothing")
    if p1 or p2:
        fail(f"cluster step ({layout}): a plain version ran on the path")
    if layout == "bytes":
        want_k1, want_k2 = 0, disp
    else:
        want_k1, want_k2 = disp + rebuild, 0
    if (k1, k2) != (want_k1, want_k2) or k1 + k2 == 0:
        fail(f"cluster step ({layout}): K1 launched {k1}, K2 {k2}; the "
             f"path made {want_k1} K1 and {want_k2} K2 dispatches")
    return {"layout": layout, "objects": n_objects, "object_bytes": obj_bytes,
            "osds": cmap.max_devices, "pg_num": 256, "victims": victims,
            "pgs_moved": int((np.asarray(up1) != np.asarray(up0))
                             .any(axis=1).sum()),
            "recover": rec, "ec_dispatches": disp,
            "rebuild_dispatches": rebuild, "k1_launches": k1,
            "k2_launches": k2, "k2_launch_shapes": k2_shapes_seen,
            "cumulative_launches_k1_k2": phase_launches, **times}


# ------------------------------------------------------------------ K3 --

def zerowire_shards(n_objects: int = ZW_OBJECTS):
    """The S3Serve mixed-size profile of the reference bench (bench.py
    ``bench_ragged_fused``): zipf(1.3) x 1 KiB object sizes clipped to
    [1 B, 1 MiB], each object k rows of L bytes, seeded from SEED."""
    rng = np.random.default_rng(SEED)
    raw = rng.zipf(1.3, size=n_objects).astype(np.float64)
    sizes = np.clip((raw * 1024).astype(np.int64), 1, 1 << 20)
    return [rng.integers(0, 256, size=(ZW_K, int(L)), dtype=np.uint8)
            for L in sizes]


def k3_bound(G: int, k: int, m: int, T: int):
    """(bound_ms, bound_by, bytes, lookups) of one K3 call: every pool
    byte read once, every parity byte and 4-byte crc written once, the
    [8m, 8k] bit-matrix read once; one shared-memory lookup per data
    byte per group of four parity rows, and one per crc'd byte (the
    crc's table walk, data and parity rows alike)."""
    nbytes = G * k * T + G * m * T + 4 * G * (k + m) + 64 * m * k
    ops = G * T * k * (-(-m // 4)) + G * (k + m) * T
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SMEM_LOOKUPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def k3_plain(bitmat, pool, chunk: int = 256):
    """K3's plain version over ``pool`` in chunks of blocks (it unpacks
    32x): (parity, data crcs, parity crcs)."""
    T = pool.shape[2]
    A8, const = ragged_fused._crc_a8(T)
    bm = torch.as_tensor(bitmat, device=pool.device)
    a8 = torch.as_tensor(A8, device=pool.device)
    parts = [ragged_fused.fused_block_math(bm, a8, const, pool[c:c + chunk])
             for c in range(0, pool.shape[0], chunk)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def k3_shapes(device, gen, main_pool: np.ndarray):
    """K3's shapes: {name: (bitmat, pool)}; m = 0 pools are the crc leg."""
    rng = np.random.default_rng(SEED + 3)

    def data(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=device, generator=gen)

    rs42 = gf.gf8_bitmatrix(gf.isa_rs_parity(ZW_K, ZW_M))
    edges = ragged_fused.pack([rng.integers(0, 256, (ZW_K, n),
                                            dtype=np.uint8)
                               for n in (1, 4096, 4097)]).pool
    shapes = {
        "zerowire_chunk": (rs42, torch.from_numpy(main_pool[:512]).to(device)),
        "rs83": (gf.gf8_bitmatrix(gf.isa_rs_parity(8, 3)), data((64, 8, 4096))),
        "k8m12_random": (rng.integers(0, 2, (96, 64), dtype=np.uint8),
                         data((33, 8, 4096))),
        "objects_1_4096_4097": (rs42, torch.from_numpy(edges).to(device)),
        # a pool one byte past a 16-byte boundary: K3's byte-load variant
        "rs42_offset1": (rs42, data((513 * ZW_K * 4096 + 1,))[1:]
                         .view(513, ZW_K, 4096)),
    }
    for T in (1, 64, 512, 4096, 4097, 65536):
        shapes[f"crc_leg_{T}"] = (np.zeros((0, 8), dtype=np.uint8),
                                  data((64 if T > 4097 else 256, 1, T)))
    # the process cluster's (phase 10) crc batches: the flush of one
    # 64 MiB object's 11 shards, the durable put's 16 x 11 one-chunk
    # shards, and one 1 MiB shard's reply frame
    blocks = PC_SU // 4096
    for name, G in (("pc_flush", (K + M) * pc_stripes(PC_FLUSH_BYTES) *
                     blocks),
                    ("pc_durable_put", PC_OBJECTS * (K + M) * blocks),
                    ("pc_reply", blocks)):
        shapes[f"crc_leg_{name}"] = (np.zeros((0, 8), dtype=np.uint8),
                                     data((G, 1, 4096)))
    return shapes


def k3_checks(device, shapes) -> dict:
    """K3 against its plain version on the card at each shape, and its
    crcs of the first and last block against zlib on the host; fails on
    any difference.  Returns {name: max_abs_err}."""
    errs = {}
    for name, (bitmat, pool) in shapes.items():
        got = gf_pallas.fused_ragged_matmul(bitmat, pool)
        want = k3_plain(bitmat, pool)
        sync(device)
        err = 0
        for g, w in zip(got, want):
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                fail(f"K3 differs from its plain version at {name}")
        host, par = pool.cpu().numpy(), got[0].cpu().numpy()
        for g in (0, host.shape[0] - 1):
            if got[1][g].tolist() != [zlib.crc32(r.tobytes())
                                      for r in host[g]] or \
                    got[2][g].tolist() != [zlib.crc32(r.tobytes())
                                           for r in par[g]]:
                fail(f"K3's crcs differ from zlib at {name}")
        errs[name] = err
        m, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
        emit({"phase": "kernel_check", "kernel": "ragged_fused",
              "shape": name, "bitmat": list(bitmat.shape),
              "pool": list(pool.shape), "max_abs_err": err,
              "dynamic_smem_bytes": gf_pallas.fused_smem_bytes(m, k)[0]})
    return errs


def _reader(sock, n: int, key: bytes, sink, out: dict) -> None:
    """Reader thread: ``n`` frames off ``sock`` (device verify inside
    ``read_frame``), each handed to ``sink``; the first error lands in
    ``out`` for the main thread to raise."""
    from ceph_tpu_torch.msg import wire
    rd = wire.SockReader(sock)
    try:
        for _ in range(n):
            sink(rd.read_frame(session_key=key, mode=wire.MODE_CRC))
    except BaseException as e:      # re-raised by the main thread
        out["error"] = e


def _stream(frames, key: bytes, sink, timeout: float = 900.0) -> None:
    """Send ``frames`` [(type, id, meta, data, csums)] over a socket pair
    while a reader thread verifies each and hands it to ``sink``; a dead
    or hung reader fails the run."""
    from ceph_tpu_torch.msg import wire
    a, b = socket.socketpair()
    for s in (a, b):
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            s.setsockopt(socket.SOL_SOCKET, opt, 1 << 21)
    out = {}
    t = threading.Thread(target=_reader, args=(b, len(frames), key, sink,
                                               out), daemon=True)
    t.start()
    try:
        for typ, rid, meta, data, cs in frames:
            if "error" in out:
                break
            wire.send_frame_sg(a, typ, rid, meta, data, session_key=key,
                               mode=wire.MODE_CRC, data_csums=cs)
    finally:
        t.join(timeout)
        a.close()
        b.close()
    if t.is_alive():
        fail("zerowire: the reader thread hung")
    if "error" in out:
        raise out["error"]


def zerowire_path(device, shards) -> dict:
    """Phase 6: fused encode on the card, SG frames over a socket pair,
    device receive verify, BlueStore commit with the verified csums, read
    back with the trusted csums, reply frames verified on the card, one
    flipped frame rejected.  Returns the step times and the counters read
    around the path."""
    from ceph_tpu_torch.cluster.bluestore import BlueStore
    from ceph_tpu_torch.cluster.objectstore import Transaction
    from ceph_tpu_torch.common import faults
    from ceph_tpu_torch.msg import encoding, wire
    n_rows = ZW_K + ZW_M
    A = gf.isa_rs_parity(ZW_K, ZW_M)
    lengths = [int(s.shape[1]) for s in shards]
    blocks = sum(-(-L // 4096) for L in lengths)
    key = np.random.default_rng(SEED).bytes(32)
    coll = (1, 0)
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    stores = [BlueStore(os.path.join(STORE_DIR, f"shard{s}"),
                        device_bytes=(blocks + 256) * 4096, min_alloc=4096)
              for s in range(n_rows)]
    times = {}
    try:
        sync(device)
        gf_pallas.launches = 0
        gf_pallas.fused_launches = 0
        xor_kernel.launches = 0
        plain0 = (gf_pallas.plain_runs, crc32_gf2.plain_runs,
                  xor_kernel.plain_runs)
        perf("wire.zero").reset()
        torch.cuda.reset_peak_memory_stats()

        # 1. the fused encode: parity and per-4 KiB csums, one K3 launch
        t0 = time.perf_counter()
        res = ragged_fused.encode(A, shards, device=device)
        times["encode_s"] = time.perf_counter() - t0
        encode_launches = gf_pallas.fused_launches

        # 2-4. SG frames with the csums folded in, verified on the card,
        # committed with the verified csums as blob csums
        frames, heads, full, tails = [], 0, 0, 0
        for i, sh in enumerate(shards):
            rows = [sh[j] for j in range(ZW_K)] + list(res.parity[i])
            css = res.data_csums[i] + res.parity_csums[i]
            for s in range(n_rows):
                meta = encoding.dumps({"cmd": "put_shard", "oid": f"o{i}",
                                       "shard": s})
                frames.append((wire.MSG_REQ_SG, len(frames) + 1, meta,
                               np.ascontiguousarray(rows[s]), css[s]))
                heads += 4 + len(meta)
                full += lengths[i] - lengths[i] % 4096
                tails += lengths[i] % 4096

        def commit(env):
            meta, data = wire.split_sg(env.payload)
            req = encoding.loads(meta)
            if env.csums is None:
                fail("zerowire: a request frame arrived without csums")
            stores[req["shard"]].apply_transaction(Transaction().write_full(
                coll, req["oid"], data, csums=env.csums, copy=False))

        t0 = time.perf_counter()
        _stream(frames, key, commit)
        times["ingest_s"] = time.perf_counter() - t0
        stored = sum(f[3].nbytes for f in frames)
        del frames

        # 5. read back with the trusted csums; reply frames verified on
        # the card and compared with the original shard bytes
        want = {}
        mismatched = []

        def replies():
            rid = 0
            for i, sh in enumerate(shards):
                for s in range(n_rows):
                    rid += 1
                    want[rid] = sh[s] if s < ZW_K else res.parity[i][s - ZW_K]
                    data, cs = stores[s].read_with_csums(coll, f"o{i}")
                    if cs is None:
                        fail(f"zerowire: o{i} shard {s} read back without "
                             f"trusted csums")
                    yield (wire.MSG_REPLY_SG, rid,
                           encoding.dumps({"oid": f"o{i}", "shard": s}),
                           data, cs)

        def check(env):
            _meta, data = wire.split_sg(env.payload)
            if env.type != wire.MSG_REPLY_SG or env.csums is None or \
                    not np.array_equal(np.frombuffer(data, np.uint8),
                                       want.pop(env.id)):
                mismatched.append(env.id)

        t0 = time.perf_counter()
        reply_frames = list(replies())
        times["read_with_csums_s"] = time.perf_counter() - t0
        reply_heads = sum(4 + len(f[2]) for f in reply_frames)
        t0 = time.perf_counter()
        _stream(reply_frames, key, check)
        times["reply_s"] = time.perf_counter() - t0
        del reply_frames
        if mismatched or want:
            fail(f"zerowire: {len(mismatched) + len(want)} shards read back "
                 f"wrong or missing")

        # 6. one frame with a flipped bit is rejected (the first object
        # of two blocks or more, its csums from the encode)
        fi = next(i for i, L in enumerate(lengths) if L >= 8192)
        flip, flip_cs = shards[fi][0], res.data_csums[fi][0]
        flip_meta = encoding.dumps({"cmd": "put_shard", "oid": "flip"})
        faults.arm("wire.flip_bit", mode="always", count=1)
        try:
            t0 = time.perf_counter()
            try:
                _stream([(wire.MSG_REQ_SG, 1, flip_meta, flip, flip_cs)],
                        key, lambda env: None)
            except wire.WireError as e:
                times["flip_rejected"] = str(e)
            else:
                fail("zerowire: a frame with a flipped bit was accepted")
            times["flip_s"] = time.perf_counter() - t0
        finally:
            faults.disarm("wire.flip_bit")
        sync(device)
        zero = perf("wire.zero").dump()
        k3, k2, k1 = (gf_pallas.fused_launches, gf_pallas.launches,
                      xor_kernel.launches)
        plain1 = (gf_pallas.plain_runs, crc32_gf2.plain_runs,
                  xor_kernel.plain_runs)
        peak = torch.cuda.max_memory_allocated()
    finally:
        for st in stores:
            st.close()
        shutil.rmtree(STORE_DIR, ignore_errors=True)

    flip_head = 4 + len(flip_meta)
    flip_full = flip.nbytes - flip.nbytes % 4096
    want_counts = {
        "scan_send_bytes": heads + reply_heads + flip_head,
        "scan_verify_bytes": heads + reply_heads + flip_head,
        "scan_store_bytes": 0,
        "scan_device_tail_bytes": 3 * tails + flip.nbytes % 4096,
        "device_crc_bytes": 2 * full + flip_full,
        "trusted_csum_bytes": stored,
    }
    got_counts = {k: zero.get(k, 0) for k in want_counts}
    if got_counts != want_counts:
        fail(f"zerowire: scan counters {got_counts}, wanted {want_counts}")
    crc_dispatches = zero.get("device_crc_dispatches", 0)
    if plain1 != plain0:
        fail("zerowire: a plain version ran on the path")
    if encode_launches != 1 or k3 != encode_launches + crc_dispatches or \
            k2 or k1:
        fail(f"zerowire: K3 launched {k3} times (encode {encode_launches}), "
             f"the path made {crc_dispatches} crc dispatches; K2 {k2}, K1 {k1}")
    return {"objects": len(shards), "k": ZW_K, "m": ZW_M,
            "data_bytes": sum(lengths) * ZW_K,
            "parity_bytes": sum(lengths) * ZW_M,
            "pool_blocks": blocks, "full_block_payload_bytes": full,
            "tail_bytes": tails, "frames": 2 * len(shards) * n_rows + 1,
            "k3_launches": k3, "encode_launches": encode_launches,
            "device_crc_dispatches": crc_dispatches,
            "counters": got_counts, "max_memory_allocated": peak,
            "res": res, **times}


def zerowire_checks(device, shards, res) -> None:
    """Outside the counted window: the path's parity against K2 on the
    same pool, and every sub-crc against zlib on the host."""
    batch = ragged_fused.pack(shards)
    bitmat = gf.gf8_bitmatrix(gf.isa_rs_parity(ZW_K, ZW_M))
    pool = torch.from_numpy(batch.pool).to(device)
    k2 = gf_pallas.bitplane_matmul(bitmat, pool).cpu().numpy()
    del pool
    g = 0
    for i, sh in enumerate(shards):
        L = sh.shape[1]
        n_blk = -(-L // 4096)
        par = k2[g:g + n_blk].transpose(1, 0, 2).reshape(ZW_M, -1)[:, :L]
        if not np.array_equal(par, res.parity[i]):
            fail(f"zerowire: object {i}'s parity differs from K2's")
        rows = [sh[j] for j in range(ZW_K)] + list(res.parity[i])
        for row, cs in zip(rows, res.data_csums[i] + res.parity_csums[i]):
            b = row.tobytes()
            if cs.subs != [zlib.crc32(b[o:o + 4096])
                           for o in range(0, L, 4096)] or \
                    cs.combined != zlib.crc32(b) or cs.length != L:
                fail(f"zerowire: object {i}'s csums differ from zlib")
        g += n_blk


def time_k3(main_pool: np.ndarray, mean_frame_blocks: int, device,
            card: str) -> dict:
    """K3's device time at the full ZeroWire pool and its crc leg at a
    2 MiB frame (512 blocks), at the ZeroWire path's mean verified frame
    and at the process cluster's flush batch, beside their bounds and
    plain versions."""
    out = {}
    rs42 = gf.gf8_bitmatrix(gf.isa_rs_parity(ZW_K, ZW_M))
    none = np.zeros((0, 8), dtype=np.uint8)
    pool = torch.from_numpy(main_pool).to(device)
    frame = torch.randint(0, 256, (512, 1, 4096), dtype=torch.uint8,
                          device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(SEED))
    pc_flush_blocks = (K + M) * pc_stripes(PC_FLUSH_BYTES) * PC_SU // 4096
    flush = torch.randint(0, 256, (pc_flush_blocks, 1, 4096),
                          dtype=torch.uint8, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(SEED + 10))
    for name, bitmat, data, iters in (
            ("full_pool", rs42, pool, 10),
            ("crc_leg_2MiB", none, frame, 50),
            ("crc_leg_mean_frame", none, frame[:mean_frame_blocks], 50),
            ("crc_leg_pc_flush", none, flush, 10)):
        G, k, T = data.shape
        m = bitmat.shape[0] // 8
        n0 = gf_pallas.fused_launches
        ms = graph_ms(lambda: gf_pallas.fused_ragged_matmul(bitmat, data),
                      iters=iters)
        call_ms = cuda_ms(lambda: gf_pallas.fused_ragged_matmul(bitmat, data),
                          iters=iters)
        if gf_pallas.fused_launches - n0 != 2 + iters + 2 + iters:
            fail("K3 timing: a wrapper call did not launch the kernel")
        plain_ms = cuda_ms(lambda: k3_plain(bitmat, data, chunk=1024),
                           iters=1, warmup=1)
        bound_ms, bound_by, nbytes, ops = k3_bound(G, k, m, T)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        emit({"phase": "timing", "kernel": "ragged_fused", "shape": name,
              "pool": [G, k, T], "m": m, "ms": ms, "call_ms": call_ms,
              "plain_ms": plain_ms, "bytes": nbytes, "lookups": ops,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "lookups_ms": ops / SMEM_LOOKUPS_PER_S * 1e3,
              "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
              "roofline_share": bound_ms / ms, "gpu": card})
    return out


# ------------------------------------------------------ EC plugins --
#
# The non-regression corpus of scripts/gen_ec_corpus.py: its payload (an
# LCG) and its 21 (plugin, technique, k, m) configs, kept here so that the
# smoke reads no script and no module of the JAX package.

CORPUS_CONFIGS = [
    ("jax", "reed_sol_van", 4, 2), ("jax", "reed_sol_van", 8, 3),
    ("jax", "cauchy", 4, 2), ("jax", "cauchy_good", 6, 3),
    ("jax", "isa_rs", 8, 4),
    ("jerasure", "reed_sol_van", 4, 2), ("jerasure", "reed_sol_van", 8, 3),
    ("jerasure", "reed_sol_r6_op", 4, 2),
    ("jerasure", "cauchy_orig", 4, 2), ("jerasure", "cauchy_good", 6, 3),
    ("isa", "reed_sol_van", 4, 2), ("isa", "cauchy", 6, 2),
    ("shec", None, 4, 3), ("lrc", None, 4, 2), ("clay", None, 4, 2),
    ("jerasure", "liberation", 5, 2), ("jerasure", "liberation", 7, 2),
    ("jerasure", "blaum_roth", 6, 2), ("jerasure", "liber8tion", 8, 2),
    ("jax", "bitsliced", 8, 3), ("jax", "bitsliced", 4, 2),
]
CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "ec_corpus.npz")


def corpus_payload(n: int = 4096) -> bytes:
    x = 0x12345678
    out = bytearray()
    for _ in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out.append((x >> 16) & 0xFF)
    return bytes(out)


def corpus_profile(plugin, technique, k, m) -> dict:
    prof = {"k": str(k), "m": str(m)}
    if technique:
        prof["technique"] = technique
    if plugin == "shec":
        prof["c"] = "2"
    if plugin == "lrc":
        prof["l"] = "3"
        prof.pop("technique", None)
    if technique == "liberation":
        prof["w"] = "7"
    elif technique == "blaum_roth":
        prof["w"] = "6"
    elif technique == "liber8tion":
        prof["w"] = "8"
    elif technique == "bitsliced":
        prof["technique"] = "reed_sol_van"
        prof["layout"] = "bitsliced"
    return prof


def inner_codecs(codec) -> list:
    """The codecs a layered codec built through the registry."""
    if hasattr(codec, "layers"):
        return [lay.codec for lay in codec.layers]
    if hasattr(codec, "pft"):
        return [codec.mds, codec.pft]
    return []


def check_devices(codec, device, what: str) -> None:
    for c in [codec] + inner_codecs(codec):
        if c.device != device:
            fail(f"{what}: a codec sits on {c.device}, not {device}")


def ec_corpus(device) -> dict:
    """Every corpus config encoded through the port's registry on the
    card, every chunk held byte for byte to tests/golden/ec_corpus.npz;
    a codec with a batched device path (jax, the bitmatrix techniques)
    also through that path."""
    corpus = np.load(CORPUS)
    data = corpus_payload()
    t0 = time.perf_counter()
    batched = 0
    for plugin, technique, k, m in CORPUS_CONFIGS:
        codec = instance().factory(
            plugin, corpus_profile(plugin, technique, k, m), device=device)
        check_devices(codec, device, f"corpus {plugin}")
        n = codec.get_chunk_count()
        key = f"{plugin}.{technique or 'default'}.k{k}m{m}"
        want = [corpus[f"{key}.c{c}"] for c in range(n)]
        chunks = codec.encode(set(range(n)), data)
        for c in range(n):
            if not np.array_equal(chunks[c], want[c]):
                fail(f"corpus {key}: chunk {c} differs on the card")
        if hasattr(codec, "encode_chunks_device"):
            prepared = codec.encode_prepare(data)
            par = codec.encode_chunks_device(prepared[None])
            if par.device.type != device.type or not np.array_equal(
                    par[0].cpu().numpy(), np.stack(want[k:])):
                fail(f"corpus {key}: the device encode differs")
            batched += 1
    return {"configs": len(CORPUS_CONFIGS), "device_encodes": batched,
            "corpus_s": time.perf_counter() - t0}


# (name, profile, kernel the pool runs, objects): BASELINE #4's CLAY,
# Ceph's LRC documentation example, BASELINE #2's isa baseline, Ceph's
# SHEC default, and a RAID-6 bitmatrix and a Cauchy jerasure pool; the
# host pools run no kernel and encode far slower, so they hold 16 objects
PLUGIN_POOLS = [
    ("jerasure-liber8tion", {"plugin": "jerasure", "technique": "liber8tion",
                             "k": "6", "m": "2", "w": "8"}, "k1", 64),
    ("lrc", {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}, "k2", 64),
    ("clay", {"plugin": "clay", "k": "8", "m": "4", "d": "11"}, "k2", 64),
    ("jerasure-cauchy_good", {"plugin": "jerasure",
                              "technique": "cauchy_good", "k": "6",
                              "m": "3"}, "host", 16),
    ("isa", {"plugin": "isa", "k": "8", "m": "3"}, "host", 16),
    ("shec", {"plugin": "shec", "k": "4", "m": "3", "c": "2"}, "host", 16),
]


def ec_dispatches():
    """(bitmatrix codec, ec.jax) encode + decode dispatches so far."""
    d = perf("ec.jax").dump()
    return (bitmatrix_codec.encode_dispatches +
            bitmatrix_codec.decode_dispatches,
            d.get("encode_dispatches", 0) + d.get("decode_dispatches", 0))


def plugin_pool(device, name: str, prof: dict, runs: str, n_objects: int,
                obj_bytes: int = 4 << 20) -> dict:
    """One erasure-code plugin's pool on the cluster step's map (phase 8):
    put_many, two OSDs of the first object's up set killed, every object
    read, both marked out, recover_all, every object read again and held
    byte for byte to what was written.  K1's and K2's launches (by
    shape) and the plain versions' runs are read around the pool."""
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ceph_tpu_torch.cluster.simulator import ClusterSim
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        ITEM_NONE, RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=32, osds_per_host=4)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    size = instance().factory(prof["plugin"], dict(prof),
                              device=device).get_chunk_count()
    om.add_pool(PGPool(id=1, name=name, type=POOL_ERASURE, size=size,
                       pg_num=256, crush_rule=0, erasure_code_profile="p",
                       stripe_unit=128 << 10))
    sim = ClusterSim(om, device=device)
    sim.create_ec_profile("p", dict(prof))
    codec = sim.codec_for(om.pools[1])
    check_devices(codec, device, name)
    if sim._device_staging(codec):
        fail(f"{name}: the pool took the HBM staging tier")
    rng = np.random.default_rng(SEED)
    names = [f"{name}{i:03d}" for i in range(n_objects)]
    datas = [rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes()
             for _ in names]
    times, shapes = {}, {}
    step = ["put_many"]

    def seen(kernel, key):
        h = shapes.setdefault(step[0], {}).setdefault(kernel, {})
        h[key] = h.get(key, 0) + 1

    def timed(label, fn):
        step[0] = label
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times[f"{label}_s"] = time.perf_counter() - t0
        return out

    sync(device)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # earlier phases' tensors
    plain0 = (xor_kernel.plain_runs, gf_pallas.plain_runs,
              crc32_gf2.plain_runs)
    disp0 = ec_dispatches()
    try:
        with launch_shapes(seen):
            placed = timed("put_many",
                           lambda: sim.put_many(1, names, datas))
            if any(len(p) != size for p in placed.values()):
                fail(f"{name}: a shard did not land")
            pool = om.pools[1]
            up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
            victims = [o for o in up if o != ITEM_NONE][:2]
            for v in victims:
                sim.kill_osd(v)
            gets = timed("degraded_get", lambda: [sim.get(1, nm)
                                                   for nm in names])
            if gets != datas:
                fail(f"{name}: a degraded read differs")
            for v in victims:
                sim.out_osd(v)
            rec = timed("recover_all", lambda: sim.recover_all(1))
            gets = timed("get_after_recovery", lambda: [sim.get(1, nm)
                                                         for nm in names])
            if gets != datas:
                fail(f"{name}: a read after recovery differs")
    finally:
        sim.shutdown()
    plain = tuple(b - a for a, b in zip(plain0, (
        xor_kernel.plain_runs, gf_pallas.plain_runs,
        crc32_gf2.plain_runs))) + (gf_pallas.fused_launches,)
    bitmatrix, jax = (b - a for a, b in zip(disp0, ec_dispatches()))
    k1, k2 = xor_kernel.launches, gf_pallas.launches
    if any(plain):
        fail(f"{name}: a plain version or K3 ran on the path: {plain}")
    want = {"k1": (bitmatrix, 0), "k2": (0, jax), "host": (0, 0)}[runs]
    if (k1, k2) != want or (runs != "host" and k1 + k2 == 0) or \
            (runs == "host" and bitmatrix + jax):
        fail(f"{name}: K1 launched {k1}, K2 {k2}; the pool made "
             f"{bitmatrix} bitmatrix and {jax} ec.jax dispatches")
    if rec["shards_rebuilt"] <= 0:
        fail(f"{name}: recovery rebuilt nothing")
    if prof["plugin"] == "clay" and not rec.get("ranged_repairs"):
        fail(f"{name}: no object recovered through the sub-chunk repair")
    return {"pool": name, "profile": prof, "runs": runs,
            "objects": n_objects, "object_bytes": obj_bytes,
            "chunks": size, "chunk_size": sim.objects[(1, names[0])]
            .chunk_size, "victims": victims, "recover": rec,
            "bitmatrix_dispatches": bitmatrix, "ec_jax_dispatches": jax,
            "k1_launches": k1, "k2_launches": k2,
            "launch_shapes": shapes, **times,
            "steps_s": sum(times.values()), "memory_allocated_before": held,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def plugin_k1_shapes(device, gen):
    """K1 at the bitmatrix techniques' shapes: liber8tion k=6 w=8 at the
    pool's 128 KiB chunks ([6, 48, 4096] words, 6 stripes of a 4 MiB
    object), its 2-erasure decode, and liberation w=7 and blaum_roth w=6,
    whose plane lengths are no multiple of 8 words."""
    out = {}
    for technique, k, w in (("liber8tion", 6, 8), ("liberation", 5, 7),
                            ("blaum_roth", 6, 6)):
        codec = instance().factory(
            "jerasure", {"technique": technique, "k": str(k), "m": "2",
                         "w": str(w)}, device=device)
        W = codec.get_chunk_size(k * (128 << 10)) // w // 4
        R, _ = codec.decode_bitmatrix(
            [c for c in range(k + 2) if c not in (0, k)], [0, k])
        for tag, bm in (("encode", codec.bitmatrix), ("decode", R)):
            out[f"{technique}_w{w}_{tag}"] = (
                torch.as_tensor(gf2.bitmatrix_masks(bm), device=device),
                random_words((6, k * w, W), gen, device))
    return out


def plugin_k2_shapes(device, gen):
    """K2 at LRC's and CLAY's per-call shapes: LRC k=4 m=2 l=3's global
    layer [1, 4, L] -> 2 rows and local layer [1, 3, L] -> 1 row at the
    pool's 128 KiB chunks; CLAY(8,4,11)'s pft [1, 2, sc] -> 2 rows and mds
    [1, 8, sc] -> 4 rows at its 2 KiB sub-chunks."""
    def data(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=device, generator=gen)

    lrc = instance().factory("lrc", {"k": "4", "m": "2", "l": "3"},
                             device=device)
    clay = instance().factory("clay", {"k": "8", "m": "4", "d": "11"},
                              device=device)
    L = 128 << 10
    sc = L // clay.get_sub_chunk_count()
    pft, _ = clay.pft.decode_matrix([2, 3], [0, 1])
    mds, _ = clay.mds.decode_matrix(list(range(4, 12)), [0, 1, 2, 3])
    return {"lrc_global": (gf.gf8_bitmatrix(lrc.layers[0].codec.parity),
                           data((1, 4, L))),
            "lrc_local": (gf.gf8_bitmatrix(lrc.layers[1].codec.parity),
                          data((1, 3, L))),
            "clay_pft": (gf.gf8_bitmatrix(pft), data((1, 2, sc))),
            "clay_mds": (gf.gf8_bitmatrix(mds), data((1, 8, sc)))}


# ------------------------------------------------ the process cluster --

# bench.py's bench_process_cluster: RS(8,3) bitsliced, 12 OSD daemons,
# pg_num 32, 1 MiB stripe unit, a staged put of 16 x 256 MiB objects per
# round, a 64 MiB flush, 16 x 4 MiB durable objects
PC_OSDS = 12
PC_PG_NUM = 32
PC_SU = 1 << 20
PC_OBJECTS = 16
PC_OBJ_BYTES = 256 << 20
PC_ROUNDS = 2
PC_FLUSH_BYTES = 64 << 20
PC_DURABLE_BYTES = 4 << 20
PC_PROFILE = {"plugin": "jax", "k": str(K), "m": str(M),
              "layout": "bitsliced"}
PC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "build", "pc")


def pc_stripes(nbytes: int) -> int:
    """Stripes of k chunks of PC_SU bytes an object of ``nbytes`` takes."""
    return max(1, -(-nbytes // (K * PC_SU)))


def compute_app_pids() -> list:
    """Pids holding a CUDA context, as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


def opens_nvidia_devices(pid: int) -> bool:
    """Whether process ``pid`` holds a file descriptor on a
    ``/dev/nvidia*`` device, as a process with a CUDA context does (one
    that only imported torch holds none)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith(
                    "/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def pc_expected_shards(words: torch.Tensor) -> list:
    """Shard bytes of one object ([S, k, W] int32 words) as the CPU plain
    encode gives them: data shard c is words[:, c], parity from a codec
    on the CPU (K1's plain version), each shard its S chunks in order."""
    cpu = instance().factory("jax", dict(PC_PROFILE), device="cpu")
    host = words.cpu()
    par = cpu.encode_words_device(host)
    return [host[:, c].contiguous().numpy().tobytes() for c in range(K)] + \
        [par[:, j].contiguous().numpy().tobytes() for j in range(M)]


def pc_words(data: bytes) -> torch.Tensor:
    """A durable object's bytes as its stored [S, k, W] words on the host
    (zero-padded to whole stripes)."""
    S = pc_stripes(len(data))
    buf = np.zeros(S * K * PC_SU, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return torch.from_numpy(buf.view(np.int32).reshape(S, K, PC_SU // 4))


def process_cluster(device, card: str) -> dict:
    """Phase 10: the process cluster.  vstart starts one mon and 12 OSD
    daemon processes asked for the CPU; a RemoteCluster here, its codec
    on the card, drives bench.py's bench_process_cluster through the
    port: a staged put (2 rounds), a 64 MiB flush, a durable put, two
    OSDs killed and every durable object read degraded, both marked out,
    recover_ec_pool, every object read again.  Each step is timed with a
    synchronize before the clock stops, and its K1 and K3 launches (by
    shape), device crc dispatches, readback bytes and host crc scans are
    read around it."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    from ceph_tpu_torch.common import crcutil
    from ceph_tpu_torch.msg import wire
    from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir
    shutil.rmtree(PC_DIR, ignore_errors=True)
    build_cluster_dir(
        PC_DIR, n_osds=PC_OSDS, osds_per_host=1, fsync=False,
        pools=[{"id": 1, "name": "ec", "type": 3, "size": K + M,
                "pg_num": PC_PG_NUM, "crush_rule": 1,
                "erasure_code_profile": "p", "stripe_unit": PC_SU}])
    W = PC_SU // 4
    S = pc_stripes(PC_OBJ_BYTES)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    names = [f"p{i:02d}" for i in range(PC_OBJECTS)]
    rng = np.random.default_rng(SEED + 10)
    dnames = [f"d{i:02d}" for i in range(PC_OBJECTS)]
    ddatas = [rng.integers(0, 256, PC_DURABLE_BYTES, dtype=np.uint8)
              .tobytes() for _ in dnames]
    fS = pc_stripes(PC_FLUSH_BYTES)
    times, steps, shapes, scans = {}, {}, {}, {}
    # payload bytes the client's host crc'd: Csums.scan passes of a full
    # block or more, and bulk frame segments sent without folded csums
    host_payload = {"scans": [], "unfolded_sends": []}
    step = [None]
    note_scan, csums_scan = crcutil.note_scan, crcutil.Csums.scan
    scan_descriptor = crcutil.Csums.__dict__["scan"]
    frame_parts = wire._frame_parts

    def seen(kernel, key):
        h = shapes.setdefault(step[0] or "checks", {}).setdefault(kernel, {})
        h[key] = h.get(key, 0) + 1

    def observed_scan(nbytes, site):
        if step[0] is not None and nbytes > 0:
            c = scans.setdefault(site, {"scans": 0, "bytes": 0, "max": 0})
            c["scans"] += 1
            c["bytes"] += int(nbytes)
            c["max"] = max(c["max"], int(nbytes))
        return note_scan(nbytes, site)

    def observed_csums_scan(cls, buf, block=crcutil.CSUM_BLOCK,
                            site="send"):
        n = len(crcutil.as_u8(buf))
        if n >= 4096:
            host_payload["scans"].append((step[0], site, n))
        return csums_scan(buf, block=block, site=site)

    def observed_frame_parts(env_type, env_id, shard, parts, session_key,
                             mode, data_csums=None):
        if env_type in (wire.MSG_REQ_SG, wire.MSG_REPLY_SG) and parts:
            n = len(parts[-1])
            if n >= 4096 and (data_csums is None or
                              data_csums.length != n):
                host_payload["unfolded_sends"].append((step[0], n))
        return frame_parts(env_type, env_id, shard, parts, session_key,
                           mode, data_csums=data_csums)

    def counts():
        ec = perf("ec.jax").dump()
        zero = perf("wire.zero").dump()
        return {"k1": xor_kernel.launches, "k2": gf_pallas.launches,
                "k3": gf_pallas.fused_launches,
                "ec_dispatches": ec.get("encode_dispatches", 0) +
                ec.get("decode_dispatches", 0),
                "device_crc_dispatches": zero.get("device_crc_dispatches", 0),
                "device_crc_bytes": zero.get("device_crc_bytes", 0),
                "readback_bytes": device_store.readback_bytes,
                "plain": xor_kernel.plain_runs + gf_pallas.plain_runs +
                crc32_gf2.plain_runs}

    tries = {}

    def timed(label, fn, full=None):
        """``fn()`` timed, its counts read around it.  A write (``full``
        given) runs again after a map refresh until ``full(result)``:
        under load the mon can mark a live daemon down for a heartbeat,
        and a write placed then misses that shard (the ack retry of
        tests/test_process_cluster.py).  A read runs once."""
        sync(device)
        c0 = counts()
        step[0] = label
        t0 = time.perf_counter()
        for n in range(1, 13):
            out = fn()
            if full is None or full(out):
                break
            time.sleep(0.5)
            rc.refresh_map()
        else:
            fail(f"process cluster {label}: not every shard acked: {out}")
        tries[label] = n
        sync(device)
        times[f"{label}_s"] = time.perf_counter() - t0
        step[0] = None
        d = {k: v - c0[k] for k, v in counts().items()}
        steps[label] = d
        if d["plain"]:
            fail(f"process cluster {label}: a plain version ran")
        if d["k1"] != d["ec_dispatches"] or d["k2"] or \
                d["k3"] != d["device_crc_dispatches"]:
            fail(f"process cluster {label}: K1 launched {d['k1']} times "
                 f"for {d['ec_dispatches']} codec dispatches, K3 {d['k3']} "
                 f"for {d['device_crc_dispatches']} crc dispatches, "
                 f"K2 {d['k2']}")
        return out

    def placed(acked):
        """Every shard of every object has a target."""
        return all(len(t) == K + M for t in acked.values())

    def daemon_shards(name):
        io = rc.ec_backend(1).io
        pg = rc._pg_for(rc.osdmap.pools[1], name)
        return [io.get_shard_bytes(pg, s, name) for s in range(K + M)]

    zero0 = perf("wire.zero").dump()
    v = Vstart(PC_DIR)
    t0 = time.perf_counter()
    v.start(PC_OSDS, hb_interval=0.5)
    times["daemons_start_s"] = time.perf_counter() - t0
    daemon_pids = {n: p.pid for n, p in v.procs.items() if n != "mon"}
    undo = contextlib.ExitStack()
    undo.enter_context(launch_shapes(seen))
    crcutil.note_scan = observed_scan
    crcutil.Csums.scan = classmethod(observed_csums_scan)
    wire._frame_parts = observed_frame_parts
    try:
        rc = RemoteCluster(PC_DIR, ec_profiles={"p": dict(PC_PROFILE)})
        for _ in range(240):
            if all(rc.mon_call({"cmd": "get_map"})["osd_up"][:PC_OSDS]):
                break
            time.sleep(0.25)
        else:
            fail("process cluster: not every OSD came up in the map")
        rc.refresh_map()
        codec = rc.codec_for(rc.osdmap.pools[1])
        if codec.device.type != "cuda" or not rc.ec_backend(1) \
                .words_supported():
            fail("process cluster: the client's codec is not bitsliced "
                 "on the card")
        torch.cuda.reset_peak_memory_stats()
        payload = random_words((PC_OBJECTS * S, K, W), gen, device)
        xor_kernel.launches = 0
        gf_pallas.launches = 0
        gf_pallas.fused_launches = 0

        # 1. staged put, two rounds
        for r in range(PC_ROUNDS):
            acked = timed(f"staged_put_{r + 1}",
                          lambda: rc.put_many_from_device(
                              1, names, payload, durable=False), placed)
            if sorted(acked) != names:
                fail("process cluster: a staged object was not placed")
        staged_bytes = rc.dev.stats()["bytes"]
        want = PC_OBJECTS * (K + M) * S * PC_SU
        if staged_bytes != want:
            fail(f"process cluster: {staged_bytes} B staged, wanted {want}")
        apps = compute_app_pids()
        held = sorted(n for n, pid in daemon_pids.items() if pid in apps)
        opened = sorted(n for n, pid in daemon_pids.items()
                        if opens_nvidia_devices(pid))
        if not opens_nvidia_devices(os.getpid()):
            fail("process cluster: the device probe sees no card in the "
                 "smoke's own process")
        if held or opened:
            fail(f"process cluster: a daemon holds a CUDA context: "
                 f"listed by nvidia-smi {held}, /dev/nvidia* open {opened}")
        pool = rc.osdmap.pools[1]
        p0 = payload[:S]
        want0 = pc_expected_shards(p0)
        for sh in range(K + M):
            key = (1, rc._pg_for(pool, names[0]), names[0], sh)
            ref = rc.dev.dirty_get(key)
            if ref is None or \
                    ref.materialize().cpu().numpy().tobytes() != want0[sh]:
                fail(f"process cluster: staged shard {sh} of {names[0]} "
                     f"differs from the CPU plain encode")
        staged_peak = torch.cuda.max_memory_allocated()
        rc.dev.clear()          # only the flush object's shards stay dirty

        # 2. flush: one 64 MiB object staged, then read back, csummed on
        # the card and committed to its daemons
        timed("flush_stage", lambda: rc.put_many_from_device(
            1, ["fl0"], payload[:fS], durable=False), placed)
        flushed = []
        timed("flush", lambda: flushed.append(rc.flush_staged(1)),
              lambda _r: not any(True for _ in rc.dev.dirty_items()))
        if sum(flushed) != K + M:
            fail(f"process cluster: flushed {sum(flushed)} shards")
        rb, want_rb = steps["flush"]["readback_bytes"], (K + M) * fS * PC_SU
        # a flush tried again reads the buffers of what stayed dirty again
        if rb < want_rb or (tries["flush"] == 1 and rb != want_rb):
            fail(f"process cluster: the flush read back {rb} B")
        if daemon_shards("fl0") != pc_expected_shards(payload[:fS]):
            fail("process cluster: fl0's shards on the daemons differ "
                 "from the CPU plain encode")

        # 3. durable put
        acked = timed("durable_put", lambda: rc.put_many(1, dnames, ddatas),
                      lambda r: all(a == K + M for a in r.values()))
        if len(acked) != len(dnames):
            fail(f"process cluster: durable put acks {acked}")
        if daemon_shards(dnames[0]) != pc_expected_shards(
                pc_words(ddatas[0])):
            fail(f"process cluster: {dnames[0]}'s shards on the daemons "
                 f"differ from the CPU plain encode")

        # 4. two shard holders killed, their staged entries evicted
        up = rc._up(pool, rc._pg_for(pool, dnames[0]))
        victims = [o for o in up if o >= 0][:2]
        for o in victims:
            v.kill9(f"osd.{o}")
        for key in list(rc.dev._entries):
            upk = rc._up(pool, key[1])
            if key[3] < len(upk) and upk[key[3]] in victims:
                rc.dev.evict(key)
        allnames = dnames + ["fl0"]
        wants = [pc_words(d).to(device) for d in ddatas] + [payload[:fS]]
        outs = timed("degraded_get_many_to_device",
                     lambda: rc.get_many_to_device(1, allnames))
        for nm, got, w in zip(allnames, outs, wants):
            if not torch.equal(got, w):
                fail(f"process cluster: degraded device read of {nm} "
                     f"differs")
        del outs
        fl_bytes = payload[:fS].cpu().numpy().tobytes()
        gets = timed("degraded_get", lambda: [rc.get(1, nm)
                                              for nm in allnames])
        if gets != ddatas + [fl_bytes]:
            fail("process cluster: a degraded read differs")

        # 5. out, recovery, every object read again
        for o in victims:
            rc.mon_call({"cmd": "mark_out", "osd": o})
        rc.refresh_map()
        rec = {}
        for attempt in range(5):
            st = timed(f"recover_ec_pool_{attempt + 1}",
                       lambda: rc.recover_ec_pool(1))
            for kk, val in st.items():
                rec[kk] = rec.get(kk, 0) + val
            if not st.get("deferred_pgs"):
                break
        else:
            fail(f"process cluster: recovery kept deferring PGs: {rec}")
        if rec.get("shards_rebuilt", 0) <= 0 or rec.get("unrecoverable"):
            fail(f"process cluster: recovery {rec}")
        rc.dev.clear()
        gets = timed("get_after_recovery", lambda: [rc.get(1, nm)
                                                    for nm in allnames])
        if gets != ddatas + [fl_bytes]:
            fail("process cluster: a read after recovery differs")
        for nm, w in ((dnames[0], pc_words(ddatas[0])),
                      ("fl0", payload[:fS])):
            want_sh = pc_expected_shards(w)
            got_sh = daemon_shards(nm)
            if any(g is not None and g != x for g, x in zip(got_sh, want_sh)):
                fail(f"process cluster: {nm}'s shards after recovery "
                     f"differ from the CPU plain encode")
        zero = {k: v - zero0.get(k, 0)
                for k, v in perf("wire.zero").dump().items()}
        peak = torch.cuda.max_memory_allocated()
        # every launch since the counts were set to 0, the steps' and
        # the smoke's own daemon_shards reads (their reply verifies)
        launched = {"k1": xor_kernel.launches,
                    "k3": gf_pallas.fused_launches}
        rc.close()
    finally:
        undo.close()
        crcutil.note_scan = note_scan
        crcutil.Csums.scan = scan_descriptor
        wire._frame_parts = frame_parts
        v.stop()
        shutil.rmtree(PC_DIR, ignore_errors=True)
    if host_payload["scans"] or host_payload["unfolded_sends"]:
        fail(f"process cluster: the client crc'd payload blocks on the "
             f"host: {host_payload['scans'][:8]} scans, "
             f"{host_payload['unfolded_sends'][:8]} unfolded sends")
    total = {k: sum(d[k] for d in steps.values())
             for k in ("k1", "k3", "device_crc_bytes", "readback_bytes")}
    if launched["k1"] != total["k1"]:
        fail(f"process cluster: K1 launched {launched['k1']} times, "
             f"{total['k1']} of them in the steps")
    return {"osds": PC_OSDS, "pg_num": PC_PG_NUM, "k": K, "m": M,
            "stripe_unit": PC_SU, "staged_objects": PC_OBJECTS,
            "staged_object_bytes": PC_OBJ_BYTES, "rounds": PC_ROUNDS,
            "flush_bytes": PC_FLUSH_BYTES,
            "durable_objects": len(dnames),
            "durable_object_bytes": PC_DURABLE_BYTES,
            "staged_bytes": staged_bytes, "staged_peak_bytes": staged_peak,
            "max_memory_allocated": peak, "victims": victims,
            "recover": rec, "steps": steps, "tries": tries,
            "launch_shapes": shapes,
            "client_host_scans": scans, "wire_zero": zero,
            "compute_app_pids": apps, "own_pid": os.getpid(),
            "own_pid_listed": os.getpid() in apps,
            "daemon_pids": daemon_pids, "k1_launches": launched["k1"],
            "k3_launches": launched["k3"],
            "k3_launches_in_checks": launched["k3"] - total["k3"],
            "device_crc_bytes": total["device_crc_bytes"],
            "readback_bytes": total["readback_bytes"], **times,
            "gpu": card}


def pc_csum_timing(device, card: str) -> dict:
    """The durable put's checksum step three ways, at its shape (16
    objects x 11 shards of 1 MiB): a host scan per sub-write (the
    reference's fan-out), K3's crc leg over the host bytes uploaded again,
    and K3's crc leg over the shards' copies on the card (the port's
    fan-out).  Wall milliseconds, median of 5, a synchronize before each
    clock stops; the three must give the same Csums."""
    from ceph_tpu_torch.common import crcutil
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    n = PC_OBJECTS * (K + M)
    shards = torch.randint(0, 256, (n, PC_SU), dtype=torch.uint8,
                           device=device, generator=gen)
    hosts = [h.numpy() for h in shards.cpu()]
    tensors = list(shards)

    def host_scan():
        return [crcutil.Csums.scan(h, site="client") for h in hosts]

    def upload():
        return crc32_gf2.csums_many(hosts)

    def on_card():
        return crc32_gf2.csums_many(hosts, tensors=tensors)

    out = {"shards": n, "shard_bytes": PC_SU, "gpu": card}
    want = None
    for name, fn in (("host_scan", host_scan), ("device_upload", upload),
                     ("device_from_card", on_card)):
        ms = []
        for _ in range(5):
            sync(device)
            t0 = time.perf_counter()
            got = fn()
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        got = [(c.subs, c.length) for c in got]
        if want is None:
            want = got
        elif got != want:
            fail(f"durable put csums: {name} differs from the host scan")
        out[f"{name}_ms"] = sorted(ms)[2]
    return out


# ------------------------------------------------------------ phase 11 --
# The failure pipeline and the block tier on the cluster step's map
# (32 hosts x 4 OSDs, straw2): a 3-replica pool (CHOOSELEAF_FIRSTN host)
# and an RS(8,3) bitsliced pool (CHOOSELEAF_INDEP host), their pg_num set
# so the PG replicas come to about 100 per OSD, Ceph's
# mon_target_pg_per_osd default: (2,048 x 3 + 512 x 11) / 128 = 92.
P11_REP_PGS = 2048
P11_EC_PGS = 512
P11_OBJ = 4 << 20             # RADOS's and RBD's object size (order 22)
P11_IMAGE = 1 << 30          # 256 objects of 4 MiB
P11_SHRINK = P11_IMAGE - 12345
P11_RANDOM_WRITES = 256       # 4 KiB each
P11_MIRROR_IMAGE = 256 << 20
P11_MIRROR_BIG, P11_MIRROR_SMALL = 16, 64
P11_NEO_OBJECTS = 64
P11_CYCLES = 8
P11_PROFILE = {"plugin": "jax", "k": str(K), "m": str(M),
               "technique": "reed_sol_van", "layout": "bitsliced"}


def p11_osdmap(device):
    """The phase's OSDMap on ``device``: pool 1 replicated, pool 2 EC."""
    from ceph_tpu_torch.cluster.osdmap import (OSDMap, PGPool, POOL_ERASURE,
                                               POOL_REPLICATED)
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE,
        Rule)
    cmap, root = build_flat_cluster(n_hosts=32, osds_per_host=4)
    for op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
        cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0), (op, 0, TYPE_HOST),
                                  (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                       pg_num=P11_REP_PGS, crush_rule=0))
    om.add_pool(PGPool(id=2, name="ec", type=POOL_ERASURE, size=K + M,
                       pg_num=P11_EC_PGS, crush_rule=1,
                       erasure_code_profile="default"))
    return om


def p11_stack(device):
    """A ClusterSim and its Monitor on the phase's map, as the thrasher's
    ``build_default_stack`` wires them."""
    from ceph_tpu_torch.cluster.monitor import Monitor
    from ceph_tpu_torch.cluster.simulator import ClusterSim
    sim = ClusterSim(p11_osdmap(device), device=device)
    sim.create_ec_profile("default", dict(P11_PROFILE))
    codec = sim.codec_for(sim.osdmap.pools[2])
    check_devices(codec, device, "phase 11 EC pool")
    if not sim._device_staging(codec):
        fail("phase 11: the RS(8,3) pool did not take the HBM staging tier")
    return sim, Monitor(sim.osdmap, failure_reports_needed=2)


def p11_step(device, label: str, fn, steps: dict):
    """Run one step of phase 11 with the kernels' counts set to 0 just
    before and read just after (K1's launches by shape); records the
    step's wall time and accounting in ``steps`` and returns ``fn()``'s
    result."""
    shapes = {}

    def seen(kernel, key):
        if kernel == "k1":
            shapes[key] = shapes.get(key, 0) + 1

    def snap():
        return counters() + (crc32_gf2.plain_runs,)

    sync(device)
    with launch_shapes(seen):
        c0 = snap()
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
    _, _, p1, p2, disp, rebuild, p3 = (b - a for a, b in zip(c0, snap()))
    k1, k2, k3 = xor_kernel.launches, gf_pallas.launches, \
        gf_pallas.fused_launches
    steps[label] = {"s": wall, "k1_launches": k1, "ec_dispatches": disp,
                    "rebuild_dispatches": rebuild, "k1_shapes": shapes}
    if p1 or p2 or p3:
        fail(f"phase 11 {label}: a plain version ran ({p1}, {p2}, {p3})")
    if k2 or k3:
        fail(f"phase 11 {label}: K2 launched {k2}, K3 {k3} on the K1 path")
    if k1 != disp + rebuild:
        fail(f"phase 11 {label}: K1 launched {k1} times; the step made "
             f"{disp} ec.jax and {rebuild} rebuild dispatches")
    return out


def p11_thrash(device, seed: int, netsplit: bool) -> dict:
    """11a: one seeded Thrasher soak over both pools on the card; every
    invariant must hold."""
    from ceph_tpu_torch.cluster.thrasher import (NETSPLIT_FAULTPOINTS,
                                                 Thrasher, ThrashConfig)
    from ceph_tpu_torch.common import faults
    sim, mon = p11_stack(device)
    cfg = ThrashConfig(seed=seed, objects=32, object_size=P11_OBJ,
                       cycles=P11_CYCLES, max_down=2)
    if netsplit:                      # what `ceph thrash --netsplit` sets
        cfg.netsplit = True
        cfg.faultpoints = NETSPLIT_FAULTPOINTS
        cfg.settle_ticks = max(cfg.settle_ticks, 40)
    label = "netsplit" if netsplit else "kill_revive"
    steps = {}
    thr = Thrasher(sim, mon, [1, 2], cfg)
    # the soak's payloads come from the thrasher's seeded per-byte
    # generator; its time is read apart from the rest of the soak
    blob, payloads = thr._blob, {"n": 0, "s": 0.0}

    def timed_blob(n):
        t0 = time.perf_counter()
        out = blob(n)
        payloads["s"] += time.perf_counter() - t0
        payloads["n"] += 1
        return out
    thr._blob = timed_blob
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    try:
        report = p11_step(device, label, thr.run, steps)
    finally:
        sim.shutdown()
        faults.reset()
    if not report["ok"]:
        fail(f"phase 11 thrash ({label}, seed {seed}): "
             f"{report['failures']}")
    st = steps[label]
    if st["k1_launches"] == 0:
        fail(f"phase 11 thrash ({label}): K1 never launched")
    return {"soak": label, "seed": seed, "cycles": cfg.cycles,
            "objects": cfg.objects, "object_bytes": cfg.object_size,
            "wall_s": st["s"], "payloads": payloads["n"],
            "payload_generation_s": payloads["s"],
            "ticks_to_health_ok": report["invariants"]["health_ticks"],
            "k1_launches": st["k1_launches"],
            "ec_dispatches": st["ec_dispatches"],
            "rebuild_dispatches": st["rebuild_dispatches"],
            "k1_launch_shapes": st["k1_shapes"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "report": report}


def p11_block_tier(device) -> dict:
    """11b: an RBD image in the RS(8,3) pool (write whole, seeded random
    4 KiB writes, snapshot, protect, clone, flatten, unaligned shrink,
    every byte of image and clone against a host oracle); rbd-mirror of a
    journaled image onto a second ClusterSim on the card; neorados's
    concurrent 4 MiB writes and reads."""
    import asyncio
    from ceph_tpu_torch.client.neorados import AsyncRados
    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.client.rbd import RBD, Image
    from ceph_tpu_torch.client.rbd_mirror import JournaledImage, \
        MirrorReplayer
    steps = {}
    rng = np.random.default_rng(SEED + 11)
    sim_a, mon_a = p11_stack(device)
    sim_b, mon_b = p11_stack(device)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    try:
        rados_a = Rados(sim_a, mon_a).connect()
        io_a = rados_a.open_ioctx("ec")
        io_b = Rados(sim_b, mon_b).connect().open_ioctx("ec")
        # ---- RBD
        rbd = RBD(io_a)
        rbd.create("vol", size=P11_IMAGE, order=22)
        img = Image(io_a, "vol")
        oracle = bytearray(rng.integers(0, 256, P11_IMAGE, dtype=np.uint8)
                           .tobytes())

        def write_whole():
            for off in range(0, P11_IMAGE, P11_OBJ):
                img.write(off, bytes(oracle[off:off + P11_OBJ]))
        p11_step(device, "rbd_write_image", write_whole, steps)
        offs = rng.integers(0, P11_IMAGE // 4096, P11_RANDOM_WRITES) * 4096
        blocks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                  for _ in offs]

        def random_writes():
            for off, blk in zip(offs, blocks):
                img.write(int(off), blk)
                oracle[int(off):int(off) + 4096] = blk
        p11_step(device, "rbd_random_4k_writes", random_writes, steps)

        def snap_clone_flatten():
            img.snap_create("s1")
            img.protect_snap("s1")
            rbd.clone("vol", "s1", "clone")
            Image(io_a, "clone").flatten()
        p11_step(device, "rbd_snap_protect_clone_flatten",
                 snap_clone_flatten, steps)
        p11_step(device, "rbd_unaligned_shrink",
                 lambda: img.resize(P11_SHRINK), steps)

        def read_back():
            return (Image(io_a, "vol").read(0, P11_IMAGE),
                    Image(io_a, "clone").read(0, P11_IMAGE))
        got_img, got_clone = p11_step(device, "rbd_read_back", read_back,
                                      steps)
        if len(got_img) != P11_SHRINK or \
                got_img != bytes(oracle[:P11_SHRINK]):
            fail("phase 11 rbd: the shrunk image differs from its oracle")
        if got_clone != bytes(oracle):
            fail("phase 11 rbd: the flattened clone differs from its "
                 "oracle")
        if Image(io_a, "clone").parent is not None or \
                Image(io_a, "vol").snap_list() != ["s1"]:
            fail("phase 11 rbd: clone still linked or snapshot list wrong")
        del got_img, got_clone, oracle
        # ---- rbd-mirror: site A's journaled image onto site B
        RBD(io_a).create("mirror", size=P11_MIRROR_IMAGE, order=22)
        prim = JournaledImage(io_a, "mirror")
        moracle = bytearray(P11_MIRROR_IMAGE)
        stride = P11_MIRROR_IMAGE // P11_MIRROR_BIG
        big = [(i * stride, rng.integers(0, 256, P11_OBJ, dtype=np.uint8)
                .tobytes()) for i in range(P11_MIRROR_BIG)]
        small = [(int(o) * 4096, rng.integers(0, 256, 4096, dtype=np.uint8)
                  .tobytes()) for o in rng.integers(
                      0, P11_MIRROR_IMAGE // 4096, P11_MIRROR_SMALL)]

        def journaled_writes():
            for off, data in big + small:
                prim.write(off, data)
                moracle[off:off + len(data)] = data
        p11_step(device, "mirror_journaled_writes", journaled_writes, steps)
        rep = MirrorReplayer(io_a, io_b, "mirror", peer="site-b")
        applied = p11_step(device, "mirror_replay", rep.replay, steps)
        sec = Image(io_b, "mirror").read(0, P11_MIRROR_IMAGE)
        if applied != P11_MIRROR_BIG + P11_MIRROR_SMALL or \
                sec != bytes(moracle) or \
                prim.read(0, P11_MIRROR_IMAGE) != bytes(moracle):
            fail(f"phase 11 rbd-mirror: {applied} entries applied, or the "
                 f"secondary differs from the primary")
        again = rep.replay()
        trimmed = rep.trim_committed()
        after_trim = rep.replay()
        if again or after_trim:
            fail(f"phase 11 rbd-mirror: a second replay applied {again}, "
                 f"after trim {after_trim}")
        del sec, moracle
        # ---- neorados: concurrent 4 MiB write_full, then read
        blobs = [rng.integers(0, 256, P11_OBJ, dtype=np.uint8).tobytes()
                 for _ in range(P11_NEO_OBJECTS)]

        def neorados(verb):
            async def flow():
                async with AsyncRados(rados_a) as ar:
                    io = await ar.open_ioctx("ec")
                    if verb == "write":
                        return await asyncio.gather(*[
                            io.write_full(f"neo{i}", b)
                            for i, b in enumerate(blobs)])
                    return await asyncio.gather(*[
                        io.read(f"neo{i}") for i in range(len(blobs))])
            return asyncio.run(flow())
        p11_step(device, "neorados_write_full",
                 lambda: neorados("write"), steps)
        got = p11_step(device, "neorados_read", lambda: neorados("read"),
                       steps)
        if list(got) != blobs:
            fail("phase 11 neorados: a read differs from its write")
        rados_a.shutdown()
    finally:
        sim_a.shutdown()
        sim_b.shutdown()
    return {"image_bytes": P11_IMAGE, "order": 22,
            "random_4k_writes": P11_RANDOM_WRITES, "shrunk_to": P11_SHRINK,
            "mirror_image_bytes": P11_MIRROR_IMAGE,
            "mirror_entries_applied": applied,
            "mirror_objects_trimmed": trimmed,
            "neorados_objects": P11_NEO_OBJECTS, "steps": steps,
            "k1_launches": sum(s["k1_launches"] for s in steps.values()),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


class P11Stats:
    """The two ClusterStats surfaces the balancer advisor reads: seeded
    per-PG heat rows (a zipf over the pool's PGs) and per-OSD
    utilization."""

    def __init__(self, om, pool: int):
        rng = np.random.default_rng(SEED + 12)
        heat = rng.zipf(1.3, om.pools[pool].pg_num).astype(np.float64)
        self.rows = sorted(({"pgid": f"{pool}.{pg}", "pool": pool,
                             "heat": float(min(h, 1e4))}
                            for pg, h in enumerate(heat)),
                           key=lambda r: -r["heat"])
        util = rng.uniform(0.05, 0.6, om.max_osd)
        self.df = [{"daemon": f"osd.{o}", "utilization": float(u)}
                   for o, u in enumerate(util)]

    def pg_heat(self, pool=None, top=None):
        rows = [r for r in self.rows if pool is None or r["pool"] == pool]
        return rows[:top] if top else rows

    def osd_df(self):
        return self.df


def p11_balancer(device) -> dict:
    """11c: calc_pg_upmaps on the 3-replica pool through the card's
    mapper, and the balancer advisor's dry run; both against the same
    calls on a CPU copy of the map."""
    from ceph_tpu_torch.cluster.balancer import (calc_pg_upmaps,
                                                 osd_ancestors,
                                                 rule_failure_domain)
    from ceph_tpu_torch.convert import osdmap_from_state, osdmap_state
    from ceph_tpu_torch.mgr.balancer_advisor import evaluate
    from ceph_tpu_torch.placement.crush_map import ITEM_NONE
    om = p11_osdmap(device)
    cpu = osdmap_from_state(osdmap_state(om), device="cpu")
    stats = P11Stats(om, 1)
    pc = perf("crush.mapper")
    steps = {}
    f0 = pc.dump().get("fallback_lanes", 0)
    e0 = om.epoch
    report = p11_step(device, "balancer_evaluate",
                      lambda: evaluate(om, stats, max_moves=8, pool=1),
                      steps)
    if om.epoch != e0 or report["epoch"] != e0:
        fail("phase 11 balancer: the advisor moved the map's epoch")
    res = p11_step(device, "calc_pg_upmaps",
                   lambda: calc_pg_upmaps(om, pool_ids=[1]), steps)
    fallback = pc.dump().get("fallback_lanes", 0) - f0
    want_report = evaluate(cpu, stats, max_moves=8, pool=1)
    want = calc_pg_upmaps(cpu, pool_ids=[1])
    if report != want_report:
        fail("phase 11 balancer: the advisor's report differs from the "
             "CPU copy's")
    if om.pg_upmap_items != cpu.pg_upmap_items or \
            (res.rounds, res.moves, res.max_deviation_before,
             res.max_deviation_after) != \
            (want.rounds, want.moves, want.max_deviation_before,
             want.max_deviation_after):
        fail("phase 11 balancer: pg_upmap_items differ from the CPU copy's")
    if not res.moves or res.max_deviation_after >= res.max_deviation_before:
        fail(f"phase 11 balancer: the deviation did not fall "
             f"({res.max_deviation_before} -> {res.max_deviation_after})")
    if fallback:
        fail(f"phase 11 balancer: {fallback} lanes fell back to the host")
    anc = osd_ancestors(om.crush, rule_failure_domain(om.crush, 0))
    for (pid, pg) in om.pg_upmap_items:
        up = [o for o in om.pg_to_up_acting_osds(pid, pg)[0]
              if o != ITEM_NONE]
        doms = [int(anc[o]) for o in up]
        if len(doms) != len(set(doms)):
            fail(f"phase 11 balancer: PG {pid}.{pg} collapsed hosts {up}")
    return {"pool": 1, "pg_num": P11_REP_PGS, "osds": om.max_osd,
            "rounds": res.rounds, "moves": res.moves,
            "max_deviation_before": res.max_deviation_before,
            "max_deviation_after": res.max_deviation_after,
            "upmap_pgs": len(om.pg_upmap_items), "fallback_lanes": fallback,
            "advisor_score_before": report["score_before"],
            "advisor_score_after": report["score_after"],
            "advisor_moves": report.get("moves", 0), "steps": steps}


# ------------------------------------------------------------ phase 12 --
#
# The sharded data plane on one card: a mesh of P12_CELLS cells that all
# lie on cuda:0 (the port's meshes may repeat a device), 1-D and 2 x 2.

P12_CELLS = 4
P12_LAYOUTS = ((0, "1d"), (2, "2x2"))


def p12_meshes(device) -> dict:
    from ceph_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    cells = [device] * P12_CELLS
    return {"1d": make_mesh(P12_CELLS, devices=cells),
            "2x2": make_mesh_2d(2, 2, devices=cells)}


def p12_cluster(device, card: str) -> dict:
    """(a) ``entry.cluster_sharded`` at phase 6's size on each layout,
    the kernels' counts set to 0 just before each call and read just
    after: K1's launches while the plane is on must be the cells times
    the plane's put + decode + recover dispatches, those of the plane-off
    run its ec.jax + rebuild dispatches; then the psum of one ragged
    dispatch on the same plane read back."""
    from ceph_tpu_torch import entry
    from ceph_tpu_torch.parallel import data_plane
    masks = xor_kernel.masks_to_device(
        gf.gf8_bitmatrix(gf.vandermonde_parity(K, M)), device)
    out = {}
    for stripes, name in P12_LAYOUTS:
        on_k1 = [0]

        def seen(kernel, key):
            if kernel == "k1" and data_plane.enabled():
                on_k1[0] += 1

        sync(device)
        with launch_shapes(seen):
            c0 = counters()
            t0 = time.perf_counter()
            sec = entry.cluster_sharded(
                P12_CELLS, stripes=stripes, device=device, seed=SEED,
                k=K, m=M, n_hosts=32, osds_per_host=4, pg_num=256,
                stripe_unit=128 << 10, technique="reed_sol_van",
                n_objects=64, obj_bytes=4 << 20, n_victims=M)
            sync(device)
            wall = time.perf_counter() - t0
        _, _, p1, p2, disp, rebuild = (b - a for a, b in zip(c0, counters()))
        k1, k2, k3 = (xor_kernel.launches, gf_pallas.launches,
                      gf_pallas.fused_launches)
        plane = (sec["put_dispatches"] + sec["decode_dispatches"] +
                 sec["recover_dispatches"])
        if p1 or p2:
            fail(f"phase 12 {name}: a plain version ran ({p1}, {p2})")
        if k2 or k3 or plane == 0 or on_k1[0] != P12_CELLS * plane or \
                k1 != disp + rebuild - plane + P12_CELLS * plane:
            fail(f"phase 12 {name}: K1 launched {k1} times ({on_k1[0]} with "
                 f"the plane on, {plane} plane dispatches x {P12_CELLS} "
                 f"cells), the path made {disp} ec.jax + {rebuild} rebuild "
                 f"dispatches; K2 {k2}, K3 {k3}")
        per = sec["per_chip"]
        if sorted(per) != [str(i) for i in range(P12_CELLS)] or \
                any(c.get("put_stripes", 0) <= 0 for c in per.values()):
            fail(f"phase 12 {name}: a cell counted no put stripes: {per}")
        if sec["recover"]["shards_rebuilt"] <= 0:
            fail(f"phase 12 {name}: recovery rebuilt nothing")
        words = random_words((13, 8 * K, 4096),
                             torch.Generator(device=device).manual_seed(SEED),
                             device)
        with entry.plane_cells(P12_CELLS, stripes, device) as dp:
            got = dp.xor_matmul_w32(masks, words)
            psum = dp.psum_probe()
        padded = 16 if not stripes else 14
        if psum != padded or not torch.equal(
                got, xor_kernel.xor_matmul_w32(masks, words)):
            fail(f"phase 12 {name}: psum {psum} (padded rows {padded}) or "
                 f"the ragged dispatch differs from the unsharded K1")
        out[name] = {"k1_launches": k1, "k1_launches_plane_on": on_k1[0],
                     "plane_k1_dispatches": plane, "wall_s": wall,
                     "psum_probe": psum, **sec}
        emit({"phase": "p12_cluster_sharded", "mesh": name, **out[name],
              "gpu": card})
        torch.cuda.empty_cache()
    return out


def p12_ragged(device, card: str, zw_pool: np.ndarray) -> dict:
    """(b) the ZeroWire pool through ``fused_ragged`` on each layout:
    parity and crcs equal to one unsharded K3 launch, K3 launched once per
    cell; each cell's block timed beside the unsharded launch."""
    from ceph_tpu_torch import entry
    rs42 = gf.gf8_bitmatrix(gf.isa_rs_parity(ZW_K, ZW_M))
    pool = torch.from_numpy(zw_pool).to(device)
    G = pool.shape[0]
    want = gf_pallas.fused_ragged_matmul(rs42, pool)
    full_ms = graph_ms(lambda: gf_pallas.fused_ragged_matmul(rs42, pool),
                       iters=10)
    out = {"launches": 0}
    for stripes, name in P12_LAYOUTS:
        with entry.plane_cells(P12_CELLS, stripes, device) as dp:
            n0 = gf_pallas.fused_launches
            got = dp.fused_ragged(rs42, pool, pool.shape[2])
            sync(device)
            n = gf_pallas.fused_launches - n0
            if n != P12_CELLS:
                fail(f"phase 12 ragged {name}: K3 launched {n} times on "
                     f"{P12_CELLS} cells")
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"phase 12 ragged {name}: the plane differs from one "
                     f"unsharded K3 launch")
            del got
            plane_ms = cuda_ms(lambda: dp.fused_ragged(rs42, pool,
                                                       pool.shape[2]),
                               iters=3, warmup=1)
        rows = P12_CELLS if not stripes else 2
        block = pool[:-(-G // rows)]
        cell_ms = graph_ms(lambda: gf_pallas.fused_ragged_matmul(rs42, block),
                           iters=10)
        out["launches"] += n
        out[name] = {"cell_blocks": int(block.shape[0]), "cell_ms": cell_ms,
                     "cells_ms": P12_CELLS * cell_ms,
                     "unsharded_ms": full_ms, "plane_call_ms": plane_ms,
                     "k3_launches": n}
        emit({"phase": "p12_ragged", "mesh": name, "pool": [G, ZW_K, 4096],
              **out[name], "gpu": card})
        torch.cuda.empty_cache()
    return out


def p12_steps(device, card: str, gen) -> dict:
    """(c) the distributed encode steps on each mesh: K2 at [128, 8,
    131072], K1 at [512, 64, 4096]; each equal to the unsharded kernel,
    its byte counter equal to the int64 sum of the data's values, the
    kernel launched once per cell; each cell's block timed beside the
    unsharded launch."""
    from ceph_tpu_torch.parallel import mesh as pmesh
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(K, M))
    masks = xor_kernel.masks_to_device(bitmat, device)
    data = torch.randint(0, 256, (128, K, 131072), dtype=torch.uint8,
                         device=device, generator=gen)
    words = random_words((512, 8 * K, 4096), gen, device)
    cases = {
        "k2": (lambda m: pmesh.distributed_encode_step(m, bitmat, data),
               lambda d: gf_pallas.bitplane_matmul(bitmat, d), data,
               lambda: gf_pallas.launches),
        "k1": (lambda m: pmesh.distributed_xor_encode_step(m, masks, words),
               lambda d: xor_kernel.xor_matmul_w32(masks, d), words,
               lambda: xor_kernel.launches)}
    out = {"k1_launches": 0, "k2_launches": 0}
    for kern, (step, unsharded, operand, count) in cases.items():
        want = unsharded(operand)
        total_want = int(operand.sum(dtype=torch.int64))
        full_ms = graph_ms(lambda: unsharded(operand), iters=10)
        for name, m in p12_meshes(device).items():
            n0 = count()
            t0 = time.perf_counter()
            got, total = step(m)
            sync(device)
            wall = time.perf_counter() - t0
            n = count() - n0
            if n != P12_CELLS or not torch.equal(got, want) or \
                    int(total) != total_want:
                fail(f"phase 12 {kern} step {name}: {n} launches, parity "
                     f"equal {torch.equal(got, want)}, bytes {int(total)} "
                     f"vs {total_want}")
            del got
            per = operand.shape[0] // pmesh.batch_sharding(m).blocks
            cell_ms = graph_ms(lambda: unsharded(operand[:per]), iters=10)
            out[f"{kern}_launches"] += n
            out[f"{kern}_{name}"] = {
                "operand": list(operand.shape), "cell_rows": per,
                "cell_ms": cell_ms, "cells_ms": P12_CELLS * cell_ms,
                "unsharded_ms": full_ms, "step_wall_s": wall,
                "launches": n, "byte_counter": total_want}
            emit({"phase": "p12_step", "kernel": kern, "mesh": name,
                  **out[f"{kern}_{name}"], "gpu": card})
    del data, words
    torch.cuda.empty_cache()
    return out


def p12_sweep(device, card: str, up0: np.ndarray) -> dict:
    """(d) phase 4's 2^20-PG sweep through ``map_pgs_batch`` with the
    plane's 4-cell mesh: equal to phase 4's sweep without one, every cell
    mapping a quarter of the lanes, no kernel launched."""
    from ceph_tpu_torch import entry
    n_pgs = int(up0.shape[0])
    _, om = sweep_map(device, n_pgs)
    perf("dataplane").reset()
    k0 = (xor_kernel.launches, gf_pallas.launches, gf_pallas.fused_launches)
    with entry.plane_cells(P12_CELLS, 0, device):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        up, _ = om.map_pgs_batch(1)
        sync(device)
        wall = time.perf_counter() - t0
    d = perf("dataplane").dump()
    lanes = [d.get(f"shard{i}.map_lanes", 0) for i in range(P12_CELLS)]
    if not np.array_equal(up, up0):
        fail("phase 12 sweep: the mesh's sweep differs from phase 4's")
    if lanes != [n_pgs // P12_CELLS] * P12_CELLS or k0 != (
            xor_kernel.launches, gf_pallas.launches,
            gf_pallas.fused_launches):
        fail(f"phase 12 sweep: cell lanes {lanes}, or a kernel launched")
    res = {"pgs": n_pgs, "map_pgs_batch_s": wall, "cell_lanes": lanes,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit({"phase": "p12_sweep", **res, "gpu": card})
    return res


def p12_nccl(device, card: str, gen) -> dict:
    """(e) ``multihost``'s cross-rank legs on CUDA tensors in a one-rank
    NCCL group started here (the fleet rule of ``ensure_initialized``
    needs 2 or more processes): all_reduce and the tiled all-gather at
    the rebuild's output shape [512, 24, 4096] int32, each equal to the
    result inside the process; the group is destroyed after."""
    import datetime

    import torch.distributed as dist

    from ceph_tpu_torch.parallel import multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        x = random_words((512, 8 * M, 4096), gen, device)
        red = multihost.all_reduce_sum(x)
        blocks = list(x.chunk(P12_CELLS))
        gat = multihost.all_gather_cells(blocks, device)
        sync(device)
        if red.dtype != x.dtype or not torch.equal(red, x) or \
                not torch.equal(gat, torch.stack(blocks)):
            fail("phase 12 nccl: a collective differs from the result "
                 "inside the process")
        res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
               "shape": list(x.shape),
               "all_reduce_ms": cuda_ms(lambda: multihost.all_reduce_sum(x),
                                        iters=10),
               "all_gather_ms": cuda_ms(
                   lambda: multihost.all_gather_cells(blocks, device),
                   iters=10)}
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        fail("phase 12 nccl: the group outlived destroy_process_group")
    emit({"phase": "p12_nccl", **res, "gpu": card})
    return res


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_k2(shapes, card: str) -> dict:
    """K2's device time at the batched encode, put, decode and ragged
    shapes and at LRC's global layer and CLAY's pft and mds calls, beside its bound, its plain version and its launch floor (an
    empty kernel at K2's grid, by graph replay like K2; None where the
    package has no floor entry point)."""
    out = {}
    floor = getattr(gf_pallas, "bitplane_floor", None)
    for name in ("encode", "put", "decode", "ragged", "lrc_global",
                 "clay_pft", "clay_mds"):
        bitmat, data = shapes[name]
        B, k, L = data.shape
        m = bitmat.shape[0] // 8
        bm_dev = torch.as_tensor(bitmat, device=data.device)
        n0 = gf_pallas.launches
        ms = graph_ms(lambda: gf_pallas.bitplane_matmul(bitmat, data),
                      iters=50)
        call_ms = cuda_ms(lambda: gf_pallas.bitplane_matmul(bitmat, data),
                          iters=50)
        if gf_pallas.launches - n0 != 2 + 50 + 2 + 50:
            fail("K2 timing: a wrapper call did not launch the kernel")
        floor_ms = None if floor is None else \
            graph_ms(lambda: floor(m, data), iters=50)
        if gf_pallas.launches - n0 != 2 + 50 + 2 + 50:
            fail("K2 timing: the floor counted a K2 launch")
        plain_ms = cuda_ms(lambda: gf_jax.bitplane_matmul(bm_dev, data),
                           iters=3, warmup=1)
        bound_ms, bound_by, nbytes, ops = k2_bound(B, k, m, L)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        emit({"phase": "timing", "kernel": "gf_bitplane", "shape": name,
              "data": list(data.shape), "out": [B, m, L], "ms": ms,
              "call_ms": call_ms, "floor_ms": floor_ms,
              "plain_ms": plain_ms, "bytes": nbytes, "lookups": ops,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "lookups_ms": ops / SMEM_LOOKUPS_PER_S * 1e3,
              "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
              "roofline_share": bound_ms / ms, "gpu": card})
    return out


def time_k1(shapes, card: str) -> dict:
    """K1's device time at the encode, decode and rebuild shapes, at the
    liber8tion (w = 8) and liberation (w = 7) encodes, at the process
    cluster's staged put, durable put and 2-erasure decode, and at phase
    11's object put, small write and 2-erasure decode."""
    timings = {}
    for name, iters in (("encode", 50), ("decode", 50), ("rebuild", 50),
                        ("liber8tion_w8_encode", 50),
                        ("liberation_w7_encode", 50), ("pc_put", 4),
                        ("pc_durable_put", 20), ("pc_decode", 20),
                        ("p11_encode_128", 50), ("p11_encode_1", 50),
                        ("p11_decode_2", 50)):
        masks, words = shapes[name]
        B, C, W = words.shape
        R = masks.shape[-2]
        Bm = B if masks.dim() == 3 else 1
        ms = graph_ms(lambda: xor_kernel.xor_matmul_w32(masks, words),
                      iters=iters)
        call_ms = cuda_ms(lambda: xor_kernel.xor_matmul_w32(masks, words),
                          iters=iters)
        m3 = masks if masks.dim() == 3 else masks[None]
        plain_ms = cuda_ms(lambda: xor_kernel._combine_torch(m3, words),
                           iters=3, warmup=1)
        bound_ms, bound_by, nbytes, ops = k1_bound(B, Bm, R, C, W)
        timings[name] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "timing", "kernel": "xor_matmul_w32", "shape": name,
              "masks": list(masks.shape), "words": list(words.shape),
              "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
              "hbm_share": nbytes / (ms * 1e-3) / HBM_BYTES_PER_S,
              "roofline_share": bound_ms / ms, "gpu": card})
    return timings


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    device = torch.device("cuda")
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    ceph_tpu_torch.set_default_device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)

    # 1. build
    build_kernels(card)

    # 2. kernels vs plain versions at the main path's shapes
    codec = instance().factory(
        "jax", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "layout": "bitsliced"})
    shapes = k1_shapes(device, codec, gen)
    shapes.update(plugin_k1_shapes(device, gen))
    errs = kernel_checks(device, shapes)
    shapes2 = k2_shapes(device, gen)
    shapes2.update(plugin_k2_shapes(device, gen))
    errs2 = k2_checks(device, shapes2)
    zw_shards = zerowire_shards()
    zw_pool = ragged_fused.pack(zw_shards).pool
    errs3 = k3_checks(device, k3_shapes(device, gen, zw_pool))
    torch.cuda.empty_cache()

    # 3. the ECBackend data path, with the launch counts read around it
    xor_kernel.launches = 0
    gf_pallas.launches = 0
    gf_pallas.fused_launches = 0
    plain0 = (xor_kernel.plain_runs, gf_pallas.plain_runs,
              crc32_gf2.plain_runs)
    torch.cuda.reset_peak_memory_stats()
    path = run_slice(device, gen, n_objects=128,
                     obj_bytes=4 << 20, stripe_unit=128 << 10)
    k1_slice = xor_kernel.launches
    path["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    path["k1_launches"] = k1_slice
    path["gpu"] = card
    emit({"phase": "slice", **path})
    if (xor_kernel.plain_runs, gf_pallas.plain_runs,
            crc32_gf2.plain_runs) != plain0:
        fail("a plain version ran on the main path")
    if k1_slice != path["dispatches"] or k1_slice == 0 or \
            gf_pallas.launches or gf_pallas.fused_launches:
        fail(f"K1 launched {k1_slice} times on the main path; the path "
             f"makes {path['dispatches']} dispatches")

    # 4. the placement sweep (no kernel: batched torch on the card)
    sweep = placement_sweep(device)
    sweep_up0 = sweep.pop("_up0")
    sweep["gpu"] = card
    emit({"phase": "placement_sweep", **sweep})

    # 5. general placement: the per-lane mapper (no kernel; the kernels'
    # counts are read around it inside and must not move)
    gp = general_placement(device)
    gp["gpu"] = card
    emit({"phase": "general_placement", **gp})
    torch.cuda.empty_cache()

    # 6. the cluster step, one pool after the other
    steps = {}
    for layout in ("bitsliced", "bytes"):
        torch.cuda.reset_peak_memory_stats()
        st = cluster_step(device, layout)
        st["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        st["gpu"] = card
        emit({"phase": "cluster_step", **st})
        steps[layout] = st
    if (xor_kernel.plain_runs, gf_pallas.plain_runs,
            crc32_gf2.plain_runs) != plain0 or gf_pallas.fused_launches:
        fail("a plain version or K3 ran on the cluster paths")

    # 7. the ZeroWire ingest path (its counts are read around it inside)
    zw = zerowire_path(device, zw_shards)
    zw_res = zw.pop("res")
    zw["gpu"] = card
    emit({"phase": "zerowire", **zw})
    zerowire_checks(device, zw_shards, zw_res)
    del zw_res
    torch.cuda.empty_cache()

    # 8. the erasure-code plugins: the corpus, then one pool per plugin
    # (each pool's counts are read around it inside)
    xor_kernel.launches = 0
    gf_pallas.launches = 0
    corpus = ec_corpus(device)
    corpus.update(k1_launches=xor_kernel.launches,
                  k2_launches=gf_pallas.launches, gpu=card)
    emit({"phase": "ec_corpus", **corpus})
    plugin_k1 = corpus["k1_launches"]
    plugin_k2 = corpus["k2_launches"]
    for name, prof, runs, n_objects in PLUGIN_POOLS:
        pp = plugin_pool(device, name, prof, runs, n_objects)
        pp["gpu"] = card
        emit({"phase": "ec_plugin_pool", **pp})
        plugin_k1 += pp["k1_launches"]
        plugin_k2 += pp["k2_launches"]
        torch.cuda.empty_cache()

    # 9. numbers
    t1 = time_k1(shapes, card)
    t2 = time_k2(shapes2, card)
    t3 = time_k3(zw_pool, round(zw["counters"]["device_crc_bytes"] / 4096 /
                                zw["device_crc_dispatches"]), device, card)
    enc1, enc2, full3 = t1["encode"], t2["encode"], t3["full_pool"]
    torch.cuda.empty_cache()

    # 10. the process cluster: daemons on the CPU, the client on the card
    # (its counts are read around each step inside)
    pc = process_cluster(device, card)
    emit({"phase": "process_cluster", **pc})
    emit({"phase": "pc_csum_timing", **pc_csum_timing(device, card)})
    torch.cuda.empty_cache()

    # 11. the failure pipeline and the block tier (each step's counts are
    # read around it inside)
    p11_k1 = 0
    for seed, netsplit in ((0, False), (1, True)):
        th = p11_thrash(device, seed, netsplit)
        th["gpu"] = card
        emit({"phase": "thrash", **th})
        p11_k1 += th["k1_launches"]
        torch.cuda.empty_cache()
    bt = p11_block_tier(device)
    bt["gpu"] = card
    emit({"phase": "block_tier", **bt})
    p11_k1 += bt["k1_launches"]
    torch.cuda.empty_cache()
    bal = p11_balancer(device)
    bal["gpu"] = card
    emit({"phase": "balancer", **bal})

    # 12. the sharded data plane over a mesh of cells on the card (each
    # run's counts are read around it inside)
    t12 = time.perf_counter()
    p12c = p12_cluster(device, card)
    p12r = p12_ragged(device, card, zw_pool)
    p12s = p12_steps(device, card, gen)
    p12_sweep(device, card, sweep_up0)
    p12_nccl(device, card, gen)
    emit({"phase": "p12_total", "s": time.perf_counter() - t12, "gpu": card})
    emit({"kernels": [
        {"name": "xor_matmul_w32", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/xor_matmul.cu",
         "replaces": "ceph_tpu/ops/xor_kernel.py:76",
         "launches": k1_slice + steps["bitsliced"]["k1_launches"] +
         plugin_k1 + pc["k1_launches"] + p11_k1 +
         sum(c["k1_launches"] for c in p12c.values()) + p12s["k1_launches"],
         "max_abs_err": max(errs.values()),
         "ms": enc1["ms"], "plain_ms": enc1["plain_ms"],
         "bound_ms": enc1["bound_ms"], "bound_by": enc1["bound_by"],
         "library_ms": None},
        {"name": "gf_bitplane", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_bitplane.cu",
         "replaces": "ceph_tpu/ops/gf_pallas.py:34",
         "launches": steps["bytes"]["k2_launches"] + plugin_k2 +
         p12s["k2_launches"],
         "max_abs_err": max(errs2.values()),
         "ms": enc2["ms"], "plain_ms": enc2["plain_ms"],
         "bound_ms": enc2["bound_ms"], "bound_by": enc2["bound_by"],
         "library_ms": None},
        {"name": "ragged_fused", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/ragged_fused.cu",
         "replaces": "ceph_tpu/ops/gf_pallas.py:83",
         "launches": zw["k3_launches"] + pc["k3_launches"] +
         p12r["launches"],
         "max_abs_err": max(errs3.values()),
         "ms": full3["ms"], "plain_ms": full3["plain_ms"],
         "bound_ms": full3["bound_ms"], "bound_by": full3["bound_by"],
         "library_ms": None}]})
    emit({"phase": "total", "s": time.perf_counter() - t_start,
          "gpu": card})
    print(f"gpu: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
