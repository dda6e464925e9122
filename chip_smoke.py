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
     card at the main path's shapes, K1 also its launch plan's shared
     memory to what the kernel lays out (K1: RS(8,3) encode, a 3-erasure
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
     and mds [1, 8, 2048] -> 4 calls; K1 at the rados client's RS(4,2)
     put of a 4 MiB object and of a 1 MiB bench write (step 10b); and K1
     and K2 at every shape step 8b launches, their operands taken from
     each cell of 8b's grid run once through ``bench_sweep.bench_cell``);
     and K1 at phase 14's shapes (``P14_K1``: RS(4,2) at W = 2, 128 and
     512 words a plane, encodes, decodes and per-stripe rebuilds, and
     RS(2,1) encodes at W = 128; each with one mask table and with a
     table a batch row, at a batch above the twins' largest);
  3. the EC data path through ECBackend: an RS(8,3) layout=bitsliced pool,
     1 MiB stripes, 128 objects of 4 MiB put in one ingest batch onto 16
     OSD device caches, 3 OSDs killed, every object read back (degraded
     reads decode in signature groups) and every lost shard rebuilt with
     one mask per stripe, all compared on the card;
  4. the placement sweep (BASELINE configs #3 and #5): a 1,000-host x
     10-OSD straw2 map, CHOOSELEAF_FIRSTN host, 3 replicas;
     ``OSDMap.map_pgs_batch`` over 2^20 PGs, then 100 OSDs out and the
     remap through both ``map_pgs_batch`` and ``map_batch_delta``; every
     lane of both sweeps held against the native C++ mapper; (4b)
     ``osdmaptool <spec> --test-map-pgs`` on the same map, the spec
     written with ``CrushMap.to_spec``, two 3-replica pools of 131,072
     PGs: every up set and primary against the native mapper, the
     printed avg / min / max against a NumPy count of the native rows;
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
     weighs 3 x 2^31) at 65,536 lanes against the native mapper; (5b)
     ``crushtool -i <that crushmap text> --test --show-statistics
     --show-utilization`` over x in [0, 262,144), rule 0, 3 replicas,
     on the general mapper: its mappings against the native mapper, its
     printout against the same printout made from the native rows, no
     lane on the host;
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
     launches counted per step and shape; (8b) ``bench_sweep --plugins
     jax,jerasure --k 4,8 --m 2,3 --sizes 4096,1048576 --iters 4
     --batch 16`` on the card (device codecs timed with CUDA events):
     each cell's K1 and K2 launches equal to its codec's dispatches, its
     rows and skipped cells equal to the port's own run on the CPU;
  9. time each kernel beside its bound and its plain version: device time
     from launches captured in one CUDA graph and replayed between CUDA
     events, and the wrapper's call time from back-to-back calls between
     CUDA events (host work included); each kernel also beside its
     launch floor, an empty kernel at the kernel's grid and shared
     memory replayed the same way (K1 also at phase 13's most-launched
     4 KiB shapes; K3 at its pool and its three crc-leg frames);
 10. the process cluster (bench.py's ``bench_process_cluster``):
     ``tools/vstart`` starts one mon, then 12 OSD daemon processes
     together (``start(..., together=True)``), each
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
     full 4 KiB block; (10b) before the daemons stop, a 4+2 pool made
     with the mon's ``pool_create`` request and the ``"default"``
     profile, ``rados put`` of a 4 MiB object, ``get`` (every byte
     equal), ``ls``, ``rm`` and ``rados bench 5``; (10c) the ``ceph`` CLI
     on those daemons with its client on the card (``status``,
     ``health``, ``osd tree``, ``df``, ``osd df``, ``pg dump``, ``osd pool
     create|ls|rm``, ``osd set|unset noout``, ``daemon osd.N perf dump``
     on the lowest OSD left alive, each a counted step), then ``ceph lint --check`` and the static
     smoke (``tools/check_static``) on the checkout, each timed, with the
     lint's finding, baselined and noqa counts;
 11. the failure pipeline and the block tier on the cluster step's map
     (32 hosts x 4 OSDs) with a 3-replica pool (pg_num 2,048) and an
     RS(8,3) bitsliced pool (pg_num 512), about 100 PG replicas an OSD,
     4 MiB objects: (a) two ``Thrasher`` soaks on the card (seed 0
     kill/revive, seed 1 netsplit; 16 objects a pool, 8 cycles), every
     invariant held; (b) a 32 MiB RBD image in the EC pool written whole
     in 4 MiB writes, 128 seeded 4 KiB random writes, snapshot, protect,
     clone, flatten, an unaligned shrink, every byte of image and clone
     against a host oracle; rbd-mirror of a 32 MiB journaled image onto a
     second ClusterSim on the card (2 x 4 MiB and 32 x 4 KiB writes,
     replay, a second replay and a trim applying nothing); neorados's 64
     concurrent 4 MiB writes and reads; (c) ``calc_pg_upmaps`` on the
     replicated pool through the card's mapper and the balancer advisor,
     both equal to the same calls on a CPU copy of the map, the deviation
     falling, every upmap keeping one replica a host, no lane on the host;
     (d) ``rbd`` on the RS(8,3) pool (a 16 MiB image created, written,
     snapshotted, overwritten, listed, rolled back, protected, cloned,
     flattened and removed; every byte against an oracle) and
     ``osdmaptool --upmap`` on the 3-replica pool, its items equal to
     (c)'s CPU copy's;
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
     beside the unsharded launch;
 13. the gateway tier and CephFS on phase 11's stack: (a) ``RGWGateway``
     on a ``Rados`` ioctx of the RS(8,3) pool (4 KiB stripe unit, HBM
     staging), a bucket of 8 index shards: 128 objects of phase 7's
     zipf(1.3) size mix put, a 64 MiB multipart object in 8 MiB parts,
     listings by prefix, marker and delimiter, every object read back
     with its ETag the MD5 of its bytes, 3 OSDs killed and every object
     read degraded, out, ``recover_all`` and every object read again, an
     online reshard from 8 to 16 shards while 32 objects are written, and
     16 PUT/GET pairs through each of the S3 and Swift frontends on
     localhost over the same index; (b) an ``MDSCluster`` of 2 ranks,
     metadata on the 3-replica pool and data on the RS(8,3) pool in the
     default ``FileLayout`` (4 MiB objects): 256 small files under 16
     directories, 16 files of 4 MiB and one of 64 MiB written and read
     back, a rename across ranks, ``MDBalancer`` moving the hot subtree,
     rank 1 restarted from its journal, 3 OSDs killed and every file
     read again; (c) ``run_serve(ServeConfig(seed=0))``, S3Serve's stock
     profile over 4 OSD daemons on the CPU with the tenants' handles on
     the card, its gate green and no full block crc'd on the host here,
     then ``--starve`` red with the gold tenant's share breach; (d)
     ``run_drill(DrillConfig(seed=0))`` with two sim zones on the card
     green, and red with ``lose_bilog``; (e) on (a)'s gateway,
     ``radosgw-admin`` user create and info, bucket list, stats and limit
     check (the object count and bytes equal to (a)'s writes), then
     ``MgrModuleHost`` over (a)'s sim and mon with the five modules: a
     Prometheus render (every perf group a family) and one scrape over
     HTTP, the dashboard's API, the autoscaler's recommendations,
     telemetry's report and devicehealth's samples;
 14. the twins of the reference's check smokes
     (``ceph_tpu_torch/tools/check_<name>.py``) through their ``main``
     with ``--device cuda``, each a counted step: ``check_multichip``
     (the sharded cluster step on 8 cells of the card held to the
     unsharded one, ``dispatched_mesh``, the ``cluster_sharded``
     section), ``check_wire`` (two OSD daemons: one crc pass per byte,
     the shm lane, the socket fallback), ``check_recovery`` (RS(4,2) at a
     16 KiB stripe unit on a sim, then three daemons and
     ``recover_pool``), ``check_async`` (three daemons: completions,
     ordering, stream pools), ``check_robustness`` (the CrashDev smoke,
     a seeded thrash twice, a netsplit soak), ``check_observability``
     (the op trail, scrapes, traces, history, a cold operand's
     ``jit.compile`` span, the balancer advisor), and the cheap legs of
     ``check_serving`` (bucket-index sharding on an RS(2,1) sim) and
     ``check_dr`` (the seed-2 drill digest): each must return 0, and
     each that reaches a kernel must launch it.  Then the whole smoke's
     wall time.

Around each path of phases 3, 6, 7, each pool of phase 8, each step of
phases 10, 11, 13 and 14 and each run of phase 12 the kernels' launch counts are
set to 0 just before and read just after: K1's must equal the bitsliced
paths' dispatches (phase 11: the ec.jax dispatches plus the rebuild
dispatches; phase 12: those of the plane-off run, and the cells times
the plane's dispatches of the plane-on run) and the bitmatrix pool's
codec dispatches (``bitmatrix_codec``'s counts), K2's the byte pool's
and the layered pools' ``ec.jax`` encode + decode dispatches (phase 12:
one a cell of each distributed step), K3's the ZeroWire path's encode
launches plus its device crc dispatches (phase 10: the device crc
dispatches alone; phase 12: one a cell; phase 13: its device crc
dispatches, while phase 13's K1 launches equal its ec.jax plus rebuild
dispatches; phase 14 as phase 13, but that a dispatch made while the
sharded data plane is on launches K1 once on each of its cells); the host
pools launch nothing,
and no plain version may run; the steps of the tools read their counts
the same way (8b: K1 equal to each cell's bitsliced ``ec.jax`` and
bitmatrix dispatches, K2 to its byte-layout ones).  After phases 8, 10,
11, 13 and 14 the smoke fails if a step launched a kernel at a shape
phase 2 did not hold.  The placement phases 4 and 5 (4b and 5b too) and phase
12's sweep run no kernel; phase 5 and phase 12's sweep fail if a count
moves.  Earlier lines print
the card (``nvidia-smi --query-gpu=name,power.limit``), the numbers as
JSON, and the ``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
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
from ceph_tpu_torch.ec.interface import ErasureCodeError
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
        per_batch = masks.dim() == 3
        plan = xor_kernel.launch_plan(m3, words, per_batch)
        smem = xor_kernel.smem_bytes(plan, masks.shape[-2],
                                     masks.shape[-1])[0]
        emit({"phase": "kernel_check", "kernel": "xor_matmul_w32",
              "shape": name, "masks": list(masks.shape),
              "words": list(words.shape), "max_abs_err": err,
              "plan": plan._asdict(), "dynamic_smem_bytes": smem})
        if err != 0 or not torch.equal(got, want):
            fail(f"K1 differs from its plain version at {name}")
        if smem != plan.smem:
            fail(f"K1's plan at {name} reckons {plan.smem} B of shared "
                 f"memory; the kernel lays out {smem} B")
    return errs


def held_shapes(pairs) -> dict:
    """{(C, W, R): the largest B held} of checked (operand shape, output
    rows) pairs: a launch "B,C,W->R" is held when a check ran its C, W
    and R at a batch no smaller."""
    out = {}
    for (B, C, W), R in pairs:
        out[(C, W, R)] = max(out.get((C, W, R), 0), B)
    return out


def shape_held(key: str, held: dict) -> bool:
    dims, rows = key.split("->")
    B, C, W = map(int, dims.split(","))
    return B <= held.get((C, W, int(rows)), 0)


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
    chunks, phase 11's encodes and 1- and 2-erasure decodes at 4 KiB
    stripe units, and phase 13's encodes, 1- to 3-erasure decodes and
    rebuilds at 4 KiB stripe units."""
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
    # phase 13's shapes, also at 4 KiB stripe units: the S3 and CephFS
    # puts encode 1 to 32 stripes (the zipf objects of up to 1 MiB and
    # the small files), an 8 MiB multipart part 256 and a 4 MiB file
    # object 128; degraded gets decode one, two or three erasures of
    # 1 to 256 stripes; recover_all rebuilds [B, 88, 128] stacks, each
    # stripe with its own full-width masks
    p13 = {f"p13_encode_{B}": (enc_masks, random_words((B, 8 * K, 128),
                                                        gen, device))
           for B in (3, 5, 17, 29, 32, 256)}
    for e, masks in ((1, dec1), (2, dec2), (3, dec_masks)):
        for B in (1, 5, 32, 256):
            p13[f"p13_decode_{e}_{B}"] = (masks, random_words(
                (B, 8 * K, 128), gen, device))
    for B in (1, 2, 7, 32, 256):
        p13[f"p13_rebuild_{B}"] = (rb_masks[:B], random_words(
            (B, 8 * n, 128), gen, device))
    return {**pc, **p11, **p13,
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
            "_up0": up0, "_cmap": cmap}


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

    text = straw_cluster_text()
    t0 = time.perf_counter()
    cmap = compile_crushmap(text)
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
            "legacy_lanes": GP_LANES, "legacy_map_batch_s": legacy,
            "_text": text}


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
    # phase 13's S3Serve frames: one 4 KiB block a frame
    shapes["crc_leg_p13_frame"] = (np.zeros((0, 8), dtype=np.uint8),
                                   data((1, 1, 4096)))
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
    and at the process cluster's flush batch, beside their bounds, plain
    versions and launch floors (an empty kernel at K3's grid and shared
    memory, 50 launches by graph replay; None where the package has no
    floor entry point)."""
    out = {}
    floor = getattr(gf_pallas, "ragged_fused_floor", None)
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
        floor_ms = None if floor is None else \
            graph_ms(lambda: floor(m, data), iters=50)
        if gf_pallas.fused_launches - n0 != 2 + iters + 2 + iters:
            fail("K3 timing: the floor counted a K3 launch")
        plain_ms = cuda_ms(lambda: k3_plain(bitmat, data, chunk=1024),
                           iters=1, warmup=1)
        bound_ms, bound_by, nbytes, ops = k3_bound(G, k, m, T)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        emit({"phase": "timing", "kernel": "ragged_fused", "shape": name,
              "pool": [G, k, T], "m": m, "ms": ms, "call_ms": call_ms,
              "floor_ms": floor_ms, "plain_ms": plain_ms, "bytes": nbytes,
              "lookups": ops,
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


@contextlib.contextmanager
def host_csum_scans(note):
    """Calls ``note(site, nbytes)`` at every host crc scan of a full 4 KiB
    block or more that this process makes while the block runs
    (``Csums.scan``; the daemons' own scans are in their processes)."""
    from ceph_tpu_torch.common import crcutil
    scan_descriptor = crcutil.Csums.__dict__["scan"]
    scan = crcutil.Csums.scan

    def observed(cls, buf, block=crcutil.CSUM_BLOCK, site="send"):
        n = len(crcutil.as_u8(buf))
        if n >= 4096:
            note(site, n)
        return scan(buf, block=block, site=site)
    crcutil.Csums.scan = classmethod(observed)
    try:
        yield
    finally:
        crcutil.Csums.scan = scan_descriptor


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
    note_scan = crcutil.note_scan
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
    v.start(PC_OSDS, hb_interval=0.5, together=True)
    times["daemons_start_s"] = time.perf_counter() - t0
    daemon_pids = {n: p.pid for n, p in v.procs.items() if n != "mon"}
    undo = contextlib.ExitStack()
    undo.enter_context(launch_shapes(seen))
    undo.enter_context(host_csum_scans(
        lambda site, n: host_payload["scans"].append((step[0], site, n))))
    crcutil.note_scan = observed_scan
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
        # 10b: the rados CLI on a new pool, after the phase's own
        # observers are put back (its steps count their own launches)
        undo.close()
        crcutil.note_scan = note_scan
        wire._frame_parts = frame_parts
        tools = tools_rados(device, card, PC_DIR)
        ceph = tools_ceph(device, card, PC_DIR,
                          min(set(range(PC_OSDS)) - set(victims)))
    finally:
        undo.close()
        crcutil.note_scan = note_scan
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
            "_tools": tools, "_ceph": ceph, "gpu": card}


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
P11_IMAGE = 32 << 20          # 8 objects of 4 MiB (1 GiB until phase 13
#                              came, then 256 and 64 MiB; cut to keep the
#                              smoke in half its time)
P11_SHRINK = P11_IMAGE - 12345
P11_RANDOM_WRITES = 128       # 4 KiB each (256 until K1's redesign)
P11_MIRROR_IMAGE = 32 << 20   # 256 MiB and 16 big writes until phase 13,
#                              then 64 MiB, 4 big and 64 small writes
P11_MIRROR_BIG, P11_MIRROR_SMALL = 2, 32
P11_THRASH_OBJECTS = 16       # a pool (32 until K1's redesign)
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


def step_counts() -> dict:
    ec = perf("ec.jax").dump()
    zero = perf("wire.zero").dump()
    return {"k1": xor_kernel.launches, "k2": gf_pallas.launches,
            "k3": gf_pallas.fused_launches,
            "ec_dispatches": ec.get("encode_dispatches", 0) +
            ec.get("decode_dispatches", 0),
            "rebuild_dispatches": simulator.rebuild_dispatches,
            "device_crc_dispatches": zero.get("device_crc_dispatches", 0),
            "device_crc_bytes": zero.get("device_crc_bytes", 0),
            "plain": xor_kernel.plain_runs + gf_pallas.plain_runs +
            crc32_gf2.plain_runs}


def check_counts(where: str, d: dict) -> None:
    """No plain version ran, K2 never launched, K1 launched once per
    ec.jax and rebuild dispatch, K3 once per device crc dispatch."""
    if d["plain"]:
        fail(f"{where}: a plain version ran {d['plain']} times")
    if d["k2"]:
        fail(f"{where}: K2 launched {d['k2']} times on the K1 path")
    if d["k1"] != d["ec_dispatches"] + d["rebuild_dispatches"]:
        fail(f"{where}: K1 launched {d['k1']} times; the step made "
             f"{d['ec_dispatches']} ec.jax and "
             f"{d['rebuild_dispatches']} rebuild dispatches")
    if d["k3"] != d["device_crc_dispatches"]:
        fail(f"{where}: K3 launched {d['k3']} times for "
             f"{d['device_crc_dispatches']} device crc dispatches")


def counted_step(device, phase: int, label: str, fn, steps: dict,
                 card: str, check=None):
    """One step of phase 11, 13 or 14: the kernels' counts set to 0 just
    before it and read just after (launches by kernel and shape, and K1's
    launches while the sharded data plane is on, ``k1_plane_on``), its
    wall time printed, the counts checked (``check``, ``check_counts``
    when None); returns ``fn()``'s result."""
    from ceph_tpu_torch.parallel import data_plane
    shapes = {}
    plane_on = [0]
    lock = threading.Lock()

    def seen(kernel, key):
        with lock:
            h = shapes.setdefault(kernel, {})
            h[key] = h.get(key, 0) + 1
            if kernel == "k1" and data_plane.enabled():
                plane_on[0] += 1

    sync(device)
    with launch_shapes(seen):
        c0 = step_counts()
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
    d = {k: v - c0[k] for k, v in step_counts().items()}
    d["k1_plane_on"] = plane_on[0]
    steps[label] = {"s": wall, **d, "launch_shapes": shapes}
    emit({"phase": f"p{phase}_step", "step": label, "s": wall,
          "k1": d["k1"], "k1_plane_on": d["k1_plane_on"], "k3": d["k3"],
          "ec_dispatches": d["ec_dispatches"],
          "rebuild_dispatches": d["rebuild_dispatches"],
          "device_crc_dispatches": d["device_crc_dispatches"],
          "gpu": card})
    (check or check_counts)(f"phase {phase} {label}", d)
    return out


def p11_thrash(device, card: str, seed: int, netsplit: bool) -> dict:
    """11a: one seeded Thrasher soak over both pools on the card; every
    invariant must hold."""
    from ceph_tpu_torch.cluster.thrasher import (NETSPLIT_FAULTPOINTS,
                                                 Thrasher, ThrashConfig)
    from ceph_tpu_torch.common import faults
    sim, mon = p11_stack(device)
    cfg = ThrashConfig(seed=seed, objects=P11_THRASH_OBJECTS,
                       object_size=P11_OBJ,
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
        report = counted_step(device, 11, label, thr.run, steps, card)
    finally:
        sim.shutdown()
        faults.reset()
    if not report["ok"]:
        fail(f"phase 11 thrash ({label}, seed {seed}): "
             f"{report['failures']}")
    st = steps[label]
    if st["k1"] == 0:
        fail(f"phase 11 thrash ({label}): K1 never launched")
    return {"soak": label, "seed": seed, "cycles": cfg.cycles,
            "objects": cfg.objects, "object_bytes": cfg.object_size,
            "wall_s": st["s"], "payloads": payloads["n"],
            "payload_generation_s": payloads["s"],
            "ticks_to_health_ok": report["invariants"]["health_ticks"],
            "k1_launches": st["k1"],
            "ec_dispatches": st["ec_dispatches"],
            "rebuild_dispatches": st["rebuild_dispatches"],
            "k1_launch_shapes": st["launch_shapes"].get("k1", {}),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "report": report}


def p11_block_tier(device, card: str) -> dict:
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
        counted_step(device, 11, "rbd_write_image", write_whole, steps,
                     card)
        offs = rng.integers(0, P11_IMAGE // 4096, P11_RANDOM_WRITES) * 4096
        blocks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                  for _ in offs]

        def random_writes():
            for off, blk in zip(offs, blocks):
                img.write(int(off), blk)
                oracle[int(off):int(off) + 4096] = blk
        counted_step(device, 11, "rbd_random_4k_writes", random_writes,
                     steps, card)

        def snap_clone_flatten():
            img.snap_create("s1")
            img.protect_snap("s1")
            rbd.clone("vol", "s1", "clone")
            Image(io_a, "clone").flatten()
        counted_step(device, 11, "rbd_snap_protect_clone_flatten",
                     snap_clone_flatten, steps, card)
        counted_step(device, 11, "rbd_unaligned_shrink",
                     lambda: img.resize(P11_SHRINK), steps, card)

        def read_back():
            return (Image(io_a, "vol").read(0, P11_IMAGE),
                    Image(io_a, "clone").read(0, P11_IMAGE))
        got_img, got_clone = counted_step(device, 11, "rbd_read_back",
                                          read_back, steps, card)
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
        counted_step(device, 11, "mirror_journaled_writes",
                     journaled_writes, steps, card)
        rep = MirrorReplayer(io_a, io_b, "mirror", peer="site-b")
        applied = counted_step(device, 11, "mirror_replay", rep.replay,
                               steps, card)
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
        counted_step(device, 11, "neorados_write_full",
                     lambda: neorados("write"), steps, card)
        got = counted_step(device, 11, "neorados_read",
                           lambda: neorados("read"), steps, card)
        if list(got) != blobs:
            fail("phase 11 neorados: a read differs from its write")
        tools = tools_rbd(device, card, io_a)
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
            "k1_launches": sum(s["k1"] for s in steps.values()),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "_tools": tools}


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


def p11_balancer(device, card: str) -> dict:
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
    report = counted_step(device, 11, "balancer_evaluate",
                          lambda: evaluate(om, stats, max_moves=8, pool=1),
                          steps, card)
    if om.epoch != e0 or report["epoch"] != e0:
        fail("phase 11 balancer: the advisor moved the map's epoch")
    res = counted_step(device, 11, "calc_pg_upmaps",
                       lambda: calc_pg_upmaps(om, pool_ids=[1]), steps,
                       card)
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
            "advisor_moves": report.get("moves", 0), "steps": steps,
            "_tools": tools_upmap(device, card, om, (want, cpu))}


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


# ------------------------------------------------------------ phase 13 --
# The gateway tier and CephFS on phase 11's stack (32 hosts x 4 OSDs; a
# 3-replica pool of 2,048 PGs and an RS(8,3) bitsliced pool of 512 PGs
# at Ceph's default 4 KiB stripe unit, on the HBM staging tier), then
# S3Serve at its stock profile and the DR drill.
# The counts were cut (S3 objects 1,024, then 512; live puts 64, pairs
# 64; small files 1,024, 4 MiB files 64, the big file 256 MiB) to keep
# the smoke in half its time: every size, layout and shape stays.
P13_OBJECTS = 128             # phase 7's S3Serve size mix, zipf(1.3)
P13_SHARDS = 8                # S3Serve's ServeConfig.index_shards
P13_RESHARD = 16
P13_LIVE_PUTS = 32            # written while the bucket reshards
P13_MP_BYTES = 64 << 20
P13_MP_PART = 8 << 20         # the S3 CLI's default part size
P13_PAIRS = 16                # PUT/GET pairs through each frontend
P13_KILLED = 3
P13_FS_DIRS = 16
P13_FS_SMALL = 256            # small files, 1 B to 16 KiB
P13_FS_MID = 16               # files of one 4 MiB object each
P13_FS_MID_BYTES = 4 << 20
P13_FS_BIG = 64 << 20         # one file of 16 objects
P13_HOT_READS = 48            # reads that make one subtree the hottest


def p13_kill(sim, mon, victims) -> None:
    """The victims die and their peers' reports mark them down in the map
    the clients follow (the heartbeat pipeline's job, done at once)."""
    for v in victims:
        sim.fail_osd(v)
    for v in victims:
        for reporter in range(len(sim.osds)):
            if reporter not in victims and mon.report_failure(v, reporter):
                break
        if mon.osdmap.is_up(v):
            fail(f"phase 13: osd.{v} was not marked down")


def p13_out(mon, victims) -> None:
    inc = mon.next_incremental()
    for v in victims:
        inc.new_weight[v] = 0
    if not mon.commit_incremental(inc):
        fail("phase 13: the mon did not commit the victims' out")


def p13_payloads(n: int, seed: int):
    """``n`` payloads of phase 7's size mix: zipf(1.3) x 1 KiB, clipped to
    [1 B, 1 MiB]."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.3, size=n).astype(np.float64)
    sizes = np.clip((raw * 1024).astype(np.int64), 1, 1 << 20)
    return [rng.integers(0, 256, int(L), dtype=np.uint8).tobytes()
            for L in sizes]


def _http(port: int, method: str, path: str, body: bytes = b"",
          headers=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    etag = r.getheader("ETag")
    conn.close()
    return r.status, (etag or "").strip('"'), data


def p13_s3(device, card: str) -> dict:
    """(a) S3 over the RS(8,3) bucket pool on the card."""
    import hashlib

    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.rgw.gateway import RGWGateway
    from ceph_tpu_torch.rgw.http_frontend import S3Frontend
    from ceph_tpu_torch.rgw.swift_frontend import SwiftFrontend
    steps = {}
    t_gen = time.perf_counter()
    datas = p13_payloads(P13_OBJECTS, SEED + 13)
    keys = [f"obj/{i % 16:02d}/{i:05d}" for i in range(P13_OBJECTS)]
    objs = dict(zip(keys, datas))
    mp_rng = np.random.default_rng(SEED + 14)
    parts = [mp_rng.integers(0, 256, P13_MP_PART, dtype=np.uint8).tobytes()
             for _ in range(P13_MP_BYTES // P13_MP_PART)]
    gen_s = time.perf_counter() - t_gen
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in objs.items()}
    sim, mon = p11_stack(device)
    try:
        io_s3 = Rados(sim, mon).connect().open_ioctx("ec")
        gw = RGWGateway(io_s3)
        b = gw.create_bucket("s3", num_shards=P13_SHARDS)

        etags = counted_step(device, 13, "s3_put", lambda: [
            b.put_object(k, v) for k, v in objs.items()], steps, card)
        if etags != [md5[k] for k in keys]:
            fail("phase 13 s3: a put's ETag is not the MD5 of its bytes")

        def multipart():
            uid = b.initiate_multipart("mp/big.bin")
            for n, part in enumerate(parts, 1):
                b.upload_part(uid, n, part)
            return b.complete_multipart(uid, list(range(1, len(parts) + 1)))
        mp_etag = counted_step(device, 13, "s3_multipart", multipart, steps, card)
        if not mp_etag.endswith(f"-{len(parts)}"):
            fail(f"phase 13 s3: multipart ETag {mp_etag}")
        objs["mp/big.bin"] = b"".join(parts)
        del parts

        def listing():
            top = b.list_objects(delimiter="/")
            by_dir = b.list_objects(prefix="obj/", delimiter="/")
            one = b.list_objects(prefix="obj/05/", max_keys=100000)
            pages, marker = [], ""
            while True:
                r = b.list_objects(marker=marker, max_keys=100)
                pages += [c["key"] for c in r["contents"]]
                if not r["is_truncated"]:
                    return top, by_dir, one, pages
                marker = r["contents"][-1]["key"]
        top, by_dir, one, pages = counted_step(device, 13, "s3_list", listing,
                                           steps, card)
        if top["common_prefixes"] != ["mp/", "obj/"] or top["contents"] or \
                by_dir["common_prefixes"] != sorted(
                    {k[:7] for k in keys}) or \
                [c["key"] for c in one["contents"]] != sorted(
                    k for k in keys if k.startswith("obj/05/")) or \
                pages != sorted(objs):
            fail("phase 13 s3: a listing differs from the keys written")

        def get_all(label):
            bad = []
            for k, v in objs.items():
                data, ent = b.get_object(k)
                if data != v or ("mp" not in ent and
                                 ent["etag"] != hashlib.md5(data)
                                 .hexdigest()):
                    bad.append(k)
            if bad:
                fail(f"phase 13 s3 {label}: {len(bad)} objects differ, "
                     f"first {bad[:4]}")
            return len(objs)
        counted_step(device, 13, "s3_get", lambda: get_all("get"), steps, card)
        pool = sim.osdmap.pools[2]
        up = sim.pg_up(pool, sim.object_pg(pool,
                                           b._data_oid(keys[0], "")))
        victims = [o for o in up if o >= 0][:P13_KILLED]
        p13_kill(sim, mon, victims)
        counted_step(device, 13, "s3_degraded_get", lambda: get_all("degraded get"),
                 steps, card)
        p13_out(mon, victims)
        rec = counted_step(device, 13, "s3_recover_all", lambda: sim.recover_all(2),
                       steps, card)
        if rec.get("shards_rebuilt", 0) <= 0:
            fail(f"phase 13 s3: recovery rebuilt nothing: {rec}")
        counted_step(device, 13, "s3_get_after_recovery",
                 lambda: get_all("get after recovery"), steps, card)

        live = {f"live/{i:03d}": v for i, v in enumerate(
            p13_payloads(P13_LIVE_PUTS, SEED + 15))}

        def reshard_while_writing():
            errs = []

            def writer():
                try:
                    for k, v in live.items():
                        gw.bucket("s3").put_object(k, v)
                except Exception as e:      # noqa: BLE001 — reported
                    errs.append(repr(e))
            th = threading.Thread(target=writer, name="p13-live-writer")
            th.start()
            st = gw.reshard_bucket("s3", P13_RESHARD)
            th.join()
            return st, errs
        st, errs = counted_step(device, 13, "s3_reshard", reshard_while_writing,
                            steps, card)
        objs.update(live)
        nb = gw.bucket("s3")
        listed = []
        marker = ""
        while True:
            r = nb.list_objects(marker=marker, max_keys=1000)
            listed += [c["key"] for c in r["contents"]]
            if not r["is_truncated"]:
                break
            marker = r["contents"][-1]["key"]
        if errs or nb.num_shards() != P13_RESHARD or listed != sorted(objs) \
                or any(nb.get_object(k)[0] != v for k, v in live.items()):
            fail(f"phase 13 s3: the online reshard lost writes ({errs}, "
                 f"{nb.num_shards()} shards, {len(listed)} keys listed)")

        pair_rng = np.random.default_rng(SEED + 16)
        s3fe, swift = S3Frontend(gw), SwiftFrontend(gw)
        s3p, swp = s3fe.start(0), swift.start(0)
        try:
            def pairs(kind):
                bad = []
                for i in range(P13_PAIRS):
                    body = pair_rng.integers(
                        0, 256, int(pair_rng.integers(1, 1 << 17)),
                        dtype=np.uint8).tobytes()
                    if kind == "http":
                        path = f"/s3/http/{i:03d}"
                        st_put, etag, _ = _http(s3p, "PUT", path, body)
                        st_get, etag2, got = _http(s3p, "GET", path)
                        ok = (st_put, st_get) == (200, 200)
                    else:
                        path = f"/v1/AUTH_test/s3/swift/{i:03d}"
                        st_put, etag, _ = _http(
                            swp, "PUT", path, body,
                            {"Content-Length": str(len(body))})
                        st_get, etag2, got = _http(swp, "GET", path)
                        ok = (st_put, st_get) == (201, 200)
                    if not ok or got != body or etag != etag2 or \
                            etag != hashlib.md5(body).hexdigest():
                        bad.append((path, st_put, st_get))
                    objs[path.split("/s3/", 1)[1]] = body
                if bad:
                    fail(f"phase 13 s3 {kind}: {bad[:4]}")
                return P13_PAIRS
            counted_step(device, 13, "s3_http_pairs", lambda: pairs("http"), steps,
                     card)
            counted_step(device, 13, "s3_swift_pairs", lambda: pairs("swift"), steps,
                     card)
        finally:
            s3fe.stop()
            swift.stop()
        total = len(nb.list_objects(max_keys=100000)["contents"])
        if total != len(objs):
            fail(f"phase 13 s3: {total} keys listed, {len(objs)} written")
        stored = sum(len(v) for v in objs.values())
        # 13e: radosgw-admin and the manager's modules on this gateway
        tools = tools_gateway_mgr(device, card, sim, mon, io_s3, objs,
                                  stored, steps)
    finally:
        sim.shutdown()
    return {"objects": len(objs), "bytes": stored, "victims": victims,
            "recover": rec, "reshard": st, "payload_generation_s": gen_s,
            "steps": steps, "_tools": tools}


def p13_cephfs(device, card: str) -> dict:
    """(b) CephFS on the card: two MDS ranks, metadata on the 3-replica
    pool, data on the RS(8,3) pool in the default layout."""
    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.cluster.striper import FileLayout
    from ceph_tpu_torch.fs.mds import MDS
    from ceph_tpu_torch.fs.multimds import MDBalancer, MDSCluster
    steps = {}
    t_gen = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    files = {}
    for i in range(P13_FS_SMALL):
        files[f"/d{i % P13_FS_DIRS:02d}/f{i:04d}"] = rng.integers(
            0, 256, int(rng.integers(1, 16 << 10)), dtype=np.uint8).tobytes()
    for i in range(P13_FS_MID):
        files[f"/mid/m{i:02d}"] = rng.integers(
            0, 256, P13_FS_MID_BYTES, dtype=np.uint8).tobytes()
    files["/big/huge.bin"] = rng.integers(0, 256, P13_FS_BIG,
                                          dtype=np.uint8).tobytes()
    gen_s = time.perf_counter() - t_gen
    layout = FileLayout()
    if (layout.object_size, layout.stripe_unit, layout.stripe_count) != \
            (4 << 20, 4 << 20, 1):
        fail(f"phase 13 cephfs: the default layout is {layout}")
    sim, mon = p11_stack(device)
    try:
        r = Rados(sim, mon).connect()
        meta, data = r.open_ioctx("rep"), r.open_ioctx("ec")
        c = MDSCluster(meta, data, n_ranks=2, layout=layout)
        # the second half of the directories lives on rank 1
        for d in range(P13_FS_DIRS):
            c.mkdir(f"/d{d:02d}")
            if d >= P13_FS_DIRS // 2:
                c.migrate(f"/d{d:02d}", 1)
        c.mkdir("/mid")
        c.mkdir("/big")

        def write_all():
            for path, v in files.items():
                c.create(path)
                c.write_file(path, v)
            return len(files)
        counted_step(device, 13, "fs_write", write_all, steps, card)

        def read_all(cl, label):
            bad = [p for p, v in files.items() if cl.read_file(p) != v]
            if bad:
                fail(f"phase 13 cephfs {label}: {len(bad)} files differ, "
                     f"first {bad[:4]}")
            return len(files)
        counted_step(device, 13, "fs_read", lambda: read_all(c, "read"), steps,
                 card)

        def rename_across():
            src, dst = "/d00/f0000", f"/d{P13_FS_DIRS - 1:02d}/moved"
            c.rename(src, dst)
            files[dst] = files.pop(src)
            return c.mdsmap.auth_rank(dst)
        if counted_step(device, 13, "fs_rename", rename_across, steps, card) != 1:
            fail("phase 13 cephfs: the renamed file is not on rank 1")

        hot = "/d01"

        def balance():
            # rank 0 serves the hot subtree and two warm ones, rank 1
            # nothing: moving the hot one is the move that evens them
            c.load.clear()
            for _ in range(P13_HOT_READS):
                c.listdir(hot)
            for warm in ("/d02", "/d03"):
                for _ in range(P13_HOT_READS // 2):
                    c.listdir(warm)
            return MDBalancer(c, min_requests=16).rebalance()
        moved = counted_step(device, 13, "fs_balance", balance, steps, card)
        if (hot, 1) not in moved or c.mdsmap.auth_rank(hot) != 1:
            fail(f"phase 13 cephfs: the balancer moved {moved}")

        def restart_rank():
            # rank 1 fails; a fresh MDS for rank 1 replays its journal
            c.ranks[1] = MDS(meta, data, layout=layout, rank=1,
                             mdsmap=c.mdsmap)
            return sorted(c.listdir(f"/d{P13_FS_DIRS - 1:02d}"))
        listed = counted_step(device, 13, "fs_restart_rank", restart_rank, steps,
                          card)
        if "moved" not in listed:
            fail("phase 13 cephfs: the restarted rank lost the rename")
        counted_step(device, 13, "fs_read_after_restart",
                 lambda: read_all(c, "read after the restart"), steps, card)

        pool = sim.osdmap.pools[2]
        ino = c.stat("/big/huge.bin")["ino"]
        up = sim.pg_up(pool, sim.object_pg(pool, f"{ino:016x}.00000000"))
        victims = [o for o in up if o >= 0][:P13_KILLED]
        p13_kill(sim, mon, victims)
        counted_step(device, 13, "fs_degraded_read",
                 lambda: read_all(c, "degraded read"), steps, card)
        subtrees = c.subtree_map()
        stored = sum(len(v) for v in files.values())
    finally:
        sim.shutdown()
    return {"files": len(files), "bytes": stored, "victims": victims,
            "subtrees": subtrees, "balancer_moved": moved,
            "payload_generation_s": gen_s, "steps": steps}


def p13_serve(device, card: str) -> dict:
    """(c) S3Serve at its stock profile: 4 OSD daemons on the CPU, the
    three default tenants, their handles on the card; the gate must
    pass, and ``--starve`` must exit red with its breach report."""
    import io

    from ceph_tpu_torch.rgw import serving
    steps, scans = {}, []
    with host_csum_scans(lambda site, n: scans.append((site, n))):
        report = counted_step(device, 13, "serve", lambda: serving.run_serve(
            serving.ServeConfig(seed=0)), steps, card)
    if not report["ok"]:
        fail(f"phase 13 serve: the gate failed: {report['breaches']} "
             f"{report['op_failures'][:4]}")
    if scans:
        fail(f"phase 13 serve: the client crc'd full blocks on the host: "
             f"{scans[:8]}")
    if steps["serve"]["k3"] == 0:
        fail("phase 13 serve: no frame was verified on the card")
    buf = io.StringIO()
    rc = counted_step(device, 13, "serve_starve", lambda: serving.serve_main(
        ["--starve", "--json"], out=buf), steps, card)
    starved = json.loads(buf.getvalue())
    breach = [b for b in starved["breaches"]
              if b["tenant"] == "gold" and b["metric"] == "share"]
    if rc != 1 or starved["ok"] or not breach:
        fail(f"phase 13 serve --starve: rc {rc}, breaches "
             f"{starved['breaches']}")
    tenants = {name: {k: m[k] for k in ("ops", "share", "p50_s", "p99_s",
                                          "p999_s", "errors", "ops_s")}
               for name, m in report["tenants"].items()}
    for name, m in tenants.items():
        emit({"phase": "p13_serve_tenant", "tenant": name, **m,
              "gpu": card})
    return {"total_ops": report["total_ops"], "wall_s": report["wall_s"],
            "ops_s": report["ops_s"], "tenants": tenants,
            "dispatch_shares": report["scheduler"]["tenant_shares"],
            "starved_breaches": starved["breaches"],
            "starved_tenants": {n: {k: m[k] for k in ("ops", "share")}
                                for n, m in starved["tenants"].items()},
            "host_block_scans": len(scans), "steps": steps}


def p13_drill(device, card: str) -> dict:
    """(d) the DR drill with two sim zones on the card: green on seed 0,
    red with one lost bilog entry."""
    from ceph_tpu_torch.cluster.dr_drill import DrillConfig, run_drill
    from ceph_tpu_torch.common import faults
    steps = {}
    try:
        green = counted_step(device, 13, "drill", lambda: run_drill(
            DrillConfig(seed=0)), steps, card)
        red = counted_step(device, 13, "drill_lose_bilog", lambda: run_drill(
            DrillConfig(seed=0, lose_bilog=True)), steps, card)
    finally:
        faults.reset()
    if not green["ok"] or not (green["converged"] and green["resharded"]
                               and green["sever_verified"]):
        fail(f"phase 13 drill: not green: {green['failures']}")
    if red["ok"] or not any("lost-canary" in f for f in red["failures"]):
        fail(f"phase 13 drill --lose-bilog: not red on the lost key: "
             f"{red['failures']}")
    return {"lag_p99_s": green["lag_p99_s"],
            "lag_samples": green["lag_samples"], "keys": green["keys"],
            "agents": green["agents"],
            "schedule_digest": green["schedule_digest"],
            "lose_bilog_failures": red["failures"], "steps": steps}


# ------------------------------------------------------------ phase 14 --
#
# The twins of the reference's check smokes (ceph_tpu_torch/tools/
# check_<name>.py) through their entry points with ``--device cuda``, in
# the order of the port's queue: the ones that reach a kernel first.
# check_serving and check_dr run their cheap legs (``--quick``), as the
# reference's own tests do; their live legs run at full size in phases
# 13c and 13d.  (name, arguments, kernels the twin must launch)
P14_TWINS = (("multichip", [], ("k1",)), ("wire", [], ("k3",)),
             ("recovery", [], ("k1",)), ("async", [], ()),
             ("robustness", [], ("k1",)), ("observability", [], ("k1",)),
             ("serving", ["--quick"], ("k1",)), ("dr", ["--quick"], ()))


def check_plane_counts(where: str, d: dict, cells: int) -> None:
    """``check_counts`` for a step that runs with the sharded data plane
    on for a while: a plane dispatch is one ec.jax or rebuild dispatch
    that launches K1 once on each of the plane's ``cells``."""
    on = d["k1_plane_on"]
    if on == 0 or on % cells:
        fail(f"{where}: {on} K1 launches with the plane on, not a "
             f"positive multiple of its {cells} cells")
    check_counts(where, dict(d, k1=d["k1"] - on + on // cells))


def p14_twins(device, card: str) -> dict:
    """14: every twin's ``main`` on the card, each a counted step (K1 =
    ec.jax + rebuild dispatches, a plane dispatch once a cell; K3 = device
    crc dispatches; K2 none; no plain version); each must return 0 and
    launch the kernels ``P14_TWINS`` names."""
    import importlib
    steps, lines = {}, {}
    for name, argv, kernels in P14_TWINS:
        mod = importlib.import_module(f"ceph_tpu_torch.tools.check_{name}")
        check = None
        if name == "multichip":
            def check(where, d, cells=mod.N_CELLS):
                check_plane_counts(where, d, cells)
        rc, out, err = counted_step(
            device, 14, name,
            lambda: tool_run(mod.main, ["--device", device.type, *argv]),
            steps, card, check=check)
        if rc != 0:
            fail(f"phase 14 check_{name}: rc {rc}\n{out}\n{err}")
        for kernel in kernels:
            if not steps[name][kernel]:
                fail(f"phase 14 check_{name}: {kernel.upper()} never "
                     f"launched")
        lines[name] = out.strip().splitlines()
        emit({"phase": "p14_twin", "twin": f"check_{name}", "argv": argv,
              "s": steps[name]["s"], "k1": steps[name]["k1"],
              "k3": steps[name]["k3"], "out": lines[name],
              "launch_shapes": steps[name]["launch_shapes"], "gpu": card})
        torch.cuda.empty_cache()
    return {"steps": steps, "out": lines,
            "k1_launches": sum(st["k1"] for st in steps.values()),
            "k3_launches": sum(st["k3"] for st in steps.values())}


# ---------------------------------------------------- the operator's tools --
#
# The tools run through their entry points (``main(argv)`` with
# ``--device cuda`` where the tool takes it) on the phase whose map,
# cluster or gateway they use: 4b osdmaptool on phase 4's map, 5b
# crushtool on phase 5's crushmap text, 8b bench_sweep after phase 8, 10b
# rados on phase 10's daemons, 11d rbd and osdmaptool --upmap on phase
# 11's stack, 13e radosgw-admin and the manager's five modules on phase
# 13's gateway.
TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "tools")
T4_PGS = 1 << 17              # each of 2 pools: 2^18 PGs, ~79 an OSD
T5_LANES = 1 << 18            # crushtool's x range
T8_GRID = {"plugins": "jax,jerasure", "k": "4,8", "m": "2,3",
           "sizes": "4096,1048576", "workloads": "encode,decode"}
T8_ARGS = [a for key, val in T8_GRID.items() for a in (f"--{key}", val)]
T8_ITERS, T8_BATCH = 4, 16
T10_PGS = 32
T10_OBJ = 4 << 20
T10_BENCH_S = 5
T11_IMAGE = 16 << 20


def tool_run(main, argv, **kw):
    """(exit code, stdout, stderr) of a tool's ``main(argv, **kw)`` in this
    process; a tool that takes ``out=`` writes its stdout there."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if kw.pop("out", False):
            rc = main(argv, out=out, **kw)
        else:
            rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def returns_of(owner, name: str, sink: list):
    """Appends what ``owner.name`` returns to ``sink`` while the block runs
    (a pass-through around it), then puts it back."""
    fn = getattr(owner, name)

    def observed(*a, **k):
        r = fn(*a, **k)
        sink.append(r)
        return r
    setattr(owner, name, observed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def shapes_of(steps: dict) -> dict:
    """{kernel: {key: launches}} summed over counted steps."""
    out = {}
    for st in steps.values():
        for kern, keys in st["launch_shapes"].items():
            h = out.setdefault(kern, {})
            for key, n in keys.items():
                h[key] = h.get(key, 0) + n
    return out


def check_held(where: str, launched: dict, held: dict) -> None:
    """Fails if a step launched a kernel at a shape phase 2 did not hold
    against its plain version ({kernel: {key: n}})."""
    for kernel, keys in launched.items():
        loose = [k for k in sorted(keys) if not shape_held(k, held[kernel])]
        if loose:
            fail(f"{where} launched {kernel.upper()} at shapes phase 2 did "
                 f"not hold against its plain version: {loose}")


def tools_osdmaptool(device, card: str, cmap) -> dict:
    """4b: ``osdmaptool <spec> --test-map-pgs`` on phase 4's map, two
    3-replica pools of T4_PGS PGs; every up set and primary against the
    native mapper, the printed avg / min / max against a NumPy count of
    the native rows."""
    from ceph_tpu_torch.cluster.osdmap import OSDMap
    from ceph_tpu_torch.native_bridge import NativeMapper
    from ceph_tpu_torch.placement.crush_map import ITEM_NONE
    from ceph_tpu_torch.tools import osdmaptool
    os.makedirs(TOOLS_DIR, exist_ok=True)
    spec = {"crush": cmap.to_spec(),
            "pools": [{"id": p, "name": f"rep{p}", "type": 1, "size": 3,
                       "pg_num": T4_PGS, "crush_rule": 0} for p in (1, 2)],
            "osds": {"down": [], "out": []}}
    path = os.path.join(TOOLS_DIR, "osdmap.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    maps = []
    c0 = step_counts()
    sync(device)
    t0 = time.perf_counter()
    with returns_of(OSDMap, "map_pgs_batch", maps):
        rc, out, err = tool_run(osdmaptool.main, [
            path, "--test-map-pgs", "--device", str(device)])
    sync(device)
    wall = time.perf_counter() - t0
    if rc != 0 or len(maps) != 2:
        fail(f"4b osdmaptool: exit {rc}, {len(maps)} pool sweeps")
    if step_counts() != c0:
        fail("4b osdmaptool: a kernel or a plain version ran on placement")
    om = osdmaptool.load_cluster(spec, device="cpu")
    nm = NativeMapper(cmap)
    weights = om.osd_weight[:cmap.max_devices].copy()
    counts = np.zeros(om.max_osd, dtype=np.int64)
    t0 = time.perf_counter()
    for pid, (up, prim) in zip((1, 2), maps):
        pps = om.pools[pid].raw_pg_to_pps_batch(np.arange(T4_PGS))
        want = compact(native_rows(nm, pps, 3, weights), ITEM_NONE)
        want_prim = np.where(want[:, 0] != ITEM_NONE, want[:, 0], -1)
        if not np.array_equal(np.asarray(up), want) or \
                not np.array_equal(np.asarray(prim), want_prim):
            fail(f"4b osdmaptool: pool {pid}'s up sets or primaries differ "
                 "from the native mapper")
        np.add.at(counts, want[want != ITEM_NONE], 1)
    native_s = time.perf_counter() - t0
    used = counts[counts > 0]
    want_out = (f" avg {used.mean():.2f} min {used.min()} max {used.max()} "
                f"over {len(used)} osds\n total replicas {2 * T4_PGS * 3}\n")
    if out != want_out:
        fail(f"4b osdmaptool printed {out!r}, the native count {want_out!r}")
    pgs_s = float(err.split("(")[1].split(" pg/s")[0].replace(",", ""))
    return {"pools": 2, "pgs": 2 * T4_PGS, "osds": cmap.max_devices,
            "stdout": out.splitlines(), "pg_per_s": pgs_s,
            "tool_wall_s": wall, "native_s": native_s,
            "native_lanes_checked": 2 * T4_PGS, "launches": {},
            "gpu": card}


def tools_crushtool(device, card: str, text: str) -> dict:
    """5b: ``crushtool -i <phase 5's crushmap text> --test
    --show-statistics --show-utilization`` over x in [0, T5_LANES) on the
    general mapper; its mappings against the native mapper, and its
    printout against the same printout made from the native rows."""
    import argparse

    from ceph_tpu_torch.native_bridge import NativeMapper
    from ceph_tpu_torch.placement.compiler import compile_crushmap
    from ceph_tpu_torch.placement.crush_map import WEIGHT_ONE
    from ceph_tpu_torch.placement.xla_mapper import XlaMapper
    from ceph_tpu_torch.tools import crushtool
    os.makedirs(TOOLS_DIR, exist_ok=True)
    path = os.path.join(TOOLS_DIR, "straw.crush")
    with open(path, "w") as f:
        f.write(text)
    pc = perf("crush.mapper")
    f0 = pc.dump().get("fallback_lanes", 0)
    rows = []
    c0 = step_counts()
    sync(device)
    t0 = time.perf_counter()
    with returns_of(XlaMapper, "map_batch", rows):
        rc, out, err = tool_run(crushtool.main, [
            "-i", path, "--test", "--show-statistics", "--show-utilization",
            "--min-x", "0", "--max-x", str(T5_LANES - 1), "--rule", "0",
            "--num-rep", "3", "--device", str(device)])
    sync(device)
    wall = time.perf_counter() - t0
    fallback = pc.dump().get("fallback_lanes", 0) - f0
    if rc != 0 or len(rows) != 1:
        fail(f"5b crushtool: exit {rc}, {len(rows)} sweeps")
    if fallback:
        fail(f"5b crushtool: {fallback} lanes went to the host")
    if step_counts() != c0:
        fail("5b crushtool: a kernel or a plain version ran on placement")
    cmap = compile_crushmap(text)
    t0 = time.perf_counter()
    raw = native_rows(NativeMapper(cmap), np.arange(T5_LANES), 3,
                      [WEIGHT_ONE] * cmap.max_devices)
    native_s = time.perf_counter() - t0
    if not np.array_equal(np.asarray(rows[0]), raw):
        fail("5b crushtool: the mappings differ from the native mapper")
    # the tool's printout made from the native rows: the utilization
    # lines are a count of them
    args = argparse.Namespace(
        rule=0, weight=None, min_x=0, max_x=T5_LANES - 1, num_rep=3,
        min_rep=1, max_rep=10, scalar=False, show_mappings=False,
        show_utilization=True, show_statistics=True,
        show_bad_mappings=False, device=torch.device("cpu"))
    buf = io.StringIO()
    keep = XlaMapper.map_batch
    XlaMapper.map_batch = lambda self, *a, **k: raw
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            crushtool.run_test(cmap, args)
    finally:
        XlaMapper.map_batch = keep
    if out != buf.getvalue():
        fail("5b crushtool: the utilization or statistics lines differ from "
             "a count of the native rows")
    rate = float(err.split("(")[1].split(" mappings/s")[0].replace(",", ""))
    return {"lanes": T5_LANES, "rule": 0, "num_rep": 3,
            "osds": cmap.max_devices, "fallback_lanes": fallback,
            "mappings_per_s": rate, "tool_wall_s": wall,
            "native_s": native_s,
            "stdout_lines": len(out.splitlines()),
            "statistics": [ln for ln in out.splitlines() if " size " in ln],
            "launches": {}, "gpu": card}


def sweep_dispatches() -> dict:
    """``step_counts`` and the bitmatrix codec's dispatches."""
    return dict(step_counts(),
                bitmatrix=bitmatrix_codec.encode_dispatches +
                bitmatrix_codec.decode_dispatches)


def sweep_rows(stdout: str) -> list:
    """bench_sweep's CSV rows less the measured ``gbps`` column."""
    return [ln.rsplit(",", 1)[0] for ln in stdout.splitlines()[1:]]


def tools_bench_sweep(device, card: str) -> dict:
    """8b: ``bench_sweep`` over the jax and jerasure codecs on the card;
    each cell's K1 and K2 launches against its codec's dispatches, the
    rows and skipped cells against the port's own run on the CPU."""
    from ceph_tpu_torch.tools import bench_sweep
    cells = []
    cell = bench_sweep.bench_cell
    shapes = {}

    def observed(plugin, technique, k, m, size, workload, *a, **kw):
        c0 = sweep_dispatches()
        try:
            return cell(plugin, technique, k, m, size, workload, *a, **kw)
        finally:
            d = {key: v - c0[key] for key, v in sweep_dispatches().items()}
            cells.append(((plugin, technique, k, m, size, workload), d))

    def seen(kernel, key):
        h = shapes.setdefault(kernel, {})
        h[key] = h.get(key, 0) + 1

    argv = T8_ARGS + ["--iters", str(T8_ITERS), "--batch", str(T8_BATCH),
                      "--device", str(device)]
    sync(device)
    t0 = time.perf_counter()
    bench_sweep.bench_cell = observed
    try:
        with launch_shapes(seen):
            rc, out, err = tool_run(bench_sweep.main, argv)
    finally:
        bench_sweep.bench_cell = cell
    sync(device)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"8b bench_sweep: exit {rc}")
    k1 = k2 = 0
    for (plugin, technique, *_), d in cells:
        if d["plain"] or d["k3"]:
            fail(f"8b bench_sweep {plugin}/{technique}: a plain version or "
                 f"K3 ran ({d})")
        bitsliced = plugin == "jax" and technique.endswith("+bitsliced")
        jax = d["ec_dispatches"]
        want1 = (jax if bitsliced else 0) + d["bitmatrix"]
        want2 = 0 if bitsliced or plugin != "jax" else jax
        if (d["k1"], d["k2"]) != (want1, want2):
            fail(f"8b bench_sweep {plugin}/{technique}: K1 {d['k1']} and K2 "
                 f"{d['k2']} launches for {jax} ec.jax and "
                 f"{d['bitmatrix']} bitmatrix dispatches")
        k1 += d["k1"]
        k2 += d["k2"]
    if not k1 or not k2:
        fail(f"8b bench_sweep: K1 {k1}, K2 {k2} launches")
    # the port's own run on the CPU: the same rows and skipped cells
    # (iterations and batch change neither)
    t0 = time.perf_counter()
    rc_c, out_c, err_c = tool_run(bench_sweep.main, T8_ARGS + [
        "--iters", "1", "--batch", "2", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    skipped = [ln for ln in err.splitlines() if ln.startswith("# ")]
    if rc_c != 0 or sweep_rows(out) != sweep_rows(out_c) or \
            skipped != [ln for ln in err_c.splitlines()
                        if ln.startswith("# ")]:
        fail("8b bench_sweep: the card's rows or skipped cells differ from "
             "the CPU run's")
    return {"rows": out.splitlines()[1:], "skipped": skipped,
            "cells": len(cells), "k1_launches": k1, "k2_launches": k2,
            "launch_shapes": shapes, "tool_wall_s": wall,
            "cpu_run_s": cpu_s, "iters": T8_ITERS, "batch": T8_BATCH,
            "gpu": card}


def tools_rados(device, card: str, cluster_dir: str) -> dict:
    """10b: on phase 10's daemons, a 4+2 pool made with the mon's
    ``pool_create`` request and the ``"default"`` profile (the request
    ``ceph osd pool create`` sends); ``rados put`` of a 4 MiB object,
    ``get``, ``ls``, ``rm``, then ``rados bench`` of 1 MiB writes."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    from ceph_tpu_torch.tools import rados_cli
    os.makedirs(TOOLS_DIR, exist_ok=True)
    steps = {}
    rc = RemoteCluster(cluster_dir)
    try:
        made = rc.mon_call({"cmd": "pool_create", "name": "rados42",
                            "pg_num": T10_PGS, "type": 3, "size": 6,
                            "crush_rule": 1,
                            "erasure_code_profile": "default"})
    finally:
        rc.close()
    data = np.random.default_rng(SEED + 100).integers(
        0, 256, T10_OBJ, dtype=np.uint8).tobytes()
    got_path = os.path.join(TOOLS_DIR, "rados_get.bin")

    def rados(*words, data_in=None):
        return tool_run(rados_cli.main, [
            "--dir", cluster_dir, "-p", "rados42", *words, "--device",
            str(device)], out=True, data_in=data_in)

    def put():
        # retried until every shard acks (ROADMAP C5)
        for _ in range(12):
            res = rados("put", "big", "-", data_in=data)
            if res[1] == f"wrote {T10_OBJ} bytes (6 acks)\n":
                return res
            time.sleep(0.5)
        fail(f"10b rados put: {res}")

    counted_step(device, 10, "tools_rados_put", put, steps, card)
    res = counted_step(device, 10, "tools_rados_get",
                       lambda: rados("get", "big", got_path), steps, card)
    with open(got_path, "rb") as f:
        if res[0] != 0 or f.read() != data:
            fail("10b rados get: the bytes read back differ")
    os.remove(got_path)
    res = counted_step(device, 10, "tools_rados_ls", lambda: rados("ls"),
                       steps, card)
    if res[0] != 0 or "big" not in res[1].splitlines():
        fail(f"10b rados ls: {res}")
    res = counted_step(device, 10, "tools_rados_rm",
                       lambda: rados("rm", "big"), steps, card)
    if res[0] != 0:
        fail(f"10b rados rm: {res}")
    res = counted_step(device, 10, "tools_rados_bench",
                       lambda: rados("bench", str(T10_BENCH_S)), steps, card)
    words = res[1].split()
    if res[0] != 0 or words[1:4] != ["writes", "x", "1"]:
        fail(f"10b rados bench: {res}")
    return {"pool": made, "object_bytes": T10_OBJ,
            "bench_writes": int(words[0]),
            "bench_mib_per_s": float(words[-2]),
            "bench_line": res[1].strip(), "steps": steps,
            "k1_launches": sum(s["k1"] for s in steps.values()),
            "k3_launches": sum(s["k3"] for s in steps.values()),
            "launch_shapes": shapes_of(steps), "gpu": card}


def tools_ceph(device, card: str, cluster_dir: str, live_osd: int) -> dict:
    """10c: the ``ceph`` CLI on phase 10's daemons with its client on the
    card: ``status``, ``health``, ``osd tree``, ``df``, ``osd df``, ``pg
    dump 1``, ``osd pool create|ls|rm``, ``osd set|unset noout`` and
    ``daemon osd.N perf dump`` (``live_osd``: the lowest OSD phase 10 did
    not kill), each a counted step (its wall time printed)."""
    from ceph_tpu_torch.tools import ceph_cli
    steps = {}

    def ceph(label, *words, ok=(0,)):
        res = counted_step(device, 10, f"tools_ceph_{label}",
                           lambda: tool_run(ceph_cli.main, [
                               "--device", str(device), "--dir",
                               cluster_dir, *words], out=True),
                           steps, card)
        if res[0] not in ok or not res[1]:
            fail(f"10c ceph {' '.join(words)}: {res}")
        return res[1]

    status = ceph("status", "status")
    # phase 10 killed two OSDs: health may warn, never fail to answer
    health = ceph("health", "health", ok=(0, 1))
    tree = ceph("osd_tree", "osd", "tree")
    df = ceph("df", "df")
    osd_df = ceph("osd_df", "osd", "df")
    pgs = ceph("pg_dump", "pg", "dump", "1")
    created = ceph("pool_create", "osd", "pool", "create", "ceph10c", "8")
    listed = ceph("pool_ls", "osd", "pool", "ls")
    noout = ceph("osd_set", "osd", "set", "noout")
    unset = ceph("osd_unset", "osd", "unset", "noout")
    removed = ceph("pool_rm", "osd", "pool", "rm", "ceph10c")
    after = ceph("pool_ls_after", "osd", "pool", "ls")
    perf_dump = json.loads(ceph("daemon_perf_dump", "daemon",
                                f"osd.{live_osd}", "perf", "dump"))
    if "health:" not in status or not health.startswith("HEALTH_"):
        fail(f"10c ceph status/health: {status!r} {health!r}")
    if sum(line.endswith(("  up", "  down"))
           for line in tree.splitlines()) != PC_OSDS:
        fail(f"10c ceph osd tree: {tree!r}")
    if "ec" not in df or "NAME" not in osd_df:
        fail(f"10c ceph df: {df!r} {osd_df!r}")
    if len(pgs.splitlines()) != PC_PG_NUM + 1:
        fail(f"10c ceph pg dump: {len(pgs.splitlines())} lines")
    if "created" not in created or "ceph10c" not in listed.split() or \
            "ceph10c" in after.split() or "removed" not in removed:
        fail(f"10c ceph pool create/ls/rm: {created!r} {listed!r} "
             f"{removed!r} {after!r}")
    if noout != "noout is set (flags: noout)\n" or \
            unset != "noout is unset (flags: -)\n":
        fail(f"10c ceph osd set/unset: {noout!r} {unset!r}")
    if not perf_dump:
        fail(f"10c ceph daemon osd.{live_osd} perf dump: empty")
    return {"steps": steps, "daemon": f"osd.{live_osd}",
            "perf_groups": len(perf_dump),
            "k1_launches": sum(s["k1"] for s in steps.values()),
            "k3_launches": sum(s["k3"] for s in steps.values()),
            "launch_shapes": shapes_of(steps), "gpu": card}


def tools_lint(card: str) -> dict:
    """10c: ``ceph lint --check`` and the static smoke (its seeded tier
    and its real tier) on the checkout, each timed; the lint's finding,
    baselined and noqa counts."""
    from ceph_tpu_torch.tools import ceph_cli, check_static
    t0 = time.perf_counter()
    rc, out, _err = tool_run(ceph_cli.main, ["lint", "--check", "--json"],
                             out=True)
    lint_s = time.perf_counter() - t0
    rep = json.loads(out)
    if rc != 0 or rep["count"] or rep["stale_baseline"]:
        fail(f"10c ceph lint --check: rc {rc}, {rep['count']} findings, "
             f"{rep['findings'][:5]}, stale {rep['stale_baseline']}")
    t0 = time.perf_counter()
    rc2, out2, err2 = tool_run(check_static.main, [])
    static_s = time.perf_counter() - t0
    if rc2 != 0:
        fail(f"10c check_static: {out2} {err2}")
    res = {"lint_s": lint_s, "findings": rep["count"],
           "baselined": rep["baselined"], "noqa": rep["noqa"],
           "rules": len(rep["rules"]), "check_static_s": static_s,
           "check_static": out2.strip().splitlines(), "gpu": card}
    emit({"phase": "p10_step", "step": "tools_lint", "s": lint_s,
          "gpu": card})
    emit({"phase": "p10_step", "step": "tools_check_static",
          "s": static_s, "gpu": card})
    return res


def tools_rbd(device, card: str, io_a) -> dict:
    """11d: ``rbd`` on phase 11's RS(8,3) pool: create a 16 MiB image,
    write it whole, snapshot, overwrite its first object, list and roll
    back, protect, clone, flatten, remove; every byte against an
    in-memory oracle.  On an EC pool the overwrite drops the object's
    SnapSet in both packages (ROADMAP C), so the rollback and the clone
    read the head: the oracle follows the reference."""
    from ceph_tpu_torch.client.rbd import Image
    from ceph_tpu_torch.tools import rbd_cli
    steps = {}
    rng = np.random.default_rng(SEED + 111)
    oracle = bytearray(rng.integers(0, 256, T11_IMAGE, dtype=np.uint8)
                       .tobytes())
    first = rng.integers(0, 256, P11_OBJ, dtype=np.uint8).tobytes()

    def rbd(*args):
        res = tool_run(rbd_cli.main, list(args), ioctx=io_a, out=True)
        if res[0] != 0:
            fail(f"11d rbd {' '.join(args)}: {res}")
        return json.loads(res[1])

    def write_whole():
        img = Image(io_a, "t16")
        for off in range(0, T11_IMAGE, P11_OBJ):
            img.write(off, bytes(oracle[off:off + P11_OBJ]))

    def overwrite_first():
        Image(io_a, "t16").write(0, first)
        oracle[:P11_OBJ] = first

    for label, fn in (
            ("create", lambda: rbd("create", "t16", "--size",
                                   str(T11_IMAGE))),
            ("write", write_whole),
            ("snap_create", lambda: rbd("snap", "create", "t16@s1")),
            ("overwrite", overwrite_first),
            ("snap_ls", lambda: rbd("snap", "ls", "t16")),
            ("snap_rollback", lambda: rbd("snap", "rollback", "t16@s1")),
            ("snap_protect", lambda: rbd("snap", "protect", "t16@s1")),
            ("clone", lambda: rbd("clone", "t16@s1", "t16c")),
            ("flatten", lambda: rbd("flatten", "t16c")),
            ("read_back", lambda: (
                Image(io_a, "t16").read(0, T11_IMAGE),
                Image(io_a, "t16c").read(0, T11_IMAGE))),
            ("rm", lambda: [rbd("rm", "t16c"),
                            rbd("snap", "unprotect", "t16@s1"),
                            rbd("snap", "rm", "t16@s1"), rbd("rm", "t16"),
                            rbd("ls")])):
        out = counted_step(device, 11, f"tools_rbd_{label}", fn, steps, card)
        if label == "snap_ls" and out != ["s1"]:
            fail(f"11d rbd snap ls: {out}")
        if label == "read_back" and (out[0] != bytes(oracle) or
                                     out[1] != bytes(oracle)):
            fail("11d rbd: the image or its flattened clone differs from "
                 "its oracle")
        if label == "rm" and {"t16", "t16c"} & set(out[-1]):
            fail(f"11d rbd: an image outlived its rm: {out[-1]}")
    return {"image_bytes": T11_IMAGE, "steps": steps,
            "k1_launches": sum(s["k1"] for s in steps.values()),
            "launch_shapes": shapes_of(steps), "gpu": card}


def tools_upmap(device, card: str, om, want) -> dict:
    """11d: ``osdmaptool --upmap`` on phase 11's map with its 3-replica
    pool; the items and the printed line against phase 11c's CPU copy's
    ``calc_pg_upmaps`` (``want``, its pool 1, at its 64 moves a round)."""
    from ceph_tpu_torch.tools import osdmaptool
    os.makedirs(TOOLS_DIR, exist_ok=True)
    pool = om.pools[1]
    spec = {"crush": om.crush.to_spec(),
            "pools": [{"id": 1, "name": "rep", "type": 1, "size": pool.size,
                       "pg_num": pool.pg_num, "crush_rule": pool.crush_rule}],
            "osds": {"down": [], "out": []}}
    path = os.path.join(TOOLS_DIR, "p11_osdmap.json")
    out_path = os.path.join(TOOLS_DIR, "p11_upmap.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    steps = {}
    rc, out, _ = counted_step(device, 11, "tools_osdmaptool_upmap",
                              lambda: tool_run(osdmaptool.main, [
                                  path, "--upmap", out_path, "--upmap-max",
                                  "64", "--device", str(device)]),
                              steps, card)
    with open(out_path) as f:
        items = json.load(f)["pg_upmap_items"]
    res, cpu = want
    want_items = {f"{pid}.{pg}": [[int(a), int(b)] for a, b in pairs]
                  for (pid, pg), pairs in sorted(cpu.pg_upmap_items.items())}
    want_line = (f"balanced in {res.rounds} rounds: {res.moves} moves, "
                 f"max deviation {res.max_deviation_before:.2f} -> "
                 f"{res.max_deviation_after:.2f}\n")
    if rc != 0 or items != want_items or out != want_line:
        fail(f"11d osdmaptool --upmap: {out!r} and {len(items)} items, the "
             f"CPU copy {want_line!r} and {len(want_items)}")
    return {"upmap_pgs": len(items), "stdout": out.strip(), "steps": steps,
            "gpu": card}


def tools_gateway_mgr(device, card: str, sim, mon, io_s3, objs: dict,
                      stored: int, steps: dict) -> dict:
    """13e: ``radosgw-admin`` on phase 13's gateway (user create / info,
    bucket list / stats / limit check), then ``MgrModuleHost`` over its
    sim and mon with the five modules: a Prometheus render and one HTTP
    scrape, the dashboard's API, the autoscaler's recommendations,
    telemetry's report and devicehealth's samples."""
    import urllib.request

    from ceph_tpu_torch.mgr import (MgrModuleHost, dashboard_module,
                                    devicehealth_module, pg_autoscaler,
                                    prometheus_module, telemetry_module)
    from ceph_tpu_torch.tools import radosgw_admin

    def admin(*args):
        res = tool_run(radosgw_admin.main, list(args), ioctx=io_s3, out=True)
        if res[0] != 0:
            fail(f"13e radosgw-admin {' '.join(args)}: {res}")
        return json.loads(res[1])

    def step(label, fn):
        return counted_step(device, 13, f"tools_{label}", fn, steps, card)

    user = step("radosgw_admin_user_create", lambda: admin(
        "user", "create", "--uid", "ops", "--display-name", "Operator"))
    if step("radosgw_admin_user_info",
            lambda: admin("user", "info", "--uid", "ops")) != user:
        fail("13e radosgw-admin: user info differs from user create")
    buckets = step("radosgw_admin_bucket_list",
                   lambda: admin("bucket", "list"))
    stats = step("radosgw_admin_bucket_stats", lambda: admin(
        "bucket", "stats", "--bucket", "s3"))["s3"]
    limits = step("radosgw_admin_bucket_limit_check",
                  lambda: admin("bucket", "limit", "check"))
    if buckets != ["s3"] or stats["num_objects"] != len(objs) or \
            stats["size"] != stored or stats["num_shards"] != P13_RESHARD:
        fail(f"13e radosgw-admin: buckets {buckets}, stats {stats}; phase "
             f"13 wrote {len(objs)} objects of {stored} B")
    row = {r["bucket"]: r for r in limits}["s3"]
    if sum(row["shard_entries"]) != len(objs) or \
            row["num_shards"] != P13_RESHARD:
        fail(f"13e radosgw-admin bucket limit check: {row}")

    host = MgrModuleHost(sim, mon)
    for mod in (prometheus_module, pg_autoscaler, devicehealth_module,
                telemetry_module, dashboard_module):
        mod.register(host)
    for name in ("prometheus", "pg_autoscaler", "devicehealth", "telemetry",
                 "dashboard"):
        host.enable(name)
    per_pool = {}
    for (pid, _name), _info in sim.objects.items():
        per_pool[pid] = per_pool.get(pid, 0) + 1
    prom = host.modules["prometheus"]
    t0 = time.perf_counter()
    text = step("mgr_prometheus_render", prom.render)
    render_s = time.perf_counter() - t0
    groups = sorted(g for g, d in perf().dump_typed().items() if d)
    missing = [g for g in groups if "# TYPE ceph_tpu_" + g.replace(
        ".", "_").replace("-", "_") + "_" not in text]
    if missing:
        fail(f"13e prometheus: perf groups with no family: {missing}")
    for pid in sim.osdmap.pools:
        line = f'ceph_pool_objects{{pool_id="{pid}"}} {per_pool.get(pid, 0)}'
        if line not in text.splitlines():
            fail(f"13e prometheus: no line {line!r}")
    port = prom.start_http(0)
    try:
        body = step("mgr_prometheus_scrape", lambda: urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=60).read().decode())
    finally:
        prom.stop_http()
    families = {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")}
    if {ln.split()[2] for ln in body.splitlines()
            if ln.startswith("# TYPE ")} != families:
        fail("13e prometheus: the scrape's families differ from the render's")
    dash = host.modules["dashboard"]
    dport = dash.start_http(0)
    api = {}
    try:
        def get_all():
            import http.client
            for route in ("/api/summary", "/api/health", "/api/osds",
                          "/api/pools", "/api/pgs", "/api/perf",
                          "/api/crush", "/api/config"):
                c = http.client.HTTPConnection("127.0.0.1", dport,
                                               timeout=120)
                c.request("GET", route)
                r = c.getresponse()
                api[route] = (r.status, json.loads(r.read()))
                c.close()
        step("mgr_dashboard_api", get_all)
    finally:
        dash.stop_http()
    if any(st != 200 for st, _ in api.values()):
        fail(f"13e dashboard: {[(k, v[0]) for k, v in api.items()]}")
    pools = {p["id"]: p for p in api["/api/pools"][1]}
    pgs = api["/api/pgs"][1]
    if any(pools[pid]["objects"] != per_pool.get(pid, 0) for pid in pools) \
            or sum(pgs["states"].values()) != sum(
                p.pg_num for p in sim.osdmap.pools.values()):
        fail(f"13e dashboard: pools {pools} or PG states {pgs['states']}")
    recs = step("mgr_pg_autoscaler",
                host.modules["pg_autoscaler"].recommendations)
    tel = host.modules["telemetry"]
    tel.on()
    step("mgr_telemetry_send", tel.send)
    report = tel.last_report()
    if report["total_objects"] != len(sim.objects) or \
            len(report["pools"]) != len(sim.osdmap.pools):
        fail(f"13e telemetry: {report['total_objects']} objects in the "
             f"report, {len(sim.objects)} in the sim")
    dh = host.modules["devicehealth"]
    step("mgr_devicehealth_scrape", dh.scrape)
    verdicts = {}
    for i in dh.metrics:
        v = dh.life_expectancy(i)
        verdicts[v] = verdicts.get(v, 0) + 1
    return {"user": user["uid"], "bucket_stats": stats,
            "limit_check": row, "render_bytes": len(text.encode()),
            "render_s": render_s, "families": len(families),
            "perf_groups": len(groups), "health": api["/api/health"][1],
            "pg_states": pgs["states"], "autoscaler": recs,
            "telemetry_health": report["health"],
            "devicehealth_verdicts": verdicts,
            "devicehealth_checks": dh.checks(), "gpu": card}

def rados_k1_shapes(device, gen) -> dict:
    """K1 at 10b's shapes: the rados client's RS(4,2) pool (the
    ``"default"`` profile's fallback, C11) encodes a 4 MiB object as one
    stripe of 1 MiB chunks and a bench write as one of 256 KiB chunks."""
    masks = torch.as_tensor(gf2.bitmatrix_masks(gf.gf8_bitmatrix(
        gf.vandermonde_parity(4, 2))), device=device)
    return {f"rados_put_{W}": (masks, random_words((1, 32, W), gen, device))
            for W in (T10_OBJ // 4 // 32, (1 << 20) // 4 // 32)}


# K1's shapes in phase 14, as the twins launch them, (B, C, W, R): C input
# rows (8 planes a data chunk, 8k, or 8(k + m) for a per-stripe rebuild),
# W words a plane (the stripe unit / 32), R output rows (8 an output
# chunk).  Each is held at a batch above the largest the twins launch,
# once with one mask table for the batch and once with a table a batch
# row: check_multichip's RS(4,2) sims (make_sim's 4 KiB stripe unit,
# W = 128, and entry.build_sim's 64 B, W = 2, on each of 8 cells),
# check_recovery's RS(4,2) at 16 KiB (W = 512), check_robustness's thrash
# stack (RS(4,2), W = 128), and check_observability's and check_serving's
# RS(2,1) pools (W = 128).
P14_K1 = ((64, 32, 2, 16), (64, 32, 2, 8), (64, 48, 2, 16),
          (32, 32, 128, 16), (32, 32, 128, 8), (32, 48, 128, 16),
          (32, 32, 512, 16), (32, 48, 512, 16), (64, 16, 128, 8))


def twin_k1_shapes(device, gen) -> dict:
    """K1 at phase 14's shapes (``P14_K1``), each with a shared mask table
    and with one a batch row, the tables random bit-matrices."""
    rng = np.random.default_rng(SEED + 14)
    out = {}
    for B, C, W, R in P14_K1:
        words = random_words((B, C, W), gen, device)
        shared = gf2.bitmatrix_masks(rng.integers(0, 2, (R, C),
                                                  dtype=np.uint8))
        rows = np.stack([gf2.bitmatrix_masks(
            rng.integers(0, 2, (R, C), dtype=np.uint8)) for _ in range(B)])
        out[f"p14_{B}x{C}x{W}_{R}"] = (torch.as_tensor(shared,
                                                       device=device), words)
        out[f"p14_{B}x{C}x{W}_{R}_per_row"] = (
            torch.as_tensor(rows, device=device), words)
    return out


def bench_sweep_operands(device):
    """K1's and K2's operands at 8b's shapes: every cell of 8b's grid run
    once through ``bench_sweep.bench_cell`` at its batch on the card, the
    first operand of each launch shape kept.  Returns ({name: (masks,
    words)}, {name: (bitmat, data)}) for ``kernel_checks`` and
    ``k2_checks``."""
    from ceph_tpu_torch.tools import bench_sweep
    k1, k2 = {}, {}
    l1, l2 = xor_kernel._launch, gf_pallas._launch

    def cap1(m3, w3, per_batch):
        key = ",".join(map(str, w3.shape)) + f"->{m3.shape[1]}"
        if key not in k1:
            k1[key] = (m3.clone() if per_batch else m3[0].clone(),
                       w3.clone())
        return l1(m3, w3, per_batch)

    def cap2(bm, d3, m):
        key = ",".join(map(str, d3.shape)) + f"->{m}"
        if key not in k2:
            k2[key] = (bm.copy(), d3.clone())
        return l2(bm, d3, m)

    xor_kernel._launch, gf_pallas._launch = cap1, cap2
    try:
        for plugin in T8_GRID["plugins"].split(","):
            for technique in bench_sweep.TECHNIQUES[plugin]:
                for k in map(int, T8_GRID["k"].split(",")):
                    for m in map(int, T8_GRID["m"].split(",")):
                        for size in map(int, T8_GRID["sizes"].split(",")):
                            for wl in T8_GRID["workloads"].split(","):
                                try:
                                    bench_sweep.bench_cell(
                                        plugin, technique, k, m, size, wl,
                                        1, T8_BATCH, device)
                                except ErasureCodeError:
                                    # a profile the codec refuses: the
                                    # sweep skips it too (8b holds its
                                    # skips to the CPU run's)
                                    pass
    finally:
        xor_kernel._launch, gf_pallas._launch = l1, l2
    return ({f"sweep_{key}": v for key, v in k1.items()},
            {f"sweep_{key}": v for key, v in k2.items()})


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


K1_TIMED = (("encode", 50), ("decode", 50), ("rebuild", 50),
            ("liber8tion_w8_encode", 50), ("liberation_w7_encode", 50),
            ("pc_put", 4), ("pc_durable_put", 20), ("pc_decode", 20),
            ("p11_encode_128", 50), ("p11_encode_1", 50),
            ("p11_decode_2", 50), ("p13_encode_3", 50),
            ("p13_encode_32", 50), ("p13_decode_1_1", 50),
            ("p13_decode_3_32", 50), ("p13_rebuild_7", 50))


def time_k1(shapes, card: str) -> dict:
    """K1's device time at the encode, decode and rebuild shapes, at the
    liber8tion (w = 8) and liberation (w = 7) encodes, at the process
    cluster's staged put, durable put and 2-erasure decode, at phase
    11's object put, small write and 2-erasure decode, and at phase 13's
    most-launched 4 KiB shapes, beside its bound, its plain version, its
    call time and its launch floor (an empty kernel at K1's grid and
    shared memory, by graph replay like K1; None where the package has
    no floor entry point)."""
    timings = {}
    floor = getattr(xor_kernel, "matmul_floor", None)
    for name, iters in K1_TIMED:
        masks, words = shapes[name]
        B, C, W = words.shape
        R = masks.shape[-2]
        Bm = B if masks.dim() == 3 else 1
        n0 = xor_kernel.launches
        ms = graph_ms(lambda: xor_kernel.xor_matmul_w32(masks, words),
                      iters=iters)
        call_ms = cuda_ms(lambda: xor_kernel.xor_matmul_w32(masks, words),
                          iters=iters)
        if xor_kernel.launches - n0 != 2 + iters + 2 + iters:
            fail("K1 timing: a wrapper call did not launch the kernel")
        floor_ms = None if floor is None else \
            graph_ms(lambda: floor(masks, words), iters=iters)
        if xor_kernel.launches - n0 != 2 + iters + 2 + iters:
            fail("K1 timing: the floor counted a K1 launch")
        m3 = masks if masks.dim() == 3 else masks[None]
        plain_ms = cuda_ms(lambda: xor_kernel._combine_torch(m3, words),
                           iters=3, warmup=1)
        bound_ms, bound_by, nbytes, ops = k1_bound(B, Bm, R, C, W)
        timings[name] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "timing", "kernel": "xor_matmul_w32", "shape": name,
              "masks": list(masks.shape), "words": list(words.shape),
              "ms": ms, "call_ms": call_ms, "floor_ms": floor_ms,
              "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
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
    shapes.update(rados_k1_shapes(device, gen))
    shapes.update(twin_k1_shapes(device, gen))
    shapes2 = k2_shapes(device, gen)
    shapes2.update(plugin_k2_shapes(device, gen))
    sweep_k1, sweep_k2 = bench_sweep_operands(device)
    shapes.update(sweep_k1)
    shapes2.update(sweep_k2)
    del sweep_k1, sweep_k2
    errs = kernel_checks(device, shapes)
    errs2 = k2_checks(device, shapes2)
    zw_shards = zerowire_shards()
    zw_pool = ragged_fused.pack(zw_shards).pool
    shapes3 = k3_shapes(device, gen, zw_pool)
    errs3 = k3_checks(device, shapes3)
    held = {"k1": held_shapes((w.shape, m.shape[-2])
                              for m, w in shapes.values()),
            "k2": held_shapes((d.shape, b.shape[0] // 8)
                              for b, d in shapes2.values()),
            "k3": held_shapes((p.shape, b.shape[0] // 8)
                              for b, p in shapes3.values() if p.dim() == 3)}
    del shapes3
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
    sweep_cmap = sweep.pop("_cmap")
    sweep["gpu"] = card
    emit({"phase": "placement_sweep", **sweep})
    # 4b. osdmaptool --test-map-pgs on the same map
    t0 = time.perf_counter()
    t4 = tools_osdmaptool(device, card, sweep_cmap)
    emit({"phase": "tools_osdmaptool", "s": time.perf_counter() - t0, **t4})
    del sweep_cmap

    # 5. general placement: the per-lane mapper (no kernel; the kernels'
    # counts are read around it inside and must not move)
    gp = general_placement(device)
    gp_text = gp.pop("_text")
    gp["gpu"] = card
    emit({"phase": "general_placement", **gp})
    # 5b. crushtool --test on the same crushmap text
    t0 = time.perf_counter()
    t5 = tools_crushtool(device, card, gp_text)
    emit({"phase": "tools_crushtool", "s": time.perf_counter() - t0, **t5})
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
    # 8b. bench_sweep over the jax and jerasure codecs
    t0 = time.perf_counter()
    t8 = tools_bench_sweep(device, card)
    emit({"phase": "tools_bench_sweep", "s": time.perf_counter() - t0, **t8})
    check_held("8b bench_sweep", t8["launch_shapes"], held)
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
    t10 = pc.pop("_tools")
    emit({"phase": "process_cluster", **pc})
    emit({"phase": "tools_rados",
          "s": sum(st["s"] for st in t10["steps"].values()), **t10})
    check_held("10b rados", t10["launch_shapes"], held)
    t10c = pc.pop("_ceph")
    emit({"phase": "tools_ceph",
          "s": sum(st["s"] for st in t10c["steps"].values()), **t10c})
    check_held("10c ceph", t10c["launch_shapes"], held)
    emit({"phase": "tools_lint", **tools_lint(card)})
    emit({"phase": "pc_csum_timing", **pc_csum_timing(device, card)})
    torch.cuda.empty_cache()

    # 11. the failure pipeline and the block tier (each step's counts are
    # read around it inside)
    p11_k1 = 0
    for seed, netsplit in ((0, False), (1, True)):
        th = p11_thrash(device, card, seed, netsplit)
        th["gpu"] = card
        emit({"phase": "thrash", **th})
        p11_k1 += th["k1_launches"]
        torch.cuda.empty_cache()
    bt = p11_block_tier(device, card)
    t11 = bt.pop("_tools")
    bt["gpu"] = card
    emit({"phase": "block_tier", **bt})
    emit({"phase": "tools_rbd",
          "s": sum(st["s"] for st in t11["steps"].values()), **t11})
    check_held("11d rbd", t11["launch_shapes"], held)
    p11_k1 += bt["k1_launches"] + t11["k1_launches"]
    torch.cuda.empty_cache()
    bal = p11_balancer(device, card)
    t11u = bal.pop("_tools")
    bal["gpu"] = card
    emit({"phase": "balancer", **bal})
    emit({"phase": "tools_osdmaptool_upmap",
          "s": sum(st["s"] for st in t11u["steps"].values()), **t11u})

    # 12. the sharded data plane over a mesh of cells on the card (each
    # run's counts are read around it inside)
    t12 = time.perf_counter()
    p12c = p12_cluster(device, card)
    p12r = p12_ragged(device, card, zw_pool)
    p12s = p12_steps(device, card, gen)
    p12_sweep(device, card, sweep_up0)
    p12_nccl(device, card, gen)
    emit({"phase": "p12_total", "s": time.perf_counter() - t12, "gpu": card})
    torch.cuda.empty_cache()

    # 13. the gateway tier and CephFS on the card, S3Serve and the DR
    # drill (each step's counts are read around it inside)
    t13 = time.perf_counter()
    p13 = {}
    for name, leg in (("s3", p13_s3), ("cephfs", p13_cephfs),
                      ("serve", p13_serve), ("drill", p13_drill)):
        t0 = time.perf_counter()
        p13[name] = leg(device, card)
        tools13 = p13[name].pop("_tools", None)
        emit({"phase": f"p13_{name}", "s": time.perf_counter() - t0,
              **p13[name], "gpu": card})
        if tools13 is not None:
            # 13e, on the S3 leg's gateway: its steps are the leg's
            for tool in ("radosgw_admin", "mgr"):
                tsteps = {k: v for k, v in p13[name]["steps"].items()
                          if k.startswith(f"tools_{tool}")}
                emit({"phase": f"tools_{tool}",
                      "s": sum(st["s"] for st in tsteps.values()),
                      "steps": tsteps, "launch_shapes": shapes_of(tsteps),
                      **({"user": tools13["user"],
                          "bucket_stats": tools13["bucket_stats"],
                          "limit_check": tools13["limit_check"]}
                         if tool == "radosgw_admin" else
                         {k: v for k, v in tools13.items()
                          if k not in ("user", "bucket_stats",
                                       "limit_check")}),
                      "gpu": card})
        torch.cuda.empty_cache()
    p13_k1 = sum(st["k1"] for res in p13.values()
                 for st in res["steps"].values())
    p13_k3 = sum(st["k3"] for res in p13.values()
                 for st in res["steps"].values())
    emit({"phase": "p13_total", "s": time.perf_counter() - t13,
          "k1_launches": p13_k1, "k3_launches": p13_k3, "gpu": card})
    for kernel in ("k1", "k3"):
        launched = {key for res in p13.values()
                    for st in res["steps"].values()
                    for key in st["launch_shapes"].get(kernel, {})}
        loose = [key for key in sorted(launched)
                 if not shape_held(key, held[kernel])]
        if loose:
            fail(f"phase 13 launched {kernel.upper()} at shapes phase 2 "
                 f"did not hold against its plain version: {loose}")
    # 14. the twins of the reference's check smokes (each twin's counts
    # are read around it inside)
    t14 = time.perf_counter()
    p14 = p14_twins(device, card)
    check_held("phase 14", shapes_of(p14["steps"]), held)
    emit({"phase": "p14_total", "s": time.perf_counter() - t14,
          "k1_launches": p14["k1_launches"],
          "k3_launches": p14["k3_launches"],
          "launch_shapes": shapes_of(p14["steps"]), "gpu": card})
    emit({"kernels": [
        {"name": "xor_matmul_w32", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/xor_matmul.cu",
         "replaces": "ceph_tpu/ops/xor_kernel.py:76",
         "launches": k1_slice + steps["bitsliced"]["k1_launches"] +
         plugin_k1 + pc["k1_launches"] + p11_k1 +
         sum(c["k1_launches"] for c in p12c.values()) + p12s["k1_launches"] +
         p13_k1 + t8["k1_launches"] + t10["k1_launches"] +
         t10c["k1_launches"] + p14["k1_launches"],
         "max_abs_err": max(errs.values()),
         "ms": enc1["ms"], "plain_ms": enc1["plain_ms"],
         "bound_ms": enc1["bound_ms"], "bound_by": enc1["bound_by"],
         "library_ms": None},
        {"name": "gf_bitplane", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_bitplane.cu",
         "replaces": "ceph_tpu/ops/gf_pallas.py:34",
         "launches": steps["bytes"]["k2_launches"] + plugin_k2 +
         p12s["k2_launches"] + t8["k2_launches"],
         "max_abs_err": max(errs2.values()),
         "ms": enc2["ms"], "plain_ms": enc2["plain_ms"],
         "bound_ms": enc2["bound_ms"], "bound_by": enc2["bound_by"],
         "library_ms": None},
        {"name": "ragged_fused", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/ragged_fused.cu",
         "replaces": "ceph_tpu/ops/gf_pallas.py:83",
         "launches": zw["k3_launches"] + pc["k3_launches"] +
         p12r["launches"] + p13_k3 + t10["k3_launches"] +
         t10c["k3_launches"] + p14["k3_launches"],
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
