#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ceph_tpu_torch``) on one card and check it.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. build every kernel of ``ceph_tpu_torch/csrc`` with nvcc for sm_90a
     (one nvcc per source, started together) and print ptxas's registers,
     shared memory and spills;
  2. hold each kernel bit-identical to its plain PyTorch version on the
     card at the main path's shapes (K1: RS(8,3) encode, a 3-erasure
     decode, a per-stripe-signature rebuild, a ragged word count);
  3. drive the slice end to end through the port's entry points: an
     RS(8,3) layout=bitsliced pool from the port's codec registry, 1 MiB
     stripes (stripe_unit 128 KiB), 128 objects of 4 MiB put in one
     ingest batch through ECBackend onto 16 OSD device caches, 3 OSDs
     killed, every object read back (degraded reads decode in signature
     groups) and compared with the payload on the card, every lost shard
     rebuilt with one mask per stripe and compared with the original;
     K1's launch count over this phase must equal the path's dispatches,
     and no plain version may run on it;
  4. time K1 (CUDA events over many launches after a warm-up) beside its
     bound and its plain version, and the host wall time of each phase.

Earlier lines print the card (``nvidia-smi --query-gpu=name,power.limit``),
the numbers as JSON, and the ``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import ceph_tpu_torch
from ceph_tpu_torch.cluster.device_store import DeviceShardCache, \
    assemble_object
from ceph_tpu_torch.cluster.ec_backend import ECBackend, ObjectGeom, ShardIO
from ceph_tpu_torch.ec import instance
from ceph_tpu_torch.ops import _build, gf, gf2, xor_kernel

SEED = 20261016
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit logic ops/s: 132 SMs x 64 INT32 lanes (H100 white paper) x the
# 1.98 GHz clock the data sheet's 67 TFLOP/s FP32 implies
# (132 x 128 x 2 x 1.98e9); one LOP3 per mask-AND-XOR step
INT32_OPS_PER_S = 132 * 64 * 1.98e9

K, M = 8, 3
N_OSDS = 16
N_PGS = 16
POOL = 1


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


def k1_bound(B: int, Bm: int, R: int, C: int, W: int):
    """(bound_ms, bound_by, bytes, ops) of one K1 call: every input read
    once, every output written once; one LOP3 per mask-AND-XOR step."""
    nbytes = 4 * (B * C * W + B * R * W + Bm * R * C)
    ops = B * R * C * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
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


def k1_shapes(device, codec, gen):
    """The main path's K1 shapes at full size: encode [512, 64, 4096]
    (shared masks), a 3-erasure decode (one signature), a rebuild
    [512, 88, 4096] with its own full-width masks per stripe, and a
    ragged W = 4095."""
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
    return {
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


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    device = torch.device("cuda")
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    ceph_tpu_torch.set_default_device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)

    # 1. build
    build_kernels(card)

    # 2. kernel vs plain version at the main path's shapes
    codec = instance().factory(
        "jax", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "layout": "bitsliced"})
    shapes = k1_shapes(device, codec, gen)
    errs = kernel_checks(device, shapes)

    # 3. the slice end to end, with the launch counts read around it
    xor_kernel.launches = 0
    plain0 = xor_kernel.plain_runs
    torch.cuda.reset_peak_memory_stats()
    path = run_slice(device, gen, n_objects=128,
                     obj_bytes=4 << 20, stripe_unit=128 << 10)
    launches = xor_kernel.launches
    path["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    path["k1_launches"] = launches
    path["gpu"] = card
    emit({"phase": "slice", **path})
    if xor_kernel.plain_runs != plain0:
        fail("a plain version ran on the main path")
    if launches != path["dispatches"] or launches == 0:
        fail(f"K1 launched {launches} times on the main path; the path "
             f"makes {path['dispatches']} dispatches")

    # 4. numbers
    timings = {}
    for name in ("encode", "decode", "rebuild"):
        masks, words = shapes[name]
        B, C, W = words.shape
        R = masks.shape[-2]
        Bm = B if masks.dim() == 3 else 1
        ms = cuda_ms(lambda: xor_kernel.xor_matmul_w32(masks, words),
                     iters=50)
        m3 = masks if masks.dim() == 3 else masks[None]
        plain_ms = cuda_ms(
                           lambda: xor_kernel._combine_torch(m3, words),
                           iters=3, warmup=1)
        bound_ms, bound_by, nbytes, ops = k1_bound(B, Bm, R, C, W)
        timings[name] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "timing", "kernel": "xor_matmul_w32", "shape": name,
              "masks": list(masks.shape), "words": list(words.shape),
              "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
              "hbm_share": nbytes / (ms * 1e-3) / HBM_BYTES_PER_S,
              "roofline_share": bound_ms / ms, "gpu": card})
    enc = timings["encode"]
    emit({"kernels": [{
        "name": "xor_matmul_w32", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/xor_matmul.cu",
        "replaces": "ceph_tpu/ops/xor_kernel.py:76",
        "launches": launches, "max_abs_err": max(errs.values()),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
