#!/usr/bin/env python3
"""Time K2 with parts of its work taken out, to see what holds it.

    python3 k2_variants.py [--shapes put,encode] [--reps 2] [--out FILE]

Builds text-edited copies of ``ceph_tpu_torch/csrc/gf_bitplane.cu`` under
``build/k2_variants/`` (one nvcc per variant, all started together) and
times each at K2's shapes from ``chip_smoke.k2_shapes`` by CUDA-graph
replay, beside the variant's launch floor, in turns (every variant once
per repetition).  The variants:

  * ``kernel``: the source as it is;
  * ``no_table_copy``: no copy of the tables into shared memory and no
    barrier (the lookups read whatever shared memory holds);
  * ``no_lookups``: the data words XORed into the accumulators in place
    of the table lookups (loads, table copy and stores stay);
  * ``no_loads``: the data words made from the column index in place of
    the loads (table copy, lookups and stores stay);
  * ``half_lookups``: a single row group's high-nibble lookups dropped;
  * ``extra_lookups``: one more lookup per byte for a single row group;
  * ``bytes16``: 16 bytes per thread at every shape;
  * ``threads256``: 256-thread blocks.

Only ``kernel`` computes K2's function (``ok`` holds it bit-identical to
the plain version); the others exist to be timed.  One JSON line per
variant, shape and repetition, with the card's ``nvidia-smi`` name and
power limit.  Needs one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "ceph_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "k2_variants")

LOOKUPS = "row_lookups<G, BPT>(acc, w[r], rb + r * ROW);"
LOAD = "load_cols<BPT, VEC>(src + (j0 + r) * L, left, w[r]);"
WAIT = """        if (j0 == 0) {
            cp_async_wait_all();
            __syncthreads();
        }"""
COPY_START = "    for (int i = tid; i < G * k * kNibWords; i += kThreads) {"
COPY_END = "    const long long b = blockIdx.x / tiles;"
SINGLE = """            if constexpr (G % 2)
                acc[G - 1][p] ^= lds32(alo + kSlot * P) ^
                                 lds32(ahi + kSlot * P + 128);"""


def variants(src: str) -> dict:
    """{name: edited source}; every edit must find its text."""
    copy = src[src.index(COPY_START):src.index(COPY_END)]
    edits = {
        "kernel": [],
        "no_table_copy": [(copy, ""), (WAIT, "")],
        "no_lookups": [(LOOKUPS, "for (int q = 0; q < W; ++q) "
                                 "acc[0][4 * q] ^= w[r][q] + rb;")],
        "no_loads": [(LOAD, "for (int q = 0; q < W; ++q) w[r][q] = "
                            "static_cast<uint32_t>(c0) * 2654435761u ^ "
                            "(j0 + r) * 0x01010101u ^ q;")],
        "half_lookups": [(SINGLE, """            if constexpr (G % 2)
                acc[G - 1][p] ^= lds32(alo + kSlot * P) ^ ahi;""")],
        "extra_lookups": [(SINGLE, """            if constexpr (G % 2)
                acc[G - 1][p] ^= lds32(alo + kSlot * P) ^
                                 lds32(ahi + kSlot * P + 128) ^
                                 lds32(alo + kSlot * P + 4);""")],
        "bytes16": [("return B * tiles16 < 2LL * sms ? 8 : 16;",
                     "return 16;")],
        "threads256": [("constexpr int kThreads = 128;",
                        "constexpr int kThreads = 256;")],
    }
    out = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"k2_variants: {name}: edit not found")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    sys.path.insert(0, HERE)
    from ceph_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    for hdr in os.listdir(SRC):
        if hdr.endswith(".cuh"):
            shutil.copy(os.path.join(SRC, hdr), OUT)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(OUT, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k2_variants: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        lib.ceph_gf_bitplane.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.ceph_gf_bitplane_floor.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="put,encode")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="", help="also append the lines here")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as smoke
    from ceph_tpu_torch.ops import gf_jax, gf_pallas

    if not torch.cuda.is_available():
        smoke.fail("k2_variants: torch.cuda.is_available() is false")
    with open(os.path.join(SRC, "gf_bitplane.cu")) as f:
        libs = build(variants(f.read()))
    dev = torch.device("cuda")
    shapes = smoke.k2_shapes(
        dev, torch.Generator(device=dev).manual_seed(smoke.SEED))
    card = smoke.gpu_line()
    for rep in range(args.reps):
        for name, lib in libs.items():
            for shape in args.shapes.split(","):
                bm, data = shapes[shape]
                B, k, L = data.shape
                m = bm.shape[0] // 8
                tab = gf_pallas.nibble_tables(bm).astype(np.uint32)
                tab = torch.from_numpy(tab.view(np.int32)).to(dev)
                out = torch.empty((B, m, L), dtype=torch.uint8, device=dev)

                def stream():
                    return torch.cuda.current_stream().cuda_stream

                def call():
                    rc = lib.ceph_gf_bitplane(
                        tab.data_ptr(), data.data_ptr(), out.data_ptr(),
                        B, k, m, L, stream())
                    if rc:
                        smoke.fail(f"k2_variants: {name} launch rc {rc}")

                call()
                torch.cuda.synchronize()
                ok = torch.equal(out, gf_jax.bitplane_matmul(
                    torch.as_tensor(bm, device=dev), data))
                if name == "kernel" and not ok:
                    smoke.fail(f"k2_variants: K2 differs at {shape}")
                line = json.dumps({
                    "variant": name, "shape": shape, "rep": rep,
                    "data": [B, k, L], "m": m, "ok": ok,
                    "ms": smoke.graph_ms(call, 50),
                    "floor_ms": smoke.graph_ms(
                        lambda: lib.ceph_gf_bitplane_floor(
                            B, k, m, L, stream()), 50),
                    "gpu": card})
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
