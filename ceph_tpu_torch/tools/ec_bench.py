"""Erasure-code benchmark — ceph_erasure_code_benchmark equivalent.

Same option surface and output contract as the reference binary
(src/test/erasure-code/ceph_erasure_code_benchmark.cc:48-123: --plugin,
--workload encode|decode, -k/-m, --size, --iterations, --erasures;
prints ``seconds\tKB`` per run, :156-184 encode loop, :251-315 decode
loop), extended with --batch to amortize device dispatch across stripes —
the capability the device backend adds.

Port of ``ceph_tpu/tools/ec_bench.py``.  The codec runs on the card by
default; ``--device cpu`` asks for the CPU (without a card and without
that request the codec's factory raises).  A codec on a CUDA device is
timed between ``torch.cuda.synchronize()`` calls.

Usage:
    python -m ceph_tpu_torch.tools.ec_bench --plugin jax --workload encode \
        -k 8 -m 3 --size $((1<<20)) --iterations 8 --batch 16 [--json]
    python -m ceph_tpu_torch.tools.ec_bench --device cpu --plugin jerasure \
        --workload decode -k 4 -m 2 --size 16384 --erasures 2
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ec import instance as ec_registry


def run(args) -> dict:
    profile = {"k": str(args.k), "m": str(args.m)}
    if args.technique:
        profile["technique"] = args.technique
    for kv in args.parameter or []:
        key, _, val = kv.partition("=")
        profile[key] = val
    codec = ec_registry().factory(args.plugin, profile, device=args.device)
    dev = codec.device
    k, m = args.k, args.m
    chunk = codec.get_chunk_size(args.size)
    rng = np.random.default_rng(args.seed)
    batch = rng.integers(0, 256, size=(args.batch, k, chunk),
                         dtype=np.uint8) if args.batch > 1 else None
    single = rng.integers(0, 256, size=(k, chunk), dtype=np.uint8)

    erasures = args.erasures
    erased = sorted(rng.choice(k + m, size=erasures, replace=False).tolist()) \
        if not args.erased else sorted(args.erased)
    avail = [i for i in range(k + m) if i not in erased]

    def one_encode():
        if batch is not None:
            out = codec.encode_chunks_batch(batch)
        else:
            out = codec.encode_chunks(single)
        return out

    if args.workload == "decode":
        parity = codec.encode_chunks_batch(batch) if batch is not None \
            else codec.encode_chunks(single)
        if batch is not None:
            full = np.concatenate([batch, parity], axis=1)
            surv = full[:, avail]
        else:
            full = np.concatenate([single, parity], axis=0)
            surv = full[avail]

    # warmup (jit compile)
    if args.workload == "encode":
        one_encode()
    else:
        if batch is not None:
            codec.decode_chunks_batch(avail, surv, erased)
        else:
            codec.decode_chunks(avail, surv, erased)

    # the *_batch and single-stripe methods return host arrays, so each
    # iteration already waits for its device work; the synchronize calls
    # bound the timed region on the card all the same
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        if args.workload == "encode":
            one_encode()
        elif batch is not None:
            codec.decode_chunks_batch(avail, surv, erased)
        else:
            codec.decode_chunks(avail, surv, erased)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    stripes = args.iterations * (args.batch if batch is not None else 1)
    payload_bytes = stripes * k * chunk
    result = {
        "plugin": args.plugin, "workload": args.workload,
        "device": str(dev),
        "k": k, "m": m, "chunk_size": chunk, "batch": args.batch,
        "iterations": args.iterations, "erased": erased,
        "seconds": dt, "KB": payload_bytes // 1024,
        "GBps": payload_bytes / dt / 1e9,
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ec_bench")
    ap.add_argument("--plugin", "-p", default="jax")
    ap.add_argument("--workload", "-w", choices=("encode", "decode"),
                    default="encode")
    ap.add_argument("-k", type=int, default=8)
    ap.add_argument("-m", type=int, default=3)
    ap.add_argument("--technique", default=None)
    ap.add_argument("--parameter", "-P", action="append",
                    help="extra profile key=value")
    ap.add_argument("--size", "-s", type=int, default=1 << 20,
                    help="object size in bytes (split into k chunks)")
    ap.add_argument("--iterations", "-i", type=int, default=8)
    ap.add_argument("--batch", "-b", type=int, default=1,
                    help="stripes per device call")
    ap.add_argument("--erasures", "-e", type=int, default=2)
    ap.add_argument("--erased", type=int, action="append", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the codec runs on (cuda or cpu)")
    args = ap.parse_args(argv)
    result = run(args)
    if args.json:
        print(json.dumps(result))
    else:
        # reference output contract: "seconds\tKB"
        print(f"{result['seconds']:.6f}\t{result['KB']}")
        print(f"# {result['GBps']:.3f} GB/s payload "
              f"({result['plugin']} {result['workload']} "
              f"k={result['k']} m={result['m']} batch={result['batch']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
