"""EC benchmark sweep — the plot-harness role.

The reference drives `ceph_erasure_code_benchmark` over a plugin ×
technique × size matrix and emits plottable series
(qa/workunits/erasure-code/bench.sh:38-57, defaults SIZE=4096,
plugins isa/jerasure, techniques vandermonde/cauchy).  Same idea:
sweep (plugin, technique, k, m, object size) through the registry's
encode/decode paths and print one CSV row per cell —
`plugin,technique,k,m,size,workload,gbps`.

Usage:
    python -m ceph_tpu_torch.tools.bench_sweep [--plugins jax,isa]
        [--k 4,8] [--m 2,3] [--sizes 4096,1048576]
        [--workloads encode,decode] [--iters 4] [--batch 16]
        [--device cpu]

A codec with a device path (the ``jax`` codec and jerasure's bitmatrix
techniques) is timed on its device: the batch is placed there first, the
full-batch warm-up (which may build the kernel) runs before the window,
and on the card the window is read from CUDA events after a
synchronize, so no output is copied off the card inside it.  A codec of
the host (isa, jerasure's matrix techniques) is timed on the host clock.

Note: ec_bench.py times the single-config reference-CLI contract
(`seconds\tKB`); this sweep shares the registry but intentionally keeps
its own minimal timing cell — if the two drift further, extract one
shared timing helper.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device

# "technique+bitsliced" runs the same matrix under the packet-plane
# layout (the flagship region-XOR kernel)
TECHNIQUES = {
    "jax": ["reed_sol_van", "cauchy", "reed_sol_van+bitsliced"],
    "jerasure": ["reed_sol_van", "cauchy_good",
                 "liberation", "blaum_roth", "liber8tion"],
    "isa": ["reed_sol_van", "cauchy"],
}


def _timed(fn, iters: int, device) -> float:
    """Seconds of ``iters`` calls of ``fn`` after one warm-up call: CUDA
    events on the card (after a synchronize), the host clock elsewhere."""
    fn()                              # warm (full batch; may build)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def bench_cell(plugin: str, technique: str, k: int, m: int, size: int,
               workload: str, iters: int, batch: int,
               device=None) -> float:
    from ..ec import instance as ec_registry
    prof = {"k": str(k), "m": str(m)}
    if technique:
        if "+" in technique:
            technique, layout = technique.split("+", 1)
            prof["layout"] = layout
        prof["technique"] = technique
    codec = ec_registry().factory(plugin, prof, device=device)
    chunk = codec.get_chunk_size(size)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(batch, k, chunk), dtype=np.uint8)
    # a codec with a device path keeps its operands and outputs there
    on_device = hasattr(codec, "encode_chunks_device")
    dev = codec.device if on_device else None
    if workload == "encode":
        if on_device:
            d = torch.as_tensor(data, device=dev)
            dt = _timed(lambda: codec.encode_chunks_device(d), iters, dev)
        else:
            dt = _timed(lambda: codec.encode_chunks_batch(data), iters, dev)
    else:
        parity = np.asarray(codec.encode_chunks_batch(data))
        full = np.concatenate([data, parity], axis=1)
        erased = sorted(rng.choice(k + m, size=min(m, 2),
                                   replace=False).tolist())
        avail = [c for c in range(k + m) if c not in erased]
        plan = sorted(codec.minimum_to_decode(set(range(k)), set(avail)))
        sub = full[:, plan]
        if on_device:
            s = torch.as_tensor(np.ascontiguousarray(sub), device=dev)
            dt = _timed(lambda: codec.decode_chunks_device(plan, s, erased),
                        iters, dev)
        else:
            dt = _timed(lambda: codec.decode_chunks_batch(plan, sub, erased),
                        iters, dev)
    return iters * batch * k * chunk / dt / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_sweep")
    ap.add_argument("--plugins", default="jax")
    ap.add_argument("--k", default="4,8")
    ap.add_argument("--m", default="2,3")
    ap.add_argument("--sizes", default="4096,1048576")
    ap.add_argument("--workloads", default="encode,decode")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codecs (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("plugin,technique,k,m,size,workload,gbps")
    for plugin in args.plugins.split(","):
        for technique in TECHNIQUES.get(plugin, [None]):
            for k in (int(v) for v in args.k.split(",")):
                for m in (int(v) for v in args.m.split(",")):
                    for size in (int(v) for v in args.sizes.split(",")):
                        for wl in args.workloads.split(","):
                            try:
                                gbps = bench_cell(
                                    plugin, technique, k, m, size, wl,
                                    args.iters, args.batch, device)
                            except Exception as e:
                                print(f"# {plugin}/{technique or ''} "
                                      f"k={k} m={m} {wl}: {e}",
                                      file=sys.stderr)
                                continue
                            print(f"{plugin},{technique or ''},{k},{m},"
                                  f"{size},{wl},{gbps:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
