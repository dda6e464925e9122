#!/usr/bin/env python3
"""Profile one sweep of the general per-lane CRUSH mapper on one card.

    python3 placement_profile.py [--pool rep|ec42] [--pgs N] [--out FILE]

Builds ``chip_smoke``'s straw-bucket 10,000-OSD map from its crushmap text
(25 racks x 40 hosts x 10 OSDs, ``alg straw``, the hammer tunables), maps
every PG of the pool once through ``OSDMap.map_pgs_batch`` to warm up,
times a second sweep with the host clock, and maps it a third time under
``torch.profiler`` (CPU and CUDA activities).  Prints one JSON line: the
sweep's wall time unprofiled and profiled, the device time (the CUDA
kernels' summed self time: one stream, so kernels do not overlap) and its
share of the unprofiled wall time, the kernel launches, and the ten
kernels with the most device time, beside the card's ``nvidia-smi`` name
and power limit.  ``--cpu`` rehearses it on the CPU, with no device
numbers.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import ceph_tpu_torch
import chip_smoke


def kernel_times(prof):
    """(summed self device time in ms, launches, top ten [name, ms,
    launches]) of the CUDA kernels in a profile."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows),
            [[k, ms, n] for k, ms, n in rows[:10]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pool", choices=("rep", "ec42"), default="ec42")
    ap.add_argument("--pgs", type=int, default=1 << 20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: the profile "
                        "needs a card (or --cpu for a rehearsal)")
    device = torch.device("cpu" if args.cpu else "cuda")
    ceph_tpu_torch.set_default_device(device)
    from ceph_tpu_torch.cluster.osdmap import (OSDMap, PGPool, POOL_ERASURE,
                                               POOL_REPLICATED)
    from ceph_tpu_torch.placement.compiler import compile_crushmap
    cmap = compile_crushmap(chip_smoke.straw_cluster_text())
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    rep = args.pool == "rep"
    om.add_pool(PGPool(id=1, name=args.pool,
                       type=POOL_REPLICATED if rep else POOL_ERASURE,
                       size=3 if rep else 6, pg_num=args.pgs,
                       crush_rule=0 if rep else 1))
    up0, _ = om.map_pgs_batch(1)
    t0 = time.perf_counter()
    up1, _ = om.map_pgs_batch(1)
    chip_smoke.sync(device)
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if not args.cpu:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        up2, _ = om.map_pgs_batch(1)
        chip_smoke.sync(device)
        wall_prof = time.perf_counter() - t0
    if not (np.array_equal(up0, up1) and np.array_equal(up0, up2)):
        chip_smoke.fail("placement profile: the sweeps disagree")
    host_ops = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key.startswith("aten::"))
    out = {"pool": args.pool, "pgs": args.pgs, "device": str(device),
           "wall_s": wall, "wall_profiled_s": wall_prof,
           "aten_ops": host_ops}
    if args.cpu:
        out.update(device_ms=None, device_share=None, launches=None,
                   top_kernels=None, gpu=None)
    else:
        dev_ms, launches, top = kernel_times(prof)
        out.update(device_ms=dev_ms, device_share=dev_ms / 1e3 / wall,
                   launches=launches, top_kernels=top,
                   gpu=chip_smoke.gpu_line())
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
