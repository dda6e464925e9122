#!/usr/bin/env python3
"""Time one kernel of the port (K1, K2, K3 or the descent) on one card.

    python3 kernel_timing.py --kernel k1|k2|k3|descend [--tree DIR ...]
        [--out FILE]

Each ``--tree`` (default: this checkout) is a root holding
``ceph_tpu_torch/``; each is timed in its own process, in the order
given, so a change and its parent compare on one card within one call
(give them as parent, change, change, parent).  Each process builds the
kernel from its tree's ``csrc/`` and runs this checkout's
``chip_smoke.time_k1``, ``time_k2``, ``time_k3`` or ``time_descend``
against that tree's package:

  * k1: K1 at ``chip_smoke.K1_TIMED``: the encode, decode and rebuild
    at 128 KiB stripe units, the liber8tion and liberation encodes, the
    process cluster's puts and decode at 1 MiB, and phases 11's and
    13's most-launched shapes at 4 KiB stripe units, with its launch
    floor (an empty kernel at K1's grid) and its call time, the floor
    where the tree's package has its entry point;
  * k2: K2 at the batched encode [128, 8, 131072], the byte pool's put
    and 3-erasure decode [4, 8, 131072] and a ragged L = 131071, with
    its launch floor (an empty kernel at K2's grid) where the tree's
    package has the floor entry point;
  * k3: K3 at the ZeroWire path's whole pool (1,024 S3Serve-profile
    objects, RS(4,2), 41,670 staged 4 KiB blocks) and its crc leg at a
    2 MiB frame, at the path's mean verified frame (70 blocks) and at the
    process cluster's flush batch, with its launch floor (an empty kernel
    at K3's grid and shared memory) where the tree's package has the
    floor entry point;
  * descend: the fast mapper's descent kernel at the remap cell's two
    launches (262,144 PGs on the 1,000-host map: the root level of 1,000
    hosts and the host level of 10 OSDs, each at [262,144, 7] rows),
    with its launch floor, the plain version on the card over the same
    launch, its ptxas registers and spills (when this process built it),
    and the least time of its draws x 137 integer instructions at the
    card's integer rate, or of the 512 KiB numerator table at HBM rate
    if larger; then every launch of smaller pools' maps
    (``chip_smoke.group_callers``) at each lanes-a-row the kernel is
    built for, beside the one it picks.

Device time by CUDA-graph replay and call time between CUDA events,
beside the bound and the plain version.  One JSON line per tree and
shape, each with the tree and the card's ``nvidia-smi`` name and power
limit; the lines also go to ``--out``.  Needs one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
MEAN_FRAME_BLOCKS = 70      # chip_smoke's ZeroWire path: 2,010,537,984
                            # crc'd bytes / 4096 / 7,033 dispatches


def _one(kernel: str, tree: str, out_path: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)      # imports the tree's ceph_tpu_torch
    import torch
    from ceph_tpu_torch.ops import ragged_fused

    if not torch.cuda.is_available():
        smoke.fail("kernel_timing: torch.cuda.is_available() is false")

    def emit(obj) -> None:
        line = json.dumps({"tree": tree, **obj})
        print(line, flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(line + "\n")
    smoke.emit = emit
    device = torch.device("cuda")
    if kernel == "k1":
        from ceph_tpu_torch.ec import instance
        codec = instance().factory(
            "jax", {"k": str(smoke.K), "m": str(smoke.M),
                    "technique": "reed_sol_van", "layout": "bitsliced"})
        gen = torch.Generator(device=device).manual_seed(smoke.SEED)
        shapes = smoke.k1_shapes(device, codec, gen)
        shapes.update(smoke.plugin_k1_shapes(device, gen))
        smoke.time_k1(shapes, smoke.gpu_line())
    elif kernel == "k2":
        gen = torch.Generator(device=device).manual_seed(smoke.SEED)
        smoke.time_k2(smoke.k2_shapes(device, gen), smoke.gpu_line())
    elif kernel == "k3":
        pool = ragged_fused.pack(smoke.zerowire_shards()).pool
        smoke.time_k3(pool, MEAN_FRAME_BLOCKS, device, smoke.gpu_line())
    else:
        card = smoke.gpu_line()
        smoke.time_descend(smoke.descend_shapes(device), card)
        smoke.time_groups(smoke.group_callers(device), card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "descend"),
                    required=True)
    ap.add_argument("--tree", action="append",
                    help="checkout root to time (repeatable, in order)")
    ap.add_argument("--out", default="", help="also append the lines here")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _one(args.kernel, args.one, args.out)
        return 0
    for tree in args.tree or [HERE]:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--kernel", args.kernel, "--one", tree,
                        "--out", args.out], check=True, timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
