#!/usr/bin/env python3
"""Time kernel K2 or K3 of one or more checkouts of the port on one card.

    python3 kernel_timing.py --kernel k2|k3 [--tree DIR ...] [--out FILE]

Each ``--tree`` (default: this checkout) is a root holding
``ceph_tpu_torch/``; each is timed in its own process, in the order
given, so a change and its parent compare on one card within one call
(give them as parent, change, change, parent).  Each process builds the
kernel from its tree's ``csrc/`` and runs this checkout's
``chip_smoke.time_k2`` or ``chip_smoke.time_k3`` against that tree's
package:

  * k2: K2 at the batched encode [128, 8, 131072], the byte pool's put
    and 3-erasure decode [4, 8, 131072] and a ragged L = 131071, with
    its launch floor (an empty kernel at K2's grid) where the tree's
    package has the floor entry point;
  * k3: K3 at the ZeroWire path's whole pool (1,024 S3Serve-profile
    objects, RS(4,2), 41,670 staged 4 KiB blocks) and its crc leg at a
    2 MiB frame and at the path's mean verified frame (70 blocks).

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
    if kernel == "k2":
        gen = torch.Generator(device=device).manual_seed(smoke.SEED)
        smoke.time_k2(smoke.k2_shapes(device, gen), smoke.gpu_line())
    else:
        pool = ragged_fused.pack(smoke.zerowire_shards()).pool
        smoke.time_k3(pool, MEAN_FRAME_BLOCKS, device, smoke.gpu_line())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("k2", "k3"), required=True)
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
