#!/usr/bin/env python3
"""The controls: runs whose ``correct`` has to come out false.

Each loop's ``control`` puts its control in the program's place: for the
EC mixes the code weakened (``weaker_code``), for the remap mix a map one
epoch behind.  The benchmark's own runs never use it.  On the card, at a
cell's own size and with a short window, each seed runs sound, then
under the control (the manifest's cells and the parked ones):

    python3 portbench/control.py --workload crush_10k_rep3.remap \\
        --seeds 11,12,13 --seconds 5

and prints one JSON line a run with its checks.  ``portbench/tests``
drives the same runs on the CPU at small sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def weaker_code():
    """Every parity row all ones: three copies of XOR parity in place of
    RS(k, m).  It survives one lost chunk, not m."""
    import numpy as np
    from ceph_tpu_torch.ops import gf

    def xor_parity(k, m, w=8):
        return np.ones((m, k), dtype=np.uint8)

    real = gf.vandermonde_parity
    gf.vandermonde_parity = xor_parity
    try:
        yield
    finally:
        gf.vandermonde_parity = real


def guarded(fn):
    """Count any error of a control's operation as a failed one."""
    def call(*a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:          # the control's own breakage
            raise IOError(f"{type(e).__name__}: {e}") from None
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from portbench import harness
    bench = harness.with_parked(
        json.loads((ROOT / "BENCHMARK.json").read_text()))
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in ("sound", "control"):
            out = harness.run_cell(ROOT, bench, args.workload, seed,
                                   args.seconds, False, "cuda",
                                   control=side == "control")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "failed": out["failed"],
                              "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, is where imports start: this
    # folder's module names (trace, generator) must not shadow others
    sys.path[0] = str(ROOT)
    sys.exit(main())
