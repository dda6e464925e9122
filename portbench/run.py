#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload crush_10k_rep3.remap --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (the card's name,
count, power limit and memory peak; with ``--trace 1`` also ``busy_s``
and ``window_s``), with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared beside its limit.  The same numbers end
standard error.  Without a card, or with fewer cards than the cell asks
for, it exits 2 and prints no result; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels and native mapper build under build/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)         # one process, few threads
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from portbench import harness
    out = harness.run_cell(ROOT, bench, args.workload, args.seed,
                           args.seconds, bool(args.trace), "cuda")
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    dev = out["device"]
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": cell["chips"], "power_limit": power_limit(),
                     **dev}
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, is where imports start: this
    # folder's module names (trace, generator) must not shadow others
    sys.path[0] = str(ROOT)
    sys.exit(main())
