"""crushtool equivalent: test/simulate CRUSH maps from JSON specs.

Mirrors the `crushtool --test` harness (reference: src/tools/crushtool.cc:365
→ CrushTester, src/crush/CrushTester.cc:477-680): sweeps x over
[min_x, max_x] × rules × replica counts and reports per-device utilization
and statistics — but the sweep is one batched device call per rule
(CrushTester.cc:612's per-x loop collapsed into XlaMapper.map_batch),
on the card unless ``--device cpu`` asks for the CPU.

Also compiles/decompiles the crushmap text language (`-c`/`-d`, the
CrushCompiler role, src/crush/CrushCompiler.cc): input maps may be
either JSON specs or `.crush` text (auto-detected).

Usage:
    python -m ceph_tpu_torch.tools.crushtool --infn map.crush --test \
        --min-x 0 --max-x 1023 --rule 0 --num-rep 3 \
        --show-utilization [--scalar] [--weight OSD W]... [--device cpu]
    python -m ceph_tpu_torch.tools.crushtool -c map.crush -o map.json
    python -m ceph_tpu_torch.tools.crushtool -d map.json [-o map.crush]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

import numpy as np

from .. import resolve_device
from ..placement.crush_map import ITEM_NONE, WEIGHT_ONE, CrushMap
from ..placement import scalar_mapper


def run_test(cmap: CrushMap, args) -> int:
    rules = [args.rule] if args.rule is not None else [
        i for i, r in enumerate(cmap.rules) if r is not None]
    weights = [WEIGHT_ONE] * cmap.max_devices
    for osd, w in args.weight or []:
        if 0 <= osd < len(weights):
            weights[osd] = int(float(w) * WEIGHT_ONE)
    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.int64)
    reps = range(args.min_rep, args.max_rep + 1) if args.num_rep is None \
        else [args.num_rep]
    for ruleno in rules:
        if ruleno >= cmap.max_rules or cmap.rules[ruleno] is None:
            print(f"rule {ruleno} dne", file=sys.stderr)
            continue
        for nrep in reps:
            t0 = time.perf_counter()
            if args.scalar:
                results = [scalar_mapper.do_rule(cmap, ruleno, int(x), nrep,
                                                 weights) for x in xs]
                results = np.asarray(
                    [r + [ITEM_NONE] * (nrep - len(r)) for r in results])
            else:
                from ..placement.xla_mapper import XlaMapper
                mapper = XlaMapper(cmap, device=args.device)
                results = mapper.map_batch(ruleno, xs, nrep, weights)
            dt = time.perf_counter() - t0
            valid = results != ITEM_NONE
            sizes = Counter(int(v) for v in valid.sum(axis=1))
            total = len(xs)
            if args.show_mappings:
                for i, x in enumerate(xs):
                    row = [int(o) for o in results[i] if o != ITEM_NONE]
                    print(f"CRUSH rule {ruleno} x {int(x)} {row}")
            if args.show_utilization:
                counts = Counter(
                    int(o) for o in results[valid.astype(bool)].ravel())
                expected = valid.sum() / max(
                    1, sum(1 for w in weights if w > 0))
                print(f"rule {ruleno} (num_rep {nrep}) "
                      f"num_osds_mapped {len(counts)}")
                for osd in sorted(counts):
                    dev = counts[osd] / expected if expected else 0.0
                    print(f"  device {osd}:\t\t stored : {counts[osd]}"
                          f"\t expected : {expected:.2f}"
                          f"\t deviation : {dev:.2f}")
            if args.show_statistics:
                for sz, n in sorted(sizes.items()):
                    print(f"rule {ruleno} (num_rep {nrep}) size {sz}:\t"
                          f"{n}/{total}")
            bad = total - sizes.get(nrep, 0)
            if args.show_bad_mappings and bad:
                print(f"rule {ruleno} (num_rep {nrep}): "
                      f"{bad}/{total} bad mappings")
            print(f"rule {ruleno} num_rep {nrep}: {total} mappings in "
                  f"{dt:.3f}s ({total / dt:,.0f} mappings/s)",
                  file=sys.stderr)
    return 0


def load_map(path: str) -> CrushMap:
    """JSON spec or crushmap text, auto-detected."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        return CrushMap.from_spec(json.loads(text))
    from ..placement.compiler import compile_crushmap
    return compile_crushmap(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("--infn", "-i",
                    help="crush map: JSON spec or crushmap text")
    ap.add_argument("-c", "--compile", metavar="SRC",
                    help="compile crushmap text -> JSON spec")
    ap.add_argument("-d", "--decompile", metavar="SRC",
                    help="decompile map -> crushmap text")
    ap.add_argument("-o", "--outfn", help="output file (default stdout)")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--rule", type=int, default=None)
    ap.add_argument("--num-rep", type=int, default=None)
    ap.add_argument("--min-rep", type=int, default=1)
    ap.add_argument("--max-rep", type=int, default=10)
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-mappings", action="store_true")
    ap.add_argument("--show-statistics", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    ap.add_argument("--scalar", action="store_true",
                    help="use the scalar reference mapper (oracle)")
    ap.add_argument("--weight", nargs=2, action="append",
                    metavar=("OSD", "W"), type=float, default=None)
    ap.add_argument("--dump", action="store_true",
                    help="print the parsed map spec")
    ap.add_argument("--tree", action="store_true",
                    help="print the hierarchy (ceph osd tree style)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the batched mapper (cuda or cpu)")
    args = ap.parse_args(argv)
    # no card and no --device cpu: raise here, whatever the verb
    args.device = resolve_device(args.device)
    if args.weight:
        args.weight = [(int(o), w) for o, w in args.weight]

    def emit(text: str) -> None:
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)

    if args.compile:
        from ..placement.compiler import compile_crushmap
        with open(args.compile) as f:
            cmap = compile_crushmap(f.read())
        emit(json.dumps(cmap.to_spec(), indent=2) + "\n")
        return 0
    if args.decompile:
        from ..placement.compiler import decompile_crushmap
        emit(decompile_crushmap(load_map(args.decompile)))
        return 0
    if not args.infn:
        ap.error("need --infn (or -c/-d)")
    cmap = load_map(args.infn)
    if args.tree:
        from ..placement.treedump import tree_dump
        emit(tree_dump(cmap))          # honors -o like -c/-d
        return 0
    if args.dump:
        json.dump(cmap.to_spec(), sys.stdout, indent=2)
        print()
        return 0
    if args.test:
        return run_test(cmap, args)
    ap.error("nothing to do (--test, --dump, -c or -d)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
