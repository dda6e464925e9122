"""Multi-host check of the data plane: the fleet boot, verified.

Port of ``scripts/check_multihost.py``.  Three layers of evidence,
cheapest first:

  * fallback: with no coordinator configured ``ensure_initialized`` is a
    no-op, rank reads report (0, 1), and ``stripe_order`` is the
    identity;
  * single-process 2-D reference: 8 CPU cells on a (2, 4) mesh run the
    encode and collective-rebuild dispatches (and a ring shift)
    bit-identically to the unsharded kernel and write one counter cell
    per mesh position;
  * the fleet: two processes (gloo, 4 CPU cells each) join one
    ``torch.distributed`` group, resolve one global 2 x 4 mesh, run the
    SAME dispatches, and must produce the same bytes while each rank
    accounts ONLY its own row — the parent sums the two ranks' per-(host,
    cell) counters through ``ClusterStats.mesh_rollup`` and requires the
    totals of the single-process run.

Runs on the CPU:

    python -m ceph_tpu_torch.tools.check_multihost            # full check
    python -m ceph_tpu_torch.tools.check_multihost --quick    # no fleet

Each child has a subprocess timeout and its process group a timeout of
its own, so a lost peer fails the check instead of hanging it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_CHILD_CELLS = 4             # CPU cells per fleet process
_PARENT_CELLS = 2 * _CHILD_CELLS
CHILD_TIMEOUT_S = 180        # one fleet child, start to report
GROUP_TIMEOUT_S = 60         # the children's process group


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def _setup(cells: int) -> None:
    """The CPU asked for, ``cells`` cells on it, one intra-op thread."""
    import torch

    import ceph_tpu_torch
    from ceph_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    ceph_tpu_torch.set_default_device("cpu")
    mesh.cells_per_device = cells


def _dispatch_payload():
    """The dispatch mix every layer runs: one replicated-mask encode, one
    collective rebuild and one ring shift over fixed operands, hashed.
    Deterministic, so the single-process reference and both fleet ranks
    must produce identical digests."""
    import hashlib

    import numpy as np

    from ceph_tpu_torch.ops import gf, xor_kernel
    from ceph_tpu_torch.parallel import data_plane as dpmod

    rng = np.random.default_rng(17)
    k, m, W8 = 4, 2, 16
    words = rng.integers(0, 2 ** 31, (6, 8 * k, W8), dtype=np.uint32) \
        .astype(np.int32)
    masks = xor_kernel.masks_to_device(
        gf.gf8_bitmatrix(gf.vandermonde_parity(k, m)))
    dp = dpmod.plane()
    if dp is None:
        return None
    enc = dp.xor_matmul_w32(masks, words, kind="put").numpy()
    reb = dp.rebuild_collective(masks, words, kind="recover").numpy()
    ring = np.arange(2 * dp.n_shards * 3, dtype=np.int32) \
        .reshape(2 * dp.n_shards, 3)
    rolled = dp.ppermute_shift(ring, 3).numpy()
    # bit-identity against the unsharded kernel, locally
    ref = xor_kernel.xor_matmul_w32(masks, words).numpy()
    want = np.roll(ring.reshape(dp.n_shards, 2, 3), 3, axis=0) \
        .reshape(ring.shape)
    if not (np.array_equal(enc, ref) and np.array_equal(reb, ref)
            and np.array_equal(rolled, want)):
        raise AssertionError("plane dispatch diverged from the "
                             "single-device kernel")
    return {
        "mesh_shape": list(dp.mesh.devices.shape),
        "sha_encode": hashlib.sha256(enc.tobytes()).hexdigest(),
        "sha_rebuild": hashlib.sha256(reb.tobytes()).hexdigest(),
        "psum": dp.psum_probe(),
        "cells": sorted(f"r{f // dp.n_cols}c{f % dp.n_cols}"
                        for f in sorted(dp._local_cells)),
    }


def _child(rank: int, port: int) -> int:
    """One fleet process: join over gloo, resolve the global 2-D plane,
    run the dispatch mix, report counters."""
    os.environ["CEPH_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["CEPH_TPU_NUM_PROCESSES"] = "2"
    os.environ["CEPH_TPU_PROCESS_ID"] = str(rank)
    _setup(_CHILD_CELLS)

    from ceph_tpu_torch.common.options import config
    from ceph_tpu_torch.common.perf_counters import perf
    from ceph_tpu_torch.parallel import mesh, multihost

    multihost.TIMEOUT_S = GROUP_TIMEOUT_S
    if not multihost.ensure_initialized():
        return _fail(f"child {rank}: fleet did not initialize")
    try:
        config().set("parallel_data_plane", True)
        perf("dataplane").reset()
        payload = _dispatch_payload()
        if payload is None:
            return _fail(f"child {rank}: no plane resolved")
        payload.update({
            "rank": multihost.process_index(),
            "nprocs": multihost.process_count(),
            "host": multihost.host_label(),
            "backend": multihost.backend(),
            "global_devices": len(mesh.global_devices()),
            "local_devices": len(mesh.local_devices()),
            "perf": {"dataplane": perf("dataplane").dump_typed()},
        })
        print("CHILD " + json.dumps(payload), flush=True)
    finally:
        multihost.shutdown()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(ref) -> int:
    """Spawn the two-process fleet and check its collective story."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CEPH_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.check_multihost",
         "--child", str(rank), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=repo) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                return _fail("fleet pair timed out")
            if p.returncode != 0:
                return _fail(f"fleet child exited {p.returncode}: "
                             f"{err[-800:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("CHILD ")]
        if not lines:
            return _fail(f"child produced no report: {out[-400:]}")
        reports.append(json.loads(lines[-1][len("CHILD "):]))
    reports.sort(key=lambda r: r["rank"])

    for r in reports:
        if r["nprocs"] != 2 or r["global_devices"] != _PARENT_CELLS \
                or r["local_devices"] != _CHILD_CELLS \
                or r["backend"] != "gloo":
            return _fail(f"rank {r['rank']}: fleet shape wrong: {r}")
        if r["mesh_shape"] != [2, _CHILD_CELLS]:
            return _fail(f"rank {r['rank']}: global mesh "
                         f"{r['mesh_shape']}, want [2, {_CHILD_CELLS}]")
        if (r["sha_encode"], r["sha_rebuild"], r["psum"]) != \
                (ref["sha_encode"], ref["sha_rebuild"], ref["psum"]):
            return _fail(f"rank {r['rank']}: fleet dispatch bytes "
                         f"diverged from the single-process reference")
    # locality: each rank owns exactly its stripe row
    own0, own1 = (set(r["cells"]) for r in reports)
    if own0 & own1 or len(own0 | own1) != _PARENT_CELLS:
        return _fail(f"per-rank cell ownership wrong: {own0} / {own1}")
    if {r["host"] for r in reports} != {"host0", "host1"}:
        return _fail(f"host labels wrong: {[r['host'] for r in reports]}")

    # mgr rollup: two ranks ingest as two daemons, totals must equal the
    # single-process run (each cell counted exactly once)
    from ceph_tpu_torch.mgr.cluster_stats import ClusterStats
    stats = ClusterStats()
    for r in reports:
        stats.ingest(f"client.{r['host']}",
                     {"perf": r["perf"], "ts": time.time(),
                      "host": r["host"]})
    roll = stats.mesh_rollup()
    if roll["n_hosts"] != 2 or roll["n_chips"] != _PARENT_CELLS:
        return _fail(f"mesh_rollup shape wrong: {roll['n_hosts']} hosts, "
                     f"{roll['n_chips']} cells")
    if roll["shape"] != [2, _CHILD_CELLS]:
        return _fail(f"mesh_rollup grid {roll['shape']}")
    for key, want in ref["cell_totals"].items():
        got = roll["totals"].get(key, 0.0)
        if got != want:
            return _fail(f"rollup totals[{key}] = {got}, "
                         f"single-process run says {want}")
    print(f"OK: 2-process fleet verified (global 2x{_CHILD_CELLS} mesh, "
          f"identical bytes, rollup totals match)")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    _setup(_PARENT_CELLS)

    import re

    from ceph_tpu_torch.common.options import config
    from ceph_tpu_torch.common.perf_counters import perf
    from ceph_tpu_torch.parallel import multihost

    # ---- fallback: no coordinator -> everything single-process ----
    if multihost.ensure_initialized():
        return _fail("ensure_initialized active without a coordinator")
    if multihost.process_index() != 0 or multihost.process_count() != 1:
        return _fail("inactive rank reads must be (0, 1)")
    if multihost.stripe_order([5, 3, 8]) != [0, 1, 2]:
        return _fail("inactive stripe_order must be the identity")

    # ---- single-process 2-D reference -----------------------------
    config().set("parallel_data_plane", True)
    config().set("parallel_data_plane_stripes", 2)
    try:
        perf("dataplane").reset()
        ref = _dispatch_payload()
        if ref is None:
            return _fail("no 2-D plane resolved single-process")
        if ref["mesh_shape"] != [2, _PARENT_CELLS // 2]:
            return _fail(f"reference mesh {ref['mesh_shape']}")
        if len(ref["cells"]) != _PARENT_CELLS:
            return _fail(f"single-process plane must own every cell, "
                         f"owns {ref['cells']}")
        # totals per counter NAME summed over the r<r>c<c> cells — the
        # reduction mesh_rollup applies to the fleet's cells
        totals = {}
        for k, v in perf("dataplane").dump().items():
            m = re.match(r"^r\d+c\d+\.(.+)$", k)
            if m and v:
                totals[m.group(1)] = totals.get(m.group(1), 0.0) + v
        ref["cell_totals"] = totals
        if not totals:
            return _fail("no per-(row, col) counters accounted")
    finally:
        config().clear("parallel_data_plane")
        config().clear("parallel_data_plane_stripes")

    if "--quick" in argv:
        print(f"OK: multihost fallback + single-process 2-D reference "
              f"verified on {_PARENT_CELLS} cells (--quick: fleet pair "
              f"skipped)")
        return 0
    return _run_pair(ref)


if __name__ == "__main__":
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        sys.exit(_child(int(sys.argv[i + 1]), int(sys.argv[i + 2])))
    sys.exit(main())
