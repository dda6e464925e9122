"""Run one cell of ``BENCHMARK.json`` and reduce it to one result.

Everything a cell needs is found by name under the manifest's
``paths``: its configuration from the manifest's ``file``, which names
its ``system`` (``systems/<system>.py``, whose ``build(cfg, device)``
makes it); its mix as ``traffic/<traffic>.json``, whose ``kind`` names
its loop (``loops/<kind>.py``, whose class ``Loop`` runs it); and each
metric as ``metrics/<metric>.py``, which defines ``read(run)`` and
returns a number or None (nothing to read: the metric is left out of the
line).  A later cell of a new system, kind or metric brings new files
and edits none.

``run_cell`` is the whole run but the look for a card, so that tests can
drive it on the CPU at small sizes; ``run.py`` refuses to run without a
card.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from . import generator, spans, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")


def find(root: Path, bench: Dict, sub: str, name: str) -> Path:
    for p in bench["paths"]:
        f = root / p / sub / name
        if f.is_file():
            return f
    raise FileNotFoundError(f"no {sub}/{name} under {bench['paths']}")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def with_parked(bench: Dict) -> Dict:
    """The manifest with the cells of ``portbench/parked.json`` added:
    cells that run correct but that the manifest leaves out (their runs
    spread too widely for a bound).  The controls and the tests run
    them; ``run.py`` runs only the manifest's."""
    parked = load_json(Path(__file__).resolve().parent / "parked.json")
    out = dict(bench)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] = list(bench[key]) + parked[key]
    return out


def load(path: Path):
    """The module in ``path``, loaded under a name of its own."""
    name = "portbench_" + path.parent.name + "_" + \
        path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, trace_on: bool):
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones."""
    group = bench["per_layer" if trace_on else "end_to_end"]
    return [m for m in group
            if cell in m.get("workloads", [cell])]


def forbidden_modules(modules) -> list:
    return sorted({n.split(".")[0] for n in modules
                   if n.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, bench: Dict, workload: str, seed: int,
             seconds: float, trace_on: bool, device: str,
             hooks: Optional[Callable[[Any], Dict[str, Any]]] = None,
             control: bool = False,
             config_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None) -> Dict:
    """Set up, warm up, measure ``seconds``, check; returns the result
    object (without ``device``'s name fields, which the caller adds).

    ``control`` puts the mix's control in the program's place (the
    loop's ``control``); ``hooks(loop)`` gives the built loop hooks of
    its own.  The benchmark's runs use neither."""
    t_setup = time.perf_counter()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    ccfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / ccfg["file"])
    cfg.update(config_override or {})
    mix = load_json(find(root, bench, "traffic", cell["traffic"] + ".json"))
    mix.update(traffic_override or {})
    build = load(find(root, bench, "systems", cfg["system"] + ".py")).build
    loop_cls = load(find(root, bench, "loops", mix["kind"] + ".py")).Loop
    ctx = loop_cls.control() if control else contextlib.nullcontext()
    with ctx as control_hooks, spans.kept(trace_on):
        return _run(root, bench, workload, cell, cfg, mix, build, loop_cls,
                    seed, seconds, trace_on, device, t_setup,
                    [control_hooks, hooks])


def _run(root, bench, workload, cell, cfg, mix, build, loop_cls, seed,
         seconds, trace_on, device, t_setup, hook_fns) -> Dict:
    import torch
    import ceph_tpu_torch
    ceph_tpu_torch.set_default_device(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from ceph_tpu_torch.ops import xor_kernel
    system = build(cfg, device)
    loop = loop_cls(system, mix, seed, device)
    for fn in hook_fns:
        if fn is not None:
            loop.hooks.update(fn(loop))
    try:
        loop.setup()
        generator.sync(device)
        # what set-up left is old by now: a full collection in the window
        # would walk it on a schedule that differs from run to run
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_setup
        k1_0 = xor_kernel.launches
        try:
            with trace.traced(trace_on, device) as tr:
                window_s = loop.run_window(seconds)
        finally:
            gc.unfreeze()
        k1_launches = xor_kernel.launches - k1_0
        peak = torch.cuda.max_memory_allocated() \
            if torch.device(device).type == "cuda" else 0
        loop.collect()
    finally:
        system.close()
    loop.sys = None
    del system
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = loop.check()
    loop.work.update(k1_launches=k1_launches)
    run = {"cell": cell, "config": cfg, "traffic": mix, "seed": seed,
           "setup_s": setup_s, "window_s": window_s, "ops": loop.ops,
           "work": loop.work,
           "trace": trace.reduce(tr.events) if trace_on else None}
    metrics = {}
    for m in cell_metrics(bench, workload, trace_on):
        v = load(find(root, bench, "metrics", m["name"] + ".py")).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": len(loop.ops), "failed": loop.failed,
           "metrics": metrics,
           "device": {"memory_peak_bytes": peak}}
    if trace_on:
        t = run["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    return out
