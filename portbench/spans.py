"""What the readers of the program's own spans share.

The port's tracer (``ceph_tpu_torch.common.tracer``) keeps the spans a
run opened in its buffer; a span's dump carries ``t0``, its
``perf_counter`` start, and ``duration_s``, its time on the host's
clock, and a span opened on a device also ``device_s``, the device's
time between its entry and its exit.  On a CUDA device that is the
stream's time between two timing events, which the span records only
while a profiler is active (``--trace 1``) and which are read at dump
time: the stage's kernels plus any idle inside the stage.  On the CPU,
torch runs each op before it returns, so it is the span's own duration.
Under the profiler each span is also a ``record_function`` range, so
``trace.py`` names an idle gap by the innermost program span above it.

The window's spans are those that start inside it: after the window's
start (its last operation's end less its length, which is at most its
first operation's start) and before its last operation's end; the
operations' times are ``perf_counter`` too.  A program without such
spans, or a run without a trace, gives nothing to read.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def window(run) -> Optional[List[Dict]]:
    """The spans that start inside the traced window, or None."""
    ops = run["ops"]
    if not run["trace"] or not ops:
        return None
    from ceph_tpu_torch.common.tracer import tracer
    lo = min(ops[0]["t0"], ops[-1]["t1"] - run["window_s"])
    hi = ops[-1]["t1"]
    return [s for s in tracer().dump()
            if "t0" in s and lo <= s["t0"] <= hi]


def per_op_ms(run, kind: str, names, field: str) -> Optional[float]:
    """The sum of ``field`` (``duration_s`` or ``device_s``) over the
    window's spans of these names, in ms for each operation of ``kind``;
    None where no such span, or one without the field, is there."""
    spans = window(run)
    if spans is None:
        return None
    vals = [s.get(field) for s in spans if s["name"] in names]
    n = sum(op["kind"] == kind for op in run["ops"])
    if not vals or None in vals or not n:
        return None
    return 1e3 * sum(vals) / n
