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
spans, or a run without a trace, gives nothing to read.  Through a
traced run the program's buffer keeps every span (``kept``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

# spans the program's buffer holds through a traced run: its own bound
# (10,000; it then drops the oldest half) holds some 200 remap sweeps
KEPT = 10 ** 6


@contextlib.contextmanager
def kept(on: bool):
    """While ``on``, the program's span buffer keeps every span (up to
    ``KEPT``), so that the readers sum all of the window's, however
    many operations it holds; its own bound is restored afterwards."""
    if not on:
        yield
        return
    from ceph_tpu_torch.common.tracer import tracer
    buf = tracer()
    bound, buf.max_spans = buf.max_spans, max(buf.max_spans, KEPT)
    try:
        yield
    finally:
        buf.max_spans = bound


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
