"""The traced window: ``torch.profiler`` over it, reduced to numbers.

The device's busy time is the union of every operation the profiler saw
on the card (kernels, copies, sets), inside the window's own span; the
device-side copies of host spans (user annotations) are not operations.  An
idle gap is a stretch of the window with nothing on the card; it is
named by the innermost host event (a PyTorch operation or one of the
harness's spans) that covers its middle, or ``host`` where none does.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "portbench.window"


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")() * 1000)


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _dur_ns(ev) -> int:
    f = getattr(ev, "duration_ns", None)
    return int(f()) if f is not None else int(ev.duration_us() * 1000)


@contextlib.contextmanager
def traced(enabled: bool, device):
    """Profile the block when ``enabled``; yields a holder whose
    ``events`` are the raw profiler events afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    class Holder:
        events = None

    h = Holder()
    if not enabled:
        yield h
        return
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield h
    h.events = prof.profiler.kineto_results.events()


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events) -> Dict:
    """{busy_s, window_s, kernel_s: {name: s}, device_ops, idle_gaps}."""
    win = None
    dev, host = [], []
    for ev in events:
        kind = str(ev.device_type())
        a = _ns(ev, "start")
        b = a + _dur_ns(ev)
        if kind.endswith("CUDA"):
            # the device-side copy of a host span is no device work
            if not ev.name().startswith("portbench.") and \
                    not _annotation(ev):
                dev.append((a, b, ev.name()))
        elif ev.name() == WINDOW:
            win = (a, b)
        else:
            host.append((a, b, ev.name()))
    if win is None:
        raise RuntimeError("the trace has no window span")
    w0, w1 = win
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
           if b > w0 and a < w1]
    kernel_s: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        kernel_s[n] += (b - a) / 1e9
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # one pass: the gaps' middles in time order against the host events
    # by start; the stack holds the events started so far, and once those
    # on top that have ended are popped, its top is the latest-started
    # event still open (an event popped had ended before an earlier
    # middle, so before every later one too)
    host.sort()
    idle: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        idle[stack[-1][2] if stack else "host"] += (b - a) / 1e9

    def top(d):
        return [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
            "kernel_s": dict(kernel_s), "device_ops": top(kernel_s),
            "idle_gaps": top(idle)}
