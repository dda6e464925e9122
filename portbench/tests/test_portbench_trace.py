"""``trace.reduce`` on synthetic profiler events: the same numbers and
names as the scan it replaced, which is kept here as the oracle, and a
time that does not grow with the events before each gap."""
import bisect
import random
import time
from collections import defaultdict

import pytest

from portbench import trace


class Ev:
    """The parts of a profiler event that ``trace.reduce`` reads."""

    def __init__(self, name, a, b, cuda=False, annotation=False):
        self._name, self._a, self._b = name, a, b
        self._kind = "DeviceType.CUDA" if cuda else "DeviceType.CPU"
        self._annotation = annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._kind

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def is_user_annotation(self):
        return self._annotation


def scan_reduce(events):
    """``trace.reduce`` as it was: each gap's middle searched back
    through up to 4,096 host events by start."""
    SCAN = 4096
    win = None
    dev, host = [], []
    for ev in events:
        kind = str(ev.device_type())
        a = trace._ns(ev, "start")
        b = a + trace._dur_ns(ev)
        if kind.endswith("CUDA"):
            if not ev.name().startswith("portbench.") and \
                    not trace._annotation(ev):
                dev.append((a, b, ev.name()))
        elif ev.name() == trace.WINDOW:
            win = (a, b)
        else:
            host.append((a, b, ev.name()))
    w0, w1 = win
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
           if b > w0 and a < w1]
    kernel_s = defaultdict(float)
    for a, b, n in dev:
        kernel_s[n] += (b - a) / 1e9
    busy = trace._union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    host.sort()
    starts = [a for a, _, _ in host]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host"
        for j in range(i, max(-1, i - SCAN), -1):
            if host[j][1] > mid:
                name = host[j][2]
                break
        idle[name] += (b - a) / 1e9

    def top(d):
        return [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
            "kernel_s": dict(kernel_s), "device_ops": top(kernel_s),
            "idle_gaps": top(idle)}


def window(t0, t1):
    return [Ev(trace.WINDOW, t0, t1),
            Ev(trace.WINDOW, t0, t1, cuda=True, annotation=True)]


def covered():
    """Each gap under one host event, kernels clipped by the window."""
    return window(100, 1000) + [
        Ev("k1", 50, 200, cuda=True), Ev("k2", 300, 400, cuda=True),
        Ev("k1", 600, 1100, cuda=True),
        Ev("launch", 190, 310), Ev("sync", 390, 620),
        Ev("portbench.sweep", 150, 450, cuda=True)]


def nested():
    """Gaps inside nested spans name the innermost open one."""
    return window(0, 1000) + [
        Ev("k", 0, 100, cuda=True), Ev("k", 300, 350, cuda=True),
        Ev("k", 600, 700, cuda=True),
        Ev("osdmap.map_pgs_batch", 50, 900),
        Ev("crush.fastmap", 60, 880), Ev("crush.fastmap.resolve", 90, 320),
        Ev("aten::eq", 150, 160), Ev("crush.fastmap.emit", 340, 800)]


def threads():
    """Events of two threads that overlap without nesting: the
    latest-started event still open names the gap, also where a
    later-started one has ended."""
    return window(0, 2000) + [
        Ev("k", 0, 310, cuda=True), Ev("k", 340, 410, cuda=True),
        Ev("k", 900, 910, cuda=True), Ev("k", 1500, 1510, cuda=True),
        Ev("thread_a", 0, 700), Ev("thread_b", 100, 300),
        Ev("thread_b.late", 350, 1300), Ev("thread_a.tail", 1000, 1100),
        Ev("tie_a", 1400, 1900), Ev("tie_b", 1400, 1800)]


def uncovered():
    """Gaps whose middle no host event covers are named ``host``."""
    return window(0, 1000) + [
        Ev("k", 100, 200, cuda=True), Ev("k", 500, 600, cuda=True),
        Ev("early", 0, 40), Ev("between", 210, 300), Ev("late", 950, 1000)]


def random_events(seed):
    """Kernels, copies and host events of many names, nested and
    overlapping at random."""
    rng = random.Random(seed)
    evs = window(1000, 400000)
    t = 0
    for _ in range(800):
        t += rng.randint(0, 600)
        evs.append(Ev(rng.choice(["k1", "k2", "Memcpy DtoH", "Memset"]),
                      t, t + rng.randint(1, 500), cuda=True))
    for _ in range(1500):
        a = rng.randint(0, 410000)
        evs.append(Ev(rng.choice(["aten::add", "aten::eq",
                                  "cudaLaunchKernel", "osdmap.post_crush",
                                  "crush.fastmap", "portbench.sweep"]),
                      a, a + rng.choice([5, 50, 500, 5000, 50000])))
    rng.shuffle(evs)
    return evs


CASES = {"covered": covered, "nested": nested, "threads": threads,
         "uncovered": uncovered}
CASES.update({f"random_{s}": (lambda s=s: random_events(s))
              for s in range(4)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_reduce_gives_the_scans_numbers_and_names(case):
    evs = CASES[case]()
    got = trace.reduce(evs)
    assert got == scan_reduce(evs)
    assert got["busy_s"] > 0 and got["idle_gaps"]


def test_reduce_names_as_expected():
    names = {n for n, _ in trace.reduce(threads())["idle_gaps"]}
    assert names == {"thread_a", "thread_b.late", "tie_a"}
    names = {n for n, _ in trace.reduce(nested())["idle_gaps"]}
    assert names == {"crush.fastmap.resolve", "crush.fastmap.emit",
                     "crush.fastmap"}
    names = {n for n, _ in trace.reduce(uncovered())["idle_gaps"]}
    assert names == {"host"}


def test_many_uncovered_gaps_reduce_in_linear_time():
    """100,000 gaps, each after a host event that has ended, none
    covered: the scan searched 4,096 events back for each."""
    n, step = 100000, 1000
    evs = window(0, n * step)
    for i in range(n):
        evs.append(Ev("k", i * step, i * step + 500, cuda=True))
        evs.append(Ev("aten::add", i * step, i * step + 600))
    t0 = time.perf_counter()
    out = trace.reduce(evs)
    took = time.perf_counter() - t0
    assert out["idle_gaps"] == [["host", pytest.approx(n * 500 / 1e9)]]
    assert took <= 2.0, took
