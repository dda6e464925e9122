"""jit_profile — compile-vs-execute attribution for device dispatches.

Copy of ``ceph_tpu/common/jit_profile.py``.  The port has no XLA compile:
``compile_event`` records a kernel build (``ops/_build.load``, component
``kernel.build``) or a first-seen GF matrix reaching the device
(``ops/gf_jax.matrix_to_device``, component ``ec.gf_jax``) under the same
span and counter names, so the same consumers read them; ``wrap`` keeps
its contract for any cached callable whose first call is the costly one.
The text below is the reference's.

The blind spot this closes (PAPERS 2108.02692's program-optimization
lens): a jit cache miss in ``xla_mapper`` / ``gf_jax`` /
``data_plane`` stalls the triggering op for the XLA compile's wall
time — seconds on a cold process — and until now that cost was
invisible: the op's latency histogram showed a mystery spike, the
flame trace showed one fat ``device.dispatch`` span, and cold-compile
stalls repeatedly masqueraded as flakes and skewed benches.

``wrap()`` takes a FRESHLY-JITTED callable (jax compiles lazily, so
the cache-insert site knows "this will compile" but the cost lands on
the first invocation) and returns a wrapper that:

  * times the FIRST call inside a ``jit.compile`` child span (tagged
    with component + shape signature) linked under whatever op span
    is active — a cold-cache slow op's assembled trace now *says* it
    compiled, and where;
  * records perf counters in the ``jit`` group: ``compiles`` (the
    monotonic headline counter the metrics-history rate layer
    queries — lint CTL702 holds it inc-only), ``compile_s`` wall-time
    histogram, per-component ``<component>.compiles``, and
    ``execute_s`` for warm calls (the compile-vs-execute split).

Already-cached callables pass through ``wrap(..., compiled=False)``
unchanged — the warm path pays nothing new beyond what callers
already paid.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from . import tracer as _trace
from .perf_counters import perf as _perf


def signature_of(*arrays: Any) -> str:
    """Compact shape/dtype signature for span tags ("8x256:int32,
    256:uint8") — enough to say WHICH executable family compiled."""
    parts = []
    for a in arrays:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is None:
            parts.append(type(a).__name__)
        else:
            parts.append("x".join(str(d) for d in shape) +
                         (f":{dtype}" if dtype is not None else ""))
    return ",".join(parts)


class ProfiledJit:
    """First call = compile event (span + counters); warm calls =
    execute accounting only."""

    __slots__ = ("fn", "component", "signature", "_cold")

    def __init__(self, fn: Callable, component: str, signature: str):
        self.fn = fn
        self.component = component
        self.signature = signature
        self._cold = True

    def __call__(self, *args, **kw):
        pc = _perf("jit")
        if self._cold:
            self._cold = False
            t0 = time.perf_counter()
            # child span only: an untraced caller must not spawn an
            # orphan root per compile, but a traced op's flame tree
            # gets the jit.compile stage it has been missing
            with _trace.child_span("jit.compile",
                                   component=self.component,
                                   signature=self.signature):
                out = self.fn(*args, **kw)
            dt = time.perf_counter() - t0
            pc.inc("compiles")
            pc.inc(f"{self.component}.compiles")
            pc.hinc("compile_s", dt)
            return out
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        pc.hinc("execute_s", time.perf_counter() - t0)
        return out


class _CompileEvent:
    """Context manager around one known-cold device materialization
    (the gf_jax matrix upload shape, where the cost is a single call,
    not a cached callable)."""

    __slots__ = ("component", "signature", "_cm", "_t0")

    def __init__(self, component: str, signature: str):
        self.component = component
        self.signature = signature

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._cm = _trace.child_span("jit.compile",
                                     component=self.component,
                                     signature=self.signature)
        self._cm.__enter__()
        return self

    def __exit__(self, et, ev, tb):
        self._cm.__exit__(et, ev, tb)
        pc = _perf("jit")
        pc.inc("compiles")
        pc.inc(f"{self.component}.compiles")
        pc.hinc("compile_s", time.perf_counter() - self._t0)
        return False


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCM()


def compile_event(component: str, signature: str = "",
                  compiled: bool = True):
    """``with compile_event("ec.gf_jax", sig, compiled):`` — a no-op
    when the cache hit (``compiled`` False)."""
    return _CompileEvent(component, signature) if compiled else _NULL


def wrap(fn: Callable, component: str, signature: str = "",
         compiled: bool = True) -> Callable:
    """Wrap a jitted callable for compile attribution.  ``compiled``
    False (cache hit) returns ``fn`` untouched — the call site's
    existing cache-miss test decides, this module never second-
    guesses it."""
    if not compiled:
        return fn
    return ProfiledJit(fn, component, signature)
