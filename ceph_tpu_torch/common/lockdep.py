"""lockdep — runtime lock-ordering cycle detection (src/common/lockdep.cc
+ mutex_debug.h roles).

The reference's mutex wrappers register every named lock and record the
ORDER graph between locks held together; an acquisition that would
create a cycle in that graph (an inversion: A-then-B somewhere,
B-then-A elsewhere) aborts with a backtrace before it can deadlock in
production.  Same contract here:

    from ceph_tpu_torch.common.lockdep import LockdepLock, enable
    enable()
    a, b = LockdepLock("a"), LockdepLock("b")
    with a:
        with b: ...          # records a -> b
    with b:
        with a: ...          # raises LockOrderError (cycle a->b->a)

Disabled by default (zero overhead beyond a boolean); enable() in
tests/debug builds (the lockdep config option role).  Detection is
per-process across threads: the order graph is global, held-lock
stacks are thread-local.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Set


class LockOrderError(RuntimeError):
    pass


_enabled = False
_graph_lock = threading.Lock()
_order: Dict[str, Set[str]] = {}        # edges: earlier -> later
_tls = threading.local()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _graph_lock:
        _order.clear()


def _held() -> List[str]:
    if not hasattr(_tls, "held"):
        _tls.held = []
    return _tls.held


def held_locks() -> List[str]:
    """This thread's currently-held lock names, outermost first
    (test/debug surface: proves the stack unwinds on exception
    paths — a stale entry would poison every later order check)."""
    return list(_held())


def _reaches(src: str, dst: str) -> bool:
    """DFS over the order graph (callers hold _graph_lock)."""
    stack, seen = [src], set()
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(_order.get(cur, ()))
    return False


def _before_acquire(name: str, recursive: bool = True) -> None:
    held = _held()
    if not held:
        return
    with _graph_lock:
        for h in held:
            if h == name:
                if recursive:
                    continue           # recursive re-acquire
                # a non-recursive lock re-acquired by its own holder
                # would deadlock right here — abort loudly instead
                raise LockOrderError(
                    f"recursive acquire of non-recursive lock "
                    f"{name!r} (self-deadlock)")
            # adding h -> name: a cycle exists iff name already
            # reaches h
            if _reaches(name, h):
                raise LockOrderError(
                    f"lock order inversion: acquiring {name!r} while "
                    f"holding {h!r}, but {name!r} -> ... -> {h!r} "
                    "was recorded earlier")
            _order.setdefault(h, set()).add(name)


class LockdepLock:
    """Lock wrapper with order registration.  ``recursive=True``
    (default) wraps an RLock; ``recursive=False`` wraps a plain Lock —
    converted daemon-plane locks keep their original self-deadlock
    semantics (and with lockdep enabled, a same-thread re-acquire
    raises LockOrderError instead of hanging).  Non-recursive locks
    need per-instance names: same-name re-acquire is indistinguishable
    from recursion."""

    def __init__(self, name: str, recursive: bool = True):
        self.name = name
        self.recursive = recursive
        self._lock = threading.RLock() if recursive else \
            threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _enabled:
            _before_acquire(self.name, self.recursive)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held().append(self.name)
        return got

    def release(self) -> None:
        held = _held()
        if self.name in held:
            # remove the most recent occurrence (recursive locks)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break
        self._lock.release()

    def __enter__(self) -> "LockdepLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
