"""Lint-rule registry — the ErasureCodePlugin registry pattern
(ceph_tpu/ec/registry.py, itself mirroring ErasureCodePlugin.cc)
applied to analysis rules.

Rules register factory callables under their rule id; a version string
is checked at registration so an out-of-tree rule built against a
different framework version fails loudly instead of silently linting
with stale invariants (the __erasure_code_version failure mode).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from .. import __version__
from .core import LintError, Rule

RuleFactory = Callable[[], Rule]


class RuleRegistry:
    """Thread-safe singleton registry of rule factories."""

    _instance: "RuleRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._factories: Dict[str, RuleFactory] = {}
        self._meta: Dict[str, Dict[str, str]] = {}

    @classmethod
    def instance(cls) -> "RuleRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                reg = cls()
                reg._load_builtins()
                # publish only after builtins loaded, so a failed
                # bootstrap retries instead of pinning an empty registry
                cls._instance = reg
        return cls._instance

    # ----------------------------------------------------------- registry --
    def add(self, rule_id: str, factory: RuleFactory,
            version: str = __version__) -> None:
        if version != __version__:
            raise LintError(
                f"rule {rule_id!r} version {version!r} != runtime "
                f"{__version__!r}")
        probe = factory()
        if probe.rule_id != rule_id:
            raise LintError(
                f"rule factory id mismatch: registered as {rule_id!r} "
                f"but builds {probe.rule_id!r}")
        with self._lock:
            if rule_id in self._factories:
                raise LintError(f"rule {rule_id!r} already registered")
            self._factories[rule_id] = factory
            self._meta[rule_id] = {"name": probe.name,
                                   "description": probe.description}

    def remove(self, rule_id: str) -> None:
        with self._lock:
            self._factories.pop(rule_id, None)
            self._meta.pop(rule_id, None)

    def has(self, rule_id: str) -> bool:
        with self._lock:
            return rule_id in self._factories

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._factories)

    def describe(self) -> Dict[str, Dict[str, str]]:
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._meta.items())}

    # ------------------------------------------------------------ factory --
    def factory(self, rule_id: str) -> Rule:
        with self._lock:
            fac = self._factories.get(rule_id)
        if fac is None:
            raise LintError(f"unknown lint rule {rule_id!r}; "
                            f"known: {self.names()}")
        return fac()

    def create(self, select: Optional[Sequence[str]] = None
               ) -> List[Rule]:
        """Fresh instances of every (or the selected) rule.  A select
        entry matches an exact id or a family prefix ('CTL3')."""
        rules = []
        for rid in self.names():
            if select and not any(rid.startswith(s.upper())
                                  for s in select):
                continue
            rules.append(self.factory(rid))
        if select and not rules:
            raise LintError(f"no rules match {list(select)!r}; "
                            f"known: {self.names()}")
        return rules

    # ----------------------------------------------------------- builtins --
    def _load_builtins(self) -> None:
        # local imports to avoid cycles; each module exposes
        # register(reg), mirroring the EC plugin seam
        from . import (rules_admin, rules_concurrency, rules_dtype,
                       rules_faults, rules_jax, rules_perfconfig,
                       rules_protocol, rules_serving, rules_shard,
                       rules_trace, rules_wire)
        for mod in (rules_jax, rules_dtype, rules_concurrency,
                    rules_perfconfig, rules_admin, rules_faults,
                    rules_trace, rules_protocol, rules_serving,
                    rules_wire, rules_shard):
            mod.register(self)


def instance() -> RuleRegistry:
    return RuleRegistry.instance()
