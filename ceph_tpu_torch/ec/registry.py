"""Erasure-code plugin registry.

The reference gates every codec behind a singleton registry that dlopens
``libec_<name>.so``, checks a build-version symbol, and lets the plugin
register itself (src/erasure-code/ErasureCodePlugin.cc:86-178); daemons
preload a configured plugin list at startup (src/global/global_init.cc:591).

The port keeps the reference package's seam: plugins register factory
callables under a name; ``factory(name, profile, device=None)``
instantiates and init()s a codec on ``device`` (the package default when
None).  A version string is checked at registration to preserve the
reference's mismatched-plugin failure mode.  The builtins are the
reference's six: ``jerasure``, ``isa``, ``jax``, ``lrc``, ``shec`` and
``clay``; a layered codec (lrc, clay) passes its own device on to the
inner codecs it builds here.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

from .. import __version__
from .interface import ErasureCodeError, ErasureCodeInterface, \
    ErasureCodeProfile

PluginFactory = Callable[..., ErasureCodeInterface]


class ErasureCodePluginRegistry:
    """Thread-safe singleton registry (ErasureCodePlugin.cc:29-60)."""

    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: Dict[str, PluginFactory] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                reg = cls()
                reg._load_builtins()
                # publish only after builtins loaded, so a failed bootstrap
                # retries instead of pinning an empty registry
                cls._instance = reg
        return cls._instance

    # ----------------------------------------------------------- registry --
    def add(self, name: str, factory: PluginFactory,
            version: str = __version__) -> None:
        """Register a plugin; version mismatch fails loudly, mirroring the
        __erasure_code_version check (ErasureCodePlugin.cc:120-143)."""
        if version != __version__:
            raise ErasureCodeError(
                f"plugin {name!r} version {version!r} != runtime "
                f"{__version__!r}")
        with self._lock:
            if name in self._plugins:
                raise ErasureCodeError(f"plugin {name!r} already registered")
            self._plugins[name] = factory

    def remove(self, name: str) -> None:
        with self._lock:
            self._plugins.pop(name, None)

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._plugins

    def names(self):
        with self._lock:
            return sorted(self._plugins)

    # ------------------------------------------------------------ factory --
    def factory(self, name: str, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        with self._lock:
            fac = self._plugins.get(name)
        if fac is None:
            raise ErasureCodeError(
                f"unknown erasure-code plugin {name!r}; "
                f"known: {self.names()}")
        return fac(profile, device=device)

    def preload(self, names) -> None:
        """Import-side-effect preload hook (ErasureCodePlugin.cc:180-196);
        builtin plugins are always loaded, so this only validates names."""
        for n in names:
            if not self.has(n):
                raise ErasureCodeError(f"cannot preload unknown plugin {n!r}")

    # ----------------------------------------------------------- builtins --
    def _load_builtins(self) -> None:
        # local imports to avoid cycles; each module exposes register(reg)
        from . import (plugin_clay, plugin_isa, plugin_jax, plugin_jerasure,
                       plugin_lrc, plugin_shec)
        for mod in (plugin_jerasure, plugin_isa, plugin_jax, plugin_lrc,
                    plugin_shec, plugin_clay):
            mod.register(self)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
