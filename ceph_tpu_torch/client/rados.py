"""librados-style client API — the L9 surface.

Role of src/librados/ (the `rados_*` C API / C++ `Rados`/`IoCtx`
classes every client program uses) and the async AIO surface: a
cluster handle that connects to the mon, per-pool I/O contexts doing
object read/write/remove/stat/list, and futures-based AIO, all routed
through the Objecter (cached map + resend) so clients behave correctly
across map changes.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..cluster.monitor import Monitor
from ..cluster.objecter import Objecter
from ..cluster.simulator import ClusterSim


class ObjectNotFound(KeyError):
    pass


@dataclass
class ObjectStat:
    size: int
    n_stripes: int


class Rados:
    """Cluster handle (librados `rados_t`): connect() attaches to the
    mon + cluster, then open_ioctx() per pool.

    AIO rides the async objecter's completion engine
    (cluster/async_objecter.py AioEngine), not a flat thread pool:
    ops to the SAME object execute strictly in submission order (the
    librados per-object write-ordering contract two overlapping
    ``aio_write_full`` calls rely on) while distinct objects run
    concurrently, and every verb returns an ``AioCompletion`` wearing
    the librados waiting verbs (is_complete / wait_for_complete /
    get_return_value / set_complete_callback)."""

    def __init__(self, sim: ClusterSim, mon: Monitor):
        self._sim = sim
        self._mon = mon
        self._objecter: Optional[Objecter] = None
        self._aio = None                  # lazy AioEngine
        self._aio_lock = threading.Lock()

    def connect(self) -> "Rados":
        self._objecter = Objecter(self._sim, self._mon)
        return self

    @property
    def connected(self) -> bool:
        return self._objecter is not None

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        if not self.connected:
            raise RuntimeError("connect() first")
        for pid, pool in self._sim.osdmap.pools.items():
            if pool.name == pool_name or str(pid) == pool_name:
                return IoCtx(self, pid)
        raise KeyError(f"no pool {pool_name!r}")

    def pool_list(self) -> List[str]:
        return [p.name or str(pid)
                for pid, p in sorted(self._sim.osdmap.pools.items())]

    def cluster_stat(self) -> Dict[str, int]:
        objs = len(self._sim.objects)
        bytes_ = sum(i.size for i in self._sim.objects.values())
        return {"num_objects": objs, "kb": bytes_ // 1024,
                "num_osds": self._sim.osdmap.max_osd,
                "epoch": self._sim.osdmap.epoch}

    def health(self) -> str:
        return self._mon.health_status(self._sim)

    @property
    def aio_engine(self):
        """The completion engine behind the aio verbs — built lazily
        so a handle that never submits async work starts no threads."""
        if self._aio is None:
            with self._aio_lock:
                if self._aio is None:
                    from ..cluster.async_objecter import AioEngine
                    self._aio = AioEngine(workers=4, name="rados-aio")
        return self._aio

    def shutdown(self) -> None:
        if self._aio is not None:
            self._aio.close()
            self._aio = None
        self._objecter = None


class IoCtx:
    """Per-pool I/O context (librados `rados_ioctx_t`)."""

    def __init__(self, rados: Rados, pool_id: int):
        self._rados = rados
        self.pool_id = pool_id

    # ------------------------------------------------------------- sync --
    def write_full(self, oid: str, data: bytes) -> None:
        self._rados._objecter.put(self.pool_id, oid, data)

    def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        self._rados._objecter.write(self.pool_id, oid, offset, data)

    def read(self, oid: str, length: Optional[int] = None,
             offset: int = 0, snap: Optional[int] = None) -> bytes:
        """``snap``: read the object's state AT that pool snapshot
        (librados snap_read context role)."""
        sim = self._rados._sim
        if snap is not None:
            try:
                data = sim.get_snap(self.pool_id, oid, snap)
            except KeyError:
                raise ObjectNotFound(f"{oid}@{snap}") from None
        else:
            if (self.pool_id, oid) not in sim.objects:
                raise ObjectNotFound(oid)
            data = self._rados._objecter.get(self.pool_id, oid)
        if length is None:
            return data[offset:]
        return data[offset:offset + length]

    # ------------------------------------------------------- snapshots --
    def snap_create(self, snap_name: str) -> int:
        return self._rados._sim.snap_create(self.pool_id, snap_name)

    def snap_lookup(self, snap_name: str) -> int:
        return self._rados._sim.snap_lookup(self.pool_id, snap_name)

    def snap_remove(self, snap_name: str) -> int:
        sid = self.snap_lookup(snap_name)
        return self._rados._sim.snap_remove(self.pool_id, sid)

    def snap_rollback(self, oid: str, snap_name: str) -> None:
        sid = self.snap_lookup(snap_name)
        self._rados._sim.snap_rollback(self.pool_id, oid, sid)

    def snap_rollback_id(self, oid: str, snap_id: int) -> None:
        """Rollback by snap ID (selfmanaged-snap rollback role —
        librbd tracks ids, not pool snap names); KeyError when the
        object has no state at that snap."""
        self._rados._sim.snap_rollback(self.pool_id, oid, snap_id)

    # ------------------------------------------------------------ exec --
    def exec(self, oid: str, cls: str, method: str,
             data: bytes = b"") -> bytes:
        """Run an in-OSD object-class method (rados_exec role)."""
        return self._rados._sim.exec_cls(self.pool_id, oid, cls,
                                         method, data)

    # ----------------------------------------------------- watch/notify --
    def watch(self, oid: str, callback) -> int:
        return self._rados._sim.watch(self.pool_id, oid, callback)

    def unwatch(self, oid: str, watch_id: int) -> None:
        self._rados._sim.unwatch(self.pool_id, oid, watch_id)

    def notify(self, oid: str, payload: bytes = b"") -> dict:
        return self._rados._sim.notify(self.pool_id, oid, payload)

    def remove(self, oid: str) -> None:
        sim = self._rados._sim
        if (self.pool_id, oid) not in sim.objects:
            raise ObjectNotFound(oid)
        sim.delete(self.pool_id, oid)

    def stat(self, oid: str) -> ObjectStat:
        info = self._rados._sim.objects.get((self.pool_id, oid))
        if info is None:
            raise ObjectNotFound(oid)
        return ObjectStat(size=info.size, n_stripes=info.n_stripes)

    def list_objects(self) -> List[str]:
        return sorted(name for (pid, name) in self._rados._sim.objects
                      if pid == self.pool_id)

    # -------------------------------------------------------------- aio --
    # Async submission through the completion engine: same-object ops
    # serialize in submission order (overlapping aio_write_full to one
    # object commit in order; a read submitted after a write observes
    # it), distinct objects run concurrently across the workers.
    def _aio_key(self, oid: str):
        return ("obj", self.pool_id, oid)

    def aio_write_full(self, oid: str, data: bytes):
        return self._rados.aio_engine.submit(
            lambda: self.write_full(oid, data),
            key=self._aio_key(oid))

    def aio_read(self, oid: str, length: Optional[int] = None,
                 offset: int = 0, snap: Optional[int] = None):
        return self._rados.aio_engine.submit(
            lambda: self.read(oid, length, offset, snap),
            key=self._aio_key(oid))

    def aio_remove(self, oid: str):
        return self._rados.aio_engine.submit(
            lambda: self.remove(oid), key=self._aio_key(oid))
