"""neorados — the asio-native async RADOS client surface.

The reference rewrote librados around asio completions (src/neorados/:
`RADOS::execute` returning awaitable operations instead of blocking
calls).  The Python-native analog is asyncio: every I/O verb returns
an awaitable and fan-out happens with `asyncio.gather`.  Data verbs
ride REAL async submission — the underlying ioctx's ``aio_*``
completions (the async objecter's engine, per-object ordered) wrapped
via ``asyncio.wrap_future`` — so an `await io.write_full(...)` is the
same submit→complete machinery the wire core runs, not a thread
parked on a blocking call.  Verbs with no aio counterpart (snap DDL,
listings) fall back to a small executor.

    async with AsyncRados(rados) as ar:
        io = await ar.open_ioctx("rep")
        await io.write_full("a", b"1")
        datas = await asyncio.gather(*[io.read(f"o{i}")
                                       for i in range(32)])

Works over BOTH tiers: an in-process `Rados` ioctx or a process
cluster's `RemoteIoCtx` (pass the opened ioctx to ``AsyncIoCtx``
directly).
"""
from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional


class AsyncIoCtx:
    """Awaitable facade over any object implementing the IoCtx
    contract (client/rados.py IoCtx or client/remote_ioctx.py
    RemoteIoCtx)."""

    def __init__(self, ioctx, executor: Optional[ThreadPoolExecutor] = None):
        self._io = ioctx
        # only a pool we CREATED may be shut down by close(): a shared
        # executor (AsyncRados hands out its own) outlives any one ioctx
        self._own_pool = executor is None
        self._pool = executor or ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="neorados")

    def _run(self, fn, *args, **kw):
        loop = asyncio.get_running_loop()
        return loop.run_in_executor(self._pool,
                                    lambda: fn(*args, **kw))

    def _aio(self, verb: str, fallback, *args):
        """Prefer the ioctx's real async submission (an AioCompletion
        IS a concurrent.futures.Future, so wrap_future turns it into
        an awaitable with no thread parked on it); executor fallback
        keeps foreign IoCtx implementations working."""
        fn = getattr(self._io, verb, None)
        if fn is not None:
            return asyncio.wrap_future(fn(*args))
        return self._run(fallback, *args)

    # ------------------------------------------------------------- verbs --
    def write_full(self, oid: str, data: bytes):
        return self._aio("aio_write_full", self._io.write_full,
                         oid, data)

    def write(self, oid: str, data: bytes, offset: int = 0):
        return self._run(self._io.write, oid, data, offset)

    def read(self, oid: str, length: Optional[int] = None,
             offset: int = 0, snap: Optional[int] = None):
        return self._aio("aio_read", self._io.read,
                         oid, length, offset, snap)

    def remove(self, oid: str):
        return self._aio("aio_remove", self._io.remove, oid)

    def stat(self, oid: str):
        return self._run(self._io.stat, oid)

    def list_objects(self):
        return self._run(self._io.list_objects)

    def snap_create(self, snap_name: str):
        return self._run(self._io.snap_create, snap_name)

    def close(self) -> None:
        if self._own_pool:
            self._pool.shutdown(wait=False)


class AsyncRados:
    """Async cluster handle (neorados::RADOS role) over a connected
    sync Rados or RemoteCluster."""

    def __init__(self, rados):
        self._rados = rados
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="neorados")

    async def open_ioctx(self, pool_name: str) -> AsyncIoCtx:
        loop = asyncio.get_running_loop()
        if hasattr(self._rados, "open_ioctx"):
            io = await loop.run_in_executor(
                self._pool, self._rados.open_ioctx, pool_name)
        else:
            # RemoteCluster: wrap the wire tier's IoCtx adapter
            from .remote_ioctx import RemoteIoCtx
            io = await loop.run_in_executor(
                self._pool, RemoteIoCtx, self._rados, pool_name)
        return AsyncIoCtx(io, executor=self._pool)

    async def __aenter__(self) -> "AsyncRados":
        return self

    async def __aexit__(self, *exc) -> None:
        self._pool.shutdown(wait=False)
