"""In-OSD object classes — the src/cls/ + ClassHandler role.

The reference executes registered "object class" methods INSIDE the
OSD, against the object an op targets (src/osd/ClassHandler.cc loading
cls_lock, cls_refcount, cls_rbd, ...; invoked via the CEPH_OSD_OP_CALL
op).  Same seam here: classes register (name, method) handlers that
run against a MethodContext scoped to one object on the PRIMARY's
objectstore; mutations are applied transactionally, so a failing
method leaves the object untouched.

Shipped classes (the reference's most-used pair):
  * lock     — advisory shared/exclusive object locks in an xattr
               (src/cls/lock/cls_lock.cc: lock/unlock/break_lock/info)
  * refcount — reference counting with put-deletes-at-zero
               (src/cls/refcount/cls_refcount.cc: get/put/read)

Surfaces: ClusterSim.exec_cls(...) (the OSD CALL op) and
IoCtx.exec(oid, cls, method, input) (the librados exec entry point).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Tuple

from .objectstore import ObjectStoreError, Transaction

Coll = Tuple[int, int]


class ClsError(IOError):
    pass


class MethodContext:
    """What a class method may touch: ONE object on the local store
    (the cls_method_context_t role)."""

    def __init__(self, store, coll: Coll, oid: str):
        self.store = store
        self.coll = coll
        self.oid = oid
        self._txn = Transaction()

    # -------------------------------------------------------------- read --
    def exists(self) -> bool:
        return self.store.exists(self.coll, self.oid)

    def read(self) -> bytes:
        return self.store.read(self.coll, self.oid)

    def getxattr(self, key: str) -> Optional[bytes]:
        try:
            return self.store.getattr(self.coll, self.oid, key)
        except (KeyError, ObjectStoreError):
            return None

    def omap_get(self, key: str) -> Optional[bytes]:
        try:
            return self.store.omap_get(self.coll, self.oid, key)
        except (KeyError, ObjectStoreError):
            return None

    # ------------------------------------------------------------- write --
    def create(self) -> None:
        self._txn.touch(self.coll, self.oid)

    def write_full(self, data: bytes) -> None:
        self._txn.write_full(self.coll, self.oid, data)

    def setxattr(self, key: str, value: bytes) -> None:
        self._txn.setattr(self.coll, self.oid, key, value)

    def omap_set(self, key: str, value: bytes) -> None:
        self._txn.omap_set(self.coll, self.oid, key, value)

    def remove(self) -> None:
        self._txn.remove(self.coll, self.oid)

    def commit(self) -> None:
        if len(self._txn.ops):
            self.store.apply_transaction(self._txn)
            self._txn = Transaction()


Method = Callable[[MethodContext, bytes], bytes]


class ClassHandler:
    """Registry + dispatcher (ClassHandler::open_class/get_method)."""

    def __init__(self):
        self._methods: Dict[Tuple[str, str], Method] = {}
        register_standard_classes(self)

    def register(self, cls: str, method: str, fn: Method) -> None:
        self._methods[(cls, method)] = fn

    def call(self, store, coll: Coll, oid: str, cls: str, method: str,
             inp: bytes = b"") -> bytes:
        fn = self._methods.get((cls, method))
        if fn is None:
            raise ClsError(f"no method {cls}.{method}")
        ctx = MethodContext(store, coll, oid)
        out = fn(ctx, inp)
        ctx.commit()
        return out


# ----------------------------------------------------------- cls_lock ----

_LOCK_XATTR = "cls_lock"


def _lock_state(ctx) -> dict:
    raw = ctx.getxattr(_LOCK_XATTR)
    return json.loads(raw.decode()) if raw else {"type": "", "holders": []}


def _lock_lock(ctx: MethodContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())          # {name, type, cookie}
    st = _lock_state(ctx)
    want = req["type"]                      # "exclusive" | "shared"
    holder = {"name": req["name"], "cookie": req.get("cookie", "")}
    if st["holders"]:
        if want == "exclusive" or st["type"] == "exclusive":
            if holder not in st["holders"]:
                raise ClsError("EBUSY: lock held")
    if not ctx.exists():
        ctx.create()
    if holder not in st["holders"]:
        st["holders"].append(holder)
    st["type"] = want if not st["holders"][:-1] else st["type"] or want
    ctx.setxattr(_LOCK_XATTR, json.dumps(st).encode())
    return b""


def _lock_unlock(ctx: MethodContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    st = _lock_state(ctx)
    holder = {"name": req["name"], "cookie": req.get("cookie", "")}
    if holder not in st["holders"]:
        raise ClsError("ENOENT: not a lock holder")
    st["holders"].remove(holder)
    if not st["holders"]:
        st["type"] = ""
    ctx.setxattr(_LOCK_XATTR, json.dumps(st).encode())
    return b""


def _lock_break(ctx: MethodContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())          # {name}: evict this holder
    st = _lock_state(ctx)
    st["holders"] = [h for h in st["holders"]
                     if h["name"] != req["name"]]
    if not st["holders"]:
        st["type"] = ""
    ctx.setxattr(_LOCK_XATTR, json.dumps(st).encode())
    return b""


def _lock_info(ctx: MethodContext, inp: bytes) -> bytes:
    return json.dumps(_lock_state(ctx)).encode()


# ------------------------------------------------------- cls_refcount ----

_REF_XATTR = "cls_refcount"


def _ref_get(ctx: MethodContext, inp: bytes) -> bytes:
    tag = inp.decode()
    raw = ctx.getxattr(_REF_XATTR)
    refs = json.loads(raw.decode()) if raw else []
    if tag not in refs:
        refs.append(tag)
    if not ctx.exists():
        ctx.create()
    ctx.setxattr(_REF_XATTR, json.dumps(refs).encode())
    return str(len(refs)).encode()


def _ref_put(ctx: MethodContext, inp: bytes) -> bytes:
    tag = inp.decode()
    raw = ctx.getxattr(_REF_XATTR)
    refs = json.loads(raw.decode()) if raw else []
    if tag in refs:
        refs.remove(tag)
    if not refs:
        if ctx.exists():
            ctx.remove()            # last ref drops the object
        return b"0"
    ctx.setxattr(_REF_XATTR, json.dumps(refs).encode())
    return str(len(refs)).encode()


def _ref_read(ctx: MethodContext, inp: bytes) -> bytes:
    raw = ctx.getxattr(_REF_XATTR)
    return raw if raw else b"[]"


def register_standard_classes(h: ClassHandler) -> None:
    h.register("lock", "lock", _lock_lock)
    h.register("lock", "unlock", _lock_unlock)
    h.register("lock", "break_lock", _lock_break)
    h.register("lock", "info", _lock_info)
    h.register("refcount", "get", _ref_get)
    h.register("refcount", "put", _ref_put)
    h.register("refcount", "read", _ref_read)
