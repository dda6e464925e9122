"""RGW user store — durable S3/Swift credentials and quotas.

The reference keeps users (access keys, secrets, display names,
quotas) in RADOS objects managed by radosgw-admin (src/rgw/rgw_user.cc,
rgw_admin.cc `user create/info/rm`).  Same shape here: one JSON row
object per user in the gateway's pool, plus an access-key → uid index
so SigV4 verification can resolve credentials in one read.  The
S3Frontend/SwiftFrontend consume ``auth_users()`` / ``swift_users()``
views of this store.
"""
from __future__ import annotations

import json
import secrets
from typing import Dict, List, Optional


class UserError(RuntimeError):
    pass


class UserStore:
    def __init__(self, ioctx):
        self.ioctx = ioctx

    # ----------------------------------------------------------- storage --
    def _uoid(self, uid: str) -> str:
        return f"rgw.user.{uid}"

    def _koid(self, access_key: str) -> str:
        return f"rgw.key.{access_key}"

    def _load(self, uid: str) -> dict:
        """Missing and corrupt are DIFFERENT errors: a torn/invalid
        record must not read as absent, or create() would silently
        clobber it and regenerate every credential."""
        try:
            blob = self.ioctx.read(self._uoid(uid))
        except KeyError:            # ObjectNotFound
            raise UserError(f"NoSuchUser: {uid}") from None
        try:
            return json.loads(bytes(blob).decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise UserError(f"CorruptUser: {uid}: {e}") from None

    def _save(self, rec: dict) -> None:
        self.ioctx.write_full(self._uoid(rec["uid"]),
                              json.dumps(rec).encode())
        for k in rec["keys"]:
            self.ioctx.write_full(self._koid(k["access_key"]),
                                  rec["uid"].encode())

    # --------------------------------------------------------------- api --
    def create(self, uid: str, display_name: str = "",
               max_buckets: int = 1000) -> dict:
        exists = True
        try:
            self._load(uid)
        except UserError as e:
            if str(e).startswith("NoSuchUser"):
                exists = False
            else:
                raise               # corrupt record: surface, don't clobber
        if exists:
            raise UserError(f"UserAlreadyExists: {uid}")
        rec = {"uid": uid, "display_name": display_name or uid,
               "max_buckets": max_buckets, "suspended": False,
               "keys": [{"access_key": "AK" + secrets.token_hex(8).upper(),
                         "secret_key": secrets.token_hex(20)}],
               "swift_keys": [{"user": f"{uid}:swift",
                               "secret_key": secrets.token_hex(16)}]}
        self._save(rec)
        return rec

    def info(self, uid: str) -> dict:
        return self._load(uid)

    def rm(self, uid: str) -> None:
        rec = self._load(uid)
        for k in rec["keys"]:
            try:
                self.ioctx.remove(self._koid(k["access_key"]))
            except Exception:
                pass
        self.ioctx.remove(self._uoid(uid))

    def suspend(self, uid: str, suspended: bool = True) -> dict:
        rec = self._load(uid)
        rec["suspended"] = suspended
        self._save(rec)
        return rec

    def key_create(self, uid: str) -> dict:
        rec = self._load(uid)
        key = {"access_key": "AK" + secrets.token_hex(8).upper(),
               "secret_key": secrets.token_hex(20)}
        rec["keys"].append(key)
        self._save(rec)
        return key

    def list_users(self) -> List[str]:
        out = []
        for oid in self.ioctx.list_objects():
            if oid.startswith("rgw.user."):
                out.append(oid[len("rgw.user."):])
        return sorted(out)

    def lookup_access_key(self, access_key: str) -> Optional[dict]:
        try:
            uid = bytes(self.ioctx.read(self._koid(access_key))).decode()
        except KeyError:
            # unknown access key -> auth failure.  A TRANSIENT read
            # error propagates: spuriously denying a VALID key on a
            # degraded read is the CTL603 fabricated-absence class
            return None
        try:
            rec = self._load(uid)
        except UserError:
            return None
        if rec["suspended"]:
            return None
        return rec

    # ------------------------------------------------------ frontend views --
    def auth_users(self) -> Dict[str, dict]:
        """S3Frontend's ``users`` mapping: access_key -> secret/user."""
        out: Dict[str, dict] = {}
        for uid in self.list_users():
            rec = self._load(uid)
            if rec["suspended"]:
                continue
            for k in rec["keys"]:
                out[k["access_key"]] = {"secret": k["secret_key"],
                                        "user": uid}
        return out

    def swift_users(self) -> Dict[str, str]:
        """SwiftFrontend's ``users`` mapping: account:user -> key."""
        out: Dict[str, str] = {}
        for uid in self.list_users():
            rec = self._load(uid)
            if rec["suspended"]:
                continue
            for k in rec.get("swift_keys", []):
                out[k["user"]] = k["secret_key"]
        return out
