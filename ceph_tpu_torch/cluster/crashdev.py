"""CrashDev — power-loss crash-state enumeration for the storage tier.

The stores assert their durability contract in comments ("WAL fsynced
before KV commit", "deferred replay is idempotent"); this module turns
those comments into a *proof harness*.  Every byte BlueStore / WalDB /
FileStore persist crosses the BlockDevice barrier API
(cluster/blockdev.py), so a Recorder attached to a store directory
captures the complete ordered write stream with ``fsync`` barriers.
From that stream the generator materializes simulated power-loss
images:

  * **clean prefix cuts** — the crash happens exactly at an op
    boundary; everything before it landed, nothing after;
  * **torn tails** — the last in-flight write persists only a seeded
    prefix of its bytes;
  * **dropped writes** — a seeded subset of the *pending* set (writes
    after their file's last barrier) never reaches media;
  * **reordering within a barrier epoch** — pending writes land in a
    seeded permutation; writes sealed by a barrier are never reordered
    across it (fsync means what it says).

Each image is reopened and the contract asserted
(:func:`check_bluestore_image`):

  1. the store mounts and ``fsck()`` is clean,
  2. every transaction ACKED before the crash point is fully
     readable (bytes match the oracle),
  3. the at-most-one unacked in-flight transaction is either absent
     or complete — never a Frankenstein mix of old and new,
  4. reopening is convergent: a SECOND crash during the mount's
     deferred/WAL replay, reopened again, still satisfies 1–3
     (:func:`double_crash_check`).

The harness is falsifiable: break the ordering (ack a transaction
whose WAL record was never fsynced — ``kv_fsync=False``) and the
dropped-tail images lose acked writes, which the checker reports
(tests prove the harness catches exactly that bug class).

``tear_wal_tail`` is the process-tier sibling used by
``ceph thrash --powercycle``: after a SIGKILL it mutates the dead
OSD's store the way a power cut could have — tearing bytes off the
WAL's trailing *partial* record (a fragment that never completed its
commit, so no acked write may depend on it).
"""
from __future__ import annotations

import os
import random
import shutil
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import blockdev
from .blockdev import (OP_BARRIER, OP_MARK, OP_RENAME, OP_TRUNC,
                       OP_UNLINK, OP_WRITE)

Rec = Tuple[str, str, Any, Any]


# ----------------------------------------------------------- analysis ---

def crash_points(log: List[Rec]) -> List[int]:
    """Prefix lengths ending right after each barrier — the 'clean
    cut at every barrier' image set."""
    return [i + 1 for i, r in enumerate(log) if r[0] == OP_BARRIER]


def pending_writes(log: List[Rec], upto: int) -> List[int]:
    """Indices of write records in ``log[:upto]`` that are NOT sealed:
    after their file's last barrier (or metadata ordering point).
    These are the writes a power cut at ``upto`` may tear, drop or
    reorder; everything else is durable."""
    sealed_at: Dict[str, int] = {}
    for i, (op, path, a, _b) in enumerate(log[:upto]):
        if op in (OP_BARRIER, OP_TRUNC, OP_UNLINK):
            sealed_at[path] = i
        elif op == OP_RENAME:
            sealed_at[path] = i          # src
            sealed_at[a] = i             # dst
    return [i for i, (op, path, _a, _b) in enumerate(log[:upto])
            if op == OP_WRITE and i > sealed_at.get(path, -1)]


def marks_before(log: List[Rec], upto: int) -> List[Any]:
    """Labels of transactions ACKED before the crash point."""
    return [r[1] for r in log[:upto] if r[0] == OP_MARK]


# ------------------------------------------------------ materialization ---

def materialize(log: List[Rec], upto: int, outdir: str, *,
                drop: Iterable[int] = (),
                tear: Optional[Tuple[int, int]] = None,
                order: Optional[List[int]] = None) -> None:
    """Replay ``log[:upto]`` into ``outdir`` (which may already hold a
    base image — the double-crash path replays a mount's writes onto a
    copy of the crashed image).

    ``drop``: pending-write indices that never reach media.
    ``tear``: ``(index, keep_bytes)`` — that pending write persists
    only its first ``keep_bytes``.
    ``order``: permutation of the pending-write indices (defaults to
    log order).  Only PENDING writes (see :func:`pending_writes`) may
    be mutated — sealed writes always land verbatim, in order.
    """
    os.makedirs(outdir, exist_ok=True)
    pend = set(pending_writes(log, upto))
    dropset = set(drop) & pend
    fds: Dict[str, int] = {}

    def fd(rel: str) -> int:
        f = fds.get(rel)
        if f is None:
            p = os.path.join(outdir, rel)
            d = os.path.dirname(p)
            if d:
                os.makedirs(d, exist_ok=True)
            fds[rel] = f = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
        return f

    def drop_fd(rel: str) -> None:
        f = fds.pop(rel, None)
        if f is not None:
            os.close(f)

    try:
        for i, (op, path, a, b) in enumerate(log[:upto]):
            if op == OP_WRITE:
                if i in pend:
                    continue             # pending tail: applied below
                os.pwrite(fd(path), b, a)
            elif op == OP_TRUNC:
                os.ftruncate(fd(path), a)
            elif op == OP_RENAME:
                drop_fd(path)
                drop_fd(a)
                src = os.path.join(outdir, path)
                dst = os.path.join(outdir, a)
                d = os.path.dirname(dst)
                if d:
                    os.makedirs(d, exist_ok=True)
                if os.path.exists(src):
                    os.replace(src, dst)
            elif op == OP_UNLINK:
                drop_fd(path)
                try:
                    os.unlink(os.path.join(outdir, path))
                except FileNotFoundError:
                    pass
            # OP_BARRIER / OP_MARK: no file effect
        # the pending tail, in the chosen order, with drops and tears
        # (deferring it is order-equivalent: by definition no later
        # ordering op touches these files inside the prefix)
        seq = [i for i in (order if order is not None
                           else sorted(pend)) if i in pend]
        for i in sorted(pend):
            if i not in seq:
                seq.append(i)            # a permutation must cover all
        for i in seq:
            if i in dropset:
                continue
            op, path, off, data = log[i]
            if tear is not None and i == tear[0]:
                data = data[:tear[1]]
            os.pwrite(fd(path), data, off)
    finally:
        for f in fds.values():
            os.close(f)


def seeded_images(log: List[Rec], seed: int, n_images: int,
                  out_base: str, prefix: str = "img"
                  ) -> Iterable[Dict[str, Any]]:
    """Seeded torn/dropped/reordered crash images: every draw comes
    from one ``random.Random(seed)``, so the image set is
    bit-reproducible per seed."""
    rng = random.Random(seed)
    for j in range(n_images):
        upto = rng.randrange(1, len(log) + 1)
        pend = pending_writes(log, upto)
        drop = [i for i in pend if rng.random() < 0.35]
        tear = None
        tearable = [i for i in pend if i not in drop
                    and len(log[i][3]) > 1]
        if tearable and rng.random() < 0.5:
            t = max(tearable)            # the in-flight last write
            tear = (t, rng.randrange(1, len(log[t][3])))
        order = list(pend)
        rng.shuffle(order)
        outdir = os.path.join(out_base, f"{prefix}-{seed}-{j}")
        materialize(log, upto, outdir, drop=drop, tear=tear,
                    order=order)
        yield {"upto": upto, "drop": drop, "tear": tear,
               "order": order, "dir": outdir, "seed": seed, "n": j}


# ------------------------------------------------------------ harness ---

class CrashHarness:
    """Drive a seeded BlueStore workload under a Recorder, keeping a
    model oracle; then enumerate crash images and assert the acked-
    write durability contract on each.

    The workload exercises every durability path: COW writes
    (single- and multi-block), deferred small overwrites, truncates,
    removes, omap rows, and WAL compaction (``compact_bytes`` is tiny
    so snapshot + MANIFEST renames land mid-stream).

    ``kv_fsync=False`` is the DELIBERATELY BROKEN ordering: the KV
    commit (and therefore the ack) happens before the WAL record is
    fsynced — the exact bug class the harness exists to catch; tests
    assert that enumeration then FAILS.
    """

    STORE_SUBDIR = "store"

    def __init__(self, root: str, *, seed: int = 0,
                 n_txns: int = 30, kv_fsync: bool = True,
                 min_alloc: int = 512, device_bytes: int = 1 << 20,
                 compact_bytes: int = 1536):
        self.root = os.path.abspath(root)
        self.seed = seed
        self.n_txns = n_txns
        self.kv_fsync = kv_fsync
        self.min_alloc = min_alloc
        self.device_bytes = device_bytes
        self.compact_bytes = compact_bytes
        # states[t] = model {oid: bytes} AFTER txn t acked;
        # states[-1] = initial empty store
        self.states: Dict[int, Dict[str, bytes]] = {-1: {}}
        self.omaps: Dict[int, Dict[Tuple[str, str], bytes]] = {-1: {}}
        self.log: List[Rec] = []

    def _open_store(self):
        from .bluestore import BlueStore
        st = BlueStore(os.path.join(self.root, self.STORE_SUBDIR),
                       fsync=True, min_alloc=self.min_alloc,
                       device_bytes=self.device_bytes,
                       deferred_max=self.min_alloc,
                       fsck_on_mount=False)
        st.kv.compact_bytes = self.compact_bytes
        if not self.kv_fsync:
            # THE BUG: acks outrun the WAL barrier
            st.kv.fsync = False
        return st

    def run_workload(self) -> List[Rec]:
        from .objectstore import Transaction
        rec = blockdev.attach(self.root)
        st = self._open_store()
        rng = random.Random(self.seed)
        C = (1, 0)
        model: Dict[str, bytes] = {}
        omodel: Dict[Tuple[str, str], bytes] = {}
        try:
            for t in range(self.n_txns):
                oid = f"obj-{rng.randrange(6)}"
                txn = Transaction()
                roll = rng.random()
                cur = model.get(oid)
                if cur is None or roll < 0.45:
                    # COW write_full, 1..4 blocks
                    n = rng.randrange(self.min_alloc // 2,
                                      4 * self.min_alloc)
                    data = bytes(rng.getrandbits(8) for _ in range(n))
                    txn.write_full(C, oid, data)
                    model[oid] = data
                elif roll < 0.75 and len(cur) > 8:
                    # small in-place overwrite -> the deferred path
                    ln = rng.randrange(1, min(len(cur),
                                              self.min_alloc // 2))
                    off = rng.randrange(0, len(cur) - ln + 1)
                    patch = bytes(rng.getrandbits(8)
                                  for _ in range(ln))
                    txn.write(C, oid, off, patch)
                    model[oid] = cur[:off] + patch + cur[off + ln:]
                elif roll < 0.85 and cur:
                    size = rng.randrange(0, len(cur))
                    txn.truncate(C, oid, size)
                    model[oid] = cur[:size]
                elif roll < 0.93:
                    txn.omap_set(C, oid, f"k{rng.randrange(3)}",
                                 bytes(rng.getrandbits(8)
                                       for _ in range(16)))
                    key = txn.ops[-1][3]
                    omodel[(oid, key)] = txn.ops[-1][4]
                else:
                    txn.remove(C, oid)
                    del model[oid]
                    for k in [k for k in omodel if k[0] == oid]:
                        del omodel[k]
                st.apply_transaction(txn)
                # the ACK boundary: everything up to here must be
                # durable in any crash image cut after this mark
                rec.mark(t)
                self.states[t] = dict(model)
                self.omaps[t] = dict(omodel)
        finally:
            st.close()
            blockdev.detach(rec)
        self.log = rec.snapshot()
        return self.log

    # ------------------------------------------------------- checking --
    def _expect_at(self, upto: int):
        """(acked_state, acked_omaps, next_state, next_omaps) for a
        crash at ``upto``: acked is the model at the last mark before
        the cut; next_* is the (at most one) in-flight transaction's
        complete outcome — the only other state an object may show."""
        acked = marks_before(self.log, upto)
        last = acked[-1] if acked else -1
        nxt = last + 1 if last + 1 in self.states else None
        return (self.states[last], self.omaps[last],
                None if nxt is None else self.states[nxt],
                None if nxt is None else self.omaps[nxt])

    def check_image(self, imgdir: str, upto: int) -> List[str]:
        """Assert the contract on one materialized image; returns the
        violations (empty = image satisfies the contract)."""
        from .bluestore import BlueStore
        from .objectstore import ObjectStoreError
        C = (1, 0)
        state, ostate, nxt, onxt = self._expect_at(upto)
        problems: List[str] = []
        store_dir = os.path.join(imgdir, self.STORE_SUBDIR)
        try:
            st = BlueStore(store_dir, fsync=False,
                           min_alloc=self.min_alloc,
                           device_bytes=self.device_bytes,
                           deferred_max=self.min_alloc,
                           fsck_on_mount=False)
        except Exception as e:
            return [f"mount failed: {type(e).__name__}: {e}"]
        try:
            bad = st.fsck()
            if bad:
                problems.append(f"fsck found {bad}")
            # every acked object fully readable, bytes exact
            seen = set()
            for oid, want in state.items():
                seen.add(oid)
                try:
                    got = st.read(C, oid)
                except (IOError, ObjectStoreError) as e:
                    if nxt is not None and oid not in nxt:
                        continue     # in-flight REMOVE landed whole
                    problems.append(
                        f"acked {oid} unreadable: {e}")
                    continue
                if got != want:
                    if nxt is not None and got == nxt.get(oid):
                        continue     # the in-flight txn landed whole
                    problems.append(
                        f"acked {oid}: {len(got)}B != expected "
                        f"{len(want)}B (Frankenstein or lost write)")
            for (oid, key), want in ostate.items():
                try:
                    got = st.omap_get(C, oid, key)
                except (KeyError, IOError, ObjectStoreError):
                    if onxt is not None and (oid, key) not in onxt:
                        continue     # in-flight remove landed whole
                    problems.append(f"acked omap {oid}/{key} lost")
                    continue
                if got != want and not (
                        onxt is not None
                        and got == onxt.get((oid, key))):
                    problems.append(f"acked omap {oid}/{key} mutated")
            # no unacked txn partially visible: any extra object (or
            # content off the acked model) must match the ONE
            # in-flight txn's complete outcome
            for oid in st.list_objects(C):
                if oid in seen:
                    continue
                if nxt is None or oid not in nxt:
                    problems.append(f"phantom object {oid}")
                    continue
                try:
                    got = st.read(C, oid)
                except (IOError, ObjectStoreError) as e:
                    problems.append(
                        f"in-flight {oid} visible but unreadable: {e}")
                    continue
                if got != nxt[oid]:
                    problems.append(
                        f"in-flight {oid} PARTIALLY visible "
                        f"(Frankenstein)")
        finally:
            st.close()
        return problems

    def double_crash_check(self, imgdir: str, upto: int,
                           seed: int, scratch: str) -> List[str]:
        """Crash AGAIN during the image's recovery (mount = WAL +
        deferred replay), reopen, and re-assert the contract — the
        'deferred replay idempotent under double-crash' rule.  Also
        asserts replay convergence: however the second crash cuts the
        replay, the final KV state digests agree."""
        from .bluestore import BlueStore
        base = os.path.join(scratch, "base")
        if os.path.exists(base):
            shutil.rmtree(base)
        shutil.copytree(imgdir, base)
        # record the first recovery's writes (mutates imgdir)
        rec = blockdev.attach(imgdir)
        try:
            st = BlueStore(os.path.join(imgdir, self.STORE_SUBDIR),
                           fsync=True, min_alloc=self.min_alloc,
                           device_bytes=self.device_bytes,
                           deferred_max=self.min_alloc,
                           fsck_on_mount=False)
            st.close()
        finally:
            blockdev.detach(rec)
        rlog = rec.snapshot()
        problems: List[str] = []
        if not rlog:
            return problems              # nothing replayed: no window
        rng = random.Random(seed)
        cuts = sorted({rng.randrange(1, len(rlog) + 1)
                       for _ in range(3)} | {len(rlog)})
        digest = None
        for ci, cut in enumerate(cuts):
            t2 = os.path.join(scratch, f"dc-{ci}")
            if os.path.exists(t2):
                shutil.rmtree(t2)
            shutil.copytree(base, t2)
            pend = pending_writes(rlog, cut)
            drop = [i for i in pend if rng.random() < 0.5]
            materialize(rlog, cut, t2, drop=drop)
            for p in self.check_image(t2, upto):
                problems.append(f"double-crash cut {cut}: {p}")
            # convergence: reopen once more and compare KV digests
            st = self._reopen_quiet(t2)
            if st is not None:
                d = st.kv.state_digest()
                st.close()
                if digest is None:
                    digest = d
                elif d != digest:
                    problems.append(
                        f"double-crash cut {cut}: replay did not "
                        f"converge (kv digest differs)")
        return problems

    def _reopen_quiet(self, imgdir: str):
        from .bluestore import BlueStore
        try:
            return BlueStore(os.path.join(imgdir, self.STORE_SUBDIR),
                             fsync=False, min_alloc=self.min_alloc,
                             device_bytes=self.device_bytes,
                             deferred_max=self.min_alloc,
                             fsck_on_mount=False)
        except Exception:
            return None

    # ----------------------------------------------------- enumeration --
    def enumerate_and_check(self, out_base: str, *,
                            seeds: Iterable[int] = (0, 1, 2),
                            images_per_seed: int = 70,
                            barrier_stride: int = 1,
                            double_crash_every: int = 0
                            ) -> Dict[str, Any]:
        """The acceptance sweep: every ``barrier_stride``-th clean
        barrier cut plus ``images_per_seed`` seeded mutated images per
        seed; returns counts + violations (empty = contract proven
        over the set)."""
        if not self.log:
            raise RuntimeError("run_workload() first")
        report: Dict[str, Any] = {"barrier_cuts": 0, "seeded": 0,
                                  "double_crash": 0, "violations": []}
        cuts = crash_points(self.log)[::max(1, barrier_stride)]
        for ci, cut in enumerate(cuts):
            d = os.path.join(out_base, f"cut-{ci}")
            materialize(self.log, cut, d)
            report["barrier_cuts"] += 1
            for p in self.check_image(d, cut):
                report["violations"].append(f"barrier cut {cut}: {p}")
            if double_crash_every and ci % double_crash_every == 0:
                report["double_crash"] += 1
                report["violations"].extend(self.double_crash_check(
                    d, cut, seed=self.seed * 997 + ci,
                    scratch=os.path.join(out_base, f"dc-{ci}")))
            shutil.rmtree(d, ignore_errors=True)
        for seed in seeds:
            for img in seeded_images(self.log, seed, images_per_seed,
                                     out_base):
                report["seeded"] += 1
                for p in self.check_image(img["dir"], img["upto"]):
                    report["violations"].append(
                        f"seed {seed} img {img['n']} "
                        f"(upto={img['upto']}, drop={img['drop']}, "
                        f"tear={img['tear']}): {p}")
                shutil.rmtree(img["dir"], ignore_errors=True)
        return report

    def lost_tail_image(self, out_base: str) -> Tuple[str, int]:
        """The worst-case image for un-barriered commits: cut at the
        end of the stream with EVERY pending write dropped.  A correct
        store survives this trivially (pending = unacked); a store
        that acks before its WAL barrier loses acked writes here —
        the falsifiability probe."""
        upto = len(self.log)
        d = os.path.join(out_base, "lost-tail")
        materialize(self.log, upto, d,
                    drop=pending_writes(self.log, upto))
        return d, upto


# ------------------------------------------------- powercycle mutation ---

_WAL_MAGIC = 0x57414C31
_WAL_HDR = struct.Struct("<IQII")


def tear_wal_tail(store_dir: str, rng: random.Random) -> int:
    """Process-tier crash-state mutation for ``--powercycle``: walk
    the dead OSD's BlueStore WAL, find the trailing PARTIAL record (a
    fragment whose commit never completed — SIGKILL/power cut landed
    mid-append), and tear a seeded number of bytes off it.  Complete,
    crc-valid records are NEVER touched: they may carry acked writes.
    Returns bytes torn (0 when the tail was clean).

    The rng is always advanced exactly once so the thrasher's seeded
    schedule stays identical whether or not a partial tail existed.
    """
    draw = rng.randrange(1, 64)          # schedule-stable draw
    wal = os.path.join(store_dir, "kv", "wal.log")
    if not os.path.exists(wal):
        return 0
    with open(wal, "rb") as f:
        blob = f.read()
    off = 0
    good_end = 0
    while off + _WAL_HDR.size <= len(blob):
        magic, _seq, ln, crc = _WAL_HDR.unpack_from(blob, off)
        if magic != _WAL_MAGIC:
            break
        payload = blob[off + _WAL_HDR.size:off + _WAL_HDR.size + ln]
        if len(payload) != ln or zlib.crc32(payload) != crc:
            break
        off += _WAL_HDR.size + ln
        good_end = off
    partial = len(blob) - good_end
    if partial <= 0:
        return 0
    tear = min(partial, draw)
    with open(wal, "r+b") as f:          # noqa: store surgery on a
        f.truncate(len(blob) - tear)     # DEAD daemon's files
    return tear
