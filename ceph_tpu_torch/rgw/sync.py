"""Multisite bucket sync — per-shard bilog replay between zones.

The RGW data-sync role (src/rgw/driver/rados/rgw_sync.cc,
rgw_data_sync.cc: per-(bucket, shard) index logs consumed by the peer
zone's sync agent) on this repo's seams:

  * MARKERS ARE PER (bucket, shard, generation).  One durable cursor
    object per (bucket, zone) holds {"gen": g, "shards": {shard:
    last_applied_seq}}; a crash/kill9 at ANY point resumes from it —
    there is no full-sync path in this agent at all (``stats
    ["full_syncs"]`` exists so gates can assert that structurally).
  * RESHARD IS A SYNCED CUTOVER, NOT A RESTART.  reshard_bucket
    end-marks the outgoing generation's bilogs in the bucket record
    (``log_gens``); the agent drains each retired generation's shards
    to those ends, bumps its cursor to the next generation, and
    continues on the new shard set.
  * CATCH-UP PIPELINES.  Each (generation, shard) drain is one job on
    the shared AioEngine, keyed (bucket, zone, gen, shard): ordering
    within a shard is FIFO-strict, while shards — and buckets, under
    PeriodSync's shared engine — fetch/apply concurrently.  Mutating
    applies go through the destination gateway's ioctx, so on the
    wire tier they ride the AsyncObjecter's (session, seq) stamps and
    a replayed apply is at-most-once at the daemon dup tables too.
  * AT-MOST-ONCE APPLIES.  The destination side keeps its own applied
    marker per (gen, shard); an entry at or below it is a counted
    ``replay_skip``, and the marker only advances AFTER the apply's
    write completed (advancing first is the acked-then-lost ordering
    bug lint CTL605 polices).
  * TRANSIENT IOErrors TAKE ExpBackoff and then SURFACE into the pass
    report with the marker unmoved — never the CTL603
    swallow-to-default class.
  * TRIM IS DRAIN-GATED.  Active-generation logs trim to the min
    cursor over every registered zone; retired generations are
    removed only once every zone drained past their end markers
    (gateway.retire_drained_bilogs).

Cross-zone traffic consults the ``net.partition`` faultpoint with
``zone.<name>`` entities, so the DR drill severs replication with the
same axis the daemons' netsplits use.
"""
from __future__ import annotations

import json
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..common import faults
from ..common.backoff import ExpBackoff
from ..common.perf_counters import perf as _perf
from .gateway import (Bucket, RGWError, RGWGateway, _read_json,
                      read_sync_state, sync_state_oid, zones_oid)

# counters every agent carries; a gate may assert on any of them
_STAT_KEYS = ("puts", "deletes", "replay_skips", "origin_skips",
              "conflict_skips", "missing_src", "errors",
              "gen_cutovers", "double_applies", "full_syncs")


def make_sync_engine(workers: int = 4):
    """The shared fetch/apply pipeline (AioEngine): per-(bucket,
    zone, gen, shard) FIFO, everything else concurrent."""
    from ..cluster.async_objecter import AioEngine
    return AioEngine(workers=workers, name="geosync")


class BucketSyncAgent:
    def __init__(self, src: RGWGateway, dst: RGWGateway, bucket: str,
                 zone: str, src_zone: str = "src",
                 engine=None, lag_bucket: bool = True):
        """``zone`` names the DESTINATION and keys the committed
        cursor in the source pool — every destination zone must use
        a distinct name, or agents would consume each other's cursor
        and silently skip entries.  ``src_zone`` names the source
        (origin stamping + the destination-side applied markers);
        ``engine`` is an optional shared AioEngine — without one the
        shard drains run serially in the calling thread."""
        self.src_gw = src
        self.dst_gw = dst
        self.bucket = bucket
        self.zone = zone
        self.src_zone = src_zone
        self.engine = engine
        self.src = src.bucket(bucket)
        self.stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}
        self.last_errors: List[str] = []
        self._stats_lock = threading.Lock()
        self._applied: Dict[Tuple[int, int], int] = {}
        self._src_ent = f"zone.{src_zone}"
        self._dst_ent = f"zone.{zone}"
        self._lag = _perf(f"geosync.{src_zone}.{zone}") \
            if lag_bucket else None
        self._register_zone()

    # ----------------------------------------------------- registration --
    def _register_zone(self) -> None:
        """Journal-client registration: trim must respect the SLOWEST
        registered zone, so every destination announces itself."""
        zones = self._zones()
        if self.zone not in zones:
            zones.append(self.zone)
            self.src_gw.ioctx.write_full(
                zones_oid(self.bucket),
                json.dumps(sorted(zones)).encode())

    def _zones(self) -> List[str]:
        # retry-through transient errors, default only on absence:
        # an "empty zone set" fabricated from a transient read error
        # would drop every peer zone from the next sync fan-out
        return _read_json(self.src_gw.ioctx, zones_oid(self.bucket),
                          [], "zone set")

    def _dst_bucket(self) -> Bucket:
        try:
            return self.dst_gw.bucket(self.bucket)
        except RGWError:
            return self.dst_gw.create_bucket(self.bucket)

    # ----------------------------------------------------------- cursor --
    def _load_state(self) -> Optional[Dict[str, Any]]:
        return read_sync_state(self.src_gw.ioctx, self.bucket,
                               self.zone)

    def _save_state(self, state: Dict[str, Any]) -> None:
        self.src_gw.ioctx.write_full(
            sync_state_oid(self.bucket, self.zone),
            json.dumps(state).encode())

    def committed_position(self) -> int:
        """Legacy single-shard cursor view (gen-0 shard-0 marker);
        kept for pre-generation callers."""
        st = self._load_state()
        if st is None or int(st.get("gen", 0)) != 0:
            return -1
        return int(st.get("shards", {}).get("0", -1))

    # -------------------------------------------- dst applied markers --
    def _applied_oid(self, gen: int, shard: int) -> str:
        return (f"rgw.sync.applied.{self.bucket}."
                f"{self.src_zone}.g{gen}.{shard}")

    def _load_applied(self, gen: int, shard: int) -> int:
        got = self._applied.get((gen, shard))
        if got is None:
            got = int(_read_json(self.dst_gw.ioctx,
                                 self._applied_oid(gen, shard), -1,
                                 "applied marker"))
            self._applied[(gen, shard)] = got
        return got

    def _advance_applied(self, gen: int, shard: int,
                         seq: int) -> None:
        """Advance the destination-side applied marker — called ONLY
        after the apply's write resolved (CTL605: marker-first is the
        acked-then-lost ordering bug).  A non-monotonic advance means
        an apply ran twice past the dedup guard; it is counted, never
        silently absorbed."""
        cur = self._applied.get((gen, shard), -1)
        if seq <= cur:
            self._bump("double_applies")
            return
        self._applied[(gen, shard)] = seq
        self.dst_gw.ioctx.write_full(self._applied_oid(gen, shard),
                                     json.dumps(seq).encode())

    # ------------------------------------------------------------ stats --
    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + by

    def lag_dump(self) -> Dict[str, Any]:
        """This agent's replication-lag histogram dump (entry mtime ->
        apply time), mergeable via mgr.cluster_stats.merge_histograms."""
        if self._lag is None:
            return {}
        h = self._lag.histogram("lag_s")
        return h.dump() if h is not None else {}

    # ------------------------------------------------------------ replay --
    def sync(self) -> Dict[str, int]:
        """One sync pass; returns {'puts': n, 'deletes': n} (richer
        counters accumulate on ``self.stats``, per-pass failures on
        ``self.last_errors``).  Cursors persist once per generation
        pump, AFTER the shard jobs' completions resolved; consumed
        journal objects trim under the min-commit rule."""
        self.last_errors = []
        dst = self._dst_bucket()
        ent = self.src_gw._read_buckets().get(self.bucket)
        if ent is None:
            raise RGWError(f"NoSuchBucket: {self.bucket}")
        cur_gen = int(ent.get("index_gen", 0))
        cur_shards = int(ent.get("num_shards", 1))
        history = {int(h["gen"]): h for h in ent.get("log_gens", [])}
        state = self._load_state()
        if state is None:
            # never synced: start at the OLDEST generation whose logs
            # still exist — a late-registering zone replays the whole
            # retained history instead of needing a full sync
            state = {"gen": min(list(history) + [cur_gen]),
                     "shards": {}}
        stats = {"puts": 0, "deletes": 0}
        # ---- generation cutover: drain retired gens to their ends --
        while int(state["gen"]) < cur_gen:
            g = int(state["gen"])
            h = history.get(g)
            if h is None:
                # retired before this zone registered: nothing left
                # to drain here (its entries are gone by the drain
                # gate's rules, i.e. no registered zone needed them)
                state = {"gen": self._next_gen(g, history, cur_gen),
                         "shards": {}}
                self._save_state(state)
                continue
            done = self._pump_gen(dst, state, g,
                                  int(h["num_shards"]),
                                  [int(e) for e in h["ends"]], stats)
            if not done:
                # blocked (partition / transient errors): the cursor
                # keeps this generation; the next pass RESUMES here —
                # never a restart
                self._trim(cur_gen, cur_shards)
                return stats
            self._bump("gen_cutovers")
            state = {"gen": self._next_gen(g, history, cur_gen),
                     "shards": {}}
            self._save_state(state)
        # ---- the active generation (no end bound) ------------------
        self._pump_gen(dst, state, cur_gen, cur_shards, None, stats)
        self._trim(cur_gen, cur_shards)
        return stats

    @staticmethod
    def _next_gen(gen: int, history: Dict[int, dict],
                  cur_gen: int) -> int:
        later = [g for g in list(history) + [cur_gen] if g > gen]
        return min(later) if later else cur_gen

    def _pump_gen(self, dst: Bucket, state: Dict[str, Any], gen: int,
                  nshards: int, ends: Optional[List[int]],
                  stats: Dict[str, int]) -> bool:
        """Drain one generation's shards (to ``ends`` when retired,
        to the live tails when active).  Returns True when every
        shard reached its end marker with no errors.  The cursor
        persists ONCE, after every shard job's completion resolved."""
        jobs: List[Tuple[int, Any]] = []
        for s in range(nshards):
            frm = int(state["shards"].get(str(s), -1))
            end = None if ends is None else ends[s]
            if end is not None and frm >= end:
                continue
            fn = (lambda s=s, frm=frm, end=end:
                  self._sync_shard(dst, gen, s, frm, end))
            if self.engine is not None:
                comp = self.engine.submit(
                    fn, key=(self.bucket, self.zone, gen, s))
            else:
                comp = _InlineResult(fn)
            jobs.append((s, comp))
        all_done = True
        for s, comp in jobs:
            try:
                res = comp.result()
            except (IOError, OSError) as e:  # engine-level failure
                res = {"last": int(state["shards"].get(str(s), -1)),
                       "puts": 0, "deletes": 0,
                       "error": f"{type(e).__name__}: {e}"}
            stats["puts"] += res["puts"]
            stats["deletes"] += res["deletes"]
            if res["error"] is not None:
                self._bump("errors")
                self.last_errors.append(
                    f"gen {gen} shard {s}: {res['error']}")
                all_done = False
            end = None if ends is None else ends[s]
            if end is not None and res["last"] < end:
                all_done = False
            if res["last"] > int(state["shards"].get(str(s), -1)):
                state["shards"][str(s)] = res["last"]
        # cursor commit AFTER the gather — every apply above is
        # resolved, so a crash here only costs re-skipped replays
        self._save_state(state)
        return all_done and ends is not None

    def _sync_shard(self, dst: Bucket, gen: int, shard: int,
                    frm: int, end: Optional[int]) -> Dict[str, Any]:
        """Replay one (gen, shard) bilog from ``frm`` (exclusive) to
        ``end`` (inclusive; None = live tail).  Never raises: the
        result carries how far it got plus the first surfaced error —
        partial progress must reach the cursor commit either way."""
        res: Dict[str, Any] = {"last": frm, "puts": 0, "deletes": 0,
                               "error": None}
        try:
            j = self.src.bilog_for_shard(shard, gen=gen)
            j._load_header()
            self._load_applied(gen, shard)
            for seq, payload in j.replay():
                if seq <= frm:
                    continue
                if end is not None and seq > end:
                    break
                if faults.partitioned(self._src_ent, self._dst_ent):
                    raise IOError(
                        f"net.partition: {self._src_ent} -> "
                        f"{self._dst_ent} severed")
                ent = json.loads(payload.decode())
                kind = self._apply_entry(dst, gen, shard, seq, ent)
                if kind is not None:
                    res[kind] += 1
                res["last"] = seq
        except (IOError, OSError) as e:
            res["error"] = f"{type(e).__name__}: {e}"
        return res

    def _apply_entry(self, dst: Bucket, gen: int, shard: int,
                     seq: int, ent: Dict[str, Any]
                     ) -> Optional[str]:
        """Apply one bilog entry with the at-most-once/LWW/origin
        rules; transient IOErrors take ExpBackoff then raise (the
        shard job surfaces them with the marker unmoved)."""
        key = ent["key"]
        if seq <= self._load_applied(gen, shard):
            self._bump("replay_skips")
            return None
        origin = ent.get("origin") or self.src_zone
        if origin == self.zone:
            # our own apply echoing back through the reverse agent:
            # the destination already has this write
            self._bump("origin_skips")
            self._advance_applied(gen, shard, seq)
            return None
        mtime = float(ent.get("mtime", 0.0))
        kind: Optional[str] = None
        backoff = ExpBackoff(base=0.02, cap=0.5,
                             seed=zlib.crc32(key.encode()) & 0xffff)
        last: Optional[Exception] = None
        for attempt in range(5):
            try:
                kind = self._apply_once(dst, ent, key, mtime, origin)
                break
            except RGWError as e:
                if "NoSuchKey" in str(e):
                    # logged-ahead put whose data never landed, or a
                    # version deleted later in the log: nothing to do
                    self._bump("missing_src")
                    kind = None
                    break
                last = e
            except (IOError, OSError) as e:
                last = e
            if attempt == 4:
                raise RGWError(f"apply {key!r} seq {seq} failed "
                               f"after retries: {last}")
            backoff.sleep(attempt)
        if kind is not None and self._lag is not None:
            import time as _time
            self._lag.hinc("lag_s", max(0.0, _time.time() - mtime))
        # marker advance strictly AFTER the apply write resolved
        self._advance_applied(gen, shard, seq)
        if kind is not None:
            self._bump(kind)
        return kind

    def _apply_once(self, dst: Bucket, ent: Dict[str, Any], key: str,
                    mtime: float, origin: str) -> Optional[str]:
        if ent["op"] == "put":
            data, meta = self.src.get_object(key)
            r = dst.apply_put(key, data, meta.get("meta") or None,
                              mtime=mtime, origin=origin)
            if r is None:
                self._bump("conflict_skips")
                return None
            return "puts"
        if dst.apply_delete(key, mtime=mtime, origin=origin):
            return "deletes"
        self._bump("conflict_skips")
        return None

    # -------------------------------------------------------------- trim --
    def _trim(self, cur_gen: int, cur_shards: int) -> None:
        """Min-commit trim of the ACTIVE generation's logs plus the
        drain-gated retirement sweep for old generations.  A zone
        whose cursor is unreadable keeps the logs (the old
        ``except Exception: -1`` swallow here was the CTL603 class —
        _read_json's taxonomy retries/raises instead)."""
        states = [read_sync_state(self.src_gw.ioctx, self.bucket, z)
                  for z in self._zones()]
        for s in range(cur_shards):
            mins = []
            for st in states:
                if st is None or int(st.get("gen", 0)) < cur_gen:
                    mins.append(-1)
                else:
                    mins.append(int(st.get("shards", {})
                                    .get(str(s), -1)))
            if mins and min(mins) >= 0:
                self.src.bilog_for_shard(s, gen=cur_gen).trim_to(
                    min(mins) + 1)
        self.src_gw.retire_drained_bilogs(self.bucket)


class _InlineResult:
    """Serial fallback when no engine is configured: run the job in
    the calling thread, quack like a completion."""

    def __init__(self, fn):
        self._v = fn()

    def result(self):
        return self._v
