"""Typed configuration registry — the L0 config/flag substrate.

Plays the role of the reference's single typed options table
(src/common/options.cc — ~1,704 `Option` rows with type / default /
min / max / enum / description) and its layered `md_config_t`
(src/common/config.{h,cc}): compiled defaults < config file < env
< runtime `set`, with observer callbacks for live reconfig
(src/common/config_obs.h).

Design differences from the reference (deliberate, TPU-native):
  * the table is tiny and grows with the framework — every tunable the
    runtime reads (lookup strategy, lane caps, cache capacities) is
    REQUIRED to come from here, so a `config().dump()` shows the entire
    knob surface the way `ceph daemon ... config show` does;
  * values are plain Python scalars — the accelerator never sees the
    registry, only operands derived from it at dispatch time.

Env layering: option `foo_bar` reads `CEPH_TPU_FOO_BAR` (the round-1
ad-hoc env names are preserved as `env` aliases where they differed).
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

TYPE_INT = "int"
TYPE_FLOAT = "float"
TYPE_BOOL = "bool"
TYPE_STR = "str"

# precedence of value sources, low to high (reference: config layering,
# src/common/config.cc — default < file < env < runtime override)
LEVEL_DEFAULT = 0
LEVEL_FILE = 1
LEVEL_ENV = 2
LEVEL_RUNTIME = 3


class OptionError(ValueError):
    pass


@dataclass(frozen=True)
class Option:
    """One typed knob (reference schema: src/common/options.h)."""
    name: str
    type: str
    default: Any
    desc: str = ""
    min: Optional[float] = None
    max: Optional[float] = None
    enum_values: Optional[Tuple[str, ...]] = None
    env: Optional[str] = None            # env var override (default derived)
    runtime: bool = True                 # changeable after startup

    def env_var(self) -> str:
        return self.env or ("CEPH_TPU_" + self.name.upper())

    def coerce(self, value: Any) -> Any:
        try:
            if self.type == TYPE_INT:
                v = int(value)
            elif self.type == TYPE_FLOAT:
                v = float(value)
            elif self.type == TYPE_BOOL:
                if isinstance(value, str):
                    lv = value.strip().lower()
                    if lv in ("1", "true", "yes", "on"):
                        v = True
                    elif lv in ("0", "false", "no", "off"):
                        v = False
                    else:
                        raise OptionError(
                            f"{self.name}: bad bool {value!r}")
                else:
                    v = bool(value)
            elif self.type == TYPE_STR:
                v = str(value)
            else:
                raise OptionError(f"{self.name}: unknown type {self.type}")
        except (TypeError, ValueError) as e:
            raise OptionError(f"{self.name}: {e}") from e
        if self.min is not None and v < self.min:
            raise OptionError(f"{self.name}: {v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise OptionError(f"{self.name}: {v} > max {self.max}")
        if self.enum_values is not None and v not in self.enum_values:
            raise OptionError(
                f"{self.name}: {v!r} not in {self.enum_values}")
        return v


class Options:
    """The registry + layered value store."""

    def __init__(self, table: Sequence[Option] = ()):
        self._lock = threading.RLock()
        self._schema: Dict[str, Option] = {}
        # name -> {level: value}
        self._values: Dict[str, Dict[int, Any]] = {}
        self._observers: Dict[str, List[Callable[[str, Any], None]]] = {}
        for opt in table:
            self.register(opt)

    # ------------------------------------------------------------ schema --
    def register(self, opt: Option) -> None:
        with self._lock:
            if opt.name in self._schema:
                raise OptionError(f"duplicate option {opt.name}")
            self._schema[opt.name] = opt

    def schema(self, name: str) -> Option:
        try:
            return self._schema[name]
        except KeyError:
            raise OptionError(f"unknown option {name}") from None

    def names(self) -> List[str]:
        return sorted(self._schema)

    # ------------------------------------------------------------ values --
    def get(self, name: str) -> Any:
        opt = self.schema(name)
        with self._lock:
            levels = self._values.get(name, {})
            if LEVEL_RUNTIME in levels:
                return levels[LEVEL_RUNTIME]
            if LEVEL_ENV in levels:
                return levels[LEVEL_ENV]
            ev = os.environ.get(opt.env_var())
            if ev is not None:
                # malformed env fails LOUDLY: silently regressing an
                # operator's setting to the default is worse than a crash
                return opt.coerce(ev)
            if LEVEL_FILE in levels:
                return levels[LEVEL_FILE]
            return opt.default

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any, level: int = LEVEL_RUNTIME) -> Any:
        opt = self.schema(name)
        if level == LEVEL_RUNTIME and not opt.runtime:
            raise OptionError(f"{name} is not runtime-changeable")
        v = opt.coerce(value)
        with self._lock:
            self._values.setdefault(name, {})[level] = v
            obs = list(self._observers.get(name, ()))
        # observers see the EFFECTIVE value: a set at a masked level
        # (e.g. file under an env override) must not poison caches
        try:
            eff = self.get(name)
        except OptionError:
            eff = None
        if eff is not None:
            for cb in obs:
                cb(name, eff)
        return v

    def clear(self, name: str, level: int = LEVEL_RUNTIME) -> None:
        self.schema(name)
        with self._lock:
            removed = self._values.get(name, {}).pop(level, None)
            obs = list(self._observers.get(name, ()))
        if removed is None:
            return
        # observers track the EFFECTIVE value: clearing an override
        # changes it just like set() does, and a cached-flag observer
        # (perf enablement, the data plane's enabled()) left unnotified
        # would keep honoring the removed override forever
        try:
            eff = self.get(name)
        except OptionError:
            eff = None
        if eff is not None:
            for cb in obs:
                cb(name, eff)

    def load_file(self, path: str) -> None:
        """JSON config file: {"option": value, ...} at LEVEL_FILE."""
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise OptionError(f"{path}: expected a JSON object")
        for k, v in data.items():
            self.set(k, v, level=LEVEL_FILE)

    # --------------------------------------------------------- observers --
    def observe(self, name: str, cb: Callable[[str, Any], None]) -> None:
        """Live-reconfig callback (reference: config_obs.h)."""
        self.schema(name)
        with self._lock:
            self._observers.setdefault(name, []).append(cb)

    # -------------------------------------------------------------- dump --
    def dump(self) -> Dict[str, Dict[str, Any]]:
        """`config show`-style dump: value + provenance per option."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, opt in sorted(self._schema.items()):
                levels = self._values.get(name, {})
                if LEVEL_RUNTIME in levels:
                    src = "runtime"
                elif LEVEL_ENV in levels or \
                        os.environ.get(opt.env_var()) is not None:
                    src = "env"
                elif LEVEL_FILE in levels:
                    src = "file"
                else:
                    src = "default"
                try:
                    value = self.get(name)
                except OptionError as e:
                    value, src = f"<invalid: {e}>", "env"
                out[name] = {"value": value, "source": src,
                             "type": opt.type, "desc": opt.desc}
        return out


# ---------------------------------------------------------------- table ----
# The framework-wide knob table.  Round-1 env names are kept as aliases
# so existing workflows keep working (CEPH_TPU_LOOKUP etc.).
_TABLE: Tuple[Option, ...] = (
    Option("lookup_strategy", TYPE_STR, "auto",
           "device table lookup lowering: auto picks gather on CPU, "
           "onehot (MXU matmul) on accelerators",
           enum_values=("auto", "gather", "onehot"), env="CEPH_TPU_LOOKUP"),
    Option("fastmap_enabled", TYPE_BOOL, True,
           "use the level-synchronous candidate-grid CRUSH mapper for "
           "supported rules", env="CEPH_TPU_FASTMAP"),
    Option("fastmap_extra_tries", TYPE_INT, 4,
           "extra retry candidates per replica slot in the fast mapper "
           "grid (lanes exceeding it fall back to the exact path); 4 "
           "measured fastest on v5e-1 at <1e-4 fallback for 3-replica "
           "sweeps — grid work scales with numrep+extra",
           min=2, max=64, env="CEPH_TPU_FASTMAP_EXTRA"),
    Option("straw2_select", TYPE_STR, "approx",
           "straw2 argmin mode: approx = f32 polynomial prefilter + "
           "exact top-2 re-check; exact = full-width fixed-point LUT",
           enum_values=("approx", "exact"), env="CEPH_TPU_SELECT"),
    Option("mapper_max_lanes_per_call", TYPE_INT, 1 << 17,
           "general mapper: max x lanes per device dispatch (one-hot "
           "intermediates are ~S*385 bytes per lane-level; keep the "
           "working set inside HBM)", min=1 << 10),
    Option("fastmap_max_grid_lanes", TYPE_INT, 1 << 23,
           "fast mapper: max (lane x candidate) product per dispatch",
           min=1 << 12),
    Option("fastmap_max_grid_mib", TYPE_INT, 12288,
           "fast mapper: HBM budget (MiB) per [rows, level-width] "
           "working buffer; lanes per dispatch scale down to fit "
           "(swept 8/12/14 GiB on v5e-1: larger chunks cut the 1M-PG "
           "sweep 2.7s -> 2.0s; 12 GiB leaves room for device-resident "
           "EC shards during recovery)",
           min=64),
    Option("ec_table_cache_size", TYPE_INT, 2516,
           "decode-matrix LRU entries per codec (reference: "
           "ErasureCodeIsaTableCache.h:35)", min=1),
    Option("ec_kernel", TYPE_STR, "auto",
           "GF(2^8) matmul lowering: auto = pallas VMEM-unpack kernel "
           "on TPU, xla elsewhere; both bit-identical",
           enum_values=("auto", "xla", "pallas")),
    Option("erasure_code_default_plugin", TYPE_STR, "jax",
           "plugin used when a profile names none (reference: "
           "osd_pool_default_erasure_code_profile, options.cc:2748)"),
    Option("erasure_code_default_layout", TYPE_STR, "bitsliced",
           "chunk layout injected into jax-plugin EC profiles that name "
           "none: bitsliced = jerasure-packet plane layout consumed "
           "directly by the masked-XOR region kernel (the at-rest "
           "format, like jerasure_schedule_encode packets, "
           "ErasureCodeJerasure.cc:162); bytes = byte-symbol compat "
           "layout (bit-plane MXU matmul path)",
           enum_values=("bytes", "bitsliced")),
    Option("osd_device_staging", TYPE_BOOL, True,
           "stage EC shard payloads in device HBM as int32 plane words "
           "(the ECBackend shard store role, ECBackend.cc:934,1015): "
           "encode/decode/recovery consume the staged planes without "
           "host round-trips; the objectstore keeps the same bytes as "
           "the durable tier"),
    Option("osd_objectstore", TYPE_STR, "bluestore",
           "ObjectStore backend for OSD daemons (reference: "
           "osd_objectstore, src/common/options.cc): bluestore = "
           "block-device extent store with allocator/csum/compression/"
           "deferred writes (cluster/bluestore.py); filestore = "
           "log-structured store; memstore = RAM (tests)",
           enum_values=("bluestore", "filestore", "memstore")),
    Option("bluestore_min_alloc_size", TYPE_INT, 4096,
           "block granularity of the BlueStore allocator and csum "
           "unit (reference: bluestore_min_alloc_size)", min=64),
    Option("bluestore_compression_algorithm", TYPE_STR, "",
           "compressor plugin for BlueStore blobs ('' = off; "
           "reference: bluestore_compression_algorithm)"),
    Option("parallel_data_plane", TYPE_BOOL, False,
           "execute the cluster hot loops (batched put encode, "
           "degraded-get/recovery decode, map_pgs_batch sweeps) "
           "sharded across the device mesh (parallel/data_plane.py — "
           "the multi-chip ParallelPGMapper + messenger fan-out role, "
           "src/osd/OSDMapMapping.h:18); off = single-device paths "
           "unchanged; ignored on hosts with fewer than 2 devices"),
    Option("parallel_data_plane_devices", TYPE_INT, 0,
           "mesh size for the sharded data plane (0 = every visible "
           "device); values above the visible device count disable "
           "the plane rather than fail mid-dispatch", min=0),
    Option("parallel_data_plane_stripes", TYPE_INT, 0,
           "stripe-row count of the MeshPlane2D (stripe, shard) 2-D "
           "mesh (parallel/mesh.py make_mesh_2d): 0/1 = the legacy "
           "1-D stripe-batch mesh; >= 2 reshapes the device list "
           "row-major into (stripes, devices/stripes) so the k+m "
           "shard dimension shards over the columns too; a count "
           "that does not divide the device count disables the "
           "plane rather than fail mid-dispatch", min=0),
    Option("multihost_coordinator", TYPE_STR, "",
           "jax.distributed coordinator address (host:port) for the "
           "multi-process MeshPlane2D ('' = single-process fallback, "
           "every data-plane path byte-identical to today's; env "
           "CEPH_TPU_COORDINATOR overrides)"),
    Option("multihost_processes", TYPE_INT, 0,
           "process count of the multi-process plane (0/1 = single-"
           "process fallback; env CEPH_TPU_NUM_PROCESSES overrides)",
           min=0),
    Option("multihost_process_id", TYPE_INT, -1,
           "this process's id in the multi-process plane (-1 = "
           "unset/fallback; env CEPH_TPU_PROCESS_ID overrides)",
           min=-1),
    Option("osd_max_backfills", TYPE_INT, 1,
           "recovery/backfill reservations an OSD grants concurrently "
           "per role (local primary-side + remote replica-side, the "
           "reference's AsyncReserver pair, src/common/AsyncReserver.h "
           "/ osd_max_backfills): concurrent PG recoveries above the "
           "cap are deferred and requeued, so recovery saturates spare "
           "bandwidth without unbounded fan-in on one OSD", min=1),
    Option("perf_counters_enabled", TYPE_BOOL, True,
           "collect dispatch/cache/bytes counters"),
    Option("op_tracker_enabled", TYPE_BOOL, True,
           "track per-op lifecycle events (objecter -> OSD queue -> "
           "device dispatch; reference: osd_enable_op_tracker)"),
    Option("op_tracker_complaint_time", TYPE_FLOAT, 30.0,
           "seconds before an op counts as slow (reference: "
           "osd_op_complaint_time)", min=0.0),
    Option("op_tracker_history_size", TYPE_INT, 100,
           "completed ops kept for dump_historic_ops (reference: "
           "osd_op_history_size)", min=1),
    Option("op_tracker_history_slow_size", TYPE_INT, 20,
           "slow ops kept for dump_historic_slow_ops (reference: "
           "osd_op_history_slow_op_size)", min=1),
    Option("op_tracker_max_inflight", TYPE_INT, 1024,
           "bound on the in-flight tracking table; ops past it run "
           "untracked (counted as op_tracker.ops_untracked)", min=1),
    Option("trace_enabled", TYPE_BOOL, True,
           "distributed tracing master switch (reference: "
           "jaeger_tracing_enable): armed, every submitted op carries "
           "a (trace_id, span_id) context across wire frames and "
           "in-process dispatch and daemons open linked child spans; "
           "disarmed, trace sites cost one dict-miss check"),
    Option("trace_max_spans", TYPE_INT, 10000,
           "bounded finished-span buffer per process; trims drop the "
           "oldest half (counted as tracer.spans_dropped) except "
           "spans of pinned (auto-sampled slow) traces", min=100),
    Option("objecter_wire_streams", TYPE_INT, 4,
           "parallel pipelined connections per OSD daemon in the "
           "async objecter's stream pool (the ms_async_op_threads / "
           "multi-connection fan-out role): one logical op's k+m "
           "shard fan-out stripes across them", min=1),
    Option("objecter_wire_window", TYPE_INT, 16,
           "per-stream send window (frames in flight before submit "
           "blocks) — the Throttle role on the async wire path",
           min=1),
    Option("objecter_wire_mode", TYPE_STR, "crc",
           "data mode of async objecter streams after the cephx "
           "handshake (reference ms_client_mode): 'crc' = "
           "plaintext payload, crc32 bound into the HMAC'd header "
           "(integrity only, the reference's intra-cluster default), "
           "'secure' = sealed payloads",
           enum_values=("crc", "secure")),
    Option("osd_cluster_wire_mode", TYPE_STR, "crc",
           "data mode of intra-cluster daemon->daemon links "
           "(replica sub-writes, recovery pushes — the reference's "
           "ms_cluster_mode, independent of the client-facing "
           "objecter_wire_mode): 'crc' keeps the one-pass "
           "trusted-csum handoff at zlib speed, 'secure' seals peer "
           "payloads",
           enum_values=("crc", "secure")),
    Option("wire_one_pass", TYPE_BOOL, True,
           "ZeroWire one-pass integrity: scatter-gather frame crcs "
           "are computed/verified as per-4KiB sub-crcs folded by "
           "crc32_combine (wire values bit-identical to a whole-"
           "payload crc32), and the receive-side verify scan's "
           "sub-crcs flow to BlueStore as trusted blob csums — one "
           "crc pass per byte per process instead of three on the "
           "put path; off = the legacy whole-buffer scans (the "
           "bench's 'before' lane)"),
    Option("wire_zero_copy", TYPE_BOOL, True,
           "ZeroWire buffer spine: bulk payloads move as memoryviews "
           "end to end (SockReader hands out views, split_sg does "
           "not materialize, _make_blob pwrites views) — off = the "
           "legacy bytes() materializations, each COUNTED on "
           "perf('wire.zero') so the bench can price copies/MiB"),
    Option("wire_shm_ring_kib", TYPE_INT, 4096,
           "shared-memory ring bytes (KiB) per client<->OSD stream "
           "pool for the same-host lane (msg/shm_ring.py): bulk "
           "payloads cross via mmap with only a doorbell on the "
           "socket; 0 disables the lane (pure socket fallback, same "
           "bytes on the wire)", min=0),
    Option("wire_device_crc", TYPE_STR, "auto",
           "batched crc32 as a GF(2) matmul next to the EC kernels "
           "(ops/crc32_gf2.py) for shards already staged in HBM: "
           "'auto' engages on accelerator backends only (a CPU "
           "matmul loses to a zlib scan), 'on' forces it (bench/"
           "test), 'off' always scans on host",
           enum_values=("auto", "on", "off")),
    Option("wire_reply_ring", TYPE_BOOL, True,
           "RingReply same-host reply lane: the daemon answers bulk "
           "reads (get/recovery pulls) through a daemon-created shm "
           "reply ring (msg/shm_ring.py, 'zwreply') with only a "
           "doorbell on the socket — zero-copy in BOTH directions, "
           "and the store-trusted blob csums ride the doorbell so "
           "the daemon sends with zero scans; requires the request "
           "ring (wire_shm_ring_kib > 0), disabled under secure "
           "mode with it; off = bulk replies ride MSG_REPLY_SG on "
           "the socket (csums still folded, zero send scans)"),
    Option("osd_mclock_scheduler_client_res", TYPE_FLOAT, 0.2,
           "default dmClock RESERVATION for a per-tenant client "
           "class (reference osd_mclock_scheduler_client_res): the "
           "fraction of dispatch slots a tenant is guaranteed under "
           "backlog before weights share the leftovers; per-tenant "
           "overrides ride the cluster spec's qos_tenants table",
           min=0.0),
    Option("osd_mclock_scheduler_client_wgt", TYPE_FLOAT, 1.0,
           "default dmClock WEIGHT for a per-tenant client class "
           "(reference osd_mclock_scheduler_client_wgt): the "
           "tenant's share of capacity left over after every "
           "reservation is met", min=0.0),
    Option("osd_mclock_scheduler_client_lim", TYPE_FLOAT, 0.0,
           "default dmClock LIMIT for a per-tenant client class "
           "(reference osd_mclock_scheduler_client_lim); 0 = "
           "unlimited", min=0.0),
    Option("metrics_history_samples", TYPE_INT, 64,
           "per-level ring bound of the leader mon's metrics history "
           "(mgr/metrics_history.py, the mgr MetricCollector / PGMap "
           "delta-history role): level 0 keeps this many raw "
           "report_perf deliveries per reporter before log2 "
           "downsampling folds the oldest pairs upward", min=2),
    Option("metrics_history_levels", TYPE_INT, 6,
           "log2 downsampling levels of the metrics history: level i "
           "holds samples whose window fuses 2^i raw deliveries, so "
           "retained wall coverage grows ~2^levels x samples while "
           "memory stays levels x samples entries per reporter",
           min=1),
    Option("pg_heat_half_life", TYPE_FLOAT, 60.0,
           "exponential-decay half life of the per-PG client-io heat "
           "ledgers (cluster/pg_heat.py, the pool HitSet role): "
           "seconds on the daemon tier, heartbeat TICKS on the sim "
           "tier's deterministic clock", min=0.001),
)

_config: Optional[Options] = None
_config_lock = threading.Lock()


def config() -> Options:
    """The process-wide registry (CephContext._conf analog)."""
    global _config
    with _config_lock:
        if _config is None:
            _config = Options(_TABLE)
        return _config
