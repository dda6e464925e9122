"""S3Serve — the multi-tenant S3 serving subsystem (ROADMAP item 3).

The millions-of-users serving benchmark, scaled to fit any box: many
concurrent S3 clients per tenant drive the RGW gateway over LIVE OSD
daemons through the AsyncObjecter wire core, with seeded zipfian key
popularity and a mixed GET/PUT/DELETE/multipart op profile per
tenant.  Three contracts distinguish this from a load generator:

  * **SLOs are a GATE, not a report**: per-tenant p99/p999 latency is
    read from the mon's cluster-wide bucket-merged histograms (the
    PR-10 ClusterStats merge — the harness ships its per-tenant op
    histograms up the same report_perf path every daemon uses) and
    the run EXITS NONZERO on a breach, with a per-tenant breach
    report.  Falsifiable by construction: a deliberately starved
    config (``--starve``) must fail.
  * **per-tenant QoS, end to end**: each tenant's identity starts as
    an S3 SigV4 verification (auth_s3), binds to the tenant's
    cluster handle (RemoteCluster.set_tenant), rides every wire
    request the async objecter submits, and lands the op in the
    tenant's OWN dmClock class inside each OSD
    (osd_mclock_scheduler_client_* / the spec's qos_tenants table).
    The gate asserts the reserved tenant kept its completed-op share
    — a noisy tenant must not push a reserved tenant below its
    r floor.
  * **chaos composes**: ``--chaos`` runs the SAME workload while a
    seeded scheduler composes all three thrashers' fault shapes —
    OSD kill/revive, ``net.partition`` netsplits armed over the
    daemons' admin sockets, and power-loss browns (device.power_loss
    + WAL tail tear + reboot, the PR-9 pipeline).  The gate relaxes
    the latency SLOs by ``chaos_slo_factor`` but adds a HARD
    invariant: zero acked-write loss (every single-writer key reads
    back with its acked ETag after heal).

Hot buckets don't serialize: the bucket is created with N index
shards (gateway.py), so concurrent writers RMW distinct shard
objects under distinct locks.

``ceph serve`` (tools/ceph_cli.py) builds a self-contained vstart
cluster, runs the harness, prints the per-tenant report, and exits
with the gate's verdict — the operator-facing serving benchmark.

In this package ``python -m ceph_tpu_torch.rgw.serving [--seed N
--starve --chaos --json --device D]`` runs it (``--dr`` the DR drill).
The daemons run on the CPU (vstart asks for it); the tenants'
``RemoteCluster`` handles take ``--device``, by default the package
default device, the card, where every inbound frame is verified by
K3's crc leg.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common.perf_counters import perf as _perf

_PERF_GROUP = "s3.serve"


# --------------------------------------------------------------- zipf --

class ZipfKeys:
    """Seeded zipfian key-popularity sampler.

    Rank r (0-based) is drawn with weight 1/(r+1)**theta — the
    classic zipf law web-object popularity follows (theta ~0.99 in
    the CDN literature; PAPERS 1709.05365 characterizes online-EC
    under exactly this shape).  Deterministic: the same (n, theta,
    seed) produces the identical index sequence, which is what makes
    a serving soak a regression test instead of an anecdote.
    """

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        if n < 1:
            raise ValueError(f"need n >= 1 keys, got {n}")
        self.n = int(n)
        self.theta = float(theta)
        self._rng = random.Random(seed)
        cum: List[float] = []
        total = 0.0
        for r in range(self.n):
            total += 1.0 / ((r + 1) ** self.theta)
            cum.append(total)
        self._cum = cum
        self._total = total

    def next_index(self) -> int:
        """The next key rank: 0 is the hottest key."""
        x = self._rng.random() * self._total
        return bisect.bisect_left(self._cum, x)


# ------------------------------------------------------------- config --

@dataclass
class TenantSpec:
    """One tenant's load + QoS + SLO contract."""
    name: str
    clients: int = 4                  # concurrent closed-loop workers
    ops: int = 120                    # this tenant's op budget
    # op mix (fractions; multipart is initiate+parts+complete)
    get_frac: float = 0.55
    put_frac: float = 0.30
    delete_frac: float = 0.10
    multipart_frac: float = 0.05
    object_kib: int = 4
    n_keys: int = 48                  # tenant keyspace size
    zipf_theta: float = 0.99
    # dmClock class parameters shipped to every OSD (qos_tenants)
    qos_res: float = 0.2
    qos_wgt: float = 1.0
    qos_lim: float = 0.0              # 0 = unlimited
    # ---- the gate ----
    slo_p99_s: float = 5.0
    slo_p999_s: float = 10.0
    min_share: float = 0.0            # completed-op share floor
    max_error_frac: float = 0.0       # failed ops / attempted


@dataclass
class ServeConfig:
    seed: int = 0
    n_osds: int = 4
    osds_per_host: int = 1            # must divide n_osds (the crush
    # map materializes hosts*per_host OSD slots; a slot with no
    # daemon would draw placements)
    pg_num: int = 16
    index_shards: int = 8             # bucket index shards
    bucket: str = "serve"
    tenants: List[TenantSpec] = field(default_factory=list)
    # ---- chaos composition ----
    chaos: bool = False
    chaos_events: int = 3             # >= one of each kind
    chaos_hold_s: float = 1.5         # partition/kill hold per event
    chaos_slo_factor: float = 20.0    # latency SLO relaxation
    # transient op-failure budget under chaos (a GET inside a kill/
    # cut window can exhaust its bounded retries — that is a
    # degraded-window error, not data loss; loss stays a HARD zero)
    chaos_error_budget: float = 0.10
    hb_interval: float = 0.25
    wait_ticks: int = 240             # bounded state polls (0.25 s)


def default_tenants(starve: bool = False) -> List[TenantSpec]:
    """The stock 3-tenant profile: a RESERVED tenant (gold) with an
    r floor and a completed-op share SLO, a plain tenant (silver),
    and a NOISY tenant (bronze) with a big weight, no reservation
    and a larger budget.  ``starve=True`` builds the falsifiability
    config: gold loses its reservation and almost all weight and
    runs one client against a tripled noisy fleet, while its share
    floor stays — the gate MUST fail it."""
    if starve:
        return [
            TenantSpec("gold", clients=1, ops=60,
                       qos_res=0.0, qos_wgt=0.01,
                       min_share=0.25, slo_p99_s=5.0),
            TenantSpec("bronze", clients=12, ops=360,
                       qos_res=0.0, qos_wgt=8.0),
        ]
    return [
        TenantSpec("gold", clients=4, ops=120,
                   qos_res=0.4, qos_wgt=2.0,
                   min_share=0.10, slo_p99_s=5.0),
        TenantSpec("silver", clients=4, ops=120,
                   qos_res=0.2, qos_wgt=1.0),
        TenantSpec("bronze", clients=8, ops=200,
                   qos_res=0.0, qos_wgt=8.0),
    ]


def draw_op(t: TenantSpec, widx: int, rng: random.Random,
            zipf: ZipfKeys) -> Tuple[str, str]:
    """One seeded (op, key) draw — THE schedule the workers run, as
    a pure function so determinism is testable against the exact
    production draw: zipfian rank over the tenant keyspace, then the
    tenant's op mix.  Mutations clamp the rank into worker
    ``widx``'s slice (rank % clients == widx), so every key has ONE
    writer and acked-write oracles are exact under concurrency."""
    rank = zipf.next_index()
    x = rng.random()
    if x < t.get_frac:
        op = "get"
    elif x < t.get_frac + t.put_frac:
        op = "put"
    elif x < t.get_frac + t.put_frac + t.delete_frac:
        op = "delete"
    else:
        op = "multipart"
    if op != "get":
        rank = rank - rank % t.clients + widx
        if rank >= t.n_keys:
            # keyspace edge: wrap to the slice's FIRST member, never
            # modulo (a plain % n_keys would break the rank-mod-
            # clients congruence and hand the key a second writer)
            rank = widx
    if op == "multipart":
        return op, f"{t.name}-mp{rank:05d}"
    return op, f"{t.name}-k{rank:05d}"


def worker_rngs(seed: int, t: TenantSpec, widx: int
                ) -> Tuple[random.Random, ZipfKeys]:
    """The (op rng, zipf sampler) pair worker ``widx`` of tenant
    ``t`` runs under — seeded from (run seed, tenant, worker), so a
    run's whole op schedule is a pure function of the seed."""
    return (random.Random((seed, t.name, widx, "ops").__repr__()),
            ZipfKeys(t.n_keys, t.zipf_theta,
                     seed=f"{seed}/{t.name}/{widx}"))


# ---------------------------------------------------------------- gate --

def evaluate_gate(per_tenant: Dict[str, Dict[str, Any]],
                  tenants: Sequence[TenantSpec],
                  slo_factor: float = 1.0,
                  data_loss: Optional[List[str]] = None,
                  error_budget: Optional[float] = None
                  ) -> List[Dict[str, Any]]:
    """The SLO/QoS gate, pure and unit-testable: per-tenant measured
    {p99_s, p999_s, share, ops, errors, attempted} against each
    tenant's contract (latency bounds scaled by ``slo_factor`` — the
    chaos relaxation; ``error_budget`` likewise floors the per-tenant
    error allowance for degraded windows, while data loss stays a
    hard zero).  Returns the breach list; empty = green."""
    breaches: List[Dict[str, Any]] = []
    for t in tenants:
        m = per_tenant.get(t.name) or {}
        p99 = m.get("p99_s")
        p999 = m.get("p999_s")
        if p99 is not None and p99 > t.slo_p99_s * slo_factor:
            breaches.append({
                "tenant": t.name, "metric": "p99_s",
                "got": p99, "bound": t.slo_p99_s * slo_factor})
        if p999 is not None and p999 > t.slo_p999_s * slo_factor:
            breaches.append({
                "tenant": t.name, "metric": "p999_s",
                "got": p999, "bound": t.slo_p999_s * slo_factor})
        if t.min_share > 0.0:
            share = float(m.get("share") or 0.0)
            if share < t.min_share:
                breaches.append({
                    "tenant": t.name, "metric": "share",
                    "got": round(share, 4), "bound": t.min_share})
        attempted = int(m.get("attempted") or 0)
        if attempted:
            bound = t.max_error_frac
            if error_budget is not None:
                bound = max(bound, error_budget)
            frac = float(m.get("errors") or 0) / attempted
            if frac > bound:
                breaches.append({
                    "tenant": t.name, "metric": "error_frac",
                    "got": round(frac, 4), "bound": bound})
    for loss in (data_loss or []):
        breaches.append({"tenant": "*", "metric": "data_loss",
                         "got": loss, "bound": "zero acked-write "
                                               "loss"})
    return breaches


# -------------------------------------------------------------- harness --

class S3ServeHarness:
    """One serving run over a LIVE vstart cluster directory.

    The cluster must already be running (``serve_main`` builds its
    own; tests may reuse a fixture cluster).  Tenant QoS classes are
    loaded by the daemons from the cluster spec's ``qos_tenants``
    table at boot — ``write_qos_spec`` amends the spec before daemon
    start."""

    def __init__(self, cluster_dir: str, cfg: ServeConfig,
                 vstart=None):
        self.dir = cluster_dir
        self.cfg = cfg
        self.v = vstart                # Vstart handle (chaos needs it)
        self.tenants = cfg.tenants or default_tenants()
        self._stop = threading.Event()
        # chaos runs gate the measurement window on the SCHEDULE
        # completing, not just the op budgets: every composed fault
        # shape must fire under live traffic
        self._chaos_done = threading.Event()
        if not cfg.chaos:
            self._chaos_done.set()
        self._counts_lock = threading.Lock()
        # tenant -> {"ops": completed, "errors": n, "attempted": n}
        self.counts: Dict[str, Dict[str, int]] = {
            t.name: {"ops": 0, "errors": 0, "attempted": 0}
            for t in self.tenants}
        # single-writer oracle: (tenant, key) -> acked etag (puts by
        # worker w touch only key ranks where rank % clients == w, so
        # each key has exactly one writer and the oracle is exact)
        self._oracle_lock = threading.Lock()
        self.oracle: Dict[Tuple[str, str], str] = {}
        self.failures: List[str] = []
        self.chaos_log: List[Tuple] = []
        self._rcs: List[Any] = []

    # ------------------------------------------------------------ setup --
    @staticmethod
    def write_qos_spec(cluster_dir: str,
                       tenants: Sequence[TenantSpec]) -> None:
        """Amend cluster.json with the tenants' dmClock classes —
        run BEFORE daemon start (daemons load the table at boot)."""
        path = os.path.join(cluster_dir, "cluster.json")
        spec = json.load(open(path))
        spec["qos_tenants"] = {
            t.name: {"res": t.qos_res, "wgt": t.qos_wgt,
                     "lim": t.qos_lim} for t in tenants}
        json.dump(spec, open(path, "w"))

    def _make_tenant_client(self, t: TenantSpec, users) -> Any:
        """One authenticated cluster handle per tenant: create the
        S3 user, run a real SigV4 sign/verify round (auth_s3 — the
        identity is what the SIGNATURE proves, not a caller claim),
        and bind the verified uid as the handle's tenant."""
        from ..client.remote import RemoteCluster
        from .auth_s3 import sign_request, verify_request
        from .users import UserError
        try:
            rec = users.create(t.name)
        except UserError as e:
            if not str(e).startswith("UserAlreadyExists"):
                raise
            # back-to-back runs on one cluster (the chaos seeds, a
            # re-entered bench): the tenant keeps its credentials
            rec = users.info(t.name)
        ak = rec["keys"][0]["access_key"]
        sk = rec["keys"][0]["secret_key"]
        headers = {"host": "s3.serve"}
        headers.update(sign_request(
            "GET", "/", "", dict(headers), b"", ak, sk))
        uid = verify_request("GET", "/", "", headers, b"",
                             {ak: {"secret": sk, "user": t.name}})
        rc = RemoteCluster(self.dir)
        rc.set_tenant(uid)
        self._rcs.append(rc)
        return rc

    # ------------------------------------------------------------ worker --
    def _blob(self, rng: random.Random, n: int) -> bytes:
        return random.Random(rng.getrandbits(32)).randbytes(n)

    def _worker(self, t: TenantSpec, widx: int, bucket) -> None:
        """One closed-loop S3 client: seeded op draws over a zipfian
        tenant keyspace until the tenant's op budget (or the run)
        ends.  Mutations stay inside this worker's key slice
        (single-writer oracle); GETs roam the whole tenant keyspace
        and verify payload-vs-ETag integrity."""
        from .gateway import RGWError
        cfg = self.cfg
        rng, zipf = worker_rngs(cfg.seed, t, widx)
        pc = _perf(_PERF_GROUP)
        nbytes = t.object_kib << 10
        while not self._stop.is_set():
            with self._counts_lock:
                c = self.counts[t.name]
                if c["ops"] >= t.ops and \
                        self._chaos_done.is_set():
                    # budget burned: the first tenant to finish ends
                    # the measurement window for everyone (shares
                    # compare the same wall interval).  Under chaos
                    # the budget is a FLOOR — traffic keeps flowing
                    # until the whole fault schedule has run
                    self._stop.set()
                    break
                c["attempted"] += 1
            op, key = draw_op(t, widx, rng, zipf)
            t0 = time.perf_counter()
            ok = True
            try:
                if op == "get":
                    try:
                        data, ent = bucket.get_object(key)
                    except RGWError as e:
                        if not str(e).startswith("NoSuchKey"):
                            raise
                        # a key never written (or deleted): a
                        # legitimate miss, not an error
                    else:
                        if "mp" not in ent and ent["etag"] != \
                                hashlib.md5(data).hexdigest():
                            ok = False
                            self.failures.append(
                                f"{key}: payload/ETag mismatch")
                elif op == "put":
                    data = self._blob(rng, nbytes)
                    etag = bucket.put_object(key, data)
                    with self._oracle_lock:
                        self.oracle[(t.name, key)] = etag
                elif op == "delete":
                    try:
                        bucket.delete_object(key)
                    except RGWError as e:
                        if not str(e).startswith("NoSuchKey"):
                            raise
                    with self._oracle_lock:
                        self.oracle.pop((t.name, key), None)
                else:
                    uid = bucket.initiate_multipart(key)
                    parts = []
                    for n in (1, 2):
                        bucket.upload_part(
                            uid, n, self._blob(rng, nbytes // 2))
                        parts.append(n)
                    bucket.complete_multipart(uid, parts)
            except Exception as e:                 # noqa: CTL603 —
                # the soak's whole point: an op failure is COUNTED
                # and gated (max_error_frac), never silently retried
                # into a green report
                ok = False
                if op in ("put", "delete"):
                    # a mutation that FAILED after possibly
                    # committing its index entry (e.g. put's GC
                    # enqueue raising after the index write) leaves
                    # the key's state AMBIGUOUS — it made no ack, so
                    # it claims nothing: drop it from the oracle
                    # rather than let a stale etag read as loss
                    with self._oracle_lock:
                        self.oracle.pop((t.name, key), None)
                self.failures.append(
                    f"{t.name}/{op} {key}: {type(e).__name__}: {e}")
            dt = time.perf_counter() - t0
            pc.hinc(f"tenant.{t.name}.op_s", dt)
            pc.hinc(f"tenant.{t.name}.{op}_s", dt)
            pc.inc(f"tenant.{t.name}.{op}_ops")
            with self._counts_lock:
                c = self.counts[t.name]
                c["ops"] += 1
                if not ok:
                    c["errors"] += 1

    # ------------------------------------------------------------- chaos --
    def _asok(self, osd: int) -> str:
        return os.path.join(self.dir, f"osd.{osd}.asok")

    def _wait(self, fn, desc: str) -> bool:
        for _ in range(self.cfg.wait_ticks):
            try:
                if fn():
                    return True
            except (OSError, IOError):
                pass
            time.sleep(0.25)
        self.failures.append(f"wait-for-state timed out: {desc}")
        return False

    def _arm_all(self, req: Dict[str, Any]) -> int:
        """fault_injection over every OSD asok; -> how many answered
        (a dead daemon's socket is skipped, exactly like the
        operator's sweep)."""
        from ..common.admin import admin_request
        n = 0
        for o in range(self.cfg.n_osds):
            try:
                admin_request(self._asok(o), req)
                n += 1
            except (OSError, IOError):
                continue
        return n

    def _chaos_driver(self, rc, rng: random.Random) -> None:
        """The composed thrasher: while the serving load runs, one
        seeded schedule interleaves all three fault shapes — the
        first scenario that runs kill + netsplit + powercycle under
        real traffic.  Every event heals before the next starts (the
        workload must survive each shape, not an unbounded pileup)."""
        from ..common.admin import admin_request
        from ..cluster.crashdev import tear_wal_tail
        cfg = self.cfg
        kinds = ["kill", "netsplit", "powercycle"]
        extra = [kinds[rng.randrange(3)]
                 for _ in range(max(0, cfg.chaos_events - 3))]
        schedule = kinds + extra
        rng.shuffle(schedule)
        for i, kind in enumerate(schedule):
            victim = rng.randrange(cfg.n_osds)
            self.chaos_log.append((kind, victim))
            if kind == "kill":
                self.v.kill9(f"osd.{victim}")
                time.sleep(cfg.chaos_hold_s)
                self.v.start_osd(victim,
                                 hb_interval=cfg.hb_interval)
                self._wait(lambda: self.v.alive(f"osd.{victim}"),
                           f"osd.{victim} revived")
            elif kind == "netsplit":
                minority = [f"osd.{victim}"]
                majority = ["mon", "mon.0", "client",
                            "client.admin"] + [
                    f"osd.{o}" for o in range(cfg.n_osds)
                    if o != victim]
                self._arm_all({
                    "prefix": "fault_injection", "action": "arm",
                    "name": "net.partition",
                    "params": {"groups": [minority, majority],
                               "oneway": False}})
                time.sleep(cfg.chaos_hold_s)
                self._arm_all({
                    "prefix": "fault_injection", "action": "disarm",
                    "name": "net.partition"})
            else:                                  # powercycle
                try:
                    admin_request(self._asok(victim), {
                        "prefix": "fault_injection", "action": "arm",
                        "name": "device.power_loss",
                        "mode": "one_in", "n": 2,
                        "seed": cfg.seed * 100 + i,
                        "params": {"exit": True}})
                except (OSError, IOError):
                    pass
                deadline = time.monotonic() + cfg.chaos_hold_s * 4
                while time.monotonic() < deadline and \
                        self.v.alive(f"osd.{victim}"):
                    time.sleep(0.1)
                if self.v.alive(f"osd.{victim}"):
                    # traffic never hit the victim's store barrier:
                    # SIGKILL keeps the soak moving
                    self.v.kill9(f"osd.{victim}")
                tear_wal_tail(
                    os.path.join(self.dir, f"osd.{victim}.store"),
                    rng)
                self.v.start_osd(victim,
                                 hb_interval=cfg.hb_interval)
                self._wait(lambda: self.v.alive(f"osd.{victim}"),
                           f"osd.{victim} rebooted")
            try:
                rc.refresh_map()
            except (OSError, IOError):
                pass
        self._chaos_done.set()

    # --------------------------------------------------------------- run --
    def run(self) -> Dict[str, Any]:
        from ..client.remote import RemoteCluster
        from ..client.remote_ioctx import RemoteIoCtx
        from .gateway import RGWGateway
        from .users import UserStore
        cfg = self.cfg
        if cfg.chaos and self.v is None:
            raise ValueError("chaos runs need the Vstart handle that "
                             "owns the daemons (kill/revive uses its "
                             "process registry)")
        _perf(_PERF_GROUP).reset()
        rc_admin = RemoteCluster(self.dir)
        self._rcs.append(rc_admin)
        io_admin = RemoteIoCtx(rc_admin, "rep")
        users = UserStore(io_admin)
        gw_admin = RGWGateway(io_admin)
        # one BUCKET per tenant (the S3 tenancy shape), each with N
        # index shards, served through the tenant's OWN authenticated
        # cluster handle: every RADOS op a tenant's workers issue
        # carries that tenant's identity.  A tenant's concurrent
        # writers arbitrate through its gateway's per-shard locks;
        # index RMW across gateway PROCESSES is outside the client-
        # side-RMW contract (RemoteIoCtx's documented caveat — the
        # reference serializes shard updates server-side in cls_rgw)
        buckets: Dict[str, Any] = {}
        for t in self.tenants:
            gw_admin.create_bucket(f"{cfg.bucket}-{t.name}",
                                   num_shards=cfg.index_shards)
            rc = self._make_tenant_client(t, users)
            buckets[t.name] = RGWGateway(
                RemoteIoCtx(rc, "rep")).bucket(
                f"{cfg.bucket}-{t.name}")
        t_start = time.perf_counter()
        threads: List[threading.Thread] = []
        for t in self.tenants:
            for w in range(t.clients):
                th = threading.Thread(
                    target=self._worker,
                    args=(t, w, buckets[t.name]),
                    name=f"serve-{t.name}-{w}", daemon=True)
                th.start()
                threads.append(th)
        chaos_th = None
        if cfg.chaos:
            chaos_th = threading.Thread(
                target=self._chaos_driver,
                args=(rc_admin, random.Random(cfg.seed)),
                name="serve-chaos", daemon=True)
            chaos_th.start()
        for th in threads:
            th.join()
        self._stop.set()
        if chaos_th is not None:
            chaos_th.join()
        wall_s = time.perf_counter() - t_start
        data_loss: List[str] = []
        if cfg.chaos:
            data_loss = self._heal_and_verify(rc_admin, buckets)
        report = self._report(rc_admin, wall_s, data_loss)
        for rc in self._rcs:
            try:
                rc.close()
            except Exception:
                pass
        return report

    def _heal_and_verify(self, rc, buckets) -> List[str]:
        """Settle after chaos: disarm everything, everyone up,
        recover, then the zero-acked-write-loss readback — every
        single-writer oracle key must GET with its acked ETag."""
        self._arm_all({"prefix": "fault_injection",
                       "action": "disarm"})
        self._wait(lambda: rc.status()["n_up"] == self.cfg.n_osds,
                   "all OSDs up at settle")
        try:
            rc.refresh_map()
            rc.recover_pool(1)
        except (OSError, IOError) as e:
            self.failures.append(f"settle recovery failed: {e}")
        loss: List[str] = []
        from .gateway import RGWError
        with self._oracle_lock:
            oracle = dict(self.oracle)
        for (tname, key), etag in sorted(oracle.items()):
            try:
                data, ent = buckets[tname].get_object(key)
            except (RGWError, IOError, OSError) as e:
                loss.append(f"{tname}/{key}: unreadable after heal "
                            f"({e})")
                continue
            if ent["etag"] != etag:
                loss.append(f"{tname}/{key}: acked write lost "
                            f"(etag {ent['etag']} != acked {etag})")
        return loss

    def _sched_shares(self, rc) -> Dict[str, Any]:
        """Per-tenant dmClock dequeue counts summed across the live
        OSDs (`status` -> scheduler stats): the daemon-side evidence
        that tenant classes really dispatched — and in what shares."""
        from ..msg.scheduler import TENANT_PREFIX
        per_class: Dict[str, int] = {}
        for o in range(self.cfg.n_osds):
            try:
                st = rc.osd_call(o, {"cmd": "status"})
            except (OSError, IOError):
                continue
            for klass, n in (st.get("scheduler") or {}).get(
                    "dequeued", {}).items():
                per_class[klass] = per_class.get(klass, 0) + int(n)
        tenant_total = sum(n for k, n in per_class.items()
                           if k.startswith(TENANT_PREFIX))
        shares = {}
        for k, n in sorted(per_class.items()):
            if k.startswith(TENANT_PREFIX) and tenant_total:
                shares[k[len(TENANT_PREFIX):]] = round(
                    n / tenant_total, 4)
        return {"dequeued": per_class, "tenant_shares": shares}

    def _report(self, rc, wall_s: float,
                data_loss: List[str]) -> Dict[str, Any]:
        cfg = self.cfg
        # ship this process's per-tenant histograms up the SAME
        # report_perf path every daemon uses, then read the SLO
        # numbers back from the mon's bucket-merged cluster view —
        # the PR-10 histogram merge is the single source of truth
        try:
            rc.mon_call({"cmd": "report_perf", "report": {
                "perf": _perf().dump_typed(), "util": {},
                "ts": time.time()}})
            quant = rc.mon_call({"cmd": "cluster_stats"})["quantiles"]
        except (OSError, IOError) as e:
            self.failures.append(f"cluster_stats unreadable: {e}")
            quant = {}
        total_ops = sum(c["ops"] for c in self.counts.values()) or 1
        per_tenant: Dict[str, Dict[str, Any]] = {}
        for t in self.tenants:
            q = quant.get(f"{_PERF_GROUP}.tenant.{t.name}.op_s") or {}
            c = self.counts[t.name]
            per_tenant[t.name] = {
                "ops": c["ops"],
                "attempted": c["attempted"],
                "errors": c["errors"],
                "ops_s": round(c["ops"] / wall_s, 2) if wall_s
                else 0.0,
                "share": round(c["ops"] / total_ops, 4),
                "p50_s": q.get("p50"), "p99_s": q.get("p99"),
                "p999_s": q.get("p999"),
                "samples": q.get("count", 0),
            }
        slo_factor = cfg.chaos_slo_factor if cfg.chaos else 1.0
        breaches = evaluate_gate(
            per_tenant, self.tenants, slo_factor=slo_factor,
            data_loss=data_loss,
            error_budget=cfg.chaos_error_budget if cfg.chaos
            else None)
        sched = self._sched_shares(rc)
        return {
            "seed": cfg.seed,
            "chaos": cfg.chaos,
            "chaos_log": [list(e) for e in self.chaos_log],
            "index_shards": cfg.index_shards,
            "wall_s": round(wall_s, 3),
            "total_ops": total_ops,
            "ops_s": round(total_ops / wall_s, 2) if wall_s else 0.0,
            "tenants": per_tenant,
            "scheduler": sched,
            "slo_factor": slo_factor,
            "breaches": breaches,
            "data_loss": data_loss,
            "op_failures": self.failures[:20],
            "ok": not breaches,
        }


# ------------------------------------------------------------ ceph serve --

def serve_main(argv: Optional[Sequence[str]] = None,
               out=None) -> int:
    """`ceph serve [--seed N --chaos --starve --json ...]`: build a
    self-contained vstart cluster (like `ceph thrash --powercycle`),
    run the serving workload, print the per-tenant report, exit with
    the SLO/QoS gate's verdict (nonzero on any breach)."""
    import argparse
    import sys
    out = out or sys.stdout
    argv = list(argv or [])
    if "--dr" in argv:
        # `ceph serve --dr`: the two-zone disaster-recovery drill
        # (sever -> failover -> heal -> convergence gate) — same
        # serving-shaped workload, different harness
        from ..cluster.dr_drill import drill_main
        argv.remove("--dr")
        return drill_main(argv, out=out)
    ap = argparse.ArgumentParser(
        prog="ceph serve",
        description="multi-tenant S3 serving workload with an "
                    "enforced SLO/QoS gate (S3Serve)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--shards", type=int, default=8,
                    help="bucket index shards")
    ap.add_argument("--ops-scale", type=float, default=1.0,
                    help="scale every tenant's op budget")
    ap.add_argument("--clients-scale", type=float, default=1.0,
                    help="scale every tenant's worker count (drive "
                         "hundreds of concurrent clients)")
    ap.add_argument("--starve", action="store_true",
                    help="the falsifiability config: the reserved "
                         "tenant loses its reservation and weight — "
                         "the gate MUST exit nonzero with a breach "
                         "report")
    ap.add_argument("--chaos", action="store_true",
                    help="compose kill + netsplit + powercycle under "
                         "the serving load (SLO-relaxed, zero "
                         "acked-write loss enforced)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the tenants' cluster handles "
                         "(default: the package default, cuda)")
    ns = ap.parse_args(argv)
    if ns.device is not None:
        from .. import set_default_device
        set_default_device(ns.device)
    tenants = default_tenants(starve=ns.starve)
    for t in tenants:
        t.ops = max(10, int(t.ops * ns.ops_scale))
        t.clients = max(1, int(t.clients * ns.clients_scale))
    cfg = ServeConfig(seed=ns.seed, n_osds=ns.osds,
                      index_shards=ns.shards, tenants=tenants,
                      chaos=ns.chaos)
    report = run_serve(cfg)
    if ns.json:
        out.write(json.dumps(report, indent=2, sort_keys=True,
                             default=str) + "\n")
    else:
        out.write(
            f"serve seed={report['seed']} shards="
            f"{report['index_shards']} chaos={report['chaos']}: "
            f"{report['total_ops']} ops in {report['wall_s']}s "
            f"({report['ops_s']} op/s)\n")
        for name, m in sorted(report["tenants"].items()):
            out.write(
                f"  {name}: {m['ops']} ops ({m['ops_s']} op/s, "
                f"share {m['share']}), p50={m['p50_s']} "
                f"p99={m['p99_s']} p999={m['p999_s']} "
                f"errors={m['errors']}\n")
        if report["scheduler"]["tenant_shares"]:
            out.write(f"  dmClock tenant dispatch shares: "
                      f"{report['scheduler']['tenant_shares']}\n")
        for b in report["breaches"]:
            out.write(f"BREACH: tenant {b['tenant']} {b['metric']} "
                      f"= {b['got']} (bound {b['bound']})\n")
        out.write("SLO gate: " +
                  ("PASS\n" if report["ok"] else "FAIL\n"))
    return 0 if report["ok"] else 1


def run_serve(cfg: ServeConfig, cluster_dir: Optional[str] = None,
              vstart=None) -> Dict[str, Any]:
    """Build (or reuse) a cluster and run one harness pass.  With
    ``cluster_dir`` the caller owns the daemons, must have written
    the qos spec before starting them, and must pass its own Vstart
    handle for chaos runs (kill/revive needs the process registry)."""
    from ..tools.vstart import Vstart, build_cluster_dir
    tenants = cfg.tenants or default_tenants()
    cfg.tenants = tenants
    if cluster_dir is not None:
        h = S3ServeHarness(cluster_dir, cfg, vstart=vstart)
        return h.run()
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="ceph-serve-")
    d = os.path.join(tmp, "cluster")
    try:
        build_cluster_dir(
            d, n_osds=cfg.n_osds, osds_per_host=cfg.osds_per_host,
            fsync=cfg.chaos,
            pools=[{"id": 1, "name": "rep", "type": 1, "size": 3,
                    "pg_num": cfg.pg_num, "crush_rule": 0}],
            qos_tenants={t.name: {"res": t.qos_res,
                                  "wgt": t.qos_wgt,
                                  "lim": t.qos_lim}
                         for t in tenants})
        v = Vstart(d)
        # the OSDs' interpreters start in parallel: each imports torch
        v.start(cfg.n_osds, hb_interval=cfg.hb_interval, together=True)
        try:
            h = S3ServeHarness(d, cfg, vstart=v)
            return h.run()
        finally:
            v.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":      # pragma: no cover
    import sys
    raise SystemExit(serve_main(sys.argv[1:]))
