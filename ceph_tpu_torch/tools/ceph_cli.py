"""`ceph` — the cluster admin CLI against a live process cluster.

Port of ``ceph_tpu/tools/ceph_cli.py``, every verb wired to the port's
modules.  The verbs that build a cluster client (the cluster commands,
``rgw``, ``telemetry``/``balancer``/``pg heat``, ``thrash``, ``serve``)
run it on ``--device`` (``cuda`` by default: the client's codec and
checksums run on the card; without one it raises unless ``--device
cpu`` asks for the CPU).  ``lint``, ``daemon`` and ``trace`` build no
client and do no device work.

The reference's main operator surface (src/ceph.in dispatching mon
commands; outputs modeled on `ceph -s`, `ceph health`, `ceph osd
tree`, `ceph mon stat`, `ceph pg dump`, `ceph df`).  Talks to the
daemons of a vstart cluster dir through the authenticated wire client
(client/remote.py) — the same path any admin tool takes, no in-process
shortcuts.

    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 status
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 health
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 mon stat
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 osd tree
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 osd out 3
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 osd pool ls --detail
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 pg dump 1
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 df
    python -m ceph_tpu_torch.tools.ceph_cli --dir /tmp/c1 scrub 1
    python -m ceph_tpu_torch.tools.ceph_cli --device cpu --dir /tmp/c1 df
    python -m ceph_tpu_torch.tools.ceph_cli lint --check

`daemon` subcommands talk to a single daemon's admin socket
(`<dir>/<name>.asok`, the `ceph daemon <name> ...` workflow —
src/ceph.in admin_socket path), not the mon.  mon/OSD daemons serve
theirs at startup; a long-running client process opts in with
`RemoteCluster.serve_admin()` (-> `<dir>/objecter.asok`):

    ... daemon osd.0 dump_ops_in_flight
    ... daemon osd.0 dump_historic_ops
    ... daemon osd.0 dump_historic_slow_ops
    ... daemon objecter perf dump
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List, Optional

from .. import using_device


def _client(cluster_dir: str):
    from ..client.remote import RemoteCluster
    return RemoteCluster(cluster_dir)


def _pool_types():
    from ..cluster.osdmap import POOL_ERASURE, POOL_REPLICATED
    return {POOL_REPLICATED: "replicated", POOL_ERASURE: "erasure"}


def cmd_status(rc, out) -> int:
    st = rc.status()
    m = rc.osdmap
    names = _pool_types()
    q = {}
    try:
        q = rc.mon_call({"cmd": "mon_status"})
    except Exception:
        pass
    out.write("  cluster:\n")
    health = "HEALTH_OK" if st["n_up"] == st["n_osds"] else "HEALTH_WARN"
    out.write(f"    health: {health}\n")
    if q:
        out.write(f"  mon: rank {q.get('rank')} of "
                  f"{q.get('n_mons')}, leader {q.get('leader')}, "
                  f"election epoch {q.get('election_epoch')}\n")
    out.write(f"  osd: {st['n_osds']} osds: {st['n_up']} up\n")
    out.write(f"  map: e{st['epoch']}\n")
    out.write("  pools:\n")
    for pid, pool in sorted(m.pools.items()):
        out.write(f"    pool {pid} '{pool.name}' "
                  f"{names.get(pool.type, pool.type)} "
                  f"size {pool.size} pg_num {pool.pg_num}\n")
    # the PGMap io line, from the mon's ClusterStats aggregator
    # (counter deltas across the daemons' heartbeat perf reports)
    try:
        cs = rc.mon_call({"cmd": "cluster_stats"})
        io = cs["io"]["cluster"]
        out.write("  io:\n")
        out.write(f"    client: {io.get('rd_bytes', 0.0) / 2**20:.1f}"
                  f" MiB/s rd, {io.get('wr_bytes', 0.0) / 2**20:.1f}"
                  f" MiB/s wr, {io.get('rd_ops', 0.0):.0f} op/s rd, "
                  f"{io.get('wr_ops', 0.0):.0f} op/s wr\n")
        # the MeshPlane2D line: the mgr rollup's (host, chip) view —
        # a two-host plane reads as ONE cluster here
        mesh = cs.get("mesh") or {}
        if mesh.get("n_chips"):
            shape = mesh.get("shape")
            grid = f", ({shape[0]}, {shape[1]}) mesh" if shape else ""
            stripes = int(mesh.get("totals", {}).get("put_stripes",
                                                     0))
            out.write(f"  plane: {mesh['n_hosts']} host(s), "
                      f"{mesh['n_chips']} chip(s){grid}, "
                      f"{stripes} put stripes\n")
    except Exception:
        pass
    return 0


def cmd_health(rc, out) -> int:
    st = rc.status()
    if st["n_up"] == st["n_osds"]:
        out.write("HEALTH_OK\n")
        return 0
    down = st["n_osds"] - st["n_up"]
    out.write(f"HEALTH_WARN {down} osds down\n")
    return 1


def cmd_mon_stat(rc, out) -> int:
    q = rc.mon_call({"cmd": "mon_status"})
    out.write(f"e{q.get('election_epoch', 0)}: {q.get('n_mons')} mons, "
              f"leader {q.get('leader')}, committed "
              f"{q.get('committed')}\n")
    return 0


def cmd_osd_tree(rc, cluster_dir: str, out) -> int:
    import os

    from ..placement.compiler import compile_crushmap
    from ..placement.treedump import tree_dump
    text = open(os.path.join(cluster_dir, "crushmap.txt")).read()
    cmap = compile_crushmap(text)
    st = rc.status()
    up = {i for i in range(st["n_osds"]) if bool(rc.osdmap.osd_up[i])}
    # tree_dump renders the id/class/weight/name table; append the
    # up/down STATUS column from the live map (`ceph osd tree` shape)
    for line in tree_dump(cmap).splitlines():
        mark = ""
        token = line.split()
        for t in token:
            if t.startswith("osd."):
                osd = int(t[4:])
                mark = "  up" if osd in up else "  down"
                break
        out.write(line + mark + "\n")
    return 0


def cmd_osd_out(rc, osd: int, out) -> int:
    r = rc.mon_call({"cmd": "mark_out", "osd": osd})
    out.write(f"marked out osd.{osd} ({json.dumps(r)})\n")
    return 0


def cmd_osd_in(rc, osd: int, out) -> int:
    r = rc.mon_call({"cmd": "mark_in", "osd": osd})
    out.write(f"marked in osd.{osd} ({json.dumps(r)})\n")
    return 0


def _pool_id(rc, name_or_id: str) -> int:
    # name match FIRST across every pool, numeric id only as a
    # fallback — a pool literally named "2" must win over pool id 2
    for pid, p in rc.osdmap.pools.items():
        if p.name == name_or_id:
            return pid
    for pid in rc.osdmap.pools:
        if str(pid) == name_or_id:
            return pid
    raise ValueError(f"no pool {name_or_id!r}")


def cmd_tier_add(rc, base: str, cache: str, out) -> int:
    rc.tier_add(_pool_id(rc, base), _pool_id(rc, cache))
    out.write(f"pool '{cache}' is now (and will remain) a tier of "
              f"'{base}'\n")
    return 0


def cmd_tier_remove(rc, base: str, cache: str, out) -> int:
    try:
        rc.tier_remove(_pool_id(rc, base), _pool_id(rc, cache))
    except IOError as e:
        out.write(f"Error: {e} (run `osd tier agent {base} 0` to "
                  f"flush+evict everything)\n")
        return 1
    out.write(f"pool '{cache}' is no longer a tier of '{base}'\n")
    return 0


def cmd_tier_agent(rc, base: str, target: Optional[str],
                   out) -> int:
    """One agent pass: flush dirty; with TARGET, also evict clean
    objects down to that count (0 = drain the cache completely)."""
    b = _pool_id(rc, base)
    if target is None:
        st = rc.tier_agent_work(b)
    else:
        st = rc.tier_agent_work(b, target_objects=int(target))
        if int(target) == 0:
            # target 0 means DRAIN: tier_agent_work's evictor keeps
            # `target` objects, so finish by evicting the remainder
            cache_id = rc.osdmap.pools[b].read_tier
            for nm in rc.list_objects(cache_id):
                rc.tier_evict(b, nm)
                st["evicted"] += 1
    out.write(f"tier agent on '{base}': flushed {st['flushed']}, "
              f"evicted {st['evicted']}\n")
    return 0


def cmd_pool_create(rc, name: str, pg_num: int, ptype: str,
                    size: int, out) -> int:
    from ..cluster.osdmap import POOL_ERASURE, POOL_REPLICATED
    r = rc.mon_call({
        "cmd": "pool_create", "name": name, "pg_num": pg_num,
        "type": POOL_ERASURE if ptype == "erasure"
        else POOL_REPLICATED,
        "size": size,
        "crush_rule": 1 if ptype == "erasure" else 0,
        "erasure_code_profile":
            "default" if ptype == "erasure" else ""})
    if r.get("existed"):
        out.write(f"pool '{name}' already exists (id "
                  f"{r['pool_id']})\n")
    else:
        out.write(f"pool '{name}' created (id {r['pool_id']}, "
                  f"epoch {r['epoch']})\n")
    return 0


def cmd_pool_rm(rc, name: str, out) -> int:
    r = rc.mon_call({"cmd": "pool_rm", "name": name})
    if r.get("existed"):
        out.write(f"pool '{name}' removed (epoch {r['epoch']})\n")
    else:
        out.write(f"pool '{name}' did not exist\n")
    return 0


def cmd_pool_ls(rc, detail: bool, out) -> int:
    names = _pool_types()
    for pid, pool in sorted(rc.osdmap.pools.items()):
        if detail:
            out.write(f"pool {pid} '{pool.name}' "
                      f"{names.get(pool.type, pool.type)} size "
                      f"{pool.size} pg_num {pool.pg_num} crush_rule "
                      f"{pool.crush_rule}\n")
        else:
            out.write(f"{pool.name}\n")
    return 0


def cmd_pg_dump(rc, pool_id: int, out) -> int:
    pool = rc.osdmap.pools[pool_id]
    out.write("PG  UP  PRIMARY\n")
    for pg in range(pool.pg_num):
        ups = rc._up(pool, pg)
        prim = next((o for o in ups if o >= 0), -1)
        out.write(f"{pool_id}.{pg}  {ups}  {prim}\n")
    return 0


def cmd_df(rc, out) -> int:
    stats = {}
    try:
        cs = rc.mon_call({"cmd": "cluster_stats"})
        df = cs.get("df") or {}
        stats = {int(k): v for k, v in (df.get("pools") or {}).items()}
        if df.get("total_bytes"):
            out.write(f"RAW USED: {df['total_used_bytes']} / "
                      f"{df['total_bytes']} bytes\n")
    except Exception:
        pass
    out.write("POOL  OBJECTS  RAW_SHARDS  RAW_BYTES\n")
    for pid, pool in sorted(rc.osdmap.pools.items()):
        row = stats.get(pid) or {}
        # daemons report per-pool shard COUNTS; byte attribution is
        # allocator-level (whole-store), so a zero here means "not
        # reported per pool", never "empty"
        nbytes = row.get("bytes", 0) or "-"
        out.write(f"{pool.name}  {len(rc.list_objects(pid))}  "
                  f"{row.get('objects', 0)}  {nbytes}\n")
    return 0


def cmd_osd_df(rc, out) -> int:
    """`ceph osd df` — per-OSD utilization from the ClusterStats
    aggregator (allocator-backed used/total bytes each daemon ships
    on its heartbeat), with recent write/read rate sparklines off
    the mon's metrics-history rings."""
    rows = rc.mon_call({"cmd": "cluster_stats"}).get("osd_df") or []
    out.write("NAME  OBJECTS  USED  TOTAL  %USE  WR  RD\n")
    for r in rows:
        out.write(f"{r['daemon']}  {r['objects']}  "
                  f"{r['bytes_used']}  {r['bytes_total']}  "
                  f"{100.0 * r['utilization']:.2f}  "
                  f"{r.get('wr_trend', '-')}  "
                  f"{r.get('rd_trend', '-')}\n")
    if not rows:
        out.write("(no daemon reports yet)\n")
    return 0


def cmd_telemetry_history(rc, counter: str, daemon: Optional[str],
                          out, as_json: bool = False) -> int:
    """`ceph telemetry history <counter> [--daemon osd.N]` — range-
    query the leader mon's metrics-history rings: retained samples +
    reset-clamped rates per reporter."""
    r = rc.mon_call({"cmd": "cluster_stats",
                     "history": {"counter": counter,
                                 "daemon": daemon}})
    if as_json:
        out.write(json.dumps(r, indent=2, sort_keys=True) + "\n")
        return 0
    series = r.get("series") or {}
    if not series:
        out.write(f"(no history for counter {counter!r})\n")
        return 1
    out.write(f"counter {counter} (cluster resets: "
              f"{r.get('counter_resets', 0)})\n")
    for name, s in sorted(series.items()):
        out.write(f"  {name}: {len(s['samples'])} samples, "
                  f"{s['resets']} resets\n")
        for (ts, v), (_rts, rate) in zip(s["samples"][1:],
                                         s["rates"]):
            out.write(f"    {ts:.3f}  {v:.0f}  ({rate:.3f}/s)\n")
    return 0


def cmd_pg_heat(rc, pool: Optional[int], top: Optional[int],
                out, as_json: bool = False) -> int:
    """`ceph pg heat [--pool P] [--top N]` — decayed per-PG client-io
    heat merged across the reporting OSDs, hottest first, plus the
    per-OSD rollup (asserted consistent with the osd.io counters)."""
    r = rc.mon_call({"cmd": "cluster_stats",
                     "heat": {"pool": pool, "top": top}})
    if as_json:
        out.write(json.dumps(r, indent=2, sort_keys=True) + "\n")
        return 0
    pgs = r.get("pgs") or []
    if not pgs:
        out.write("(no heat reported yet)\n")
        return 1
    out.write("PGID  HEAT  RD_OPS  WR_OPS  RD_B  WR_B  OSDS\n")
    for row in pgs:
        out.write(f"{row['pgid']}  {row['heat']:.3f}  "
                  f"{row['rd_ops']:.1f}  {row['wr_ops']:.1f}  "
                  f"{row['rd_bytes']:.0f}  {row['wr_bytes']:.0f}  "
                  f"{','.join(row['osds'])}\n")
    return 0


def cmd_balancer_eval(rc, max_moves: int, pool: Optional[int],
                      out, as_json: bool = False) -> int:
    """`ceph balancer eval` / `ceph balancer propose [--json]` — the
    dry-run advisor: imbalance score from heat x utilization and the
    proposed upmap moves, as a REPORT (nothing is actuated)."""
    r = rc.mon_call({"cmd": "balancer_eval", "max_moves": max_moves,
                     "pool": pool})
    if as_json:
        out.write(json.dumps(r, indent=2, sort_keys=True) + "\n")
        return 0
    out.write(f"current imbalance score: {r['score_before']:.6f} "
              f"(epoch {r['epoch']}, {r['pgs_considered']} hot "
              f"pgs)\n")
    props = r.get("proposals") or []
    if not props:
        out.write("no improving moves found (dry run; map "
                  "unchanged)\n")
        return 0
    out.write(f"proposed score: {r['score_after']:.6f} with "
              f"{len(props)} move(s):\n")
    for p in props:
        out.write(f"  pg {p['pgid']}: osd.{p['from']} -> "
                  f"osd.{p['to']} (heat {p['heat']:.3f}, score -> "
                  f"{p['score_after']:.6f})\n")
    out.write("dry run only — apply is not implemented in this "
              "release\n")
    return 0


def cmd_trace(cluster_dir: str, token: str, out,
              as_json: bool = False) -> int:
    """`ceph trace <op_id>` — the cluster-level trace assembly: find
    the op's trace id in ANY daemon/client tracked-op dump, gather
    `dump_traces` spans from every admin socket in the cluster dir,
    and assemble the cross-process tree (the Jaeger query role)."""
    import glob
    import os

    from ..common.admin import admin_request
    from ..common.tracer import assemble, render_trace
    socks = sorted(glob.glob(os.path.join(cluster_dir, "*.asok")))
    if not socks:
        out.write(f"Error: no admin sockets under {cluster_dir}\n")
        return 1
    trace_id = None
    if token.startswith("0x"):
        trace_id = int(token, 16)
    # op ids are PER-PROCESS counters, so "op 7" can exist on the
    # client AND on several daemons: collect every match and refuse
    # an ambiguous resolution instead of silently rendering the
    # first asok's unrelated trace
    matches: Dict[int, str] = {}
    spans = []
    for path in socks:
        name = os.path.basename(path)[:-len(".asok")]
        if trace_id is None:
            for dump in ("dump_historic_slow_ops",
                         "dump_historic_ops", "dump_ops_in_flight"):
                try:
                    r = admin_request(path, {"prefix": dump}) \
                        .get("result") or {}
                except (OSError, IOError):
                    break
                for op in r.get("ops", []):
                    if str(op.get("op_id")) == token and \
                            op.get("trace_id"):
                        matches.setdefault(int(op["trace_id"]), name)
        try:
            r = admin_request(path, {"prefix": "dump_traces"}) \
                .get("result") or {}
            spans.extend(r.get("spans") or [])
        except (OSError, IOError):
            continue
    if trace_id is None:
        if len(matches) > 1:
            out.write(f"Error: op id {token!r} is ambiguous (op ids "
                      f"are per-process) — candidates:\n")
            for tid, name in sorted(matches.items()):
                out.write(f"  {name}: trace {tid:#x}\n")
            out.write("re-run with the 0x<trace_id> form\n")
            return 1
        if matches:
            trace_id = next(iter(matches))
    if trace_id is None:
        out.write(f"Error: op {token!r} not found in any daemon's "
                  f"tracked-op dumps (or it carries no trace)\n")
        return 1
    trees = assemble(s for s in spans
                     if int(s.get("trace_id", 0)) == trace_id)
    tree = trees.get(trace_id)
    if tree is None:
        out.write(f"Error: no spans for trace {trace_id:#x}\n")
        return 1
    if as_json:
        out.write(json.dumps(tree, indent=2, sort_keys=True,
                             default=str) + "\n")
    else:
        out.write(render_trace(tree) + "\n")
    return 0


def cmd_scrub(rc, pool_id: int, out) -> int:
    r = rc.scrub_pool(pool_id)
    out.write(json.dumps(r) + "\n")
    return 0


DAEMON_COMMANDS = ("dump_ops_in_flight", "dump_historic_ops",
                   "dump_historic_slow_ops", "dump_traces",
                   "perf dump", "perf reset",
                   "config show", "config get", "config set",
                   "trace dump", "trace reset", "fault_injection",
                   "store_fsck", "help")


def cmd_daemon(cluster_dir: str, name: str, words: List[str],
               out) -> int:
    """`ceph daemon <osd.N|mon.N|objecter> <command...>` over the
    daemon's admin socket (admin_socket JSON protocol, common/admin.py).
    Multi-word admin prefixes ("perf dump") are joined; a trailing
    KEY[=VALUE] pair becomes the request's key/value args.

    `fault_injection` takes its own grammar (runtime fault control):

        ... daemon osd.0 fault_injection                 # status
        ... daemon osd.0 fault_injection arm wire.drop_frame \\
                mode=one_in n=5 seed=3 [count=2]
        ... daemon osd.0 fault_injection disarm [NAME]
    """
    import os

    from ..common.admin import admin_request
    path = os.path.join(cluster_dir, f"{name}.asok")
    if not os.path.exists(path):
        out.write(f"Error: no admin socket for {name!r} "
                  f"(expected {path})\n")
        return 1
    req = {"prefix": " ".join(words)}
    if words[0] == "store_fsck":
        # `... daemon osd.N store_fsck [repair]` — on-demand store
        # consistency walk; `repair` quarantines inconsistencies
        req = {"prefix": "store_fsck",
               "repair": "repair" in words[1:]}
    elif words[0] == "fault_injection":
        req = {"prefix": "fault_injection"}
        rest = words[1:]
        if rest:
            req["action"] = rest[0]
            pos = [w for w in rest[1:] if "=" not in w]
            if pos:
                req["name"] = pos[0]
            for w in rest[1:]:
                if "=" in w:
                    k, v = w.split("=", 1)
                    if k in ("mode", "n", "seed", "count"):
                        req[k] = v
                    elif k == "match":
                        # phase filter: a JSON object on the command
                        # line (match={"cmd":"put_shard"})
                        req["match"] = json.loads(v)
                    else:
                        # anything else (e.g. seconds=0.2) rides as a
                        # faultpoint param the fire site reads back
                        req.setdefault("params", {})[k] = v
    # `config get KEY` / `config set KEY VALUE` style trailing args
    elif len(words) >= 3 and " ".join(words[:2]) in DAEMON_COMMANDS:
        req["prefix"] = " ".join(words[:2])
        req["key"] = words[2]
        if len(words) >= 4:
            req["value"] = words[3]
    reply = admin_request(path, req)
    out.write(json.dumps(reply.get("result", reply), indent=2,
                         sort_keys=True, default=str) + "\n")
    return 0 if "error" not in reply else 1


def main(argv: Optional[List[str]] = None,
         out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="ceph")
    ap.add_argument("--dir", default=None,
                    help="vstart cluster directory (required for "
                         "every command except `lint`)")
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--size", type=int, default=3,
                    help="replica count for `osd pool create`")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cluster client (cuda or "
                         "cpu)")
    ap.add_argument("words", nargs="+",
                    help="command, e.g.: status | health | mon stat | "
                         "osd tree | osd out N | osd in N | "
                         "osd set|unset noout|nodown | osd pool ls | "
                         "osd tier add|remove BASE CACHE | "
                         "osd tier agent BASE [TARGET] | "
                         "osd df | trace OP_ID [--json] | "
                         "pg dump POOL | pg heat [--pool=P --top=N] "
                         "| telemetry history COUNTER "
                         "[--daemon=osd.N] | "
                         "balancer eval|propose [--json] | "
                         "df | scrub POOL | "
                         "daemon NAME dump_ops_in_flight|"
                         "dump_historic_ops|dump_historic_slow_ops|"
                         "perf dump|fault_injection [...]|"
                         "store_fsck [repair] | "
                         "lint [--check|--json|--sarif|"
                         "--rule CTL###|--graph module.fn|...] | "
                         "thrash [--seed N --cycles K --netsplit "
                         "--powercycle --json] | "
                         "serve [--seed N --chaos --starve --json] | "
                         "serve --dr [--seed N --chaos "
                         "--lose-bilog --json] | "
                         "rgw POOL bucket reshard|limit ...")
    ns, extra = ap.parse_known_args(argv)
    if ns.words[0] == "lint":
        # static-analysis surface (ceph_tpu_torch/analysis): needs no
        # cluster — unknown flags pass through to the lint runner
        # (`ceph lint --check`, `ceph lint --json`, ...)
        from ..analysis.runner import main as lint_main
        return lint_main(ns.words[1:] + extra, out=out)
    # the admin-socket verbs (`daemon`, `trace`) build no client; every
    # other verb runs its client on --device
    on_device = contextlib.nullcontext() \
        if ns.words[0] in ("daemon", "trace") else using_device(ns.device)
    with on_device:
        return _main(ap, ns, extra, out)


def _main(ap, ns, extra: List[str], out) -> int:
    if ns.words[0] == "thrash":
        # robustness surface (`ceph thrash --seed N --cycles K
        # --json`): a seeded kill/revive soak with self-healing
        # invariants — builds its own in-process stack, no --dir
        from ..cluster.thrasher import main as thrash_main
        return thrash_main(ns.words[1:] + extra, out=out)
    if ns.words[0] == "serve":
        # serving surface (`ceph serve [--chaos --starve --json]`):
        # the multi-tenant S3 workload with the enforced SLO/QoS
        # gate — builds its own vstart cluster, exits nonzero on
        # any per-tenant breach (rgw/serving.py).  `serve --dr`
        # routes to the two-zone disaster-recovery drill
        # (cluster/dr_drill.py) and exits with its convergence gate
        from ..rgw.serving import serve_main
        return serve_main(ns.words[1:] + extra, out=out)
    if ns.words[0] == "rgw":
        # gateway admin over a live cluster: `ceph rgw <pool>
        # <radosgw-admin words...>` builds the pool's IoCtx and
        # hands through to radosgw-admin (bucket reshard / bucket
        # limit check / user ... against daemons)
        if ns.dir is None:
            ap.error("--dir is required for `rgw`")
        if len(ns.words) < 3:
            ap.error("rgw POOL COMMAND...")
        from ..client.remote_ioctx import RemoteIoCtx
        from .radosgw_admin import main as rgw_main
        rc = _client(ns.dir)
        try:
            io = RemoteIoCtx(rc, ns.words[1])
            return rgw_main(ns.words[2:] + extra, ioctx=io, out=out)
        except (RuntimeError, ValueError, OSError, KeyError) as e:
            out.write(f"Error: {e}\n")
            return 1
        finally:
            rc.close()
    if ns.words[0] == "trace":
        # cluster-level trace assembly over the daemons' admin
        # sockets: needs no mon connection (an op is usually traced
        # BECAUSE something is wedged)
        if ns.dir is None:
            ap.error("--dir is required for `trace`")
        if len(ns.words) < 2:
            ap.error("trace OP_ID|0xTRACE_ID [--json]")
        try:
            return cmd_trace(ns.dir, ns.words[1], out,
                             as_json="--json" in (ns.words[2:] +
                                                  extra))
        except (RuntimeError, ValueError, OSError) as e:
            out.write(f"Error: {e}\n")
            return 1
    if ns.words[0] in ("telemetry", "balancer") or \
            ns.words[:2] == ["pg", "heat"]:
        # ClusterScope observability verbs: their flags ride `extra`
        # (use --flag=value forms; argparse scrambles split pairs)
        if ns.dir is None:
            ap.error(f"--dir is required for `{ns.words[0]}`")
        sub = argparse.ArgumentParser(prog=f"ceph {ns.words[0]}")
        sub.add_argument("--daemon", default=None)
        sub.add_argument("--pool", type=int, default=None)
        sub.add_argument("--top", type=int, default=None)
        sub.add_argument("--max-moves", type=int, default=8,
                         dest="max_moves")
        sub.add_argument("--json", action="store_true",
                         dest="as_json")
        sub.add_argument("rest", nargs="*")
        fl = sub.parse_args(ns.words[1:] + extra)
        rc = _client(ns.dir)
        try:
            if ns.words[0] == "telemetry":
                if fl.rest[:1] != ["history"] or len(fl.rest) < 2:
                    ap.error("telemetry history COUNTER "
                             "[--daemon=osd.N] [--json]")
                return cmd_telemetry_history(rc, fl.rest[1],
                                             fl.daemon, out,
                                             fl.as_json)
            if ns.words[0] == "balancer":
                if fl.rest[:1] not in (["eval"], ["propose"]):
                    ap.error("balancer eval|propose "
                             "[--max-moves=N] [--pool=P] [--json]")
                return cmd_balancer_eval(
                    rc, fl.max_moves, fl.pool, out,
                    fl.as_json or fl.rest[0] == "propose")
            return cmd_pg_heat(rc, fl.pool, fl.top, out, fl.as_json)
        except (RuntimeError, ValueError, OSError) as e:
            out.write(f"Error: {e}\n")
            return 1
        finally:
            rc.close()
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if ns.dir is None:
        ap.error("--dir is required for cluster commands")
    if ns.words[0] == "daemon":
        # admin-socket path: talks to ONE daemon directly, needs no
        # mon connection (and must work while the mon is down)
        if len(ns.words) < 3:
            ap.error("daemon NAME COMMAND...")
        try:
            return cmd_daemon(ns.dir, ns.words[1], ns.words[2:], out)
        except (RuntimeError, ValueError, OSError) as e:
            out.write(f"Error: {e}\n")
            return 1
    rc = _client(ns.dir)
    try:
        return _dispatch(ap, ns, rc, out)
    except (RuntimeError, ValueError, OSError) as e:
        out.write(f"Error: {e}\n")
        return 1
    finally:
        rc.close()


def _dispatch(ap, ns, rc, out) -> int:
    w = ns.words

    def arg(i: int) -> str:
        if len(w) <= i:
            ap.error(f"{' '.join(w)}: missing operand")
        return w[i]

    if w[0] in ("status", "-s"):
        return cmd_status(rc, out)
    if w[0] == "health":
        return cmd_health(rc, out)
    if w[:2] == ["mon", "stat"]:
        return cmd_mon_stat(rc, out)
    if w[:2] == ["osd", "tree"]:
        return cmd_osd_tree(rc, ns.dir, out)
    if w[:2] == ["osd", "out"]:
        return cmd_osd_out(rc, int(arg(2)), out)
    if w[:2] == ["osd", "in"]:
        return cmd_osd_in(rc, int(arg(2)), out)
    if w[:2] == ["osd", "set"]:
        # `ceph osd set noout|nodown` — ride out a known partition:
        # noout stops the down->out transition, nodown stops failure
        # reports from marking OSDs down (OSDMonitor flag commands)
        r = rc.mon_call({"cmd": "osd_set_flag", "flag": arg(2)})
        out.write(f"{arg(2)} is set (flags: "
                  f"{','.join(r['flags']) or '-'})\n")
        return 0
    if w[:2] == ["osd", "unset"]:
        r = rc.mon_call({"cmd": "osd_unset_flag", "flag": arg(2)})
        out.write(f"{arg(2)} is unset (flags: "
                  f"{','.join(r['flags']) or '-'})\n")
        return 0
    if w[:3] == ["osd", "pool", "ls"]:
        return cmd_pool_ls(rc, ns.detail, out)
    if w[:3] == ["osd", "pool", "create"]:
        name = arg(3)
        pg_num = int(w[4]) if len(w) > 4 else 16
        ptype = w[5] if len(w) > 5 else "replicated"
        return cmd_pool_create(rc, name, pg_num, ptype,
                               ns.size, out)
    if w[:3] == ["osd", "pool", "rm"]:
        return cmd_pool_rm(rc, arg(3), out)
    if w[:3] == ["osd", "tier", "add"]:
        return cmd_tier_add(rc, arg(3), arg(4), out)
    if w[:3] == ["osd", "tier", "remove"]:
        return cmd_tier_remove(rc, arg(3), arg(4), out)
    if w[:3] == ["osd", "tier", "agent"]:
        return cmd_tier_agent(rc, arg(3),
                              w[4] if len(w) > 4 else None, out)
    if w[:2] == ["osd", "df"]:
        return cmd_osd_df(rc, out)
    if w[:2] == ["pg", "dump"]:
        return cmd_pg_dump(rc, int(arg(2)), out)
    if w[0] == "df":
        return cmd_df(rc, out)
    if w[0] == "scrub":
        return cmd_scrub(rc, int(arg(1)), out)
    ap.error(f"unknown command: {' '.join(w)}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
