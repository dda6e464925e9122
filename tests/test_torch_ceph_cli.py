"""The port's ``ceph`` CLI against the reference's, over one live process
cluster of the port.

Twins of the ``ceph`` half of ``tests/test_admin_cli.py``.  One cluster
of the port (``tools/vstart.py``: a mon and 4 OSD daemons on the CPU,
one a host, a 3-replica pool ``rep``) serves the file.  Each verb runs
through the reference's ``ceph`` and then through the port's
(``--device cpu``) on the same cluster: the read verbs must print the
same text, the mutating verbs (``osd pool create|rm``, ``osd set|unset
noout``) must print the same replies and leave the same map, and
``daemon osd.0 ...`` must answer the same over the admin socket.  The two
clients speak one wire protocol to the same daemons.
"""
import io
import json
import re
import time

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.tools import ceph_cli as ref_cli
from ceph_tpu_torch.tools import ceph_cli
from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir

# One intra-op thread per test process (the suite runs under several
# xdist workers).
torch.set_num_threads(1)

N_OSDS = 4
POOLS = [{"id": 1, "name": "rep", "type": 1, "size": 3, "pg_num": 8,
          "crush_rule": 0}]
# the read verbs, each printed by both CLIs and compared
READ_VERBS = (("status",), ("health",), ("mon", "stat"), ("osd", "tree"),
              ("osd", "pool", "ls"), ("pg", "dump", "1"), ("df",),
              ("osd", "df"))
# admin-socket commands both CLIs' `daemon` verb dispatches and whose
# replies do not move between two calls
DAEMON_COMMANDS = ("config show", "perf reset", "trace reset", "help")


def wait_for_full_reports(d, timeout=120.0):
    """Until the mon holds every OSD's usage report: the read verbs print
    the same text twice only once no daemon's first report is still on
    its way (one landing between the two CLIs' calls adds that OSD's
    bytes to ``df``'s total).  The cluster takes no client IO, so the
    trend columns of ``osd df`` stay ``-``."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    rc = RemoteCluster(d)
    try:
        deadline = time.monotonic() + timeout
        while True:
            rows = rc.mon_call({"cmd": "cluster_stats"}).get("osd_df") \
                or []
            if len(rows) == N_OSDS and all(r["bytes_total"] > 0
                                           for r in rows):
                return
            assert time.monotonic() < deadline, \
                f"the OSDs' reports never filled: {rows}"
            time.sleep(0.5)
    finally:
        rc.close()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cephc") / "cluster")
    build_cluster_dir(d, n_osds=N_OSDS, osds_per_host=1, fsync=False,
                      pools=POOLS)
    v = Vstart(d)
    v.start(N_OSDS, hb_interval=0.25)
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    try:
        wait_for_full_reports(d)
        yield d
    finally:
        ceph_tpu_torch.set_default_device(prev)
        v.stop()


def run(main, d, *words, port=False):
    out = io.StringIO()
    argv = (["--device", "cpu"] if port else []) + ["--dir", d, *words]
    rc = main(argv, out=out)
    return rc, out.getvalue()


def both(d, *words):
    return run(ref_cli.main, d, *words), run(ceph_cli.main, d, *words,
                                             port=True)


@pytest.mark.parametrize("words", READ_VERBS,
                         ids=["-".join(w) for w in READ_VERBS])
def test_read_verbs_print_the_same(cluster, words):
    ref, port = both(cluster, *words)
    assert port == ref
    assert port[0] == 0 and port[1]


def test_osd_tree_marks_every_osd_up(cluster):
    rc, txt = run(ceph_cli.main, cluster, "osd", "tree", port=True)
    assert rc == 0
    assert sum(line.endswith("  up") for line in txt.splitlines()) == \
        N_OSDS


def _masked(text):
    """A reply with its epochs and pool ids masked: the two CLIs' runs
    follow each other, so the map moved on between them."""
    return re.sub(r"(id|epoch) \d+", r"\1 N", text)


def _pool_map(d, main, port):
    """The pools of the map as ``osd pool ls --detail`` prints them, ids
    masked."""
    rc, txt = run(main, d, "--detail", "osd", "pool", "ls", port=port)
    assert rc == 0
    return sorted(re.sub(r"^pool \d+ ", "pool N ", line)
                  for line in txt.splitlines())


def test_mutating_verbs_leave_the_same_map(cluster):
    recs = []
    for main, port in ((ref_cli.main, False), (ceph_cli.main, True)):
        rec = [_masked(run(main, cluster, "osd", "pool", "create",
                           "clipool", "8", port=port)[1]),
               _pool_map(cluster, main, port),
               run(main, cluster, "osd", "set", "noout", port=port),
               run(main, cluster, "osd", "unset", "noout", port=port),
               _masked(run(main, cluster, "osd", "pool", "rm", "clipool",
                           port=port)[1]),
               _pool_map(cluster, main, port)]
        recs.append(rec)
    assert recs[1] == recs[0]
    created, pools, set_, unset, removed, after = recs[1]
    assert created == "pool 'clipool' created (id N, epoch N)\n"
    assert any("'clipool' replicated size 3 pg_num 8" in p for p in pools)
    assert set_ == (0, "noout is set (flags: noout)\n")
    assert unset == (0, "noout is unset (flags: -)\n")
    assert removed == "pool 'clipool' removed (epoch N)\n"
    assert not any("clipool" in p for p in after)


def test_osd_out_and_in_send_the_same_commands(cluster):
    for verb in ("out", "in"):
        ref, port = both(cluster, "osd", verb, "3")
        assert port[0] == ref[0] == 0
        assert _masked(port[1]).split(" (")[0] == \
            _masked(ref[1]).split(" (")[0] == f"marked {verb} osd.3"


@pytest.mark.parametrize("command", DAEMON_COMMANDS)
def test_daemon_commands_answer_the_same(cluster, command):
    ref, port = both(cluster, "daemon", "osd.0", *command.split())
    assert port == ref
    assert port[0] == 0


def test_daemon_perf_dump_has_the_same_counters(cluster):
    """``perf dump`` values move with the heartbeats between two calls:
    the groups and counter names must match, and after ``perf reset``
    the port's dump reads the same counters."""
    ref, port = both(cluster, "daemon", "osd.0", "perf", "dump")
    assert port[0] == ref[0] == 0
    a, b = json.loads(ref[1]), json.loads(port[1])
    assert sorted(a) == sorted(b)
    for group in a:
        assert sorted(a[group]) == sorted(b[group]), group


def test_daemon_without_a_socket_fails_the_same(cluster):
    ref, port = both(cluster, "daemon", "osd.99", "perf", "dump")
    assert port == ref
    assert port[0] == 1 and "no admin socket" in port[1]


def test_lint_verb_lists_the_same_rule_ids():
    outs = []
    for main in (ref_cli.main, ceph_cli.main):
        buf = io.StringIO()
        assert main(["lint", "--list-rules"], out=buf) == 0
        outs.append([line.split()[0] for line in
                     buf.getvalue().splitlines()])
    assert outs[1] == outs[0]
    assert "CTL101" in outs[1] and "CTL1006" in outs[1]


def test_port_cli_defaults_to_the_card(cluster):
    """Without ``--device cpu`` a client verb runs on the card, and this
    machine has none (the test skips where one is present)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ceph_cli.main(["--dir", cluster, "status"], out=io.StringIO())


def test_unknown_command_is_refused(cluster):
    for main, port in ((ref_cli.main, False), (ceph_cli.main, True)):
        with pytest.raises(SystemExit):
            run(main, cluster, "no", "such", "verb", port=port)


def test_health_admin_command_equals_reference():
    """The sim's ``health`` admin command (registered with a monitor)
    answers as the reference's does."""
    from ceph_tpu.cluster.admin_commands import \
        register_cluster_commands as ref_register
    from ceph_tpu.cluster.monitor import Monitor as RefMonitor
    from ceph_tpu.common.admin import AdminServer as RefAdmin
    from ceph_tpu_torch.cluster.admin_commands import \
        register_cluster_commands
    from ceph_tpu_torch.cluster.monitor import Monitor
    from ceph_tpu_torch.common.admin import AdminServer
    from tests.test_torch_substrate import _sims
    ref_sim, sim = _sims()
    try:
        srv, ref_srv = AdminServer(), RefAdmin()
        register_cluster_commands(srv, sim, Monitor(sim.osdmap))
        ref_register(ref_srv, ref_sim, RefMonitor(ref_sim.osdmap))
        got = srv.handle({"prefix": "health"})
        assert got == ref_srv.handle({"prefix": "health"})
        assert isinstance(got["result"], list)
    finally:
        ref_sim.shutdown()
        sim.shutdown()
