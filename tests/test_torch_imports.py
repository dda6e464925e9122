"""The port stands alone: no module of ceph_tpu_torch, and none of its
root scripts (chip_smoke.py, kernel_timing.py, k2_variants.py,
placement_profile.py), imports
JAX or the reference package; its entry points
default to the card and never fall back to the CPU on their own."""
import ast
import pathlib

import pytest
import torch

import ceph_tpu_torch

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def port_files():
    return sorted((REPO / "ceph_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py", REPO / "kernel_timing.py",
         REPO / "k2_variants.py", REPO / "placement_profile.py"]


def imported_roots(path):
    """Top-level package of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in port_files()}
    for want in ("ceph_tpu_torch/ops/xor_kernel.py",
                 "ceph_tpu_torch/ec/plugin_jax.py",
                 "ceph_tpu_torch/cluster/ec_backend.py", "chip_smoke.py",
                 "ceph_tpu_torch/ops/ragged_fused.py",
                 "ceph_tpu_torch/parallel/mesh.py",
                 "ceph_tpu_torch/parallel/multihost.py",
                 "ceph_tpu_torch/parallel/data_plane.py",
                 "ceph_tpu_torch/tools/check_multihost.py",
                 "ceph_tpu_torch/ops/crc32_gf2.py",
                 "ceph_tpu_torch/common/crcutil.py",
                 "ceph_tpu_torch/common/auth.py",
                 "ceph_tpu_torch/common/compressor.py",
                 "ceph_tpu_torch/msg/wire.py",
                 "ceph_tpu_torch/msg/shm_ring.py",
                 "ceph_tpu_torch/cluster/blockdev.py",
                 "ceph_tpu_torch/cluster/kv.py",
                 "ceph_tpu_torch/cluster/wal_kv.py",
                 "ceph_tpu_torch/cluster/bluestore.py",
                 "ceph_tpu_torch/placement/compiler.py",
                 "ceph_tpu_torch/placement/treedump.py",
                 "ceph_tpu_torch/common/backoff.py",
                 "ceph_tpu_torch/common/log.py",
                 "ceph_tpu_torch/common/admin.py",
                 "ceph_tpu_torch/cluster/admin_commands.py",
                 "ceph_tpu_torch/cluster/striper.py",
                 "ceph_tpu_torch/cluster/scrub_machine.py",
                 "ceph_tpu_torch/ec/bitmatrix_raid6.py",
                 "ceph_tpu_torch/ec/bitmatrix_codec.py",
                 "ceph_tpu_torch/ec/plugin_jerasure.py",
                 "ceph_tpu_torch/ec/plugin_isa.py",
                 "ceph_tpu_torch/ec/plugin_shec.py",
                 "ceph_tpu_torch/ec/plugin_lrc.py",
                 "ceph_tpu_torch/ec/plugin_clay.py",
                 "ceph_tpu_torch/tools/ec_bench.py",
                 "ceph_tpu_torch/cluster/filestore.py",
                 "ceph_tpu_torch/cluster/crashdev.py",
                 "ceph_tpu_torch/cluster/daemon_pglog.py",
                 "ceph_tpu_torch/cluster/class_handler.py",
                 "ceph_tpu_torch/mgr/__init__.py",
                 "ceph_tpu_torch/mgr/module_host.py",
                 "ceph_tpu_torch/mgr/metrics_history.py",
                 "ceph_tpu_torch/mgr/cluster_stats.py",
                 "ceph_tpu_torch/cluster/monitor.py",
                 "ceph_tpu_torch/cluster/mon_quorum.py",
                 "ceph_tpu_torch/cluster/objecter.py",
                 "ceph_tpu_torch/parallel/__init__.py",
                 "ceph_tpu_torch/parallel/multihost.py",
                 "ceph_tpu_torch/cluster/async_objecter.py",
                 "ceph_tpu_torch/cluster/daemon.py",
                 "ceph_tpu_torch/tools/vstart.py",
                 "ceph_tpu_torch/client/__init__.py",
                 "ceph_tpu_torch/client/remote.py",
                 "ceph_tpu_torch/client/rados.py",
                 "ceph_tpu_torch/client/striper.py",
                 "ceph_tpu_torch/client/remote_ioctx.py",
                 "ceph_tpu_torch/cluster/heartbeat.py",
                 "ceph_tpu_torch/cluster/peering.py",
                 "ceph_tpu_torch/cluster/thrasher.py",
                 "ceph_tpu_torch/cluster/tiering.py",
                 "ceph_tpu_torch/cluster/balancer.py",
                 "ceph_tpu_torch/mgr/balancer_advisor.py",
                 "ceph_tpu_torch/mgr/balancer_module.py",
                 "ceph_tpu_torch/fs/__init__.py",
                 "ceph_tpu_torch/fs/journaler.py",
                 "ceph_tpu_torch/client/rbd.py",
                 "ceph_tpu_torch/client/rbd_mirror.py",
                 "ceph_tpu_torch/client/neorados.py",
                 "ceph_tpu_torch/rgw/__init__.py",
                 "ceph_tpu_torch/rgw/users.py",
                 "ceph_tpu_torch/rgw/auth_s3.py",
                 "ceph_tpu_torch/rgw/gateway.py",
                 "ceph_tpu_torch/rgw/sync.py",
                 "ceph_tpu_torch/rgw/zone.py",
                 "ceph_tpu_torch/rgw/http_frontend.py",
                 "ceph_tpu_torch/rgw/swift_frontend.py",
                 "ceph_tpu_torch/rgw/serving.py",
                 "ceph_tpu_torch/cluster/dr_drill.py",
                 "ceph_tpu_torch/fs/mdsmap.py",
                 "ceph_tpu_torch/fs/mds.py",
                 "ceph_tpu_torch/fs/multimds.py",
                 "ceph_tpu_torch/analysis/__init__.py",
                 "ceph_tpu_torch/analysis/core.py",
                 "ceph_tpu_torch/analysis/registry.py",
                 "ceph_tpu_torch/analysis/baseline.py",
                 "ceph_tpu_torch/analysis/astutil.py",
                 "ceph_tpu_torch/analysis/runner.py",
                 "ceph_tpu_torch/analysis/shardspec.py",
                 "ceph_tpu_torch/analysis/rules_jax.py",
                 "ceph_tpu_torch/analysis/rules_dtype.py",
                 "ceph_tpu_torch/analysis/rules_shard.py",
                 "ceph_tpu_torch/analysis/rules_faults.py",
                 "ceph_tpu_torch/tools/ceph_cli.py",
                 "ceph_tpu_torch/tools/lint.py",
                 "ceph_tpu_torch/tools/check_static.py",
                 "ceph_tpu_torch/tools/check_multichip.py",
                 "ceph_tpu_torch/tools/check_wire.py",
                 "ceph_tpu_torch/tools/check_recovery.py",
                 "ceph_tpu_torch/tools/check_async.py",
                 "ceph_tpu_torch/tools/check_robustness.py",
                 "ceph_tpu_torch/tools/check_observability.py",
                 "ceph_tpu_torch/tools/check_serving.py",
                 "ceph_tpu_torch/tools/check_dr.py"):
        assert want in names


def test_every_reference_file_has_its_twin():
    """The port mirrors the reference's layout: every ``ceph_tpu/X/y.py``
    has its ``ceph_tpu_torch/X/y.py``."""
    ref = sorted(p.relative_to(REPO / "ceph_tpu").as_posix()
                 for p in (REPO / "ceph_tpu").rglob("*.py"))
    missing = [r for r in ref if not (REPO / "ceph_tpu_torch" / r).exists()]
    assert not missing, f"{len(missing)} of {len(ref)} files have no " \
        f"twin: {missing}"
    assert len(ref) >= 156


def reference_smokes():
    return sorted(p.stem for p in (REPO / "scripts").glob("check_*.py"))


def test_every_reference_smoke_has_its_twin():
    """Every check smoke of the reference (``scripts/check_<name>.py``)
    has its ``ceph_tpu_torch/tools/check_<name>.py``."""
    smokes = reference_smokes()
    missing = [s for s in smokes
               if not (REPO / "ceph_tpu_torch" / "tools" / f"{s}.py").exists()]
    assert not missing, f"{len(missing)} of {len(smokes)} smokes have no " \
        f"twin: {missing}"
    assert len(smokes) >= 10


@pytest.mark.parametrize("name", [s[len("check_"):]
                                  for s in reference_smokes()
                                  if s not in ("check_multihost",
                                               "check_static")])
def test_every_smoke_twin_needs_a_card_unless_the_cpu_is_asked_for(name):
    """A twin's ``--device`` defaults to the card: without one it raises
    before it builds a sim or starts a daemon, and never drops to the
    CPU on its own (``check_multihost`` and ``check_static`` run on the
    CPU by design)."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"ceph_tpu_torch.tools.check_{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert ceph_tpu_torch.default_device() == "cuda"


@pytest.mark.parametrize(
    "path", port_files(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_import(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_roots_are_caught(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from ceph_tpu.ops import gf\n"
                   "from ceph_tpu_torch.ops import gf2\n"
                   "from . import sibling\n")
    assert sorted(set(imported_roots(src)) & set(FORBIDDEN)) == \
        ["ceph_tpu", "jax"]


def test_default_device_is_cuda_and_never_falls_back():
    assert ceph_tpu_torch.default_device() == "cuda"
    if torch.cuda.is_available():
        assert ceph_tpu_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ceph_tpu_torch.resolve_device()
        from ceph_tpu_torch.ec import instance
        for plugin in instance().names():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                instance().factory(plugin, {"k": "4", "m": "2"})
        # the general per-lane mapper (a straw map) never maps on the host
        from ceph_tpu_torch.placement.compiler import compile_crushmap
        from ceph_tpu_torch.placement.xla_mapper import XlaMapper
        straw = compile_crushmap(
            "device 0 osd.0\ndevice 1 osd.1\ntype 0 osd\ntype 10 root\n"
            "root r {\n id -1\n alg straw\n hash 0\n"
            " item osd.0 weight 1.0\n item osd.1 weight 1.0\n}\n")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            XlaMapper(straw, fast=False)
        # the process cluster's client and daemons: the card unless the
        # CPU is asked for
        from ceph_tpu_torch.client.remote import RemoteCluster
        from ceph_tpu_torch.cluster import daemon
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RemoteCluster("/nonexistent-cluster-dir")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            daemon.main(["osd", "--cluster-dir", "/nonexistent", "--id", "0"])
        # the thrasher's standalone stack builds its sim on the card
        from ceph_tpu_torch.cluster.thrasher import build_default_stack
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_default_stack()
        # the DR drill's zones and S3Serve's tenant handles: the card
        # unless the CPU is asked for
        from ceph_tpu_torch.cluster.dr_drill import (DrillConfig, _SimZone,
                                                     drill_main, run_drill)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _SimZone("a")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_drill(DrillConfig(seed=0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            drill_main(["--seed", "0"])
        from ceph_tpu_torch.rgw.serving import (S3ServeHarness,
                                                ServeConfig, default_tenants)
        harness = S3ServeHarness("/nonexistent", ServeConfig())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            harness._make_tenant_client(default_tenants()[0], _NoUsers())
        assert ceph_tpu_torch.default_device() == "cuda"
    assert ceph_tpu_torch.resolve_device("cpu").type == "cpu"


class _NoUsers:
    """A user store that knows every tenant (for the handle check)."""

    def create(self, uid):
        return {"keys": [{"access_key": "AK", "secret_key": "SK"}]}


def test_set_default_device_round_trip():
    prev = ceph_tpu_torch.default_device()
    try:
        ceph_tpu_torch.set_default_device("cpu")
        assert ceph_tpu_torch.resolve_device() == torch.device("cpu")
    finally:
        ceph_tpu_torch.set_default_device(prev)
    assert ceph_tpu_torch.default_device() == prev
