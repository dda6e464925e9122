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
                 "ceph_tpu_torch/client/neorados.py"):
        assert want in names


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
        assert ceph_tpu_torch.default_device() == "cuda"
    assert ceph_tpu_torch.resolve_device("cpu").type == "cpu"


def test_set_default_device_round_trip():
    prev = ceph_tpu_torch.default_device()
    try:
        ceph_tpu_torch.set_default_device("cpu")
        assert ceph_tpu_torch.resolve_device() == torch.device("cpu")
    finally:
        ceph_tpu_torch.set_default_device(prev)
    assert ceph_tpu_torch.default_device() == prev
