"""The port stands alone: no module of ceph_tpu_torch, and not
chip_smoke.py, imports JAX or the reference package; its entry points
default to the card and never fall back to the CPU on their own."""
import ast
import pathlib

import pytest
import torch

import ceph_tpu_torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def port_files():
    return sorted((REPO / "ceph_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


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
                 "ceph_tpu_torch/cluster/ec_backend.py", "chip_smoke.py"):
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
        with pytest.raises(RuntimeError, match="no CUDA device"):
            instance().factory("jax", {"k": "4", "m": "2",
                                       "layout": "bitsliced"})
    assert ceph_tpu_torch.resolve_device("cpu").type == "cpu"


def test_set_default_device_round_trip():
    prev = ceph_tpu_torch.default_device()
    try:
        ceph_tpu_torch.set_default_device("cpu")
        assert ceph_tpu_torch.resolve_device() == torch.device("cpu")
    finally:
        ceph_tpu_torch.set_default_device(prev)
    assert ceph_tpu_torch.default_device() == prev
