"""What the benchmark may load: no JAX, nothing of the JAX package, and
in the reference nothing of the port and no native library."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ceph_tpu"}
PB = ROOT / "portbench"


def imported(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_jax_package(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_stands_alone(path):
    assert not set(imported(path)) & (FORBIDDEN | {"ceph_tpu_torch",
                                                   "ctypes", "portbench"})
    text = path.read_text()
    assert "CDLL" not in text and "native" not in text.replace(
        "native mapper", "")


def test_a_rehearsal_loads_no_jax():
    """A whole CPU run of each cell in a fresh process: afterwards no
    module of JAX or the JAX package is loaded, and the reference's
    modules loaded none of the port."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.tests import tiny\n"
        "for wl in tiny.CELLS:\n"
        "    assert tiny.run(wl, seconds=0.3)['correct']\n"
        "from portbench import harness\n"
        "print(json.dumps(harness.forbidden_modules(sys.modules)))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    from portbench import harness
    assert harness.forbidden_modules(
        ["ceph_tpu_torch", "ceph_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["ceph_tpu.ops", "jax.numpy", "flax"]) == ["ceph_tpu", "flax", "jax"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                        "crush_10k_rep3.remap", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_without_the_program_there_is_no_result(tmp_path):
    """A checkout of the benchmark alone: the run fails before any
    result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, json\n"
            f"sys.path[:0] = [{str(tmp_path)!r}]\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"root = Path({str(tmp_path)!r})\n"
            "bench = json.loads((root / 'BENCHMARK.json').read_text())\n"
            "print(json.dumps(harness.run_cell(root, bench, "
            "'crush_10k_rep3.remap', 1, 0.1, False, 'cpu')))\n")
    r = subprocess.run([sys.executable, "-I", "-c", code],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert "ceph_tpu_torch" in r.stderr
    assert r.stdout.strip() == ""
