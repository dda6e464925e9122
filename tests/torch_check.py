"""Shared by the tests of the port's check-smoke twins
(``tests/test_torch_check_*.py``): a twin run in a child process on the
CPU, with a wall-clock bound, and a perf group emptied for a twin run in
the test's own process.

A twin that starts OSD daemons runs in its own process with a timeout:
no pytest timeout plugin is installed, so a hang (ROADMAP section C's
serve hang lies on check_serving's path) then fails one test instead of
holding the suite.  The child and its daemons get one intra-op thread
each, as every test process does (C1).
"""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_twin(name, *args, timeout):
    """``python -m ceph_tpu_torch.tools.check_<name> --device cpu *args``
    from the repo's root; returns the CompletedProcess (text output)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", f"ceph_tpu_torch.tools.check_{name}",
         "--device", "cpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def reference_smoke(name):
    """``scripts/check_<name>.py`` of the reference, loaded as a module
    (the way the reference's own tests load it)."""
    import importlib.util
    path = REPO / "scripts" / f"check_{name}.py"
    spec = importlib.util.spec_from_file_location(f"check_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fresh_perf_group(monkeypatch, perf, name):
    """Empties ``perf(name)`` in place until the test ends, then gives it
    back its keys and counts.

    A group keeps every key it ever counted: ``reset()`` sets each to 0
    and keeps it.  Under ``--dist loadfile`` a worker runs whole files one
    after another in one process, so a twin run in the test's process
    finds the keys of every earlier file's run in the same group (a 2 x 4
    plane's ``r0c0.*`` ... ``r1c3.*`` beside the 1-D ``shard<i>.*``).
    The group object stays the same one, since a live data plane holds
    it."""
    group = perf(name)
    monkeypatch.setattr(group, "_types", {})
    monkeypatch.setattr(group, "_vals", {})
    return group
