"""The CRAM transcripts of ``tests/cli/*.t`` run against the port's CLIs.

Each transcript's commands are rewritten before they run: the module
path ``ceph_tpu.tools.`` becomes ``ceph_tpu_torch.tools.``, ``--device
cpu`` is added to the tools that take it (the port's CLIs run on the card
by default), and ``/tmp/`` becomes the test's own directory, so that the
reference's runner and this one can run side by side.  Stdout is compared
byte for byte with the transcript's expected lines; the ``.t`` files are
read, never written.

A second test runs every ``--scalar`` command of the transcripts without
``--scalar``: the port's batched torch mapper must print what the scalar
mapper's transcript expects, at the transcript's own x ranges.
"""
import contextlib
import io
import os
import shlex
import subprocess
from pathlib import Path

import pytest

from tests.test_cli_transcripts import CLI_DIR, TRANSCRIPTS, parse_transcript

ROOT = Path(__file__).parent.parent
DEVICE_TOOLS = ("crushtool", "osdmaptool")


def port_command(cmd: str, tmp: Path) -> str:
    """The reference's transcript command, aimed at the port."""
    cmd = cmd.replace("ceph_tpu.tools.", "ceph_tpu_torch.tools.")
    for tool in DEVICE_TOOLS:
        mod = f"-m ceph_tpu_torch.tools.{tool}"
        cmd = cmd.replace(mod, f"{mod} --device cpu")
    return cmd.replace("/tmp/", f"{tmp}/")


def run_command(cmd: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread a tool process, as in the test processes: the
    # suite runs under several workers, and a full torch pool in each
    # command oversubscribes the cores the other workers' tests need
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        cmd, shell=True, cwd=str(CLI_DIR), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, timeout=600)
    return proc.stdout


def test_rewrite_aims_every_command_at_the_port(tmp_path):
    cmd = ("python -m ceph_tpu.tools.crushtool -d basic.crush -o "
           "/tmp/rt1.crush && python -m ceph_tpu.tools.osdmaptool c.json")
    assert port_command(cmd, tmp_path) == (
        "python -m ceph_tpu_torch.tools.crushtool --device cpu -d "
        f"basic.crush -o {tmp_path}/rt1.crush && python -m "
        "ceph_tpu_torch.tools.osdmaptool --device cpu c.json")


@pytest.mark.parametrize("path", TRANSCRIPTS,
                         ids=[p.name for p in TRANSCRIPTS])
def test_transcript_on_the_port(path, tmp_path):
    blocks = parse_transcript(path.read_text())
    assert blocks, f"{path.name}: no command blocks"
    for cmd, expected in blocks:
        ported = port_command(cmd, tmp_path)
        assert "ceph_tpu.tools." not in ported
        got = run_command(ported).splitlines()
        assert got == expected, (
            f"{path.name}: transcript mismatch for {ported!r}\n"
            f"--- expected ---\n" + "\n".join(expected) +
            "\n--- got ---\n" + "\n".join(got))


SCALAR_BLOCKS = [(p.name, cmd, out) for p in TRANSCRIPTS
                 for cmd, out in parse_transcript(p.read_text())
                 if "--scalar" in cmd]


@pytest.mark.parametrize("name,cmd,expected", SCALAR_BLOCKS,
                         ids=[b[0] for b in SCALAR_BLOCKS])
def test_batched_mapper_prints_the_scalar_transcript(name, cmd, expected,
                                                     monkeypatch):
    """The command without ``--scalar``, in this process on the CPU."""
    from ceph_tpu_torch.tools import crushtool, osdmaptool
    words = shlex.split(cmd)
    assert words[:2] == ["python", "-m"]
    tool = {"ceph_tpu.tools.crushtool": crushtool,
            "ceph_tpu.tools.osdmaptool": osdmaptool}[words[2]]
    argv = [w for w in words[3:] if w != "--scalar"] + ["--device", "cpu"]
    monkeypatch.chdir(CLI_DIR)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tool.main(argv) == 0
    assert buf.getvalue().splitlines() == expected, name


def test_scalar_transcripts_cover_both_tools():
    tools = {shlex.split(cmd)[2] for _, cmd, _ in SCALAR_BLOCKS}
    assert tools == {"ceph_tpu.tools.crushtool", "ceph_tpu.tools.osdmaptool"}
    assert len(SCALAR_BLOCKS) == 6
