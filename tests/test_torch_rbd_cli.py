"""The port's ``rbd`` CLI against the reference's.

Twins of ``tests/test_rbd_cli.py``: each scenario runs once in each
package (``tests/torch_twin.py``) on the sim of ``tests/test_snaps``'s
size, the port on the CPU, and records every command's exit code and
output; the records and every object of the sims must be equal.  The
tool takes an injected ioctx and no ``--device``: its device is the
ioctx's sim's.  One more scenario runs the image family on the
erasure-coded pool.
"""
import importlib
import io
import json

from tests.torch_twin import assert_twin, make_sim, open_ioctx


def tools(pkg):
    root = "ceph_tpu" if pkg.name == "ref" else "ceph_tpu_torch"
    return (importlib.import_module(f"{root}.tools.rbd_cli"),
            importlib.import_module(f"{root}.client.rbd"))


def runner(pkg, pool="rep"):
    rbd_cli, rbd = tools(pkg)
    ioctx = open_ioctx(pkg, make_sim(pkg), pool)

    def run(*args):
        out = io.StringIO()
        rc = rbd_cli.main(list(args), ioctx=ioctx, out=out)
        return rc, out.getvalue()

    return run, ioctx, rbd.Image


def image_lifecycle(pkg):
    run, _, _ = runner(pkg)
    return [run("create", "disk", "--size", str(1 << 22)), run("ls"),
            run("create", "disk", "--size", "1024"),
            run("info", "disk"),
            run("resize", "disk", "--size", str(1 << 23)),
            run("info", "disk"), run("rm", "disk"), run("ls"),
            run("info", "disk")]


def test_image_lifecycle(monkeypatch):
    rec = assert_twin(image_lifecycle, monkeypatch)
    assert rec[0][0] == 0 and json.loads(rec[1][1]) == ["disk"]
    assert rec[2][0] == 1                            # duplicate
    info = json.loads(rec[3][1])
    assert info["size"] == 1 << 22 and info["parent"] is None
    assert json.loads(rec[5][1])["size"] == 1 << 23
    assert json.loads(rec[7][1]) == [] and rec[8][0] == 1


def snap_and_clone_family(pkg, pool="rep"):
    run, ioctx, Image = runner(pkg, pool)
    rec = [run("create", "base", "--size", str(1 << 22))]
    Image(ioctx, "base").write(0, b"golden-bytes")
    rec += [run("snap", "create", "base@gold"), run("snap", "ls", "base")]
    Image(ioctx, "base").write(0, b"BROKEN-BYTES")
    rec += [run("snap", "rollback", "base@gold")]
    rec.append(Image(ioctx, "base").read(0, 12))
    rec += [run("snap", "protect", "base@gold"),
            run("clone", "base@gold", "child"),
            run("children", "base@gold"),
            run("snap", "create", "base@other"),
            run("snap", "protect", "base@other"),
            run("clone", "base@other", "child2"),
            run("children", "base@gold"), run("children", "base@other"),
            run("flatten", "child2"), run("snap", "unprotect", "base@other"),
            run("snap", "rm", "base@other")]
    rec.append(Image(ioctx, "child").read(0, 12))
    rec += [run("snap", "rm", "base@gold"), run("flatten", "child"),
            run("info", "child"), run("snap", "unprotect", "base@gold"),
            run("snap", "rm", "base@gold"), run("children", "base@gone"),
            run("info", "base")]
    return rec


def test_snap_and_clone_family(monkeypatch):
    rec = assert_twin(snap_and_clone_family, monkeypatch)
    assert rec[4] == b"golden-bytes"
    assert json.loads(rec[2][1]) == ["gold"]
    assert json.loads(rec[7][1]) == ["child"]
    assert json.loads(rec[11][1]) == ["child"]
    assert json.loads(rec[12][1]) == ["child2"]
    assert rec[16] == b"golden-bytes"
    assert rec[17][0] == 1          # protected snap with a child
    assert json.loads(rec[19][1])["parent"] is None
    assert rec[21][0] == 0 and rec[22][0] == 1


def test_snap_and_clone_family_on_the_ec_pool(monkeypatch):
    """On the EC pool the partial write drops the object's SnapSet in
    both packages (ROADMAP C), so the rollback reads the head back: the
    twin holds the port to the reference's answer."""
    rec = assert_twin(lambda pkg: snap_and_clone_family(pkg, "ec"),
                      monkeypatch)
    assert rec[0][0] == 0 and json.loads(rec[2][1]) == ["gold"]
    assert rec[21][0] == 0 and rec[22][0] == 1
