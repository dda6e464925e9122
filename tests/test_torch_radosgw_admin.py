"""The port's ``radosgw-admin`` against the reference's.

Twins of ``tests/test_radosgw_admin.py``: each scenario runs once in each
package (``tests/torch_twin.py``, which seeds the access keys and the
gateway's clock alike in both), the port on the CPU, and records every
command's exit code and output; the records and every object of the sims
must be equal.  The tool takes an injected ioctx and no ``--device``.
"""
import importlib
import io
import json

import pytest

from tests.torch_twin import assert_twin, make_sim, open_ioctx, outcome


def exits(fn):
    """``outcome`` that also records argparse's SystemExit by its code."""
    try:
        return outcome(fn)
    except SystemExit as e:
        return ("raised", "SystemExit", e.code)


def admin(pkg):
    root = "ceph_tpu" if pkg.name == "ref" else "ceph_tpu_torch"
    return importlib.import_module(f"{root}.tools.radosgw_admin").main


def runner(pkg, pool="rep"):
    main = admin(pkg)
    ioctx = open_ioctx(pkg, make_sim(pkg), pool)

    def run(*args):
        out = io.StringIO()
        rc = main(list(args), ioctx=ioctx, out=out)
        return rc, out.getvalue()

    return run, ioctx


def user_lifecycle(pkg):
    run, _ = runner(pkg)
    return [run("user", "create", "--uid", "alice", "--display-name",
                "Alice"),
            run("user", "create", "--uid", "alice"),
            run("user", "list"), run("key", "create", "--uid", "alice"),
            run("user", "info", "--uid", "alice"),
            run("user", "suspend", "--uid", "alice"),
            run("user", "enable", "--uid", "alice"),
            run("user", "rm", "--uid", "alice"),
            run("user", "info", "--uid", "alice")]


def test_user_lifecycle(monkeypatch):
    rec = assert_twin(user_lifecycle, monkeypatch)
    user = json.loads(rec[0][1])
    assert rec[0][0] == 0 and user["uid"] == "alice" and \
        user["keys"][0]["access_key"]
    assert rec[1][0] == 1 and "UserAlreadyExists" in rec[1][1]
    assert json.loads(rec[2][1]) == ["alice"]
    assert len(json.loads(rec[4][1])["keys"]) == 2
    assert rec[7][0] == 0 and rec[8][0] == 1


def bucket_and_gc(pkg, pool="rep"):
    run, ioctx = runner(pkg, pool)
    b = pkg.gw.RGWGateway(ioctx).create_bucket("data")
    b.put_object("a", b"x" * 100)
    b.put_object("b", b"y" * 50)
    rec = [run("bucket", "list"), run("bucket", "stats", "--bucket", "data"),
           run("bucket", "stats")]
    b.put_object("a", b"z" * 100)
    rec += [run("gc", "list"), run("gc", "process"), run("gc", "list"),
            run("bucket", "limit", "check", "--max-entries", "2"),
            run("bucket", "reshard", "--bucket", "data",
                "--num-shards", "3"),
            run("bucket", "stats", "--bucket", "data"),
            run("bucket", "limit", "check")]
    return rec


@pytest.mark.parametrize("pool", ["rep", "ec"])
def test_bucket_and_gc_commands(monkeypatch, pool):
    rec = assert_twin(lambda pkg: bucket_and_gc(pkg, pool), monkeypatch)
    assert json.loads(rec[0][1]) == ["data"]
    st = json.loads(rec[1][1])["data"]
    assert st["num_objects"] == 2 and st["size"] == 150
    assert rec[3][0] == rec[4][0] == 0
    rows = {r["bucket"]: r for r in json.loads(rec[6][1])}
    assert rows["data"]["fill_status"] == "WARN"    # 2 of 2 entries
    assert json.loads(rec[7][1])["num_shards"] == 3
    assert json.loads(rec[8][1])["data"]["num_shards"] == 3


def realm_family(pkg):
    run, _ = runner(pkg)
    return [run("realm", "create", "--realm", "earth"),
            run("zonegroup", "create", "--realm", "earth",
                "--rgw-zonegroup", "us", "--master"),
            run("zone", "create", "--realm", "earth", "--rgw-zonegroup",
                "us", "--rgw-zone", "us-east", "--master"),
            run("period", "update", "--realm", "earth"),
            run("period", "update", "--commit", "--realm", "earth"),
            run("period", "list", "--realm", "earth"),
            run("period", "get", "--realm", "earth")]


def test_realm_command_family(monkeypatch):
    rec = assert_twin(realm_family, monkeypatch)
    assert json.loads(rec[1][1])["name"] == "us"
    assert json.loads(rec[3][1]) == {"staged": True}
    p = json.loads(rec[4][1])
    assert rec[4][0] == 0 and p["epoch"] == 1
    assert p["zonegroups"]["us"]["master_zone"] == "us-east"
    assert json.loads(rec[5][1]) == [p["period_id"]]
    assert json.loads(rec[6][1])["period_id"] == p["period_id"]


def failed_commands(pkg):
    run, ioctx = runner(pkg)
    rec = [exits(lambda: run("user", "frobnicate", "--uid", "x")),
           exits(lambda: run("user")),
           exits(lambda: run("user", "create")),
           sorted(ioctx.list_objects())]
    users = pkg.users.UserStore(ioctx)
    users.create("carol")
    ioctx.write_full("rgw.user.carol", b"{torn-json")
    rec += [run("user", "info", "--uid", "carol"),
            run("user", "create", "--uid", "carol")]
    return rec


def test_failed_command_does_not_create_realm(monkeypatch):
    rec = assert_twin(failed_commands, monkeypatch)
    assert [r[:2] for r in rec[:3]] == [("raised", "SystemExit")] * 3
    assert not any(o.startswith("rgw.realm.") for o in rec[3])
    assert rec[4][0] == rec[5][0] == 1 and "CorruptUser" in rec[5][1]
