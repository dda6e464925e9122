"""The ZeroWire ingest chain end to end, through both packages at a few
objects: fused encode -> scatter-gather frames -> receive verify ->
BlueStore commit with trusted csums -> read back with trusted csums ->
reply frame -> receive verify.

The port runs the chain over a socket pair with ``wire_device_crc=on``
(the device crc program; on the CPU its plain version); the reference
runs the same steps with its own modules.  Parity, every Csums, every
frame's bytes, the stored blob csums and the read-back must be equal,
and the port's scan counters must show that no full block was scanned
on the host.  ``convert.csums_state`` carries a Csums between the
packages.
"""
import os
import socket
import threading
import zlib

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.cluster.bluestore import BlueStore as RefBlueStore
from ceph_tpu.cluster.objectstore import Transaction as RefTransaction
from ceph_tpu.common import crcutil as ref_crcutil
from ceph_tpu.msg import wire as ref_wire
from ceph_tpu.ops import ragged_fused as ref_rf
from ceph_tpu_torch import convert
from ceph_tpu_torch.cluster.bluestore import BlueStore
from ceph_tpu_torch.cluster.objectstore import Transaction
from ceph_tpu_torch.common import crcutil
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.msg import encoding, wire
from ceph_tpu_torch.ops import gf, ragged_fused

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

K, M = 4, 2
SIZES = [1, 4096, 4097, 9000, 12288]
KEY = bytes(range(32))


def _cs(c):
    return (c.block, list(c.subs), c.length, c.combined)


@pytest.fixture
def device_crc_on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    config().set("wire_device_crc", "on")
    yield
    config().clear("wire_device_crc")
    ceph_tpu_torch.set_default_device(prev)


def _shard_rows(shards, res, i):
    """Object i's k + m shard rows and their csums, in shard order."""
    rows = [shards[i][j] for j in range(K)] + \
        [res.parity[i][r] for r in range(M)]
    css = list(res.data_csums[i]) + list(res.parity_csums[i])
    return rows, css


def _read_frames(sock, n, out, sink):
    """Reader thread: n frames off ``sock``, each handed to ``sink``;
    an exception lands in ``out`` for the caller to raise."""
    rd = wire.SockReader(sock)
    try:
        for _ in range(n):
            sink(rd.read_frame(session_key=KEY, mode=wire.MODE_CRC))
    except Exception as e:
        out["error"] = e


def _send_all(frames, sink):
    a, b = socket.socketpair()
    out = {}
    t = threading.Thread(target=_read_frames, args=(b, len(frames), out,
                                                    sink))
    t.start()
    try:
        for typ, rid, meta, data, cs in frames:
            wire.send_frame_sg(a, typ, rid, meta, data, session_key=KEY,
                               mode=wire.MODE_CRC, data_csums=cs)
    finally:
        t.join(30)
        a.close()
        b.close()
    assert not t.is_alive(), "reader thread hung"
    if "error" in out:
        raise out["error"]


def test_ingest_chain_equals_reference(tmp_path, device_crc_on_cpu):
    rng = np.random.default_rng(7)
    A = gf.isa_rs_parity(K, M)
    shards = [rng.integers(0, 256, (K, n), dtype=np.uint8) for n in SIZES]

    # 1. fused encode in both packages
    res = ragged_fused.encode(A, shards)
    ref = ref_rf.encode(A, shards)
    for i in range(len(SIZES)):
        assert (res.parity[i] == np.asarray(ref.parity[i])).all()
        for g, w in zip(res.data_csums[i] + res.parity_csums[i],
                        ref.data_csums[i] + ref.parity_csums[i]):
            assert _cs(g) == _cs(w)

    # 2. frames: byte-identical to the reference's, csums folded
    frames, heads, full, tails = [], 0, 0, 0
    for i in range(len(SIZES)):
        rows, css = _shard_rows(shards, res, i)
        rrows, rcss = _shard_rows(shards, ref, i)
        for s, (row, cs) in enumerate(zip(rows, css)):
            meta = encoding.dumps({"cmd": "put_shard", "oid": f"o{i}",
                                   "shard": s})
            data = np.ascontiguousarray(row)
            parts = [wire._U32.pack(len(meta)), meta, data]
            got = wire._frame_parts(wire.MSG_REQ_SG, 1, -1, list(parts),
                                    KEY, wire.MODE_CRC, data_csums=cs)
            want = ref_wire._frame_parts(
                ref_wire.MSG_REQ_SG, 1, -1,
                [parts[0], meta, np.ascontiguousarray(rrows[s])], KEY,
                ref_wire.MODE_CRC, data_csums=rcss[s])
            assert [bytes(p) for p in got] == [bytes(p) for p in want]
            frames.append((wire.MSG_REQ_SG, len(frames) + 1, meta, data, cs))
            heads += 4 + len(meta)
            n = data.nbytes
            full += n - n % 4096
            tails += n % 4096

    # 3-4. over a socket, device verify, commit with the trusted csums
    stores = [BlueStore(str(tmp_path / f"port{s}"), device_bytes=4 << 20,
                        min_alloc=4096, fsync=False) for s in range(K + M)]
    refs = [RefBlueStore(str(tmp_path / f"ref{s}"), device_bytes=4 << 20,
                         min_alloc=4096, fsync=False) for s in range(K + M)]
    z0 = perf("wire.zero").dump()

    def commit(env):
        meta, data = wire.split_sg(env.payload)
        req = encoding.loads(meta)
        assert env.csums is not None
        stores[req["shard"]].apply_transaction(Transaction().write_full(
            (1, 0), req["oid"], data, csums=env.csums, copy=False))

    _send_all(frames, commit)
    z1 = perf("wire.zero").dump()

    def d(key, a=None, b=None):
        a, b = a or z0, b or z1
        return b.get(key, 0) - a.get(key, 0)

    assert d("scan_send_bytes") == heads
    assert d("scan_verify_bytes") == heads
    assert d("scan_store_bytes") == 0
    assert d("scan_device_tail_bytes") == tails
    assert d("device_crc_bytes") == full
    assert d("trusted_csum_bytes") == full + tails
    for i in range(len(SIZES)):
        rrows, rcss = _shard_rows(shards, ref, i)
        for s in range(K + M):
            refs[s].apply_transaction(RefTransaction().write_full(
                (1, 0), f"o{i}", np.ascontiguousarray(rrows[s]).tobytes(),
                csums=rcss[s], copy=False))

    # 5. read back with the trusted csums, reply frames verified on device
    replies, expect = [], {}
    for i in range(len(SIZES)):
        rows, _ = _shard_rows(shards, res, i)
        for s in range(K + M):
            data, cs = stores[s].read_with_csums((1, 0), f"o{i}")
            rdata, rcs = refs[s].read_with_csums((1, 0), f"o{i}")
            assert data == rdata == rows[s].tobytes()
            assert _cs(cs) == _cs(rcs)
            assert [list(b.csums) for b in
                    stores[s]._get((1, 0), f"o{i}").blobs] == \
                [list(b.csums) for b in refs[s]._get((1, 0), f"o{i}").blobs]
            meta = encoding.dumps({"oid": f"o{i}", "shard": s})
            rid = len(replies) + 1
            replies.append((wire.MSG_REPLY_SG, rid, meta, data, cs))
            expect[rid] = data
    got = {}

    def check(env):
        assert env.type == wire.MSG_REPLY_SG and env.csums is not None
        got[env.id] = bytes(wire.split_sg(env.payload)[1])

    z2 = perf("wire.zero").dump()
    _send_all(replies, check)
    z3 = perf("wire.zero").dump()
    assert got == expect
    assert d("device_crc_bytes", z2, z3) == full
    reply_heads = sum(4 + len(r[2]) for r in replies)
    assert d("scan_send_bytes", z2, z3) == reply_heads
    assert d("scan_verify_bytes", z2, z3) == reply_heads
    for st in stores + refs:
        st.close()


def test_flipped_reply_frame_is_rejected(device_crc_on_cpu):
    from ceph_tpu_torch.common import faults
    data = os.urandom(3 * 4096)
    cs = crcutil.Csums.scan(data, site="test")
    faults.arm("wire.flip_bit", mode="always", count=1)
    try:
        with pytest.raises(wire.WireError):
            _send_all([(wire.MSG_REPLY_SG, 1, b"m", data, cs)],
                      lambda env: None)
    finally:
        faults.disarm("wire.flip_bit")


def test_csums_cross_between_packages():
    data = os.urandom(2 * 4096 + 17)
    ref = ref_crcutil.Csums.scan(data, site="test")
    state = convert.csums_state(ref)
    port = convert.csums_from_state(state)
    assert isinstance(port, crcutil.Csums)
    assert _cs(port) == _cs(ref) and port.combined == zlib.crc32(data)
    back = convert.csums_from_state(convert.csums_state(port),
                                    cls=ref_crcutil.Csums)
    assert isinstance(back, ref_crcutil.Csums) and _cs(back) == _cs(ref)
    bad = dict(state, combined=state["combined"] ^ 1)
    with pytest.raises(ValueError, match="combine"):
        convert.csums_from_state(bad)
