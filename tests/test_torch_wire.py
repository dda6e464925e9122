"""The port's wire integrity tier against ceph_tpu: the crc algebra
(common/crcutil.py), the device crc (ops/crc32_gf2.py, K3's crc leg on
the card, its plain version here) and the framing layer (msg/wire.py).

All exact: crc32 values, Csums (block, subs, length, combined) and frame
bytes must equal the reference's and zlib's.  The port's receive verify
differs from the reference's on purpose in two ways, each pinned here:
a device-crc failure raises instead of host-scanning, and whether
``wire_device_crc=auto`` engages is asked of the default device on every
call (no process cache).
"""
import os
import random
import socket
import threading
import zlib

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.common import crcutil as ref_crcutil
from ceph_tpu.msg import encoding as ref_encoding
from ceph_tpu.msg import wire as ref_wire
from ceph_tpu.ops import crc32_gf2 as ref_crc
from ceph_tpu_torch.common import auth, crcutil, faults
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.msg import encoding, wire
from ceph_tpu_torch.ops import crc32_gf2

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


@pytest.fixture
def on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def _cs(c):
    return (c.block, list(c.subs), c.length, c.combined)


def _zero():
    return perf("wire.zero").dump()


def _delta(a, b, key):
    return b.get(key, 0) - a.get(key, 0)


# ------------------------------------------------------- combine algebra --

def test_crc32_combine_matches_zlib_and_reference():
    rng = random.Random(7)
    for _ in range(100):
        n = rng.randrange(0, 6000)
        data = os.urandom(n)
        cut = rng.randrange(0, n + 1)
        a, b = data[:cut], data[cut:]
        got = crcutil.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
        assert got == zlib.crc32(data) == ref_crcutil.crc32_combine(
            zlib.crc32(a), zlib.crc32(b), len(b))
    assert crcutil.crc32_combine(0, 0, 0) == 0
    assert crcutil.crc32_combine(zlib.crc32(b"x"), zlib.crc32(b"y"),
                                 1) == zlib.crc32(b"xy")


@pytest.mark.parametrize("block", [1, 3, 512, 4096, 65536])
def test_one_pass_scan_equals_reference(block):
    rng = random.Random(block)
    for _ in range(6):
        n = rng.randrange(0, 40000)
        data = os.urandom(n)
        cs = crcutil.Csums.scan(data, block=block)
        assert _cs(cs) == _cs(ref_crcutil.Csums.scan(data, block=block))
        assert cs.combined == zlib.crc32(data)
        assert _cs(crcutil.Csums(block, cs.subs, n)) == _cs(cs)


def test_combine_series_and_zero_matrices_equal_reference():
    parts = [os.urandom(n) for n in (0, 1, 4096, 777, 0, 9000)]
    crc = crcutil.combine_series(
        0, [zlib.crc32(p) for p in parts], [len(p) for p in parts])
    assert crc == zlib.crc32(b"".join(parts))
    for n in (0, 1, 7, 4096, 123457):
        assert crcutil._zero_matrix(n) == ref_crcutil._zero_matrix(n)


# ------------------------------------------------------------ device crc --

@pytest.mark.parametrize("block", [1, 64, 512, 4096])
def test_crc32_blocks_equals_reference_and_zlib(block, on_cpu):
    rng = np.random.default_rng(block)
    blocks = rng.integers(0, 256, (6, block), dtype=np.uint8)
    want = np.array([zlib.crc32(r.tobytes()) for r in blocks],
                    dtype=np.uint32)
    A, c = crc32_gf2.crc_matrix(block)
    rA, rc = ref_crc.crc_matrix(block)
    assert c == rc and (A == rA).all()
    assert (crc32_gf2.crc32_blocks_np(blocks) == want).all()
    assert (ref_crc.crc32_blocks(blocks, block=block) == want).all()
    p0 = crc32_gf2.plain_runs
    got = crc32_gf2.crc32_blocks(blocks, block=block)
    assert crc32_gf2.plain_runs == p0 + 1
    assert got.dtype == np.uint32 and (got == want).all()
    t = crc32_gf2.crc32_blocks(torch.from_numpy(blocks), block=block)
    assert (t == want).all()


@pytest.mark.parametrize("block", [1, 64, 512, 4096])
def test_csums_many_with_tails_equals_reference(block, on_cpu):
    bufs = [os.urandom(n) for n in (0, 100, 512, 5000, 1536, 3 * 4096 + 7)]
    got = crc32_gf2.csums_many(bufs, block=block)
    want = ref_crc.csums_many(bufs, block=block)
    for buf, g, w in zip(bufs, got, want):
        assert _cs(g) == _cs(w)
        assert g.combined == zlib.crc32(buf)
        assert g.subs == [zlib.crc32(buf[o:o + block])
                          for o in range(0, len(buf), block)]


@pytest.mark.parametrize("block", [64, 4096])
def test_csums_many_from_tensors_equals_reference(block, on_cpu):
    """The same bytes given as tensors (int32 words, uint8, or None for
    a buffer held only on the host) give the reference's Csums: the
    full blocks are crc'd from the tensors, the tails from the host."""
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 100, 4 * 4096, 3 * 4096 + 8, 512)]
    tensors = [None, torch.from_numpy(np.frombuffer(bufs[1], np.uint8)
                                      .copy()),
               torch.from_numpy(np.frombuffer(bufs[2], "<i4").copy()),
               torch.from_numpy(np.frombuffer(bufs[3], "<i4").copy()
                                .reshape(2, -1)),
               None]
    got = crc32_gf2.csums_many(bufs, block=block, tensors=tensors)
    want = ref_crc.csums_many(bufs, block=block)
    for buf, g, w in zip(bufs, got, want):
        assert _cs(g) == _cs(w)
        assert g.combined == zlib.crc32(buf)
    with pytest.raises(ValueError, match="tensor of"):
        crc32_gf2.csums_many([bufs[2]], block=block, tensors=[tensors[1]])


def test_crc32_blocks_counts_and_rejects(on_cpu):
    z0 = _zero()
    crc32_gf2.crc32_blocks(np.zeros((3, 64), np.uint8), block=64)
    z1 = _zero()
    assert _delta(z0, z1, "device_crc_dispatches") == 1
    assert _delta(z0, z1, "device_crc_bytes") == 3 * 64
    with pytest.raises(ValueError, match=r"\[N, 64\]"):
        crc32_gf2.crc32_blocks(np.zeros((3, 65), np.uint8), block=64)
    with pytest.raises(TypeError):
        crc32_gf2.crc32_blocks(torch.zeros((3, 64), dtype=torch.int32),
                               block=64)


def test_crc32_blocks_of_an_empty_batch(on_cpu):
    """Intended divergence: the reference's jnp reshape divides by the
    batch size and raises; the port returns no crcs.  No caller sends an
    empty batch (csums_many dispatches only with a full block)."""
    empty = np.zeros((0, 4096), np.uint8)
    with pytest.raises(ZeroDivisionError):
        ref_crc.crc32_blocks(empty)
    got = crc32_gf2.crc32_blocks(empty)
    assert got.dtype == np.uint32 and got.shape == (0,)


def test_crc32_blocks_plain_refuses_blocks_of_2_mib():
    """Intended divergence: the plain version's float32 product is exact
    only below 2^21-byte blocks, so it refuses a 2 MiB block instead of
    returning an inexact crc (the reference's int32 product takes any
    size; on the card K3's crc leg does)."""
    with pytest.raises(ValueError, match="2\\^21-byte"):
        crc32_gf2.crc32_blocks_plain(
            torch.zeros((1, 2 << 20), dtype=torch.uint8))


# ------------------------------------------------------------ wire frames --

@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("mode", ["crc", "plain", "secure"])
def test_frame_parts_byte_identical_to_reference(folded, mode):
    """The port assembles exactly the reference's frame (header, payload
    and MAC), with and without precomputed csums folded into the crc."""
    key = None if mode == "plain" else os.urandom(32)
    wmode = wire.MODE_SECURE if mode == "secure" else wire.MODE_CRC
    meta = encoding.dumps({"cmd": "put_shard", "oid": "x"})
    assert meta == ref_encoding.dumps({"cmd": "put_shard", "oid": "x"})
    data = os.urandom(37 * 1024 + 5)
    parts = [wire._U32.pack(len(meta)), meta, data]
    kw = {}
    if folded:
        kw = {"data_csums": crcutil.Csums.scan(data)}
    if mode == "secure":
        # sealing draws a fresh nonce: compare the unsealed frames
        got = wire._frame_parts(wire.MSG_REQ_SG, 5, -1, list(parts), key,
                                wmode, **kw)
        env = wire._parse_frame(bytes(got[0]), b"".join(
            bytes(p) for p in got[1:-1]), bytes(got[-1]), key, wmode)
        assert bytes(env.payload) == b"".join(bytes(p) for p in parts)
        return
    ref_kw = {}
    if folded:
        ref_kw = {"data_csums": ref_crcutil.Csums.scan(data)}
    got = wire._frame_parts(wire.MSG_REQ_SG, 5, -1, list(parts), key,
                            wmode, **kw)
    want = ref_wire._frame_parts(ref_wire.MSG_REQ_SG, 5, -1, list(parts),
                                 key, wmode, **ref_kw)
    assert [bytes(p) for p in got] == [bytes(p) for p in want]
    legacy = wire._frame_parts(wire.MSG_REQ_SG, 5, -1, list(parts), key,
                               wmode)
    assert [bytes(p) for p in got] == [bytes(p) for p in legacy]


def test_sealed_box_interoperates_with_reference():
    key = os.urandom(32)
    msg = os.urandom(3000)
    from ceph_tpu.common import auth as ref_auth
    assert ref_auth.unseal(key, auth.seal(key, msg)) == msg
    assert auth.unseal(key, ref_auth.seal(key, msg)) == msg


def _sg_roundtrip(data, key, mode=wire.MODE_CRC, data_csums=None):
    a, b = socket.socketpair()
    try:
        meta = encoding.dumps({"cmd": "put_shard", "oid": "x"})
        rd = wire.SockReader(b)
        out = {}

        def reader():
            try:
                out["env"] = rd.read_frame(session_key=key, mode=mode)
            except Exception as e:          # surfaced by the caller
                out["env"] = e
        t = threading.Thread(target=reader)
        t.start()
        wire.send_frame_sg(a, wire.MSG_REQ_SG, 1, meta, data,
                           session_key=key, mode=mode,
                           data_csums=data_csums)
        t.join(20)
        assert not t.is_alive(), "reader thread hung"
        return meta, out["env"]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("device_crc", ["on", "off"])
def test_sg_receive_one_pass_csums_and_zero_copy_views(device_crc, on_cpu):
    key = os.urandom(32)
    data = os.urandom(200 * 1024 + 77)
    sent_csums = crcutil.Csums.scan(data, site="test")
    config().set("wire_device_crc", device_crc)
    try:
        z0 = _zero()
        meta, env = _sg_roundtrip(data, key, data_csums=sent_csums)
        z1 = _zero()
    finally:
        config().clear("wire_device_crc")
    assert env.type == wire.MSG_REQ_SG
    m2, d2 = wire.split_sg(env.payload)
    assert m2 == meta
    assert isinstance(d2, memoryview) and bytes(d2) == data
    assert _cs(env.csums) == _cs(ref_crcutil.Csums.scan(data))
    full = len(data) - len(data) % 4096
    head = 4 + len(meta)
    assert _delta(z0, z1, "scan_send_bytes") == head
    if device_crc == "on":
        assert _delta(z0, z1, "device_crc_bytes") == full
        assert _delta(z0, z1, "scan_verify_bytes") == head
        assert _delta(z0, z1, "scan_device_tail_bytes") == len(data) - full
    else:
        assert _delta(z0, z1, "device_crc_bytes") == 0
        assert _delta(z0, z1, "scan_verify_bytes") == head + len(data)


def test_sg_flip_bit_still_rejected(on_cpu):
    key = os.urandom(32)
    config().set("wire_device_crc", "on")
    faults.arm("wire.flip_bit", mode="always", count=1)
    try:
        _meta, env = _sg_roundtrip(os.urandom(96 * 1024), key)
    finally:
        faults.disarm("wire.flip_bit")
        config().clear("wire_device_crc")
    assert isinstance(env, wire.WireError)


def test_flip_bit_in_plaintext_payload_fails_the_device_crc(on_cpu):
    """No session key: the flipped bit lands in the payload's last byte
    and the device-verified combine rejects it."""
    config().set("wire_device_crc", "on")
    faults.arm("wire.flip_bit", mode="always", count=1)
    try:
        _meta, env = _sg_roundtrip(os.urandom(64 * 1024), None)
    finally:
        faults.disarm("wire.flip_bit")
        config().clear("wire_device_crc")
    assert isinstance(env, wire.WireError) and "crc" in str(env)


def test_legacy_flags_reproduce_old_behavior(on_cpu):
    key = os.urandom(32)
    data = os.urandom(128 * 1024)
    config().set("wire_one_pass", False)
    config().set("wire_zero_copy", False)
    try:
        c0 = _zero().get("copy_bytes", 0)
        _meta, env = _sg_roundtrip(data, key)
        assert env.csums is None
        _m, d2 = wire.split_sg(env.payload)
        assert isinstance(d2, bytes) and d2 == data
        assert _zero().get("copy_bytes", 0) > c0
    finally:
        config().clear("wire_one_pass")
        config().clear("wire_zero_copy")


# ----------------------------------------- receive verify: the divergences --

@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_receive_csums_modes_with_the_cpu_asked_for(mode, on_cpu):
    data = os.urandom(3 * 4096 + 11)
    config().set("wire_device_crc", mode)
    try:
        z0 = _zero()
        cs = wire.receive_csums(memoryview(data))
        z1 = _zero()
    finally:
        config().clear("wire_device_crc")
    assert _cs(cs) == _cs(ref_crcutil.Csums.scan(data))
    if mode == "on":           # the device program, here its plain version
        assert _delta(z0, z1, "device_crc_bytes") == 3 * 4096
        assert _delta(z0, z1, "scan_verify_bytes") == 0
    else:                      # off, and auto with the CPU asked for
        assert _delta(z0, z1, "device_crc_bytes") == 0
        assert _delta(z0, z1, "scan_verify_bytes") == len(data)


def test_auto_follows_the_default_device_without_a_cache():
    """The reference caches its backend probe for the process; the port
    asks the default device on every call, so a switch takes effect at
    once."""
    prev = ceph_tpu_torch.default_device()
    try:
        ceph_tpu_torch.set_default_device("cpu")
        assert wire._device_worthwhile() is False
        ceph_tpu_torch.set_default_device("cuda")
        assert wire._device_worthwhile() is True
        ceph_tpu_torch.set_default_device("cpu")
        assert wire._device_worthwhile() is False
        assert "worthwhile" not in wire._dev_crc
    finally:
        ceph_tpu_torch.set_default_device(prev)


def test_device_crc_failure_raises_instead_of_host_scanning():
    """``auto`` on a CUDA default device runs the device crc; when that
    fails (here: no card) the verify raises and nothing is host-scanned
    in its place — the reference would count a fallback and scan."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device crc runs")
    prev = ceph_tpu_torch.default_device()
    data = os.urandom(2 * 4096)
    try:
        ceph_tpu_torch.set_default_device("cuda")
        for mode in ("auto", "on"):
            config().set("wire_device_crc", mode)
            z0 = _zero()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                wire.receive_csums(data)
            z1 = _zero()
            assert _delta(z0, z1, "scan_verify_bytes") == 0
            assert _delta(z0, z1, "device_crc_fallbacks") == 0
    finally:
        config().clear("wire_device_crc")
        ceph_tpu_torch.set_default_device(prev)


# --------------------------------------------------------------- shm ring --

def test_shm_ring_put_read_and_seqlock(tmp_path):
    from ceph_tpu_torch.msg.shm_ring import RingReader, ShmRing
    ring = ShmRing.create(str(tmp_path), "t", 256 << 10)
    rdr = RingReader(ring.path, ring.size)
    try:
        toks = []
        while True:
            tok = ring.put(b"Q" * 60_000)
            if tok is None:
                break
            toks.append(tok)
        assert len(toks) >= 3
        view, cs = rdr.read(toks[0].meta)
        assert bytes(view) == b"Q" * 60_000
        ring.free(toks[0])
        assert ring.put(b"R" * 50_000) is not None
        with pytest.raises(wire.WireError):
            rdr.read(toks[0].meta)
    finally:
        rdr.close()
        ring.close(unlink=True)
