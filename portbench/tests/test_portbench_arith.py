"""The frozen arithmetic and the readers' statistics, on hand-worked
cases."""
import pytest
import torch

from portbench import arith, readers
from portbench.reference import straw2


def test_ops_per_draw_is_the_hash():
    # 2 LOP3 for the seed XOR, 5 mixes x 9 lines x (IADD3, SHF, LOP3)
    assert arith.OPS_PER_DRAW == 137


def test_codec_bytes():
    # a 4 MiB object at 4 KiB units: 128 stripes of 8 data + 3 parity
    assert arith.encode_bytes(1, 128, 8, 3, 4096) == 5767168
    assert arith.encode_bytes(64, 128, 8, 3, 4096) == 64 * 5767168
    assert arith.decode_bytes(128, 8, 0, 4096) == 0
    assert arith.decode_bytes(128, 8, 2, 4096) == 128 * 10 * 4096


def test_codec_roofline():
    assert arith.codec_least_s(3.35e9) == pytest.approx(1e-3)
    assert arith.roofline_pct(1e-3, 2e-3) == pytest.approx(50.0)
    assert arith.roofline_pct(1e-3, 0) is None
    assert arith.roofline_pct(0, 1.0) is None


def test_placement_roofline():
    rate = 132 * 64 * 1.98e9
    assert arith.placement_least_s(10 ** 9, 1) == \
        pytest.approx(10 ** 9 * 137 / rate)
    # with no draws the table's one read bounds it
    assert arith.placement_least_s(0, 2) == \
        pytest.approx(2 * 65536 * 8 / 3.35e12)
    least = arith.placement_least_s(7.9e8, 1)
    assert arith.roofline_pct(least, 2.0) == \
        pytest.approx(100 * 7.9e8 * 137 / rate / 2.0)


def test_straw2_draws_without_retries():
    # one replica, all in: 3 host draws at the root, 2 in the host
    x = straw2.pps(1, 64, "cpu")
    rw = torch.full((6,), 0x10000, dtype=torch.int64)
    up, draws = straw2.map_firstn(x, 3, 2, rw, 1)
    assert (draws == 3 + 2).all() and len(draws) == 64
    assert (up[:, 0] < 6).all()


def test_straw2_draws_every_try_when_all_out():
    # one host, both OSDs out: 51 tries of 1 + 2 draws, no OSD found
    x = straw2.pps(1, 16, "cpu")
    up, draws = straw2.map_firstn(x, 1, 2, torch.zeros(2, dtype=torch.int64),
                                  1)
    assert (draws == 51 * 3).all() and len(draws) == 16
    assert (up == straw2.NONE).all()


def test_quantiles():
    xs = [float(i) for i in range(1, 21)]
    assert readers.p95(xs) == 19.0
    assert readers.p95([5.0]) == 5.0
    assert readers.p50(xs) == 10.5
    assert readers.p95([]) is None
    assert readers.per_gib(3, 2 ** 31) == 1.5
