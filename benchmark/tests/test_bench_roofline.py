"""The frozen yardstick (`benchmark/roofline/counts.py`) gives the Bound
column of PERF.md's table of kernels, rows 1-7, as the port's on-card
checks printed it (ms)."""

import pytest

from benchmark.roofline import counts

ROWS = [  # (row, work, the printed bound in ms, its digits)
    (1, counts.sponge_work(768, 832, 32, 136), 0.00139),  # K1 c_tilde [768, 832 B] -> 32 B
    (2, counts.mask_limbs_work(768, 5, 20), 0.00496),  # K2 W = 768, L = 5
    (3, counts.ball_stream_work(768, 272), 0.000297),  # K3 level 3, B = 768, 272 B: whole stream
    (4, counts.ntt_work(30, True), 0.0000184),  # K4 inverse [30, 256]
    (5, counts.permute_work(131072), 0.0339),  # K5 planes [25, 131072]
    (6, counts.sponge_planes_work(20480, 34, 66, 160, 136), 0.0264),  # K6 [34, 20480] -> [20480, 160]
    (7, counts.ball_stream_work(16384, 272), 0.00634),  # K7 B = 16384, 272 B: whole stream
]


@pytest.mark.parametrize("row, work, printed", ROWS, ids=[f"row{r[0]}" for r in ROWS])
def test_bound_column(row, work, printed):
    assert counts.bound_s(work) * 1e3 == pytest.approx(printed, rel=5e-3)


def test_ball_lower_bound_under_walked_bound():
    """SampleInBall's bound without its stream (one byte a take) is below
    the bound of the bytes the walks read (rows 3 and 7: 0.000254 and
    0.00542 ms)."""
    assert counts.bound_s(counts.ball_work(768, 49)) * 1e3 <= 0.000254
    assert counts.bound_s(counts.ball_work(16384, 49)) * 1e3 <= 0.00542


def test_peaks():
    assert counts.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert counts.bound_s(counts.int8_gemm_work(16384, 1280, 4608), counts.INT8_OPS_PER_S) == pytest.approx(
        max((16384 * 1280 + 1280 * 4608 + 4 * 16384 * 4608) / 3.35e12, 2 * 16384 * 1280 * 4608 / 1979e12))
