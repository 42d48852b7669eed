"""The frozen arithmetic, pinned to the values the repository's kernel
table was measured against."""

import pytest

from benchmark import peaks


def test_rank_pass_bound_of_k1_at_four_targets():
    ms, by = peaks.bound(*peaks.rank_pass(2048, 200_000, 64, 4))
    assert by == 'operations'
    assert ms == pytest.approx(0.831, abs=5e-4)


def test_rank_pass_bound_of_k1m():
    ms, by = peaks.bound(*peaks.rank_pass(2048, 200_000, 64, 1, 4))
    assert by == 'operations'
    assert ms == pytest.approx(6.419, abs=5e-4)


def test_dense_adam_bytes_of_mf_bpr_msd():
    params = 1_019_318 * 65 + 384_546 * 65
    assert params == 91_251_160
    assert peaks.dense_adam_bytes(params) / 1e9 == pytest.approx(2.190,
                                                                 abs=5e-4)
    ms, by = peaks.bound(*peaks.bilinear_step(8192, 64, params))
    assert by == 'bytes'
    assert ms == pytest.approx(0.654, abs=0.005)


def test_target_compares_search_the_sorted_targets_past_four():
    assert [peaks.target_compares(t) for t in (1, 2, 4, 8, 1000)] == [
        1, 2, 4, 5, 11]


def test_no_fma_floor():
    assert peaks.no_fma_floor_ms(2048, 200_000, 64) == pytest.approx(
        1.565, abs=5e-4)
