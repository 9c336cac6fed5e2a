"""The FLOP and byte counts against shapes worked by hand."""

import pytest

from portbench import counts


def test_cigp_step_at_n_4():
    # n^3 = 64; Gram 16 pairs x (3*2 + 3) = 144; gradient terms 8 * 16 = 128
    assert counts.cigp_step_flops(4, 2) == 64 + 144 + 128


def test_chol_cost_at_one_panel():
    flops, nbytes = counts.chol_cost(2, 64)
    assert flops == pytest.approx(2 * (64 ** 3 / 3 + 64 ** 3 / 3))
    tri = 64 * 65 / 2
    assert nbytes == 4 * 2 * (2 * tri + 64 * 64)


def test_tri_inv_cost_at_4096():
    flops, nbytes = counts.tri_inv_cost(4, 4096)
    assert flops == pytest.approx(4 * 4096 ** 3 / 3)
    assert nbytes == 4 * 4 * (4096 * 4097 + 4096 * 64)
    # operations bound it at this size
    assert counts.bound_s(flops, nbytes) == pytest.approx(flops / 67e12)


def test_bound_by_bytes_at_small_n():
    flops, nbytes = counts.chol_cost(4, 64)
    assert counts.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_ar_fit_sums_its_stages():
    one = counts.ar_fit_flops([8], 2, 4, 10, 3)
    two = counts.ar_fit_flops([8, 8], 2, 4, 10, 3)
    assert two == pytest.approx(2 * one)
    assert one == pytest.approx(41 * counts.cigp_step_flops(8, 2) + counts.cigp_export_flops(8, 2)
                                + counts.cigp_predict_flops(8, 3, 2))

