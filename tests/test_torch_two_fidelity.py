"""The port's two-fidelity compat layer (`models/two_fidelity.py`) against
the JAX package's on the CPU.

`find_subsets_and_indexes` is numpy in both: equal outputs.  The GAR
wrapper trains from the JAX model's init (`convert.load_state`) on the
JAX test's field fixture (`tests/test_two_fidelity.py:94`, 30 steps, one
restart) and is held to the JAX run: final NLML of each stage within 1e-4
of max(|NLML|, 1), means within 3e-4 of their largest magnitude (the
port's float64 eigh against JAX's float32 one on degenerate mode
spectra) and variances within 1e-3 (prior minus explained, both O(1)
against a result of ~0.15: float32 cancellation).  The vector wrappers delegate to the AR, NAR and ResGP
trainers that tests/test_torch_gpbasic.py holds to the JAX package; here
they are held to the JAX test's own bar (in-fill RMSE < 0.5 on the smooth
toy)."""

import jax
import numpy as np
import pytest

from fidelityfusion_tpu.models import two_fidelity as J
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.models import two_fidelity as T


@pytest.mark.parametrize("case", ["rows", "flat_1d", "mixed_1d_2d", "multidim", "no_overlap"])
def test_find_subsets_and_indexes_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "rows":
        x_low = np.arange(8, dtype=np.float32).reshape(-1, 1)
        x_high = x_low[[1, 3, 5]]
    elif case == "flat_1d":
        x_low, x_high = np.arange(8, dtype=np.float32), np.asarray([1.0, 3.0, 5.0], np.float32)
    elif case == "mixed_1d_2d":
        x_low, x_high = np.arange(8, dtype=np.float32), np.asarray([[1.0], [5.0]], np.float32)
    elif case == "multidim":
        x_low = rng.random((10, 3)).astype(np.float32)
        x_high = x_low[[7, 0, 4]]
    else:
        x_low, x_high = rng.random((6, 2)), rng.random((4, 2)) + 2.0
    for got, want in zip(T.find_subsets_and_indexes(x_low, x_high),
                         J.find_subsets_and_indexes(x_low, x_high)):
        np.testing.assert_array_equal(got, want)


def test_find_subsets_dim_mismatch_raises():
    with pytest.raises(ValueError):
        T.find_subsets_and_indexes(np.zeros((4, 2)), np.zeros((3, 5)))


@pytest.fixture(scope="module")
def vector_data():
    rng = np.random.default_rng(3)
    x_low = np.sort(rng.random((40, 1)).astype(np.float32) * 10, axis=0)
    x_high = x_low[:24]
    return [x_low, x_high], [np.sin(x_low) - 0.5 * np.sin(2 * x_low), np.sin(x_high)]


@pytest.mark.parametrize("name", ["AR", "NAR", "ResGP"])
def test_two_fidelity_vector_models(name, vector_data):
    cls, train = {"AR": (T.ARTwoFidelity, T.train_AR_twofidelity),
                  "NAR": (T.NARTwoFidelity, T.train_NAR_twofidelity),
                  "ResGP": (T.ResGPTwoFidelity, T.train_ResGP_twofidelity)}[name]
    model = cls(device="cpu")
    train(model, *vector_data, max_iter=60, lr_init=5e-2, n_restarts=1)
    x_test = np.linspace(0.5, 9.5, 30, dtype=np.float32).reshape(-1, 1)
    mean, cov = model.forward(x_test)
    mean = mean.detach().numpy()
    assert mean.shape == (30, 1) and np.isfinite(mean).all()
    assert np.sqrt(np.mean((mean - np.sin(x_test)) ** 2)) < 0.5


def test_two_fidelity_gar_from_jax_init_matches_jax():
    rng = np.random.default_rng(5)
    x_low = rng.random((20, 1)).astype(np.float32)
    x_high = x_low[:12]
    y_low = np.sin(2 * np.pi * x_low)[:, :, None] * np.ones((1, 4, 4), np.float32)
    y_high = np.sin(2 * np.pi * x_high)[:, :, None] * np.ones((1, 6, 6), np.float32)
    jm = J.GARTwoFidelity((4, 4), (6, 6))
    init = jax.tree_util.tree_map(np.asarray, jm.model.params)
    jhist = J.train_GAR_twofidelity(jm, [x_low, x_high], [y_low, y_high], max_iter=30,
                                    lr_init=5e-2, n_restarts=1)
    jmean, jvar = (np.asarray(a) for a in jm.forward(x_high[:5]))
    tm = T.GARTwoFidelity((4, 4), (6, 6), device="cpu")
    load_state(tm.model, init)
    hist = T.train_GAR_twofidelity(tm, [x_low, x_high], [y_low, y_high], max_iter=30,
                                   lr_init=5e-2, n_restarts=1)
    for h, jh in zip(hist, jhist):
        h, jh = h.numpy(), np.asarray(jh)
        assert abs(h[-1] - jh[-1]) <= 1e-4 * max(abs(jh[-1]), 1.0), (h[-1], jh[-1])
    mean, var = (a.detach().numpy() for a in tm.forward(x_high[:5]))
    assert mean.shape == (5, 6, 6)
    # the port decomposes its float32 Grams in float64, the JAX package in
    # float32: on these rank-one fields (degenerate mode spectra) that moves
    # the trained means by up to 1.4e-4 of their scale, hence 3e-4; the
    # variance is prior - explained, both O(1) against a result of ~0.15
    # (float32 cancellation, 5.8e-5 measured), hence 1e-3 of its scale
    np.testing.assert_allclose(mean, jmean, atol=3e-4 * np.abs(jmean).max())
    np.testing.assert_allclose(var, jvar, atol=1e-3 * np.abs(jvar).max())


def test_forward_before_train_raises():
    with pytest.raises(RuntimeError):
        T.ARTwoFidelity(device="cpu").forward(np.zeros((3, 1), np.float32))
