"""CAR-large and FIDES against the JAX package on the CPU: the kernels'
values and gradients on the same seeded inputs and parameters (the JAX MC
draws carried across with `convert.py`), fits from the JAX init, and
predictions with JAX-trained parameters against the JAX models recomputed
in float64.  Staged CAR is in tests/test_torch_car.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models import car as JCAR
from fidelityfusion_tpu.models import fides as JFD
from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
from fidelityfusion_tpu.ops.kernels import ARDKernel as JARD
from fidelityfusion_tpu.train.fit import fit as jfit
from fidelityfusion_tpu_torch.convert import load_state, params_from_numpy
from fidelityfusion_tpu_torch.demo import _toy_3fid
from fidelityfusion_tpu_torch.models import car as TCAR
from fidelityfusion_tpu_torch.models import fides as TFD
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel as TARD
from fidelityfusion_tpu_torch.train.fit import fit as tfit
from tests.torch_port_checks import _np, perturbed, value_and_grads_match


def _xs(rng, n1, n2):
    """Joint [x, s] inputs of CAR-large: x standard normal, s in {1, 2, 3}."""
    def one(n):
        return np.concatenate([rng.standard_normal((n, 1)), rng.integers(1, 4, (n, 1))],
                              axis=1).astype(np.float32)
    return one(n1), one(n2)


@pytest.mark.parametrize("same", [True, False], ids=["training-gram", "cross-gram"])
def test_continuous_fidelity_kernel_value_and_grad_match_jax(same):
    """The Gram (with phi computed once where x1 is x2) and the gradient of
    a weighted sum of it, every parameter; rtol 1e-4."""
    rng = np.random.default_rng(0)
    jk, tk = JCAR.ContinuousFidelityKernel(base=JARD()), TCAR.ContinuousFidelityKernel(base=TARD())
    p = perturbed(jk.init_params(1), rng)
    x1, x2 = _xs(rng, 30, 20)
    x2 = x1 if same else x2
    wts = rng.standard_normal((30, len(x2))).astype(np.float32)
    jx1, jx2 = jnp.asarray(x1), jnp.asarray(x2)
    tx1 = torch.tensor(x1)
    tx2 = tx1 if same else torch.tensor(x2)
    value_and_grads_match(lambda q: jnp.sum(jk.apply(q, jx1, jx2) * wts),
                           lambda q: (tk.apply(q, tx1, tx2) * torch.tensor(wts)).sum(),
                           p, rtol=1e-4, atol=1e-6)
    with torch.no_grad():
        diag = tk.diag(params_from_numpy(p, "cpu"), tx1)
    np.testing.assert_allclose(diag.numpy(), np.diagonal(np.asarray(
        jk.apply(jax.tree_util.tree_map(jnp.asarray, p), jx1, jx1))), rtol=1e-5)


BOUNDS = [(0.0, 1.0, 0.0, 1.0), (0.0, 0.5, 0.0, 2.0)]


@pytest.mark.parametrize("bounds", BOUNDS, ids=["unit", "mixed"])
def test_fides_kernel_and_nll_match_jax(bounds):
    """FIDES's Gram (value and gradient of a weighted sum, rtol 1e-4) and
    its NLML (value rtol 1e-5, gradients 2e-3), every parameter."""
    rng = np.random.default_rng(1)
    jf, tf = JFD.FIDES(), TFD.FIDES()
    p = perturbed(jf.init_params(1), rng, scale=0.2)
    jb, tb = JFD.FidelityBounds(*bounds), TFD.FidelityBounds(*bounds)
    x1, x2 = rng.standard_normal((25, 1)), rng.standard_normal((18, 1))
    wts = rng.standard_normal((25, 18))
    value_and_grads_match(
        lambda q: jnp.sum(jf.kernel(q, jnp.asarray(x1, jnp.float32),
                                    jnp.asarray(x2, jnp.float32), jb) * wts),
        lambda q: (tf.kernel(q, torch.tensor(x1, dtype=torch.float32),
                             torch.tensor(x2, dtype=torch.float32), tb)
                   * torch.tensor(wts, dtype=torch.float32)).sum(),
        p, rtol=1e-4, atol=1e-6)
    y = (np.sin(2 * x1) + 0.1 * rng.standard_normal((25, 1))).astype(np.float32)
    x = x1.astype(np.float32)
    value_and_grads_match(lambda q: jf.nll(q, jnp.asarray(x), jnp.asarray(y), jb),
                           lambda q: tf.nll(q, torch.tensor(x), torch.tensor(y), tb),
                           p, rtol=1e-5, atol=1e-5)
    assert not np.allclose(tf.kernel(params_from_numpy(p, "cpu"), torch.tensor(x), torch.tensor(x),
                                     TFD.FidelityBounds(0.0, 2.0, 0.0, 2.0)).numpy(),
                           np.asarray(jf.kernel(jax.tree_util.tree_map(jnp.asarray, p),
                                                jnp.asarray(x), jnp.asarray(x), jb)))


def test_fides_fit_and_predictions_match_jax():
    """A 20-step FIDES fit from the JAX init: every step's loss within 1e-3
    of max(|NLML|, rows) of the JAX package's; `predict` and `predict_full`
    with the JAX-trained parameters within rtol 1e-4, of their scale, of
    the JAX package's in float64 (a (co)variance's scale: the prior
    variance it cancels from)."""
    rng = np.random.default_rng(0)
    x = (rng.random((40, 1)) * 6).astype(np.float32)
    y = (np.sin(x) + 0.05 * rng.standard_normal((40, 1))).astype(np.float32)
    xt = np.linspace(0, 6, 30, dtype=np.float32)[:, None]
    jf, tf = JFD.FIDES(), TFD.FIDES()
    jb, tb = JFD.FidelityBounds(0.0, 1.0, 0.0, 1.0), TFD.FidelityBounds(0.0, 1.0, 0.0, 1.0)
    p0 = jf.init_params(1)
    jres = jfit(lambda p: jf.nll(p, jnp.asarray(x), jnp.asarray(y), jb), p0, steps=20, lr=5e-2)
    tres = tfit(tf.nll, params_from_numpy(_np(p0), "cpu"), steps=20, lr=5e-2,
                loss_args=(torch.tensor(x), torch.tensor(y), tb))
    jl, tl = np.asarray(jres.losses), tres.losses.numpy()
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3 * max(np.abs(jl).max(), len(x)), rtol=0)
    tp = params_from_numpy(_np(jres.params), "cpu")
    T = torch.tensor
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                     jres.params)
        x64, y64, xt64 = (jnp.asarray(a, jnp.float64) for a in (x, y, xt))
        want = [np.asarray(a) for a in jax.jit(jf.predict, static_argnums=4)(
            p64, x64, y64, xt64, jb)]
        want_full = [np.asarray(a) for a in jax.jit(jf.predict_full, static_argnums=4)(
            p64, x64, y64, xt64, jb)]
    with torch.no_grad():
        got = tf.predict(tp, T(x), T(y), T(xt), tb)
        got_full = tf.predict_full(tp, T(x), T(y), T(xt), tb)
        prior = float(tf.gram_args(tp, 1, tb)[1] + tf.noise(tp))
    for g, w, scale in zip((*got, *got_full), (*want, *want_full),
                           (np.abs(want[0]).max(), prior, np.abs(want[0]).max(), prior)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * scale)
    assert (got[1] > 0).all()


def test_car_large_fit_and_forward_match_jax():
    """CAR-large from the JAX init (its _w and _t carried across) on three
    stacked fidelities: every step's loss within 1e-3 of max(|NLML|, rows)
    of the JAX package's; then, with the JAX-trained parameters, the mean
    within rtol 1e-4, of its scale, of the JAX model's in float64 and the
    covariance within 1e-4 of the prior variance."""
    xs, ys, x_test, _ = _toy_3fid(seed=4, sizes=(64, 48, 32), pool=200, nested=True)
    entries = [{"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
               for i, (x, y) in enumerate(zip(xs, ys))]
    jdm, jm = JDM(entries), JCAR.ContinuousAutoRegressionLarge(3, JARD())
    init = _np(jm.params)
    jl = np.asarray(JCAR.train_CAR_large(jm, jdm, max_iter=20, lr_init=5e-2))
    dm = TDM(entries)
    model = TCAR.ContinuousAutoRegressionLarge(3, TARD(), device="cpu")
    load_state(model, init)
    tl = TCAR.train_CAR_large(model, dm, max_iter=20, lr_init=5e-2).numpy()
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3 * max(np.abs(jl).max(), 144), rtol=0)

    load_state(model, _np(jm.params))
    x_tr, y_tr = jm._joint_train_data(jdm)
    norm = jdm.normalizelayer[2]
    xt = np.concatenate([norm.normalize_x(x_test), np.full((len(x_test), 1), 3.0)], axis=1)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                     jm.params)
        m, c = (np.asarray(a) for a in jax.jit(jm.gp.predict)(
            p64, *(jnp.asarray(np.asarray(a, np.float64)) for a in (x_tr, y_tr, xt))))
    m64, c64 = m * norm.y_std + norm.y_mean, c * norm.y_std ** 2
    got_m, got_c = model.forward(dm, x_test)
    np.testing.assert_allclose(got_m.numpy(), m64, rtol=1e-4, atol=1e-4 * np.abs(m64).max())
    np.testing.assert_allclose(got_c.numpy(), c64, atol=1e-4 * np.abs(np.diagonal(c64)).max())
