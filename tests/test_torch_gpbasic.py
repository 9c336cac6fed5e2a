"""The port's `MCFidelityKernel`, `GPBasic` and restart ladder against the
JAX package on the CPU, on the same seeded inputs and parameters (the JAX
MC draws carried across with `convert.py`), and the CIGP cascades end to
end: AR (`train_AR`, `forward`, `export_posterior`), ResGP, NAR and
staged CAR, subset and non-subset; CAR-large and FIDES."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models import ar as JA
from fidelityfusion_tpu.models import car as JCAR
from fidelityfusion_tpu.models import cigp as JC
from fidelityfusion_tpu.models import fides as JFD
from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu.ops.kernels import ARDKernel as JARD
from fidelityfusion_tpu.ops.kernels import SquaredExponentialKernel as JSE
from fidelityfusion_tpu.train.fit import fit as jfit
from fidelityfusion_tpu.train.fit import gp_restart_batch as j_restart_batch
from fidelityfusion_tpu_torch.convert import load_state, params_from_numpy
from fidelityfusion_tpu_torch.demo import _toy_3fid
from fidelityfusion_tpu_torch.models import ar as TA
from fidelityfusion_tpu_torch.models import car as TCAR
from fidelityfusion_tpu_torch.models import cigp as TC
from fidelityfusion_tpu_torch.models import fides as TFD
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel as TARD
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel as TSE
from fidelityfusion_tpu_torch.train import fit as TF
from fidelityfusion_tpu_torch.train.fit import fit as tfit
from fidelityfusion_tpu_torch.train.fit import restart_scores
from tests import torch_port_checks as PC
from tests.torch_port_checks import _np, leaves, perturbed, value_and_grads_match


def _kernels(name):
    if name == "ARD":
        return JK.ARDKernel(), TK.ARDKernel()
    if name == "SE":
        return JK.SquaredExponentialKernel(), TK.SquaredExponentialKernel()
    jb, tb = _kernels(name.split("-")[1])
    return (JK.MCFidelityKernel(base=jb, lf=1.0, hf=2.0),
            TK.MCFidelityKernel(base=tb, lf=1.0, hf=2.0))


@pytest.mark.parametrize("name", ["MC-ARD", "MC-SE"])
def test_mc_fidelity_kernel_value_and_grad_match_jax(name):
    """Gram and the gradient of a weighted sum of it, every parameter
    (the fidelity factor's b, length scale and signal variance, the
    base kernel's), rtol 1e-4."""
    rng = np.random.default_rng(0)
    jk, tk = _kernels(name)
    p = perturbed(jk.init_params(2), rng)
    x1, x2 = rng.standard_normal((20, 2)), rng.standard_normal((15, 2))
    wts = rng.standard_normal((20, 15))
    jx1, jx2 = jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
    tx1, tx2 = torch.tensor(x1, dtype=torch.float32), torch.tensor(x2, dtype=torch.float32)
    tp = value_and_grads_match(lambda q: jnp.sum(jk.apply(q, jx1, jx2) * wts),
                               lambda q: (tk.apply(q, tx1, tx2) * torch.tensor(wts)).sum(),
                               p, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tk.apply(tp, tx1, tx2).detach().numpy(), np.asarray(jax.jit(
        jk.apply)(jax.tree_util.tree_map(jnp.asarray, p), jx1, jx2)), rtol=1e-4, atol=1e-7)


def test_mc_fidelity_kernel_batched_factor_matches_unbatched():
    """With a leading restart axis on b, the length scales and the z draws
    (as `stack_params` builds it), each restart's factor is the unbatched
    one's."""
    tk = _kernels("MC-ARD")[1]
    p = tk.init_params(1, device="cpu")
    ps = [dict(p, b=torch.tensor(b), length_scales=torch.tensor([ls]))
          for b, ls in ((0.5, 1.0), (1.0, 0.3), (2.0, 3.0))]
    batch = TF.stack_params(ps)
    assert isinstance(batch["_z"], tuple) and batch["_z"][0].shape == (3, tk.n_mc)
    assert TF._frozen_mask(batch)["_z"] == (False, False)
    got = tk.fidelity_factor(batch)
    want = torch.stack([tk.fidelity_factor(q) for q in ps])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _gp_case(case, rng, n=48):
    x = rng.standard_normal((n, 1)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    y_var = (0.05 * rng.random(n)).astype(np.float32) if case == "y_var" else None
    mask = (np.arange(n) < n - 9) if case == "mask" else None
    return x, y, y_var, mask


@pytest.mark.parametrize("kernel", ["ARD", "MC-ARD"])
@pytest.mark.parametrize("case", ["plain", "y_var", "mask", "relative_jitter"])
def test_gpbasic_nll_and_predictions_match_jax(kernel, case):
    """`GPBasic.nll` (value rtol 1e-5, gradients 2e-3: the bars of
    tests/test_linalg.py), `predict` and `predict_diag` (no noise in
    either) within rtol 1e-4, of their scale, of the JAX package's in
    float64, the bar of the AR forward test below: the port's
    posterior multiplies by W = inv(L) where the JAX package solves with L,
    which costs float32 accuracy (3.0e-5 of the means' scale at worst here,
    the JAX package's float32 7.4e-6).  A posterior (co)variance's scale
    is the prior variance it cancels from."""
    rng = np.random.default_rng(1)
    jk, tk = _kernels(kernel)
    rel = case == "relative_jitter"
    jgp, tgp = JC.GPBasic(kernel=jk, relative_jitter=rel), TC.GPBasic(kernel=tk, relative_jitter=rel)
    p = perturbed(jgp.init_params(1), rng, scale=0.2)
    p["noise_variance"] = np.asarray([0.15], np.float32)
    x, y, y_var, mask = _gp_case(case, rng)
    xt = np.linspace(-2, 2, 17, dtype=np.float32)[:, None]
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    T = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    tp = value_and_grads_match(
        lambda q: jgp.nll(q, J(x), J(y), y_var=J(y_var), mask=J(mask)),
        lambda q: tgp.nll(q, T(x), T(y), y_var=T(y_var), mask=T(mask)),
        p, rtol=1e-5, atol=1e-5, grad_rtol=2e-3)
    with torch.no_grad(), jax.enable_x64(True):
        J64 = lambda a: None if a is None else jnp.asarray(  # noqa: E731
            a, jnp.float64 if a.dtype == np.float32 else a.dtype)
        jp64 = jax.tree_util.tree_map(J64, p)
        prior = float(tgp.kernel.diag(tp["kernel"], T(xt)).max())
        for fn in ("predict", "predict_diag"):
            got = getattr(tgp, fn)(tp, T(x), T(y), T(xt), y_var=T(y_var), mask=T(mask))
            want = jax.jit(getattr(jgp, fn))(jp64, J64(x), J64(y), J64(xt), y_var=J64(y_var),
                                             mask=J64(mask))
            # scales: the means' own, the prior variance for the
            # (co)variances, which cancel from it
            for g, w, scale in zip(got, want, (np.abs(np.asarray(want[0])).max(), prior)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4 * scale)


def test_restart_ladder_matches_jax_for_gpbasic_over_mc_kernel():
    """`gp_restart_batch` on a GPBasic-over-MCFidelityKernel parameter dict:
    restarts 0-7 (the deterministic ladder, with noise_variance 0.3 and the
    base kernel's length scales set) equal the JAX package's leaf by leaf."""
    rng = np.random.default_rng(2)
    jk, tk = _kernels("MC-ARD")
    p = perturbed(JC.GPBasic(kernel=jk).init_params(1), rng)
    x = rng.random((40, 1)).astype(np.float32) * 5
    j_out = j_restart_batch(jk, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), 8,
                            jax.random.PRNGKey(0))
    t_out = TF.gp_restart_batch(tk, params_from_numpy(p, "cpu"), torch.tensor(x), 8)
    assert len(t_out) == 8
    for i, (jq, tq) in enumerate(zip(j_out, t_out)):
        if i:
            assert float(tq["noise_variance"][0]) == np.float32(0.3)
        assert len(leaves(jq)) == len(leaves(tq)) == 8
        for a, b in zip(leaves(jq), leaves(tq)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ------------------------------------------------------------------ the CIGP cascades
# AR end to end (the slice's main path: `train_AR`, `forward` and
# `export_posterior` on the toy sin, subset and non-subset, stage 0 at 320
# rows so the blocked branch runs), the data helpers, and ResGP, NAR and
# staged CAR (subset and non-subset; `tests/torch_port_checks.py` says what
# is checked and to which tolerance; the JAX MC z draws come across with
# staged CAR's init).

AR_ITERS = 40
AR_SIZES = (320, 160, 96)


def _ar_data(nonsubset):
    xs, ys, x_test, y_test = _toy_3fid(seed=3, nonsubset=nonsubset, sizes=AR_SIZES, pool=400,
                                       nested=True)
    entries = [{"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
               for i, (x, y) in enumerate(zip(xs, ys))]
    return entries, x_test, y_test


def _train_ar_jax(nonsubset):
    entries, x_test, y_test = _ar_data(nonsubset)
    dm = JDM(entries)
    model = JA.AR(3, [JSE()] * 3, if_nonsubset=nonsubset)
    hist = JA.train_AR(model, dm, max_iter=AR_ITERS, lr_init=5e-2, n_restarts=4)
    mean, cov = jax.jit(lambda xt: model.forward(dm, xt))(jnp.asarray(x_test, jnp.float32))
    return {"model": model, "dm": dm, "hist": [np.asarray(h) for h in hist],
            "mean": np.asarray(mean), "cov": np.asarray(cov), "x_test": x_test,
            "y_test": y_test, "entries": entries}


@pytest.fixture(scope="module")
def ar_jax_runs():
    """One JAX AR training per design, shared by the AR tests here."""
    return {ns: _train_ar_jax(ns) for ns in (False, True)}


@pytest.mark.parametrize("nonsubset", [False, True], ids=["subset", "nonsubset"])
def test_train_ar_matches_jax(ar_jax_runs, nonsubset):
    """Per-stage final NLML (rel 1e-3), chosen restart and test RMSE (abs
    1e-3) against the JAX package trained on the same data."""
    ref = ar_jax_runs[nonsubset]
    dm = TDM(ref["entries"])
    model = TA.AR(3, [TSE() for _ in range(3)], if_nonsubset=nonsubset, device="cpu")
    hist = TA.train_AR(model, dm, max_iter=AR_ITERS, lr_init=5e-2, n_restarts=4)
    for i, (h, jh) in enumerate(zip(hist, ref["hist"])):
        s, js = restart_scores(h), restart_scores(jh)
        assert int(np.argmin(s)) == int(np.argmin(js)), (i, s, js)
        # a stage NLML sums O(1) terms over its rows and can cancel to near
        # zero (6.2 at 96 rows here): rel 1e-3 of max(|NLML|, rows)
        n_rows = AR_SIZES[i]
        assert abs(s.min() - js.min()) <= 1e-3 * max(abs(js.min()), n_rows), (i, s, js)
    mean, cov = model.forward(dm, ref["x_test"])
    rmse = np.sqrt(np.mean((mean.numpy() - ref["y_test"]) ** 2))
    jrmse = np.sqrt(np.mean((ref["mean"] - ref["y_test"]) ** 2))
    assert abs(rmse - jrmse) < 1e-3 and rmse < 0.1, (rmse, jrmse)
    assert cov.shape == (len(ref["x_test"]),) * 2 and torch.isfinite(cov).all()


def _ar_cascade_f64(jm, jdm, x_test):
    """`AR.forward` of the JAX model recomputed in float64 from its own
    `CIGP.predict` (its f32 forward carries the quadratic-expansion Gram's
    rounding, 2e-4 on these means)."""
    with jax.enable_x64(True):
        mean = cov = None
        for i in range(3):
            norm = jdm.normalizelayer[i]
            xt = (x_test - norm.x_mean) / (norm.x_std + 1e-10)
            if i == 0:
                x_tr, y_tr = jdm.get_data(0, normal=True)
            else:
                x_tr, y_tr = jdm.get_data_by_name(f"res-{i}")
                y_tr = y_tr[0]
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                         jm.params["gp"][i])
            m, c = jax.jit(jm.gp_list[i].predict)(
                p64, *(jnp.asarray(np.asarray(a, np.float64)) for a in (x_tr, y_tr, xt)))
            m, c = np.asarray(m), np.asarray(c)
            if i == 0:
                mean, cov = m, c
            else:
                rho = float(jm.params["rho"][i - 1])
                shift, scale = jm.stage_norm[i]
                mean, cov = rho * mean + shift + scale * m, rho ** 2 * cov + scale ** 2 * c
        norm = jdm.normalizelayer[2]
        return mean * norm.y_std + norm.y_mean, cov * norm.y_std ** 2


def test_forward_and_export_with_carried_params_match_jax(ar_jax_runs):
    """The JAX-trained parameters carried across with `convert.py` give the
    same prediction cascade.  The JAX f32 forward is itself off its float64
    value by its Gram's rounding (2e-4 on these means, 3e-6 on covariances
    of 1e-3 that cancel from prior variances of O(1)), so: means within
    rtol 1e-4 (of their scale) of the JAX cascade in float64 and no
    farther from the JAX f32 means than those are from float64, plus that
    1e-4; covariances no farther from float64 than the JAX f32 ones."""
    ref = ar_jax_runs[False]
    jm, jdm = ref["model"], ref["dm"]
    dm = TDM(ref["entries"])
    for name, entry in jdm.data_dict.items():
        if entry["fidelity_index"] is None:  # the residual datasets of training
            dm.add_data(name, None, entry["X"], entry["Y"])
    model = TA.AR(3, [TSE() for _ in range(3)], device="cpu")
    load_state(model, jax.tree_util.tree_map(np.asarray, jm.params), jm.stage_norm)
    xt = ref["x_test"]
    m64, c64 = _ar_cascade_f64(jm, jdm, xt)
    jpost, jstate = jm.export_posterior(jdm)
    jpm, jpv = (np.asarray(a) for a in jax.jit(jpost)(jstate, jnp.asarray(xt, jnp.float32)))
    mtol = 1e-4 * np.abs(m64).max()
    mean, cov = model.forward(dm, xt)
    post, state = model.export_posterior(dm)
    pm, pv = post(state, xt)
    err = lambda a, b: np.abs(np.asarray(a) - b).max()  # noqa: E731
    for got_m, got_v, j_m, j_v, v64 in ((mean.numpy(), cov.numpy(), ref["mean"], ref["cov"], c64),
                                        (pm.numpy(), pv.numpy(), jpm, jpv, np.diagonal(c64))):
        np.testing.assert_allclose(got_m, m64, rtol=1e-4, atol=mtol)
        assert err(got_v, v64) <= err(j_v, v64), (err(got_v, v64), err(j_v, v64))
        assert err(got_m, j_m) <= err(j_m, m64) + mtol


def test_data_helpers_match_jax():
    """Row matching (native and numpy), pairing, the legacy subset API and
    the metrics are the JAX package's (numpy on both sides)."""
    from fidelityfusion_tpu.experiments import metrics as JM
    from fidelityfusion_tpu.models import data_manager as JD
    from fidelityfusion_tpu_torch.experiments import metrics as TM
    from fidelityfusion_tpu_torch.models import data_manager as TD
    from fidelityfusion_tpu_torch.utils.native import match_rows_native
    from fidelityfusion_tpu_torch.utils.subset_tools import SubsetChecker

    rng = np.random.default_rng(0)
    x1 = rng.integers(0, 5, (60, 2)).astype(float)
    x2 = rng.integers(0, 5, (40, 2)).astype(float)
    for f in ("match_rows", "pair_rows"):
        for a, b in zip(getattr(TD, f)(x1, x2), getattr(JD, f)(x1, x2)):
            np.testing.assert_array_equal(a, b)
    native = match_rows_native(x1, x2)
    if native is not None:  # a C compiler was found
        for a, b in zip(native, JD.match_rows(x1, x2)):
            np.testing.assert_array_equal(a, b)
    assert SubsetChecker.self_test()
    a, m, v = rng.random(30), rng.random(30), rng.random(30)
    assert TM.calculate_metrix(a, m, v) == JM.calculate_metrix(a, m, v)


@pytest.fixture(scope="module")
def jax_runs():
    return PC.jax_runs()


def test_resgp_training_from_jax_init_matches_jax(jax_runs):
    PC.check_training(jax_runs, "ResGP", False)


def test_resgp_forward_with_carried_params_matches_jax(jax_runs):
    PC.check_forward(jax_runs, "ResGP")


def test_resgp_nonsubset_training_from_jax_init_matches_jax(jax_runs):
    PC.check_training(jax_runs, "ResGP", True)


def test_nar_training_from_jax_init_matches_jax(jax_runs):
    PC.check_training(jax_runs, "NAR", False)


def test_nar_forward_with_carried_params_matches_jax(jax_runs):
    PC.check_forward(jax_runs, "NAR")


def test_nar_nonsubset_training_from_jax_init_matches_jax(jax_runs):
    PC.check_training(jax_runs, "NAR", True)


def test_car_training_from_jax_init_matches_jax(jax_runs):
    PC.check_training(jax_runs, "CAR", False)


def test_car_forward_with_carried_params_matches_jax(jax_runs):
    PC.check_forward(jax_runs, "CAR")


def test_car_nonsubset_training_from_jax_init_matches_jax(jax_runs):
    PC.check_training(jax_runs, "CAR", True)


# ------------------------------------------------------------------ CAR-large and FIDES
# The kernels' values and gradients on the same seeded inputs and
# parameters (the JAX MC draws carried across with `convert.py`), fits
# from the JAX init, and predictions with JAX-trained parameters against
# the JAX models recomputed in float64.


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
