"""The slice end to end: the port's `train_AR`, `forward` and
`export_posterior` against the JAX package on the toy sin, subset and
non-subset, with stage 0 at 320 rows so the blocked branch runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models import ar as JA
from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
from fidelityfusion_tpu.ops.kernels import SquaredExponentialKernel as JSE
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.demo import _toy_3fid
from fidelityfusion_tpu_torch.models import ar as TA
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel as TSE
from fidelityfusion_tpu_torch.train.fit import restart_scores

ITERS = 40
SIZES = (320, 160, 96)


def _data(nonsubset):
    xs, ys, x_test, y_test = _toy_3fid(seed=3, nonsubset=nonsubset, sizes=SIZES, pool=400,
                                       nested=True)
    entries = [{"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
               for i, (x, y) in enumerate(zip(xs, ys))]
    return entries, x_test, y_test


def _train_jax(nonsubset):
    entries, x_test, y_test = _data(nonsubset)
    dm = JDM(entries)
    model = JA.AR(3, [JSE()] * 3, if_nonsubset=nonsubset)
    hist = JA.train_AR(model, dm, max_iter=ITERS, lr_init=5e-2, n_restarts=4)
    mean, cov = jax.jit(lambda xt: model.forward(dm, xt))(jnp.asarray(x_test, jnp.float32))
    return {"model": model, "dm": dm, "hist": [np.asarray(h) for h in hist],
            "mean": np.asarray(mean), "cov": np.asarray(cov), "x_test": x_test,
            "y_test": y_test, "entries": entries}


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX training per design, shared by every test here."""
    return {ns: _train_jax(ns) for ns in (False, True)}


@pytest.mark.parametrize("nonsubset", [False, True], ids=["subset", "nonsubset"])
def test_train_ar_matches_jax(jax_runs, nonsubset):
    """Per-stage final NLML (rel 1e-3), chosen restart and test RMSE (abs
    1e-3) against the JAX package trained on the same data."""
    ref = jax_runs[nonsubset]
    dm = TDM(ref["entries"])
    model = TA.AR(3, [TSE() for _ in range(3)], if_nonsubset=nonsubset, device="cpu")
    hist = TA.train_AR(model, dm, max_iter=ITERS, lr_init=5e-2, n_restarts=4)
    for i, (h, jh) in enumerate(zip(hist, ref["hist"])):
        s, js = restart_scores(h), restart_scores(jh)
        assert int(np.argmin(s)) == int(np.argmin(js)), (i, s, js)
        # a stage NLML sums O(1) terms over its rows and can cancel to near
        # zero (6.2 at 96 rows here): rel 1e-3 of max(|NLML|, rows)
        n_rows = SIZES[i]
        assert abs(s.min() - js.min()) <= 1e-3 * max(abs(js.min()), n_rows), (i, s, js)
    mean, cov = model.forward(dm, ref["x_test"])
    rmse = np.sqrt(np.mean((mean.numpy() - ref["y_test"]) ** 2))
    jrmse = np.sqrt(np.mean((ref["mean"] - ref["y_test"]) ** 2))
    assert abs(rmse - jrmse) < 1e-3 and rmse < 0.1, (rmse, jrmse)
    assert cov.shape == (len(ref["x_test"]),) * 2 and torch.isfinite(cov).all()


def _jax_cascade_f64(jm, jdm, x_test):
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


def test_forward_and_export_with_carried_params_match_jax(jax_runs):
    """The JAX-trained parameters carried across with `convert.py` give the
    same prediction cascade.  The JAX f32 forward is itself off its float64
    value by its Gram's rounding (2e-4 on these means, 3e-6 on covariances
    of 1e-3 that cancel from prior variances of O(1)), so: means within
    rtol 1e-4 (of their scale) of the JAX cascade in float64 and no
    farther from the JAX f32 means than those are from float64, plus that
    1e-4; covariances no farther from float64 than the JAX f32 ones."""
    ref = jax_runs[False]
    jm, jdm = ref["model"], ref["dm"]
    dm = TDM(ref["entries"])
    for name, entry in jdm.data_dict.items():
        if entry["fidelity_index"] is None:  # the residual datasets of training
            dm.add_data(name, None, entry["X"], entry["Y"])
    model = TA.AR(3, [TSE() for _ in range(3)], device="cpu")
    load_state(model, jax.tree_util.tree_map(np.asarray, jm.params), jm.stage_norm)
    xt = ref["x_test"]
    m64, c64 = _jax_cascade_f64(jm, jdm, xt)
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
