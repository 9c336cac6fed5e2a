"""The port's joint training (`models/joint.py`) against the JAX package on
the CPU: `train_joint` for AR, ResGP and NAR (subset and non-subset), staged
CAR, and GAR and CIGAR (subset and non-subset), each from the JAX model's
own initial parameters (carried across with `convert.load_state`), on the
JAX tests' data (`tests/test_ar.py:build_manager` over the toy sin,
`tests/test_joint.py:_poisson_manager`), then `forward` with the
JAX-trained parameters carried across.

Tolerances:
- cascades (AR, ResGP, NAR, CAR): the loss at every step within 1e-3 of
  max(|loss|, total rows) (float32 factorizations of trained Sigmas differ
  by ~1e-4 of the NLML's O(rows) terms, `tests/torch_port_checks.py`);
  `forward` with the JAX-trained parameters: means within 1e-4 of their
  scale of the JAX cascade recomputed in float64, covariances within 1e-4
  of the largest prior variance;
- GAR and CIGAR (`tests/torch_field_checks.py`'s bars): the loss at every
  step within 1e-4 of max(|loss|, 1) (GAR, element-normalized) or of
  max(|loss|, total rows) (CIGAR); `forward` means and variances, of the
  port trained from the JAX init and of the JAX-trained parameters carried
  across, within 1e-4 of their largest magnitude of the JAX `forward`.
The NaN pattern of the loss history is the JAX one (the rollback keeps
the same steps).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fidelityfusion_tpu.models import ar as JA
from fidelityfusion_tpu.models import car as JCAR
from fidelityfusion_tpu.models import cigar as JC
from fidelityfusion_tpu.models import gar as JG
from fidelityfusion_tpu.models import joint as JJ
from fidelityfusion_tpu.models import nar as JN
from fidelityfusion_tpu.models import resgp as JR
from fidelityfusion_tpu.ops.kernels import ARDKernel as JARD
from fidelityfusion_tpu.ops.kernels import SquaredExponentialKernel as JSE
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.models import ar as TA
from fidelityfusion_tpu_torch.models import car as TCAR
from fidelityfusion_tpu_torch.models import cigar as TC
from fidelityfusion_tpu_torch.models import gar as TG
from fidelityfusion_tpu_torch.models import joint as TJ
from fidelityfusion_tpu_torch.models import nar as TN
from fidelityfusion_tpu_torch.models import resgp as TR
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel as TARD
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel as TSE
from tests.test_ar import build_manager
from tests.test_joint import _poisson_manager

ITERS = 15
ROUNDS = {"AR": 4, "ResGP": 4, "NAR": 4, "GAR": 3, "CIGAR": 3}
# (JAX model, port model, JAX kernel, port kernel, lr): the JAX tests' settings
CASCADES = {"AR": (JA.AR, TA.AR, JSE, TSE, 5e-2), "ResGP": (JR.ResGP, TR.ResGP, JSE, TSE, 5e-2),
            "NAR": (JN.NAR, TN.NAR, JSE, TSE, 5e-2),
            "CAR": (JCAR.ContinuousAutoRegression, TCAR.ContinuousAutoRegression, JARD, TARD,
                    2e-2)}
FIELDS = {"GAR": (JG.GAR, TG.GAR), "CIGAR": (JC.CIGAR, TC.CIGAR)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried_dm(jdm):
    """A port data manager with the JAX run's data and the stage datasets
    its training registered."""
    dm = TDM([{"raw_fidelity_name": k, "fidelity_indicator": e["fidelity_index"], "X": e["X"],
               "Y": e["Y"]} for k, e in jdm.data_dict.items() if e["fidelity_index"] is not None])
    for key, entry in jdm.data_dict.items():
        if entry["fidelity_index"] is None:
            dm.add_data(key, None, entry["X"], entry["Y"])
    return dm


def _check_history(losses, jlosses, scale_floor, rtol):
    """Every step's loss within ``rtol`` of max(|JAX loss|, scale_floor);
    the same NaN pattern."""
    got, want = losses.detach().numpy(), np.asarray(jlosses)
    assert got.shape == want.shape, (got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), (got, want)
    tol = rtol * np.maximum(np.abs(want[~nan]), scale_floor)
    err = np.abs(got[~nan] - want[~nan])
    assert (err <= tol).all(), (err.max(), tol.min(), got, want)


def _stage_rows(jdm, n_fid, nonsubset):
    """Rows entering the joint loss: fidelity 0 plus each stage's set."""
    rows = len(jdm.get_data(0)[0])
    for i in range(1, n_fid):
        if nonsubset:
            rows += len(jdm.get_data(i)[0])
        else:
            rows += len(jdm.get_overlap_input_data(i - 1, i)[2])
    return rows


def _jax_cascade_f64(name, jm, jdm, x_test):
    """The JAX cascade's `forward`, recomputed in float64 stage by stage
    from its own GPs' `predict`."""
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        mean = cov = None
        for i in range(jm.fidelity_num):
            norm = jdm.normalizelayer[i]
            xt = (x_test - norm.x_mean) / (norm.x_std + 1e-10)
            if i == 0:
                x_tr, y_tr = jdm.get_data(0, normal=True)
            else:
                x_tr, y_tr = jdm.get_data_by_name(f"{'concat' if name == 'NAR' else 'res'}-{i}")
                y_tr = y_tr[0]
            if name == "NAR" and i > 0:
                xt = np.concatenate([xt, mean.reshape(len(xt), -1)], axis=1)
            p64 = to64(jm.params["gp"][i])
            if name == "CAR" and i > 0:
                p64 = JCAR.ContinuousAutoRegression._bind_b(p64, to64(jm.params["b"]))
            m, c = (np.asarray(a) for a in jax.jit(jm.gp_list[i].predict)(
                p64, *(jnp.asarray(np.asarray(a, np.float64)) for a in (x_tr, y_tr, xt))))
            if i == 0 or name == "NAR":
                mean, cov = m, c
            else:
                rho = {"AR": lambda: float(jm.params["rho"][i - 1]), "ResGP": lambda: 1.0,
                       "CAR": lambda: float(np.exp(np.asarray(jm.params["b"], np.float64)))}[name]()
                shift, scale = jm.stage_norm[i]
                mean, cov = rho * mean + shift + scale * m, rho ** 2 * cov + scale ** 2 * c
        norm = jdm.normalizelayer[jm.fidelity_num - 1]
        return mean * norm.y_std + norm.y_mean, cov * norm.y_std ** 2


def _documented_frozen_mask(params):
    """`fidelityfusion_tpu/train/fit.py:_frozen_mask` as its docstring
    states it: every leaf under a key starting with "_" is frozen, at any
    depth.  The JAX function stops at the first list and so trains the MC
    draws of a parameter tree ``{"gp": [...]}`` (joint CAR's); the port
    keeps them frozen (ROADMAP Queue 3)."""
    def walk(t, frozen):
        if isinstance(t, dict):
            return {k: walk(v, frozen or k.startswith("_")) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, frozen) for v in t)
        return not frozen
    return walk(params, False)


def _cascade_case(toy_sin_data, name, nonsubset, monkeypatch):
    jcls, tcls, jk, tk, lr = CASCADES[name]
    kw = {"if_nonsubset": True} if nonsubset else {}
    jdm = build_manager(toy_sin_data)
    jm = jcls(3, [jk() for _ in range(3)], input_dim=1, **kw)
    init = _np(jm.params)
    if name == "CAR":
        monkeypatch.setattr(importlib.import_module("fidelityfusion_tpu.train.fit"),
                            "_frozen_mask", _documented_frozen_mask)
    jlosses = JJ.train_joint(jm, jdm, max_iter=ITERS, lr_init=lr, rounds=ROUNDS.get(name, 4))

    dm = _carried_dm(build_manager(toy_sin_data))
    model = tcls(3, [tk() for _ in range(3)], input_dim=1, device="cpu", **kw)
    load_state(model, init)
    losses = TJ.train_joint(model, dm, max_iter=ITERS, lr_init=lr, rounds=ROUNDS.get(name, 4))
    _check_history(losses, jlosses, _stage_rows(jdm, 3, nonsubset), 1e-3)
    x_test = toy_sin_data["test"][0]
    mean, _ = model.forward(dm, x_test)
    assert np.isfinite(mean.numpy()).all()

    # the JAX-trained cascade carried across
    carried = tcls(3, [tk() for _ in range(3)], input_dim=1, device="cpu", **kw)
    load_state(carried, _np(jm.params), getattr(jm, "stage_norm", None))
    m64, c64 = _jax_cascade_f64(name, jm, jdm, x_test)
    mean, cov = carried.forward(_carried_dm(jdm), x_test)
    np.testing.assert_allclose(mean.numpy(), m64, rtol=1e-4, atol=1e-4 * np.abs(m64).max())
    np.testing.assert_allclose(cov.numpy(), c64, atol=1e-4 * np.abs(np.diagonal(c64)).max())


def _check_close(got, want):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _field_case(name, nonsubset):
    jcls, tcls = FIELDS[name]
    x, ys, jdm = _poisson_manager(flatten=name == "CIGAR")
    shapes = ([y.shape[1:] for y in ys] if name == "GAR" else [(6, 6), (10, 10), (14, 14)])
    kw = {"if_nonsubset": True} if nonsubset else {}
    jm = jcls(3, [JARD() for _ in range(3)], shapes, input_dim=x.shape[1], **kw)
    init = _np(jm.params)
    jlosses = JJ.train_joint(jm, jdm, max_iter=ITERS, lr_init=5e-2, rounds=ROUNDS[name])
    x_test = x[40:]
    jmean, jvar = (np.asarray(a) for a in jax.jit(lambda xt: jm.forward(jdm, xt))(
        jnp.asarray(x_test, jnp.float32)))

    _, _, dm = _poisson_manager(flatten=name == "CIGAR")
    dm = _carried_dm(dm)
    model = tcls(3, [TARD() for _ in range(3)], shapes, input_dim=x.shape[1], device="cpu", **kw)
    load_state(model, init)
    losses = TJ.train_joint(model, dm, max_iter=ITERS, lr_init=5e-2, rounds=ROUNDS[name])
    floor = _stage_rows(jdm, 3, nonsubset) if name == "CIGAR" else 1.0
    _check_history(losses, jlosses, floor, 1e-4)
    mean, var = model.forward(dm, x_test)
    _check_close(mean, jmean)
    _check_close(var, jvar)
    assert (var.detach().numpy() > 0).all()

    carried = tcls(3, [TARD() for _ in range(3)], shapes, input_dim=x.shape[1], device="cpu")
    cdm = _carried_dm(jdm)
    load_state(carried, _np(jm.params), jm.stage_norm, data_manager=cdm)
    mean, var = carried.forward(cdm, x_test)
    _check_close(mean, jmean)
    _check_close(var, jvar)


@pytest.mark.parametrize("nonsubset", [False, True], ids=["subset", "nonsubset"])
@pytest.mark.parametrize("name", ["AR", "ResGP", "NAR"])
def test_train_joint_cascade_matches_jax(toy_sin_data, name, nonsubset, monkeypatch):
    _cascade_case(toy_sin_data, name, nonsubset, monkeypatch)


def test_train_joint_car_matches_jax(toy_sin_data, monkeypatch):
    """Staged CAR joint (ARD, lr 2e-2, the JAX test's), the global b bound
    into every residual kernel; the MC draws stay frozen on both sides."""
    _cascade_case(toy_sin_data, "CAR", False, monkeypatch)


@pytest.mark.parametrize("nonsubset", [False, True], ids=["subset", "nonsubset"])
@pytest.mark.parametrize("name", ["GAR", "CIGAR"])
def test_train_joint_field_model_matches_jax(name, nonsubset):
    _field_case(name, nonsubset)


def test_train_joint_rejects_what_jax_rejects():
    """Non-subset joint CAR and unsupported models raise TypeError, as in
    the JAX package."""
    from fidelityfusion_tpu_torch.models.cigp import CIGP

    car = TCAR.ContinuousAutoRegression(2, [TARD(), TARD()], if_nonsubset=True, device="cpu")
    with pytest.raises(TypeError, match="ContinuousAutoRegressionLarge"):
        TJ.train_joint(car, TDM(), max_iter=1)
    with pytest.raises(TypeError, match="not supported"):
        TJ.train_joint(CIGP(TSE()), TDM(), max_iter=1)
