"""Checks shared by the tests of the port against the JAX package.

Parameters and gradients: `perturbed`, `leaves`, `value_and_grads_match`
(tests/test_torch_gpbasic.py, tests/test_torch_legacy_utils.py).

Cascades (ResGP, NAR and staged CAR, in tests/test_torch_gpbasic.py): the
port's trainer from
the JAX model's init against the JAX package on the toy sin, subset and
non-subset, then `forward` (and `export_posterior` where the model has
one) with the JAX-trained parameters carried across, against the JAX
cascade recomputed in float64.  Two fidelities (the toy's lowest and
highest), to keep the JAX compiles few: stage 0 at 320 rows takes the
blocked branch, stage 1 (96 rows) the fused one and, non-subset, the
imputation through `forward`."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fidelityfusion_tpu.models import car as JCAR
from fidelityfusion_tpu.models import nar as JN
from fidelityfusion_tpu.models import resgp as JR
from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu_torch.convert import load_state, params_from_numpy
from fidelityfusion_tpu_torch.demo import _toy_3fid
from fidelityfusion_tpu_torch.models import car as TCAR
from fidelityfusion_tpu_torch.models import nar as TN
from fidelityfusion_tpu_torch.models import resgp as TR
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.train.fit import restart_scores
from fidelityfusion_tpu_torch.utils.tree import tree_map

ITERS = 15
SIZES = (320, 160, 96)  # the toy's three fidelities; FIDS are used
FIDS = (0, 2)
# (JAX model, JAX trainer, port model, port trainer, JAX kernel, port kernel, lr)
MODELS = {
    "ResGP": (JR.ResGP, JR.train_ResGP, TR.ResGP, TR.train_ResGP,
              JK.SquaredExponentialKernel, TK.SquaredExponentialKernel, 5e-2),
    "NAR": (JN.NAR, JN.train_NAR, TN.NAR, TN.train_NAR,
            JK.SquaredExponentialKernel, TK.SquaredExponentialKernel, 5e-2),
    # train_CAR's default lr: at 5e-2 the shortest ladder restart overshoots
    # at step 7 into an ill-conditioned spike (NLML -473 -> +708) where the
    # two float32 factorizations differ by 2.5e-3 of the value, and the
    # trajectories part from there (0.25 apart after 15 steps at 96 rows,
    # against a bar of 0.096)
    "CAR": (JCAR.ContinuousAutoRegression, JCAR.train_CAR, TCAR.ContinuousAutoRegression,
            TCAR.train_CAR, JK.ARDKernel, TK.ARDKernel, 1e-2),
}


def _data(nonsubset):
    xs, ys, x_test, y_test = _toy_3fid(seed=3, nonsubset=nonsubset, sizes=SIZES, pool=400,
                                       nested=True)
    entries = [{"raw_fidelity_name": str(k), "fidelity_indicator": k, "X": xs[i], "Y": ys[i]}
               for k, i in enumerate(FIDS)]
    return entries, x_test, y_test


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(params, rng, scale=0.3):
    """A numpy copy of a JAX parameter tree with seeded values around it
    for every leaf not under a "_" key (the MC draws are kept)."""
    def walk(t, frozen):
        if isinstance(t, dict):
            return {k: walk(v, frozen or k.startswith("_")) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, frozen) for v in t)
        a = np.asarray(t, np.float32)
        return a if frozen else (a + scale * rng.standard_normal(a.shape)).astype(np.float32)
    return walk(_np(params), False)


def leaves(tree):
    """Leaves with dict keys in sorted order, as `jax.tree_util` flattens."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in leaves(v)]
    return [tree]


def value_and_grads_match(jfn, tfn, p, rtol, atol, grad_rtol=None):
    """``jfn(params)`` (JAX, jitted) and ``tfn(params)`` (the port) on the
    numpy tree ``p``: scalars within ``rtol``, and their gradients in every
    leaf (a leaf the port's value does not use: zero) within ``grad_rtol``
    (default ``rtol``) and ``atol``."""
    jv, jg = jax.jit(jax.value_and_grad(jfn))(jax.tree_util.tree_map(jnp.asarray, p))
    tp = tree_map(lambda a: a.requires_grad_(True), params_from_numpy(p, "cpu"))
    v = tfn(tp)
    np.testing.assert_allclose(v.item(), float(jv), rtol=rtol)
    v.backward()
    for a, t in zip(leaves(jg), leaves(tp)):
        g = torch.zeros(t.shape) if t.grad is None else t.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=grad_rtol or rtol, atol=atol)
    return tp


def jax_runs():
    """A getter of one JAX training per (model, design), made on first use
    and kept: a test module's fixture."""
    runs = {}

    def get(name, nonsubset):
        if (name, nonsubset) not in runs:
            jcls, jtrain, _, _, jkernel, _, lr = MODELS[name]
            entries, x_test, y_test = _data(nonsubset)
            dm = JDM(entries)
            model = jcls(len(FIDS), [jkernel()] * len(FIDS), if_nonsubset=nonsubset)
            init = _np(model.params)
            hist = jtrain(model, dm, max_iter=ITERS, lr_init=lr, n_restarts=4)
            mean, _ = jax.jit(lambda xt: model.forward(dm, xt))(jnp.asarray(x_test, jnp.float32))
            runs[name, nonsubset] = {
                "model": model, "dm": dm, "init": init, "hist": [np.asarray(h) for h in hist],
                "mean": np.asarray(mean), "x_test": x_test, "y_test": y_test,
                "entries": entries}
        return runs[name, nonsubset]

    return get


def _port_model(name, nonsubset=False):
    tcls, tkernel = MODELS[name][2], MODELS[name][5]
    return tcls(len(FIDS), [tkernel() for _ in FIDS], if_nonsubset=nonsubset, device="cpu")


def _check_stages(hist, jhist, sizes):
    """Per stage: final NLML within 1e-3 of max(|NLML|, rows) (fp32
    factorizations of the trained, ill-conditioned Sigma differ by ~1e-4
    of the NLML's O(rows) terms); the chosen restart equal unless the JAX
    scores of the two restarts lie within that tolerance of each other."""
    for i, (h, jh) in enumerate(zip(hist, jhist)):
        s, js = restart_scores(h), restart_scores(jh)
        tol = 1e-3 * max(abs(js.min()), sizes[i])
        assert abs(s.min() - js.min()) <= tol, (i, s, js)
        pick, jpick = int(np.argmin(s)), int(np.argmin(js))
        assert pick == jpick or abs(js[pick] - js[jpick]) <= tol, (i, s, js)


def check_training(jax_runs, name, nonsubset):
    """Per-stage final NLML and chosen restart (see `_check_stages`), test
    RMSE within 1e-3, against the JAX package trained on the same data from
    the same init (its MC draws included)."""
    ref = jax_runs(name, nonsubset)
    ttrain, lr = MODELS[name][3], MODELS[name][6]
    dm = TDM(ref["entries"])
    model = _port_model(name, nonsubset)
    load_state(model, ref["init"])
    hist = ttrain(model, dm, max_iter=ITERS, lr_init=lr, n_restarts=4)
    _check_stages(hist, ref["hist"], [SIZES[i] for i in FIDS])
    mean, cov = model.forward(dm, ref["x_test"])
    rmse = np.sqrt(np.mean((mean.numpy() - ref["y_test"]) ** 2))
    jrmse = np.sqrt(np.mean((ref["mean"] - ref["y_test"]) ** 2))
    assert abs(rmse - jrmse) < 1e-3, (rmse, jrmse)
    assert cov.shape == (len(ref["x_test"]),) * 2 and np.isfinite(cov.numpy()).all()


def _stage_data(jdm, name, i):
    if i == 0:
        return jdm.get_data(0, normal=True)
    x_tr, y_tr = jdm.get_data_by_name(f"{'concat' if name == 'NAR' else 'res'}-{i}")
    return x_tr, y_tr[0]


def _jax_cascade_f64(name, jm, jdm, x_test):
    """The JAX model's `forward`, recomputed in float64 stage by stage from
    its own GPs' `predict`."""
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        b = to64(jm.params["b"]) if name == "CAR" else None
        rho = float(np.exp(np.asarray(b))) if name == "CAR" else 1.0
        mean = cov = None
        for i in range(len(FIDS)):
            norm = jdm.normalizelayer[i]
            xt = (x_test - norm.x_mean) / (norm.x_std + 1e-10)
            if name == "NAR" and i > 0:
                xt = np.concatenate([xt, mean.reshape(len(xt), -1)], axis=1)
            p64 = to64(jm.params["gp"][i])
            if name == "CAR" and i > 0:
                p64 = JCAR.ContinuousAutoRegression._bind_b(p64, b)
            m, c = (np.asarray(a) for a in jax.jit(jm.gp_list[i].predict)(
                p64, *(jnp.asarray(np.asarray(a, np.float64))
                       for a in (*_stage_data(jdm, name, i), xt))))
            if i == 0 or name == "NAR":
                mean, cov = m, c
            else:
                shift, scale = jm.stage_norm[i]
                mean, cov = rho * mean + shift + scale * m, rho ** 2 * cov + scale ** 2 * c
        norm = jdm.normalizelayer[len(FIDS) - 1]
        return mean * norm.y_std + norm.y_mean, cov * norm.y_std ** 2


def check_forward(jax_runs, name):
    """The JAX-trained parameters carried across with `convert.load_state`
    give the same prediction cascade: means within rtol 1e-4 of their
    scale of the JAX cascade in float64 (the JAX f32 forward carries its
    quadratic-expansion Gram's rounding), variances within 1e-4 of the
    prior's; `export_posterior` (cached factorizations, padded to 64 rows
    or not), where the model has one, agrees with `forward`."""
    ref = jax_runs(name, False)
    jm, jdm = ref["model"], ref["dm"]
    dm = TDM(ref["entries"])
    for key, entry in jdm.data_dict.items():
        if entry["fidelity_index"] is None:  # the stage datasets of training
            dm.add_data(key, None, entry["X"], entry["Y"])
    model = _port_model(name)
    load_state(model, _np(jm.params), getattr(jm, "stage_norm", None))
    xt = ref["x_test"]
    m64, c64 = _jax_cascade_f64(name, jm, jdm, xt)
    mtol, vtol = 1e-4 * np.abs(m64).max(), 1e-4 * np.abs(np.diagonal(c64)).max()
    mean, cov = model.forward(dm, xt)
    np.testing.assert_allclose(mean.numpy(), m64, rtol=1e-4, atol=mtol)
    np.testing.assert_allclose(cov.numpy(), c64, atol=vtol)
    if not hasattr(model, "export_posterior"):
        return
    for pad in (None, 64):
        post, state = model.export_posterior(dm, pad_multiple=pad)
        pm, pv = post(state, xt)
        np.testing.assert_allclose(pm.numpy(), mean.numpy(), rtol=1e-4, atol=mtol)
        np.testing.assert_allclose(pv.numpy(), np.diagonal(cov.numpy()), atol=vtol)
