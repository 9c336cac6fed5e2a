"""The port's linalg, CIGP and Adam/restart training against the JAX
package: float64 where exactness is the question, float32 at the JAX
tests' bars."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fidelityfusion_tpu.models.cigp import CIGP as JCIGP
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu.ops import linalg as JL
from fidelityfusion_tpu.train.fit import adam_scan as jax_adam_scan
from fidelityfusion_tpu.train.fit import fit_restarts as jax_fit_restarts
from fidelityfusion_tpu_torch.models.cigp import CIGP as TCIGP
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.ops import linalg as TL
from fidelityfusion_tpu_torch.train import fit as TF


def _t(a):
    return torch.tensor(np.asarray(a))


def _problem(rng, n=130, m=17, d=2):
    x = np.sort(rng.random(n)) * 6
    xt = rng.random(m) * 6
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    Ks = np.exp(-0.5 * (x[:, None] - xt[None, :]) ** 2)
    Kss = np.exp(-0.5 * (xt[:, None] - xt[None, :]) ** 2)
    y = rng.standard_normal((n, d))
    mask = np.arange(n) < n - 11
    return K, Ks, Kss, y, mask


def test_linalg_f64_matches_jax():
    rng = np.random.default_rng(0)
    K, Ks, Kss, y, mask = _problem(rng)
    yv = rng.random(K.shape[0]) * 0.1
    def jax_side(K, y, Ks, Kss, yv, jm):
        jS = JL.assemble_sigma(K, 0.05, y_var=yv, mask=jm, relative_jitter=True)
        S = JL.assemble_sigma(K, 0.05)
        cache = JL.posterior_cache(S, y, mask=jm)
        want = {
            "nll": JL.mvn_nll(S, y),
            "nll_mask": JL.mvn_nll(jS, y, mask=jm),
            "nll_direct": JL.mvn_nll(S, y, method="direct"),
            "fused": JL.mvn_nll_fused(S, y),
            "post": JL.posterior(S, y, Ks, Kss, mask=jm),
            "post_diag": JL.posterior_diag(S, y, Ks, jnp.diagonal(Kss)),
            "logdet": JL.chol_logdet(S),
            "cached_diag": JL.posterior_diag_cached(cache, Ks, jnp.diagonal(Kss), mask=jm),
            "cached": JL.posterior_cached(cache, Ks, Kss, mask=jm),
            "W": cache["W"], "alpha": cache["alpha"],
        }
        g_mask = jax.grad(lambda s_, yy: JL.mvn_nll(s_, yy, mask=jm), argnums=(0, 1))(jS, y)
        return jS, want, g_mask

    with jax.enable_x64(True):
        jS, want, g_mask = jax.jit(jax_side)(*map(jnp.asarray, (K, y, Ks, Kss, yv, mask)))
        jS = np.asarray(jS)
    tS = TL.assemble_sigma(_t(K), 0.05, y_var=_t(yv), mask=_t(mask), relative_jitter=True)
    np.testing.assert_allclose(tS.numpy(), jS, rtol=1e-12, atol=1e-15)
    S = TL.assemble_sigma(_t(K), 0.05)
    tm = _t(mask)
    cache = TL.posterior_cache(S, _t(y), mask=tm)
    got = {
        "nll": TL.mvn_nll(S, _t(y)),
        "nll_mask": TL.mvn_nll(tS, _t(y), mask=tm),
        "nll_direct": TL.mvn_nll(S, _t(y), method="direct"),
        "fused": TL.mvn_nll_fused(S, _t(y)),
        "post": TL.posterior(S, _t(y), _t(Ks), _t(Kss), mask=tm),
        "post_diag": TL.posterior_diag(S, _t(y), _t(Ks), _t(Kss).diagonal()),
        "logdet": TL.chol_logdet(S),
        "cached_diag": TL.posterior_diag_cached(cache, _t(Ks), _t(Kss).diagonal(), mask=tm),
        "cached": TL.posterior_cached(cache, _t(Ks), _t(Kss), mask=tm),
        "W": cache["W"], "alpha": cache["alpha"],
    }
    for k, w in want.items():
        for g_, w_ in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(w)):
            np.testing.assert_allclose(np.asarray(g_), np.asarray(w_), rtol=1e-9, atol=1e-10,
                                       err_msg=k)
    tSg, yg = tS.clone().requires_grad_(), _t(y).requires_grad_()
    TL.mvn_nll(tSg, yg, mask=tm).backward()
    sym = lambda a: 0.5 * (a + a.T)  # noqa: E731  (the gradient of a symmetric input)
    np.testing.assert_allclose(sym(tSg.grad.numpy()), sym(np.asarray(g_mask[0])), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(yg.grad.numpy(), np.asarray(g_mask[1]), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(TL.pad_rows(_t(y), 140).numpy(),
                               np.asarray(JL.pad_rows(jnp.asarray(y), 140)))
    assert (TL.row_mask(3, 5).numpy() == np.asarray(JL.row_mask(3, 5))).all()


def test_mvn_nll_fused_f32_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((200, 200))
    S = (A @ A.T + 200 * np.eye(200)).astype(np.float32)  # the JAX tests' fixture
    y = rng.standard_normal((200, 2)).astype(np.float32)
    wv, (wS, wy) = jax.jit(jax.value_and_grad(JL.mvn_nll_fused, argnums=(0, 1)))(
        jnp.asarray(S), jnp.asarray(y))
    St, yt = _t(S).requires_grad_(), _t(y).requires_grad_()
    v = TL.mvn_nll_fused(St, yt)
    v.backward()
    np.testing.assert_allclose(float(v), float(wv), rtol=1e-5)
    np.testing.assert_allclose(St.grad.numpy(), np.asarray(wS), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------ Adam
def _jloss(p, nan_above):
    v = jnp.sum((p["w"] - 3.0) ** 2 * jnp.asarray([1.0, 4.0])) + jnp.sum(jnp.sin(p["k"]["b"]))
    return jnp.where(p["w"][0] > nan_above, jnp.nan, v + 0.0 * jnp.sum(p["_c"]))


def _tloss(p, nan_above):
    v = ((p["w"] - 3.0) ** 2 * torch.tensor([1.0, 4.0], dtype=p["w"].dtype)).sum(-1) \
        + torch.sin(p["k"]["b"]).sum(-1)
    return torch.where(p["w"][..., 0] > nan_above, torch.nan, v + 0.0 * p["_c"].sum(-1))


P0 = {"w": [0.5, -1.0], "k": {"b": [0.3]}, "_c": [2.0]}


@pytest.mark.parametrize("nan_above", [np.inf, 1.2], ids=["plain", "nan_rollback"])
def test_adam_scan_matches_optax_f64(nan_above):
    """50 Adam steps against `optax.adam` in the JAX package's `adam_scan`,
    float64 to 1e-9, with and without the NaN last-good rollback."""
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), P0,
                                    is_leaf=lambda v: isinstance(v, list))
        trainable = {"w": True, "k": {"b": True}, "_c": False}
        jf, jg, jl = jax.jit(lambda p: jax_adam_scan(
            lambda q: _jloss(q, nan_above), p, optax.adam(0.1), 50, trainable=trainable))(jp)
    tp = {"w": _t(P0["w"]), "k": {"b": _t(P0["k"]["b"])}, "_c": _t(P0["_c"])}
    tf, tg, tl = TF.adam_scan(lambda q: _tloss(q, nan_above), tp, 0.1, 50,
                              trainable=TF._frozen_mask(tp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9, atol=1e-12)
    for a, b in ((tf, jf), (tg, jg)):
        for k in ("w", "_c"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a["k"]["b"].numpy(), np.asarray(b["k"]["b"]), rtol=1e-9)
    if np.isfinite(nan_above):
        assert np.isnan(tl.numpy()).any() and tg["w"][0] <= nan_above


def _jrestart_loss(p):
    return _jloss(p, 2.5)


def test_fit_restarts_scores_last_finite_loss_like_jax():
    """Restarts that hit NaN keep their last verified point; the winner is
    picked by last finite loss and re-verified unbatched, as in JAX."""
    starts = [[0.5, -1.0], [2.4, 3.0], [-3.0, 0.0]]
    with jax.enable_x64(True):
        jb = {"w": jnp.asarray(starts), "k": {"b": jnp.asarray([[0.3], [2.0], [-1.0]])},
              "_c": jnp.zeros((3, 1))}
        jbest, jres = jax_fit_restarts(_jrestart_loss, jb, steps=30, lr=0.2, loss_args=())
    tb = {"w": _t(starts), "k": {"b": _t([[0.3], [2.0], [-1.0]])}, "_c": torch.zeros((3, 1),
                                                                                    dtype=torch.float64)}
    tbest, tres = TF.fit_restarts(lambda p: _tloss(p, 2.5), tb, steps=30, lr=0.2)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-9)
    np.testing.assert_allclose(tbest["w"].numpy(), np.asarray(jbest["w"]), rtol=1e-9)
    score = TF.restart_scores(tres.losses)
    assert np.isfinite(score).all() and np.isnan(tres.losses.numpy()).any()


# ------------------------------------------------------------------ CIGP
def _cigp_case(branch):
    """(JAX spec, port spec, raw params, n, mask?) for one `CIGP.nll` branch."""
    se = {"length_scale": [-1.5], "signal_variance": [0.2]}
    ard = {"length_scales": [0.8], "signal_variance": [1.3]}
    if branch == "se_analytic":
        return JCIGP(JK.SquaredExponentialKernel()), TCIGP(TK.SquaredExponentialKernel()), se, 512, False
    if branch == "blocked":  # the port's restart route is its plain spec's
        return (JCIGP(JK.SquaredExponentialKernel(), blocked_nll=True),
                TCIGP(TK.SquaredExponentialKernel()), se, 330, False)
    if branch == "hybrid":
        return JCIGP(JK.ARDKernel()), TCIGP(TK.ARDKernel()), ard, 512, False
    if branch == "fused":
        return JCIGP(JK.ARDKernel()), TCIGP(TK.ARDKernel()), ard, 200, False
    return JCIGP(JK.SquaredExponentialKernel()), TCIGP(TK.SquaredExponentialKernel()), se, 200, True


@pytest.mark.parametrize("branch", ["se_analytic", "blocked", "hybrid", "fused", "masked"])
def test_cigp_nll_dispatch_matches_jax_f64(branch):
    """`CIGP.nll` value and parameter gradients, one case per branch of the
    JAX package's dispatch, in float64."""
    jgp, tgp, kraw, n, masked = _cigp_case(branch)
    rng = np.random.default_rng(7)
    x = np.sort(rng.random((n, 1)) * 8, axis=0)
    if branch == "se_analytic":
        # the JAX se_nlml forms its cross term in float32 even under x64
        # (fused_se.py:67); on a 1/256 grid every product is exact there
        x = np.sort(rng.integers(0, 256, (n, 1)), axis=0) / 256.0
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((n, 1))
    mask = (np.arange(n) < n - 9) if masked else None
    with jax.enable_x64(True):
        jp = {"kernel": {k: jnp.asarray(v, jnp.float64) for k, v in kraw.items()},
              "log_beta": jnp.asarray([2.5], jnp.float64)}
        jmask = None if mask is None else jnp.asarray(mask)
        wv, wg = jax.jit(jax.value_and_grad(
            lambda p: jgp.nll(p, jnp.asarray(x), jnp.asarray(y), mask=jmask)))(jp)
    tp = {"kernel": {k: _t(v).requires_grad_() for k, v in kraw.items()},
          "log_beta": _t([2.5]).requires_grad_()}
    v = tgp.nll(tp, _t(x), _t(y), mask=None if mask is None else _t(mask))
    v.backward()
    np.testing.assert_allclose(float(v), float(wv), rtol=1e-9)
    for k in kraw:
        np.testing.assert_allclose(tp["kernel"][k].grad.numpy(), np.asarray(wg["kernel"][k]),
                                   rtol=1e-6)
    np.testing.assert_allclose(tp["log_beta"].grad.numpy(), np.asarray(wg["log_beta"]), rtol=1e-6)


ROUTE_CASES = {  # case -> (port spec, restarts, masked, y_var, se_nlml calls)
    "se_unbatched": (TCIGP(TK.SquaredExponentialKernel()), None, False, False, 1),
    "se_restarts": (TCIGP(TK.SquaredExponentialKernel()), 2, False, False, 0),
    "ard": (TCIGP(TK.ARDKernel()), None, False, False, 0),
    "analytic_off": (TCIGP(TK.SquaredExponentialKernel(), se_analytic_nll=False), None, False,
                     False, 0),
    "masked": (TCIGP(TK.SquaredExponentialKernel()), None, True, False, 0),
    "y_var": (TCIGP(TK.SquaredExponentialKernel()), None, False, True, 0),
}


def _route_inputs(restarts=None):
    n = 512
    rng = np.random.default_rng(9)
    x = _t(np.sort(rng.random((n, 1)) * 8, axis=0))
    y = torch.sin(2 * x) + 0.1 * _t(rng.standard_normal((n, 1)))
    p = {"kernel": {"length_scale": _t([-1.5]), "signal_variance": _t([0.2])},
         "log_beta": _t([2.5])}
    if restarts:
        p = TF.stack_params([p] * restarts)
    return p, x, y


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_cigp_nll_route(case, monkeypatch):
    """`CIGP.nll` takes `se_nlml` only for one unmasked SE matrix of
    `SE_ANALYTIC_MIN_N` rows without targets' variances; a restart batch,
    another kernel, the route switched off, a mask or ``y_var`` go through
    `linalg.mvn_nll`."""
    from fidelityfusion_tpu_torch.models import cigp as TC
    from fidelityfusion_tpu_torch.ops import fused_se

    gp, restarts, masked, with_var, want = ROUTE_CASES[case]
    assert TC.SE_ANALYTIC_MIN_N == 512
    p, x, y = _route_inputs(restarts=restarts)
    if isinstance(gp.kernel, TK.ARDKernel):
        p["kernel"] = {"length_scales": _t([0.8]), "signal_variance": _t([1.3])}
    calls = []
    se_nlml = fused_se.se_nlml
    monkeypatch.setattr(fused_se, "se_nlml", lambda *a, **k: calls.append(1) or se_nlml(*a, **k))
    mask = _t(np.arange(512) < 500) if masked else None
    y_var = torch.full((512,), 1e-3, dtype=x.dtype) if with_var else None
    v = gp.nll(p, x, y, y_var=y_var, mask=mask)
    assert len(calls) == want
    assert v.shape == ((restarts,) if restarts else ()) and bool(torch.isfinite(v).all())


def test_cigp_nll_route_forwards_agree_f64():
    """At 512 rows in float64 the analytic and generic forwards agree to
    1e-12, and the two routes' parameter gradients to 1e-6."""
    p, x, y = _route_inputs()
    vals, grads = [], []
    for on in (True, False):
        q = {"kernel": {k: v.clone().requires_grad_() for k, v in p["kernel"].items()},
             "log_beta": p["log_beta"].clone().requires_grad_()}
        v = TCIGP(TK.SquaredExponentialKernel(), se_analytic_nll=on).nll(q, x, y)
        v.backward()
        vals.append(float(v))
        grads.append([q["kernel"]["length_scale"].grad, q["kernel"]["signal_variance"].grad,
                      q["log_beta"].grad])
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-12)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_cigp_predict_and_cache_match_jax_f64():
    rng = np.random.default_rng(8)
    x = np.sort(rng.random((90, 1)) * 8, axis=0)
    y = np.sin(2 * x)
    xt = rng.random((13, 1)) * 8
    kraw = {"length_scale": [-0.3], "signal_variance": [0.2]}
    jgp, tgp = JCIGP(JK.SquaredExponentialKernel()), TCIGP(TK.SquaredExponentialKernel())
    def jax_side(jp, jx, jy, jxt):
        cache = jgp.posterior_cache(jp, jx, jy)
        return [jgp.predict(jp, jx, jy, jxt), jgp.predict_diag(jp, jx, jy, jxt),
                jgp.predict_cached(jp, cache, jx, jxt), jgp.predict_diag_cached(jp, cache, jx, jxt)]

    with jax.enable_x64(True):
        jp = {"kernel": {k: jnp.asarray(v, jnp.float64) for k, v in kraw.items()},
              "log_beta": jnp.asarray([3.0], jnp.float64)}
        want = jax.jit(jax_side)(jp, *map(jnp.asarray, (x, y, xt)))
    tp = {"kernel": {k: _t(v) for k, v in kraw.items()}, "log_beta": _t([3.0])}
    tx, ty, txt = _t(x), _t(y), _t(xt)
    cache = tgp.posterior_cache(tp, tx, ty)
    got = [tgp.predict(tp, tx, ty, txt), tgp.predict_diag(tp, tx, ty, txt),
           tgp.predict_cached(tp, cache, tx, txt), tgp.predict_diag_cached(tp, cache, tx, txt)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-10)
    # x64_factor: the float64 island's NLML (the JAX package's, rtol 1e-6 on
    # its float32 result); only masked training stays unsupported
    x64 = TCIGP(TK.SquaredExponentialKernel(), x64_factor=True)
    jx64 = JCIGP(JK.SquaredExponentialKernel(), x64_factor=True)
    jp32 = {"kernel": {k: jnp.asarray(v, jnp.float32) for k, v in kraw.items()},
            "log_beta": jnp.asarray([3.0], jnp.float32)}
    np.testing.assert_allclose(
        x64.nll(tp, tx, ty).item(),
        float(jx64.nll(jp32, *(jnp.asarray(a, jnp.float32) for a in (x, y)))), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        x64.nll(tp, tx, ty, mask=torch.ones(len(x), dtype=torch.bool))
