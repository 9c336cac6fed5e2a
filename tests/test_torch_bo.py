"""The port's BO layer (`fidelityfusion_tpu_torch/bo/`, `data/cost.py`,
`data/objectives.py`) against the JAX package on the CPU.

The JAX functions draw from `jax.random`, which no torch stream
reproduces: each comparison feeds the JAX draws (starts, candidate grids,
fantasy normals) to the port as numpy arrays.

Tolerances:
- cost models and objectives: equal arrays (the same numpy code);
- `ucb`/`ei`/`pi`/`pf`/`mean_sigma_ratio`/`kg`: 1e-12 in float64, 1e-6
  relative in float32;
- `optimize_acqf`/`find_next_batch` from the same starts on an analytic
  peak: x to 1e-4, value to 1e-5 relative;
- JAX's AR trained on Forrester's {1: 10, 2: 4} design (the loop's
  protocol), carried across with `convert.load_state`: the exported
  posteriors' means within 1e-4 of their scale and variances within 1e-4
  of the prior variance at 64 points (the port multiplies by W = inv(L),
  ROADMAP Queue 3); the `MFAcqScore` values within 1e-3 of their scale (a 1e-4
  posterior error through EI's and PI's z); the acquisition step from
  JAX's starts: the same fidelity and x within 1e-3 of the box width (the
  fixture's UCB has a clear winner);
- fantasy KG, strategies, MACE and the continuous scores on fed draws: 1e-5
  relative where values are compared (best-observed KG: and 1e-6 of the
  value scale over the cost, float32 sums of values near 5); the same pick;
- the loops: monotone incumbents and growing cost, the checkpoint resume
  and the UCB gate's escalation as `tests/test_bo.py` asks of JAX, finite
  continuous records.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.bo import acq as JACQ
from fidelityfusion_tpu.bo import cfkg as JCFKG
from fidelityfusion_tpu.bo import continuous as JCONT
from fidelityfusion_tpu.bo import mace as JMACE
from fidelityfusion_tpu.bo import mf_acq as JMF
from fidelityfusion_tpu.bo import optimize as JOPT
from fidelityfusion_tpu.bo import strategies as JSTRAT
from fidelityfusion_tpu.data import cost as JCOST
from fidelityfusion_tpu.data import objectives as JOBJ
from fidelityfusion_tpu.models import ar as JA
from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
from fidelityfusion_tpu.ops.kernels import SquaredExponentialKernel as JSE
from fidelityfusion_tpu_torch.bo import acq as TACQ
from fidelityfusion_tpu_torch.bo import cfkg as TCFKG
from fidelityfusion_tpu_torch.bo import continuous as TCONT
from fidelityfusion_tpu_torch.bo import mace as TMACE
from fidelityfusion_tpu_torch.bo import mf_acq as TMF
from fidelityfusion_tpu_torch.bo import optimize as TOPT
from fidelityfusion_tpu_torch.bo import strategies as TSTRAT
from fidelityfusion_tpu_torch.bo.continuous_loop import mf_bo_continuous
from fidelityfusion_tpu_torch.bo.loop import acquire, mf_bo_discrete
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.data import cost as TCOST
from fidelityfusion_tpu_torch.data import objectives as TOBJ
from fidelityfusion_tpu_torch.models import ar as TA
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel as TSE

def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("name", ["linear", "power", "continuous"])
def test_cost_models_match_jax(name):
    jc, tc = {"linear": (JCOST.LinearCost(5.0), TCOST.LinearCost(5.0)),
              "power": (JCOST.PowerCost(10.0), TCOST.PowerCost(10.0)),
              "continuous": (JCOST.ContinuousCost(2.0, 0.1, 1.0),
                             TCOST.ContinuousCost(2.0, 0.1, 1.0))}[name]
    z = np.linspace(0.1, 1.0, 7)
    for arg in (z, 2, 0.5):
        np.testing.assert_array_equal(np.asarray(tc.compute_cost(arg)),
                                      np.asarray(jc.compute_cost(arg)))
    data = [np.zeros((5, 1)), np.zeros((3, 1))]
    if name == "continuous":
        assert tc.compute_model_cost(data, [z]) == jc.compute_model_cost(data, [z])
        np.testing.assert_array_equal(tc.transform(z), jc.transform(z))
    else:
        assert tc.compute_model_cost(data) == jc.compute_model_cost(data)
        assert tc.compute_index({1: 10, 2: 4}) == jc.compute_index({1: 10, 2: 4})


@pytest.mark.parametrize("name", ["Forrester2", "Forrester4", "NonLinearSin", "Branin",
                                  "Hartmann3"])
def test_objectives_match_jax(name):
    make, init = {
        "Forrester2": (lambda m: m.Forrester(2), {1: 10, 2: 4}),
        "Forrester4": (lambda m: m.Forrester(4), {1: 16, 2: 8, 3: 6, 4: 4}),
        "NonLinearSin": (lambda m: m.NonLinearSin(), {1: 10, 2: 4}),
        "Branin": (lambda m: m.Branin(), 8),
        "Hartmann3": (lambda m: m.Hartmann3(), 8),
    }[name]
    jo, to = make(JOBJ), make(TOBJ)
    assert to.search_range == jo.search_range
    assert type(to.cost).__name__ == type(jo.cost).__name__
    assert dataclasses.asdict(to.cost) == dataclasses.asdict(jo.cost)
    rng = np.random.default_rng(0)
    x = rng.random((9, to.x_dim))
    fids = (range(1, to.total_fidelity_num + 1) if hasattr(to, "total_fidelity_num")
            else (0.1, 0.55, 1.0, rng.random((9, 1))))
    for s in fids:
        np.testing.assert_array_equal(to.get_data(x, s), jo.get_data(x, s))
    for seed in (0, 3):
        for a, b in zip(to.initiate_data(init, seed), jo.initiate_data(init, seed)):
            for u, v in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(u, v)


# ----------------------------------------------------------- acquisitions


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_single_fidelity_acquisitions_match_jax(dtype):
    rng = np.random.default_rng(1)
    mean = rng.standard_normal(40).astype(dtype)
    var = (rng.random(40) * 2.0 + 1e-3).astype(dtype)
    var[:3] = [0.0, -1e-7, 1e-20]  # the floors
    mean2 = rng.standard_normal((40, 3)).astype(dtype)
    var2 = (rng.random((40, 3)) + 0.1).astype(dtype)
    f_best, th = 0.3, [0.1, -0.2, 0.5]
    tdt = getattr(torch, dtype)
    with jax.enable_x64(dtype == "float64"):
        jm, jv, jm2, jv2 = (jnp.asarray(a) for a in (mean, var, mean2, var2))
        eps = np.array(jax.random.normal(jax.random.PRNGKey(4), (10, 40), jm.dtype))
        eps2 = np.array(jax.random.normal(jax.random.PRNGKey(5), (10, 40, 3), jm.dtype))
        want = [JACQ.ucb(jm, jv, 2.0), JACQ.ei(jm, jv, f_best), JACQ.pi(jm, jv, f_best),
                JACQ.kg(jm, jv, f_best, jax.random.PRNGKey(4)),
                JACQ.kg(jm2, jv2, f_best, jax.random.PRNGKey(5)),
                JACQ.pf(jm2, jv2, th), JACQ.mean_sigma_ratio(jm, jv)]
        want = [np.asarray(w) for w in want]
    tm, tv, tm2, tv2 = (_t(a, tdt) for a in (mean, var, mean2, var2))
    got = [TACQ.ucb(tm, tv, 2.0), TACQ.ei(tm, tv, f_best), TACQ.pi(tm, tv, f_best),
           TACQ.kg(tm, tv, f_best, eps=_t(eps, tdt)), TACQ.kg(tm2, tv2, f_best, eps=_t(eps2, tdt)),
           TACQ.pf(tm2, tv2, th), TACQ.mean_sigma_ratio(tm, tv)]
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        if dtype == "float64":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_optimize_acqf_and_find_next_batch_match_jax():
    """Multi-start Adam from JAX's starts on an analytic peak of value 2 at
    (0.3, 0.6) (scaled per dimension), 60 steps at lr 0.05; the
    random-candidate argmax on JAX's candidates."""
    w = np.asarray([1.0, 3.0], np.float32)

    def jfn(x):
        return 2.0 - jnp.sum(w * (x - jnp.asarray([0.3, 0.6])) ** 2, axis=-1)

    def tfn(x):
        return 2.0 - (_t(w) * (x - _t([0.3, 0.6])) ** 2).sum(-1)

    bounds = np.asarray([[0.0, 1.0], [-1.0, 2.0]])
    key = jax.random.PRNGKey(0)
    lo, hi = bounds[:, 0], bounds[:, 1]
    x0 = np.array(jax.random.uniform(key, (8, 2)) * (hi - lo) + lo, np.float32)
    jx, jv = JOPT.optimize_acqf(jfn, bounds, key, raw_samples=8, steps=60, lr=0.05)
    tx, tv = TOPT.optimize_acqf(tfn, bounds, raw_samples=8, steps=60, lr=0.05, x0=x0,
                                device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    # acq_args call form
    tx2, _ = TOPT.optimize_acqf(lambda x, c: tfn(x) + c, bounds, steps=60, lr=0.05,
                                acq_args=(1.0,), x0=x0, device="cpu")
    np.testing.assert_allclose(tx2.numpy(), tx.numpy(), atol=1e-6)

    key = jax.random.PRNGKey(1)
    cands = np.stack([np.array(jax.random.uniform(k, (500, 2)) * (hi - lo) + lo)
                      for k in jax.random.split(key, 3)])
    jb = np.asarray(JOPT.find_next_batch(jfn, bounds, key, batch_size=3, n_samples=500))
    tb = TOPT.find_next_batch(tfn, bounds, batch_size=3, n_samples=500, candidates=cands,
                              device="cpu")
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-6)


# --------------------------------------- the AR surrogate of the BO loop

SEED = 0


@pytest.fixture(scope="module")
def ar_pair():
    """JAX's AR trained on Forrester's {1: 10, 2: 4} design as the loop
    trains it (non-subset, 100 steps at 5e-2, stages padded to 16), and the
    port's AR with those parameters and stage datasets."""
    f = JOBJ.Forrester(2)
    xs, ys = f.initiate_data({1: 10, 2: 4}, SEED)
    entries = [{"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": xs[i], "Y": ys[i]}
               for i in range(2)]
    jdm = JDM(entries)
    jm = JA.AR(2, [JSE(), JSE()], if_nonsubset=True, input_dim=1)
    JA.train_AR(jm, jdm, max_iter=100, lr_init=5e-2, pad_multiple=16)
    dm = TDM(entries)
    for key, entry in jdm.data_dict.items():
        if entry["fidelity_index"] is None:
            dm.add_data(key, None, entry["X"], entry["Y"])
    tm = TA.AR(2, [TSE(), TSE()], if_nonsubset=True, input_dim=1, device="cpu")
    load_state(tm, _np(jm.params), jm.stage_norm)
    jposts = [jm.export_posterior(jdm, to_fidelity=s, pad_multiple=16) for s in range(2)]
    tposts = [tm.export_posterior(dm, to_fidelity=s, pad_multiple=16) for s in range(2)]
    return {"jm": jm, "jdm": jdm, "tm": tm, "dm": dm, "jposts": jposts, "tposts": tposts,
            "f_best": float(max(np.max(y) for y in ys))}


@pytest.mark.parametrize("s", [0, 1])
def test_export_posterior_matches_jax(ar_pair, s):
    x = np.linspace(0.0, 1.0, 64, dtype=np.float32).reshape(-1, 1)
    jpost, jstate = ar_pair["jposts"][s]
    tpost, tstate = ar_pair["tposts"][s]
    jmean, jvar = (np.asarray(a) for a in jpost(jstate, jnp.asarray(x)))
    tmean, tvar = tpost(tstate, _t(x))
    # the variance's scale is the prior's, which a far point shows: the
    # posterior variance is prior minus explained, and its rounding that
    # of the prior
    prior = float(np.asarray(jpost(jstate, jnp.asarray([[1e3]]))[1]).max())
    np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-4 * np.abs(jmean).max())
    np.testing.assert_allclose(tvar.numpy(), jvar, atol=1e-4 * max(np.abs(jvar).max(), prior))
    np.testing.assert_allclose([float(a) for a in tstate["y_norm"]],
                               [float(a) for a in jstate["y_norm"]], rtol=1e-6)


def _scores(ar_pair, s, method, beta=0.3, x=None):
    jpost, jstate = ar_pair["jposts"][s]
    tpost, tstate = ar_pair["tposts"][s]
    kw = {}
    if method == "UCB":
        kw = {"y_shift": float(jstate["y_norm"][0]), "y_scale": float(jstate["y_norm"][1])}
    js = JMF.MFAcqScore(jpost, method=method, beta=beta, **kw)
    eps = np.array(jax.random.normal(jax.random.PRNGKey(0), (10, len(x)), jnp.float32))
    ts = TMF.MFAcqScore(tpost, method=method, beta=beta, kg_eps=_t(eps), **kw)
    f_best = ar_pair["f_best"]
    return (np.asarray(js(jnp.asarray(x), jstate, jnp.float32(f_best))),
            ts(_t(x), tstate, torch.tensor(f_best)).numpy())


@pytest.mark.parametrize("method", ["UCB", "EI", "PI", "KG"])
def test_mf_acq_score_matches_jax(ar_pair, method):
    x = np.linspace(0.0, 1.0, 16, dtype=np.float32).reshape(-1, 1)
    for s in range(2):
        want, got = _scores(ar_pair, s, method, x=x)
        np.testing.assert_allclose(got, want, atol=1e-3 * max(np.abs(want).max(), 1.0))
    # the generator default of KG is N(0, 1) seeded 0, a fixed draw
    if method == "KG":
        tpost, tstate = ar_pair["tposts"][1]
        ts = TMF.MFAcqScore(tpost, method="KG")
        a, b = (ts(_t(x), tstate, torch.tensor(0.0)) for _ in range(2))
        assert torch.equal(a, b)


@pytest.mark.parametrize("it", [0, 4])
def test_acquisition_step_matches_jax(ar_pair, it):
    """The loop's cached UCB step (JAX `bo/loop.py`'s code path, here
    spelled out) from JAX's starts against the port's `acquire`: the same
    fidelity and x within 1e-3 of the box width; the gate's choice is the
    JAX gate's on the chosen x."""
    import math

    beta = 0.2 * math.log(it + 1.1)
    bounds = np.asarray([[0.0, 1.0]])
    key = jax.random.PRNGKey(SEED)
    f_best = ar_pair["f_best"]
    jxs, jvs, starts = [], [], []
    for s, (post, state) in enumerate(ar_pair["jposts"]):
        score = JMF.MFAcqScore(post, method="UCB", beta=beta, y_shift=float(state["y_norm"][0]),
                               y_scale=float(state["y_norm"][1]))
        k = jax.random.fold_in(jax.random.fold_in(key, it), s)
        starts.append(np.array(jax.random.uniform(k, (16, 1))))
        x_s, v_s = JOPT.optimize_acqf(score, jnp.asarray(bounds, jnp.float32), k,
                                      raw_samples=16, steps=30, lr=0.1,
                                      acq_args=(state, jnp.float32(f_best)))
        jxs.append(np.asarray(x_s))
        jvs.append(float(v_s))
    jx = jxs[int(np.argmax(jvs))].reshape(1, -1)
    js = 1
    for s, (post, state) in enumerate(ar_pair["jposts"]):
        _, v = post(state, jnp.asarray(jx))
        y_std = float(state["y_norm"][1])
        if beta * float(jnp.max(v)) / (y_std * y_std + 1e-12) > 0.01:
            js = s
            break
    tx, ts, tv, _ = acquire(ar_pair["tm"], ar_pair["dm"], "UCB", beta, f_best, bounds,
                            [0.01, 0.01], 30, 0.1, starts=starts)
    assert sorted(jvs)[-1] - sorted(jvs)[0] > 1e-2  # a clear winner
    assert ts == js
    np.testing.assert_allclose(tx, jx, atol=1e-3)
    np.testing.assert_allclose(tv, max(jvs), rtol=1e-3)


# ------------------------------------------------- KG, strategies, MACE


def _toy_posterior(mod):
    """(x, s) -> (mean, var) of the JAX strategy tests, in either package."""
    if mod is jnp:
        return lambda x, s: (jnp.sum(jnp.sin(5 * x), -1), jnp.ones(x.shape[0]) * (0.5 / (s + 1)))
    return lambda x, s: (torch.sin(5 * x).sum(-1), torch.ones(x.shape[0]) * (0.5 / (s + 1)))


def _toy_mean_cov(mod, var_scale=0.3):
    if mod is jnp:
        return (lambda x, s: 5.0 * jnp.exp(-20.0 * (x[:, 0] - 0.5) ** 2) + 0.1 * s,
                lambda x, s: var_scale * jnp.exp(
                    -2.0 * jnp.sum((x[:, None, :] - x[None, :, :]) ** 2, -1)))
    return (lambda x, s: 5.0 * torch.exp(-20.0 * (x[:, 0] - 0.5) ** 2) + 0.1 * s,
            lambda x, s: var_scale * torch.exp(
                -2.0 * ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)))


@pytest.mark.parametrize("is_top,is_last", [(False, False), (True, False), (True, True)])
def test_best_observed_kg_scores_match_jax(is_top, is_last):
    rng = np.random.default_rng(2)
    x = np.sort(rng.random((24, 1)), axis=0).astype(np.float32)
    jmean, jcov = _toy_mean_cov(jnp)
    tmean, tcov = _toy_mean_cov(torch)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (24,)))
    kw = dict(cross_scale=0.8, incumbent=4.0, cost_s=10.0, is_top=is_top, is_last=is_last)
    want = np.asarray(JCFKG.best_observed_kg_scores(
        jmean(jnp.asarray(x), 1), jmean(jnp.asarray(x), 0), jcov(jnp.asarray(x), 0),
        key=key, **kw))
    got = TCFKG.best_observed_kg_scores(tmean(_t(x), 1), tmean(_t(x), 0), tcov(_t(x), 0),
                                        eps=_t(eps), **kw).numpy()
    # float32 values of scale max(incumbent, max mu) = 5 taken off before the cost
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * 5.0 / 10.0)


@pytest.mark.parametrize("name", ["UCB", "EI", "ES", "cfKG"])
def test_strategies_match_jax(name):
    """Each strategy on the JAX tests' analytic posteriors with JAX's draws
    fed: the same x and fidelity."""
    bounds = np.asarray([[0.0, 1.0]])
    post_j, post_t = _toy_posterior(jnp), _toy_posterior(torch)
    if name == "UCB":
        seed, n = 0, 100
        xs = np.array(jax.random.uniform(jax.random.PRNGKey(seed + 1007), (n, 1)))
        for gamma in (0.01, 1e6, 1e-9):
            j = JSTRAT.MFUCBStrategy(1, 2, post_j, iteration=3, gamma=gamma, seed=seed)
            t = TSTRAT.MFUCBStrategy(1, 2, post_t, iteration=3, gamma=gamma, seed=seed,
                                     device="cpu")
            (jx, js), (tx, ts) = j.compute_next(), t.compute_next(draws={"xs": xs})
            assert ts == js
            np.testing.assert_allclose(tx, jx, atol=1e-7)
    elif name == "EI":
        def retrain_var(x, s):
            return 0.5 / (s + 1) * 0.5

        seed = 2
        x0 = np.array(jax.random.uniform(jax.random.PRNGKey(seed + 10086), (16, 1)))
        j = JSTRAT.MFEIStrategy(1, 2, post_j, cost_fn=lambda s: float(s),
                                retrain_variance_fn=retrain_var, f_best=0.5, seed=seed)
        t = TSTRAT.MFEIStrategy(1, 2, post_t, cost_fn=lambda s: float(s),
                                retrain_variance_fn=retrain_var, f_best=0.5, seed=seed,
                                device="cpu")
        (jx, js), (tx, ts) = j.compute_next(), t.compute_next(draws={"x0": x0})
        assert ts == js
        np.testing.assert_allclose(tx, jx, atol=1e-3)
    elif name == "ES":
        for seed, cross, last in ((1, None, False), (3, lambda s: 0.01, False), (3, None, True)):
            k1, _, k3 = jax.random.split(jax.random.PRNGKey(seed + 31), 3)
            draws = {"xs": np.array(jax.random.uniform(k1, (24, 1))),
                     "eps": np.array(jax.random.normal(k3, (32, 24)))}
            kw = dict(cost_fn=lambda s: 10.0 ** s, cross_scale_fn=cross, seed=seed,
                      n_candidates=24, n_mc=32, is_last=last)
            jx, js = JSTRAT.MFESStrategy(1, 2, post_j, **kw).compute_next()
            tx, ts = TSTRAT.MFESStrategy(1, 2, post_t, device="cpu", **kw).compute_next(draws)
            assert ts == js
            np.testing.assert_allclose(tx, jx, atol=1e-7)
    else:
        jmean, jcov = _toy_mean_cov(jnp)
        tmean, tcov = _toy_mean_cov(torch)
        for inc, last in ((0.0, False), (4.9, False), (0.0, True)):
            seed = 5
            kx, ke = jax.random.split(jax.random.PRNGKey(seed + 77))
            draws = {"xs": np.array(jax.random.uniform(kx, (64, 1))),
                     "eps": np.array(jax.random.normal(ke, (24,)))}
            kw = dict(cost_fn=lambda s: 10.0 ** s, incumbent=inc, seed=seed, is_last=last,
                      cross_scale_fn=lambda s: 0.9, bounds=bounds)
            jx, js = JSTRAT.CFKGStrategy(1, 2, jmean, jcov, **kw).compute_next()
            tx, ts = TSTRAT.CFKGStrategy(1, 2, tmean, tcov, device="cpu", **kw).compute_next(
                draws)
            assert ts == js
            np.testing.assert_allclose(tx, jx, atol=1e-7)


def test_pmax_entropy_and_mace_match_jax():
    mean = np.sin(np.linspace(0, 6, 32)).astype(np.float32)
    std = (0.1 + 0.3 * np.linspace(0, 1, 32) ** 2).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (256, 32)))
    want = float(JSTRAT.MFESStrategy._pmax_entropy(jnp.asarray(mean), jnp.asarray(std), key,
                                                    256))
    got = float(TSTRAT.MFESStrategy._pmax_entropy(_t(mean), _t(std), _t(eps)))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    objs = np.asarray([[0.0, 1.0], [1.0, 0.0], [0.5, 0.5], [1.0, 1.0], [0.5, 0.5]])
    np.testing.assert_array_equal(TMACE.pareto_mask(_t(objs)).numpy(),
                                  np.asarray(JMACE.pareto_mask(jnp.asarray(objs))))
    rng = np.random.default_rng(3)
    m, v = rng.standard_normal(50).astype(np.float32), (rng.random(50) + 0.05).astype(np.float32)
    for th in (None, [0.2]):
        want = np.asarray(JMACE.mace_objectives(jnp.asarray(m), jnp.asarray(v), 0.4, th))
        got = TMACE.mace_objectives(_t(m), _t(v), 0.4, th).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(TMACE.pareto_mask(_t(want)).numpy(),
                                      np.asarray(JMACE.pareto_mask(jnp.asarray(want))))
    x = TMACE.mace_select(lambda xs: (torch.sin(3 * xs).sum(-1), torch.full((xs.shape[0],), 0.2)),
                          np.array([[0.0, 1.0]]), f_best=0.5, n_candidates=128, device="cpu")
    assert x.shape == (1, 1) and 0.0 <= x[0, 0] <= 1.0


def test_retrain_gain_matches_fantasy_gain():
    """`tests/test_strategies.py`'s contract, in the port: the rank-1
    fantasy KG and the append-and-recompute KG agree in value and ranking
    on a seeded CIGP posterior."""
    from fidelityfusion_tpu_torch.models.cigp import CIGP

    rng = np.random.default_rng(3)
    x_tr = _t(np.sort(rng.random((24, 1)) * 6, axis=0))
    y_tr = _t(np.sin(x_tr.numpy()) + 0.05 * rng.standard_normal((24, 1)))
    gp = CIGP(kernel=TSE())
    params = gp.init_params(1, device="cpu")
    params["log_beta"] = torch.tensor([3.0])

    def mean_fn(x, s=0):
        return gp.predict_diag(params, x_tr, y_tr, x)[0]

    def var_fn(x, s=0):
        return gp.predict_diag(params, x_tr, y_tr, x)[1]

    def cov_fn(a, b, s=0):
        _, cov = gp.predict(params, x_tr, y_tr, torch.cat([a, b], dim=0))
        return cov[: a.shape[0], a.shape[0]:] - gp.noise(params)

    grid = torch.linspace(0.0, 6.0, 40).reshape(-1, 1)
    cands = _t([[0.4], [1.7], [2.9], [4.1], [5.3], [5.9]])
    with torch.no_grad():
        fast = np.asarray([float(TCFKG.fantasy_gain(mean_fn, var_fn, cov_fn, cands[i:i + 1], 0,
                                                    grid, 1.0)) for i in range(6)])
    full = np.asarray([TCFKG.retrain_gain(gp, params, x_tr, y_tr, cands[i:i + 1], grid, 1.0)
                       for i in range(6)])
    scale = max(np.abs(full).max(), 1e-6)
    np.testing.assert_allclose(fast, full, atol=5e-3 * scale + 1e-6, rtol=0.05)
    assert list(np.argsort(fast)) == list(np.argsort(full)), (fast, full)


def test_continuous_scores_match_jax():
    """`information_gap`, `gamma_z`, max-value ES and the best-observed KG
    (mid-loop and last iteration) on fed grids and draws."""
    srange = [[0.0, 1.0], [0.1, 1.0]]
    cost = TCOST.ContinuousCost(2.0, 0.1, 1.0)
    jcost = JCOST.ContinuousCost(2.0, 0.1, 1.0)
    ju = JCONT.ContinuousFidelityUCB(1, srange, None, jcost, seed=4)
    tu = TCONT.ContinuousFidelityUCB(1, srange, None, cost, seed=4, device="cpu")
    tu.z_range = ju.z_range
    xi = ju.information_gap(ju.z_range)
    np.testing.assert_allclose(tu.information_gap(tu.z_range), xi, rtol=1e-12)
    np.testing.assert_allclose(tu.gamma_z(xi), ju.gamma_z(xi), rtol=1e-12)

    def jpost(x, z):
        return jnp.sum(jnp.sin(5 * x), -1) * z, jnp.ones(x.shape[0]) * (0.4 + 0.1 * z)

    def tpost(x, z):
        return torch.sin(5 * x).sum(-1) * z, torch.ones(x.shape[0]) * (0.4 + 0.1 * z)

    je = JCONT.ContinuousFidelityES(1, srange, jpost, jcost, seed=2, n_candidates=24, n_mc=32,
                                    maximize=True)
    te = TCONT.ContinuousFidelityES(1, srange, tpost, cost, seed=2, n_candidates=24, n_mc=32,
                                    maximize=True, device="cpu")
    te.xs, te.zs = je.xs, je.zs
    eps = np.array(jax.random.normal(jax.random.PRNGKey(2 + 131), (32, 24)))
    (jx, jz), (tx, tz) = je.compute_next(), te.compute_next(eps=eps)
    np.testing.assert_allclose(tx, jx)
    assert tz == pytest.approx(jz)

    def jmc(xz):
        x = xz[:, 0]
        d2 = (xz[:, None, 0] - xz[None, :, 0]) ** 2
        return 5.0 * jnp.exp(-20.0 * (x - 0.5) ** 2) * xz[:, 1], 0.05 * jnp.exp(-4.0 * d2)

    def tmc(xz):
        x = xz[:, 0]
        d2 = (xz[:, None, 0] - xz[None, :, 0]) ** 2
        return 5.0 * torch.exp(-20.0 * (x - 0.5) ** 2) * xz[:, 1], 0.05 * torch.exp(-4.0 * d2)

    seed = 1
    kx, kg, ke = jax.random.split(jax.random.PRNGKey(seed + 86), 3)
    xs, zs = JCONT._candidate_grid(kx, srange, 1, 48)
    draws = {"xs": xs, "zs": zs, "grid": JCONT._candidate_grid(kg, srange, 1, 64)[0],
             "eps": np.array(jax.random.normal(ke, (24,)))}
    for inc, last in ((0.0, False), (3.0, False), (0.0, True)):
        jx, jz = JCONT.continuous_best_observed_kg(jmc, srange, jcost, incumbent=inc, seed=seed,
                                                   is_last=last)
        tx, tz = TCONT.continuous_best_observed_kg(tmc, srange, cost, incumbent=inc, seed=seed,
                                                   is_last=last, draws=draws, device="cpu")
        np.testing.assert_allclose(tx, jx)
        assert tz == pytest.approx(jz)


# ---------------------------------------------------------------- loops


def _monotone(rec):
    inc, cost = rec["incumbents"], rec["cost"]
    return (all(b >= a - 1e-9 for a, b in zip(inc, inc[1:]))
            and all(b > a for a, b in zip(cost, cost[1:])))


@pytest.mark.parametrize("model_name,iters", [("AR", 3), ("ResGP", 2), ("NAR", 2)])
def test_mf_bo_discrete_loop(model_name, iters):
    """`tests/test_bo.py`'s short loops: incumbents monotone, cost growing,
    every record finite, the time split recorded."""
    rec = mf_bo_discrete(TOBJ.Forrester(2), method="UCB", model_name=model_name,
                         bo_iterations=iters, init_index={1: 8, 2: 4}, seed=0,
                         train_iters=40 if model_name == "AR" else 30,
                         acq_iterations=15 if model_name == "AR" else 10, device="cpu")
    assert len(rec["incumbents"]) == iters and len(rec["S"]) == iters
    assert _monotone(rec)
    assert np.isfinite(rec["X"]).all() and np.isfinite(rec["incumbents"]).all()
    for t, a, b in zip(rec["operation_time"], rec["train_time"], rec["acq_time"]):
        assert 0 < a + b <= t


def test_mf_bo_checkpoint_resume(tmp_path):
    f = TOBJ.Forrester(2)
    ckpt = str(tmp_path / "bo.npz")
    kw = dict(init_index={1: 8, 2: 4}, seed=0, train_iters=30, acq_iterations=10,
              checkpoint_path=ckpt, device="cpu")
    rec1 = mf_bo_discrete(f, bo_iterations=2, **kw)
    assert len(rec1["S"]) == 2
    rec2 = mf_bo_discrete(f, bo_iterations=4, **kw)
    assert len(rec2["S"]) == 4
    assert rec2["incumbents"][:2] == rec1["incumbents"]


def test_mf_bo_ucb_gate_escalates_in_normalized_space():
    """Within five iterations the ladder reaches the top fidelity and the
    incumbent does not fall below the initial design's best."""
    rec = mf_bo_discrete(TOBJ.Forrester(2), method="UCB", bo_iterations=5,
                         init_index={1: 10, 2: 4}, seed=0, train_iters=30, acq_iterations=10,
                         device="cpu")
    assert any(int(s) == 1 for s in rec["S"]), rec["S"]
    assert rec["incumbents"][-1] > rec["incumbents"][0] - 1e-9


@pytest.mark.parametrize("method", ["UCB", "ES", "KG"])
def test_mf_bo_continuous_loop(method):
    rec = mf_bo_continuous(TOBJ.Branin(), method=method, bo_iterations=2, n_init=6, seed=0,
                           train_iters=40, device="cpu")
    assert len(rec["incumbents"]) == 2
    assert np.isfinite(rec["incumbents"]).all() and np.isfinite(rec["X"]).all()
    assert all(0.1 <= z <= 1.0 for z in rec["Z"])
    assert rec["incumbents"][1] >= rec["incumbents"][0] - 1e-9
    if method == "ES":
        assert rec["Z"][-1] == 1.0
