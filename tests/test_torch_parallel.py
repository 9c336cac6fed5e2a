"""The port's sharding layer (`fidelityfusion_tpu_torch/parallel/`, the
trainers' ``n_mesh`` stages, `experiments/sharded_sweep.py`, example 05)
against the JAX package on the CPU.

The port's side runs in two gloo worlds of 4 ranks, spawned together once
for the module (`tests/torch_parallel_workers.py`, which imports no JAX), while the
JAX side runs here on the 8-device virtual CPU mesh with 4 devices on the
sharded axis (`make_n_mesh(4)`, `make_rn_mesh(2, 2)`), so both pad alike.
Inputs come from numpy seeds (and the JAX restart batches from
`perturb_params`, passed to the port as arrays).

Bars are the JAX tests' own (`tests/test_nsharded.py`,
`test_kron_nsharded.py`, `test_parallel.py`, `test_trainer_nsharded.py`):
NLML 1e-3 of max(1, |v|) and gradients 2e-3 a leaf (max abs difference
over the leaf's max); posteriors atol 2e-4 on the mean, rtol 2e-3 / atol
2e-5 on the variance; restart NLMLs rtol 1e-3 / atol 1e-4; the tracked
Kronecker loss 2e-4 of max(1, |v|), its gradients 5e-3; training
trajectories rtol 2e-3; the cascades' test RMSE and relative-error bars.
Added here: in float64 the sharded NLML and gradient at P = 4 equal the
port's unsharded `CIGP.nll` to 1e-9 relative, and the sharded tracked
Kronecker loss and gradient its unsharded `HOGP.nll_tracked` (which holds
the algorithms and the cross-rank gradient contract exactly); the sharded restart fit
equals the port's unsharded `fit_restarts` at `test_parallel.py`'s 1e-4;
the seed sweep's metric rows equal JAX's to 1e-3 relative.
"""

import concurrent.futures
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models.cigp import CIGP as JCIGP
from fidelityfusion_tpu.models.hogp import HOGP as JHOGP
from fidelityfusion_tpu.ops.kernels import ARDKernel as JARD
from fidelityfusion_tpu.ops.kernels import SquaredExponentialKernel as JSE
from fidelityfusion_tpu.parallel import kron_nsharded as JK
from fidelityfusion_tpu.parallel import nsharded as JN
from fidelityfusion_tpu.train.fit import perturb_params as j_perturb

ROOT = Path(__file__).resolve().parents[1]
WORKERS = Path(__file__).resolve().parent / "torch_parallel_workers.py"
WORLD = 4
# two worlds run at once: the trainers (about a minute) and everything else
WORLDS = (("nll", "nll64", "posterior", "restarts", "fit_nsharded", "fit_restarts", "hogp",
           "hogp64", "fit_hogp", "mesh", "sweep", "sweep200", "scaling"), ("trainers",))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree, keys sorted (the same
    order for a JAX tree and the port's numpy one)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree))]


def _grad_rel_err(g_port, g_ref):
    return {p: float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
            for (p, a), (_, b) in zip(_flat(g_port), _flat(g_ref))}


def _cigp_fixture(n, d_in, d_out=1, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d_in)) * 4).astype(np.float32)
    y = (np.sin(x.sum(1, keepdims=True)) * np.linspace(1.0, 2.0, d_out)[None, :]
         + 0.1 * rng.standard_normal((n, d_out))).astype(np.float32)
    return x, y


def _jgp(kind):
    return JCIGP(kernel=JARD() if kind == "ard" else JSE(), se_analytic_nll=False,
                 hybrid_nll=False)


NLL_CASES = [  # (n, d_in, d_out, kernel, y_var): the last two pad to 252 rows
    (256, 2, 1, "ard", False), (250, 3, 2, "ard", False), (250, 2, 1, "se", True)]


def _nll_inputs():
    out = []
    for n, d_in, d_out, kind, with_var in NLL_CASES:
        x, y = _cigp_fixture(n, d_in, d_out)
        yv = (np.random.default_rng(1).random(n) * 0.05).astype(np.float32) if with_var else None
        out.append({"x": x, "y": y, "y_var": yv, "kernel": kind,
                    "params": _np(_jgp(kind).init_params(d_in))})
    return out


def _toy_sin():
    """`tests/conftest.py:toy_sin_data`, rebuilt from its numpy seed."""
    rng = np.random.default_rng(1)
    x_all = rng.random((500, 1)) * 20
    idx = [np.sort(rng.permutation(500)[:k]) for k in (300, 300, 250)]
    xs = [x_all[i] for i in idx]
    noise = lambda n: rng.random((n, 1)) * 0.1 - 0.05  # noqa: E731
    ys = [np.sin(xs[0]) - 0.5 * np.sin(2 * xs[0]) + noise(300),
          np.sin(xs[1]) - 0.3 * np.sin(2 * xs[1]) + noise(300),
          np.sin(xs[2]) + noise(250)]
    x_test = np.linspace(0, 20, 100).reshape(-1, 1)
    return list(zip(xs, ys)), (x_test, np.sin(x_test))


def _inputs():
    from fidelityfusion_tpu.data.pde import generate_poisson_mf_dataset

    inp = {"nll": _nll_inputs()}
    inp["nll64"] = [{"x": c["x"].astype(np.float64), "y": c["y"].astype(np.float64),
                     "kernel": c["kernel"], "params": c["params"]} for c in inp["nll"][:2]]
    post = []
    for n, m, seed in ((256, 17, 9), (75, 17, 5)):
        rng = np.random.default_rng(seed)
        x = (rng.random((n, 2)) * 3).astype(np.float32)
        post.append({"x": x, "y": np.sin(x.sum(1, keepdims=True)).astype(np.float32),
                     "xt": (rng.random((m, 2)) * 3).astype(np.float32),
                     "params": _np(_jgp("ard").init_params(2))})
    inp["posterior"] = post

    x, y = _cigp_fixture(96, 2, seed=7)
    rng = np.random.default_rng(8)
    batch = _np(j_perturb(jax.random.PRNGKey(0), _jgp("ard").init_params(2), n=4))
    from fidelityfusion_tpu.models.coupling import TensorLinear as JTL

    tl = JTL((2, 3), (3, 3))
    inp["restarts"] = {
        "x": x, "yl": y, "yh": (y * 1.3 + 0.1 * rng.standard_normal(y.shape)).astype(np.float32),
        "yl_t": rng.standard_normal((96, 6)).astype(np.float32),
        "yh_t": rng.standard_normal((96, 9)).astype(np.float32),
        "l_shape": (2, 3), "h_shape": (3, 3), "shift": 0.1, "scale": 1.3,
        "batch_residual": {"gp": batch, "rho": np.linspace(0.6, 1.4, 4).astype(np.float32)},
        "batch_lift": {"gp": batch, "tl": _np(jax.tree_util.tree_map(
            lambda a: jnp.stack([a * (1.0 + 0.05 * i) for i in range(4)]), tl.init_params()))}}

    rng = np.random.default_rng(5)
    x = (rng.random((256, 2)) * 3).astype(np.float32)
    inp["fit_nsharded"] = {"x": x, "y": np.sin(x.sum(1, keepdims=True)).astype(np.float32),
                           "params": _np(_jgp("ard").init_params(2)), "steps": 15}
    batch = jax.tree_util.tree_map(np.array, batch)
    batch["log_beta"][1] = np.nan  # restart 1 diverges from its first step
    inp["fit_restarts"] = {"x": inp["restarts"]["x"], "y": inp["restarts"]["yl"],
                           "batch": batch, "steps": 10}

    hogp_cases = []
    for step in (0, 1):
        hogp_cases.append(dict(_hogp_fixture(64, (4, 3), 0), step=step, y_var=None))
    c = _hogp_fixture(32, (3, 3), 1)
    c.update(step=0, y_var=(np.random.default_rng(2).random(32) * 0.1).astype(np.float32))
    hogp_cases.append(c)
    inp["hogp"] = hogp_cases
    inp["hogp64"] = [dict(c, x=c["x"].astype(np.float64), y=c["y"].astype(np.float64))
                     for c in hogp_cases[:2]]
    inp["fit_hogp"] = dict(_hogp_fixture(64, (4, 4), 3), steps=12)

    rng = np.random.default_rng(0)
    x = (rng.random((48, 1)) * 6).astype(np.float32)
    gp = JCIGP(kernel=JSE())
    p = gp.init_params(1)
    from fidelityfusion_tpu.ops import linalg as JL
    from jax.scipy.linalg import cho_solve

    Sigma = JL.assemble_sigma(gp.kernel.apply(p["kernel"], x, x), gp.noise(p))
    alpha = cho_solve((JL.cholesky(Sigma), True), jnp.sin(x))
    inp["mesh"] = {"x": x, "y": np.sin(x), "params": _np(p),
                   "batch": _np(j_perturb(jax.random.PRNGKey(0), p, n=8)),
                   "cands": np.linspace(0, 6, 64, dtype=np.float32).reshape(-1, 1),
                   "xt": np.linspace(0, 6, 80, dtype=np.float32).reshape(-1, 1),
                   "alpha": np.asarray(alpha)}
    inp["sweep"] = dict(SWEEP)
    inp["sweep200"] = dict(SWEEP, steps=200)
    inp["scaling"] = {"n": 64, "steps": 10, "restarts_per_device": 2, "reps": 1}
    train, test = _toy_sin()
    inp["trainers"] = {"toy_train": train, "toy_test": test, "iters": 60, "field_iters": 60,
                       "fields": generate_poisson_mf_dataset(n_samples=48, resolutions=(6, 10, 14),
                                                             d_in=4, seed=3)}
    return inp


# 50 steps for equality with JAX: at lr 5e-2 on 12 high rows the two float32
# trajectories part later (max relative metric difference 4.7e-4 at 50
# steps, 1.2e-3 at 100, 4e-2 at 150); the JAX harness's 200 steps are held
# to its own bar (`tests/test_experiments.py:test_sharded_seed_sweep`)
SWEEP = {"dataset": "tl112", "seeds": [0, 1, 2, 3], "n_high": 12, "n_low": 48, "n_test": 32,
         "steps": 50}


def _hogp_fixture(n, shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 2)) * 4).astype(np.float32)
    y = rng.standard_normal((n,) + shape).astype(np.float32)
    hogp = JHOGP(kernel=JARD(), output_shape=shape)
    params = hogp.init_params(2)
    # a realistic V_prev for a tracked step: the eigenbasis at perturbed params
    p2 = jax.tree_util.tree_map(lambda a: a * 1.05, params)
    _, V_prev = jnp.linalg.eigh(hogp.kernel.apply(p2["kernel"], x, x) + hogp.jitter * jnp.eye(n))
    return {"x": x, "y": y, "shape": shape, "params": _np(params), "V_prev": np.asarray(V_prev)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's results, computed by two 4-rank gloo worlds started here
    (`WORLDS`); the JAX side of each test runs while they work."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    inputs = _inputs()
    torch.save(inputs, tmp / "inputs.pt")
    from fidelityfusion_tpu_torch.parallel.multihost import free_ports, launch_local_world

    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    runs = [(tasks, tmp / f"out{i}.pt", pool.submit(
        launch_local_world, [sys.executable, str(WORKERS), str(tmp / "inputs.pt"),
                             str(tmp / f"out{i}.pt"), *tasks], WORLD, 900, cwd=str(ROOT),
        port=port))
            for i, (tasks, port) in enumerate(zip(WORLDS, free_ports(len(WORLDS))))]
    results = {}

    def get(name):
        if name not in results:
            tasks, out, run = next(r for r in runs if name in r[0])
            bad = [(r, c, e[-4000:]) for r, (c, _, e) in enumerate(run.result()) if c != 0]
            assert not bad, bad
            got = torch.load(out, weights_only=False)
            print("port world seconds by task:", got.pop("seconds"))
            results.update(got)
        return results[name]

    yield inputs, get
    pool.shutdown()


def _j_mesh_n():
    return JN.make_n_mesh(WORLD)


@pytest.mark.parametrize("case", range(len(NLL_CASES)),
                         ids=[f"{n}x{d}x{o}-{k}{'-yvar' if v else ''}"
                              for n, d, o, k, v in NLL_CASES])
def test_cigp_nll_nsharded_value_and_grad_match_jax(world, case):
    inputs, get = world
    c = inputs["nll"][case]
    gp, mesh = _jgp(c["kernel"]), _j_mesh_n()
    yv = None if c["y_var"] is None else jnp.asarray(c["y_var"])
    v_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: JN.cigp_nll_nsharded(gp, p, c["x"], c["y"], mesh, y_var=yv)))(c["params"])
    v, g = get("nll")[case]
    assert abs(float(v) - float(v_ref)) < 1e-3 * max(1.0, abs(float(v_ref))), (v, v_ref)
    errs = _grad_rel_err(g, g_ref)
    assert max(errs.values()) < 2e-3, errs


@pytest.mark.parametrize("case", range(2), ids=["256x2x1", "250x3x2-padded"])
def test_cigp_nll_nsharded_float64_equals_unsharded_port(world, case):
    """Float64, P = 4: the sharded value and gradient against the port's
    own unsharded NLML, to 1e-9 relative."""
    _, get = world
    (v, g), (v_ref, g_ref) = get("nll64")[case]
    assert abs(float(v) - float(v_ref)) <= 1e-9 * abs(float(v_ref)), (v, v_ref)
    errs = _grad_rel_err(g, g_ref)
    assert max(errs.values()) <= 1e-9, errs


@pytest.mark.parametrize("case", range(2), ids=["256-rows", "75-rows-padded"])
def test_cigp_posterior_nsharded_matches_jax(world, case):
    inputs, get = world
    c = inputs["posterior"][case]
    gp = _jgp("ard")
    mesh = _j_mesh_n()
    m_ref, v_ref = jax.jit(lambda p: JN.cigp_posterior_nsharded(gp, p, c["x"], c["y"], c["xt"],
                                                                mesh))(c["params"])
    m_dense, v_dense = gp.predict_diag(c["params"], c["x"], c["y"], c["xt"])
    m, v = get("posterior")[case]
    for ref_m, ref_v in ((m_ref, v_ref), (m_dense, v_dense)):
        np.testing.assert_allclose(m, np.asarray(ref_m), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(v, np.asarray(ref_v), rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("kind", ["residual", "lift"])
def test_restarts_nll_nsharded_2d_mesh_matches_jax(world, kind):
    """(2, 2) mesh, the restarts on "r": the AR rho stage and the CIGAR
    lift, values and gradients."""
    inputs, get = world
    c = inputs["restarts"]
    gp, mesh = _jgp("ard"), JN.make_rn_mesh(2, 2)
    lift = None
    if kind == "lift":
        from fidelityfusion_tpu.models.coupling import TensorLinear as JTL

        lift = JTL(c["l_shape"], c["h_shape"])
        yl, yh = c["yl_t"], c["yh_t"]
    else:
        yl, yh = c["yl"], c["yh"]

    def total(pb):
        ls = JN.restarts_nll_nsharded(gp, pb, c["x"], None, mesh, r_axis="r",
                                      residual=(yl, yh, c["shift"], c["scale"]), lift=lift)
        return jnp.sum(ls), ls

    (_, ls_ref), g_ref = jax.jit(jax.value_and_grad(total, has_aux=True))(c[f"batch_{kind}"])
    ls, g = get("restarts")[kind]
    np.testing.assert_allclose(ls, np.asarray(ls_ref), rtol=1e-3, atol=1e-4)
    errs = _grad_rel_err(g, g_ref)
    assert max(errs.values()) < 2e-3, errs


def test_fit_nsharded_matches_jax(world):
    inputs, get = world
    c = inputs["fit_nsharded"]
    _, losses_ref = JN.fit_nsharded(_jgp("ard"), c["params"], c["x"], c["y"], _j_mesh_n(),
                                    steps=c["steps"], lr=5e-2)
    _, losses = get("fit_nsharded")
    np.testing.assert_allclose(losses, np.asarray(losses_ref), rtol=2e-3)
    assert losses[-1] < losses[0]


def test_fit_restarts_nsharded_rolls_back_a_nan_restart(world):
    """Restart 1 starts at a NaN log_beta: it never takes a step, its final
    NLML is +inf and it cannot win; the others and the winner are JAX's."""
    inputs, get = world
    c = inputs["fit_restarts"]
    mesh = JN.make_rn_mesh(2, 2)
    best_ref, final_ref = jax.jit(lambda b: JN.fit_restarts_nsharded(
        _jgp("ard"), b, c["x"], c["y"], mesh, steps=c["steps"], lr=5e-2, r_axis="r"))(c["batch"])
    best, final = get("fit_restarts")
    final_ref = np.asarray(final_ref)
    assert np.isinf(final[1]) and np.isinf(final_ref[1])
    live = [0, 2, 3]
    assert np.all(np.isfinite(final[live]))
    np.testing.assert_allclose(final[live], final_ref[live], rtol=1e-3, atol=1e-4)
    assert int(np.argmin(final)) == int(np.argmin(final_ref))
    for (p, a), (_, b) in zip(_flat(best), _flat(best_ref)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4, err_msg=p)


@pytest.mark.parametrize("case", range(3), ids=["64x4x3-refresh", "64x4x3-tracked",
                                                "32x3x3-yvar"])
def test_hogp_nll_tracked_nsharded_matches_jax(world, case):
    """The refresh step (a replicated eigh of the gathered Gram), a tracked
    step (the distributed Jacobi sweep) and ``y_var``: value and every
    parameter's gradient."""
    inputs, get = world
    c = inputs["hogp"][case]
    hogp = JHOGP(kernel=JARD(), output_shape=c["shape"])
    aux = (jnp.asarray(c["V_prev"]), jnp.zeros((), jnp.float32))
    yv = None if c["y_var"] is None else jnp.asarray(c["y_var"])
    mesh = _j_mesh_n()
    v_ref, g_ref = jax.jit(jax.value_and_grad(lambda p: JK.hogp_nll_tracked_nsharded(
        hogp, p, aux, jnp.float32(c["step"]), c["x"], c["y"], mesh, refresh_every=64,
        y_var=yv)[0]))(c["params"])
    v, g = get("hogp")[case]
    assert abs(float(v) - float(v_ref)) < 2e-4 * max(1.0, abs(float(v_ref))), (v, v_ref)
    errs = _grad_rel_err(g, g_ref)
    assert max(errs.values()) < 5e-3, errs


@pytest.mark.parametrize("case", range(2), ids=["64x4x3-refresh", "64x4x3-tracked"])
def test_hogp_nll_tracked_nsharded_float64_equals_unsharded_port(world, case):
    """Float64, P = 4: the sharded tracked value and every parameter's
    gradient against the port's own unsharded `nll_tracked`, to 1e-9
    relative."""
    _, get = world
    (v, g), (v_ref, g_ref) = get("hogp64")[case]
    assert abs(float(v) - float(v_ref)) <= 1e-9 * abs(float(v_ref)), (v, v_ref)
    errs = _grad_rel_err(g, g_ref)
    assert max(errs.values()) <= 1e-9, errs


def test_fit_hogp_nsharded_matches_jax(world):
    inputs, get = world
    c = inputs["fit_hogp"]
    hogp = JHOGP(kernel=JARD(), output_shape=c["shape"])
    good_ref, losses_ref, _ = JK.fit_hogp_nsharded(hogp, c["params"], c["x"], c["y"],
                                                   _j_mesh_n(), steps=c["steps"], lr=5e-2)
    good, losses = get("fit_hogp")
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, np.asarray(losses_ref), rtol=2e-3, atol=2e-4)
    for (p, a), (_, b) in zip(_flat(good), _flat(good_ref)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4, err_msg=p)


def test_sharded_fit_restarts_matches_unsharded(world):
    """`sharded_fit_restarts` over 4 ranks (2 restarts each) against the
    port's unsharded `fit_restarts` (test_parallel.py's 1e-4 bars) and the
    JAX one: each loss within 1e-3 of max(1, |loss|) (the NLML bar; two
    float32 trajectories part by ~1e-5 of the losses' scale over 30 steps,
    which is 4e-2 relative where a history crosses zero)."""
    from fidelityfusion_tpu.train.fit import fit_restarts as j_fit_restarts
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import fit_restarts
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    inputs, get = world
    c = inputs["mesh"]
    gp = CIGP(kernel=SquaredExponentialKernel())
    x, y = torch.tensor(c["x"]), torch.tensor(c["y"])
    best_u, res_u = fit_restarts(lambda p: gp.nll(p, x, y),
                                 tree_map(torch.tensor, c["batch"]), steps=30, lr=5e-2)
    jgp = JCIGP(kernel=JSE())
    best_j, res_j = j_fit_restarts(lambda p: jgp.nll(p, c["x"], c["y"]), c["batch"], steps=30,
                                   lr=5e-2)
    r = get("mesh")
    np.testing.assert_allclose(r["losses"], res_u.losses.numpy(), rtol=1e-4, atol=1e-5)
    lj = np.asarray(res_j.losses)
    assert np.all(np.abs(r["losses"] - lj) <= 1e-3 * np.maximum(1.0, np.abs(lj)))
    for (p, a), (_, b) in zip(_flat(r["best"]), _flat(tree_map(lambda t: t.numpy(), best_u))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=p)


def test_sharded_acq_argmax_and_posterior_mean(world):
    """The argmax over gathered scores is the dense one (test_parallel.py);
    the row-sharded posterior mean is the dense K_* alpha of JAX."""
    inputs, get = world
    c = inputs["mesh"]
    r = get("mesh")
    assert np.isclose(r["bv"], r["vals"].max(), rtol=1e-5)
    np.testing.assert_allclose(r["bx"], c["cands"][np.argmax(r["vals"])], rtol=1e-6)
    jgp = JCIGP(kernel=JSE())
    mean_j, var_j = jgp.predict_diag(c["params"], c["x"], c["y"], c["cands"])
    vals_j = np.asarray(mean_j).reshape(-1) + np.sqrt(np.maximum(np.asarray(var_j), 0.0))
    assert np.isclose(r["bv"], vals_j.max(), rtol=1e-4)
    dense = np.asarray(jgp.kernel.apply(c["params"]["kernel"], c["xt"], c["x"])) @ c["alpha"]
    np.testing.assert_allclose(r["mean"], dense, rtol=1e-4, atol=1e-5)


def test_sharded_seed_sweep_matches_jax(world):
    from fidelityfusion_tpu.experiments.sharded_sweep import run_sharded_seed_sweep as j_sweep

    _, get = world
    rows_ref = j_sweep(mesh=jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("restart",)),
                       **SWEEP)
    rows = get("sweep")
    assert [r["seed"] for r in rows] == SWEEP["seeds"]
    for r, ref in zip(rows, rows_ref):
        assert set(r) == set(ref)
        for k in ("r2", "rmse", "nll", "nrmse"):
            assert abs(r[k] - ref[k]) <= 1e-3 * max(abs(ref[k]), 1e-3), (k, r, ref)


def test_sharded_seed_sweep_at_the_harness_steps(world):
    """200 steps (the harness's default): every row finite, the median RMSE
    under the JAX test's bar (tl1 targets span about [-10, 17])."""
    rows = world[1]("sweep200")
    assert [r["seed"] for r in rows] == SWEEP["seeds"]
    assert all(np.isfinite([r[k] for k in ("r2", "rmse", "nll", "nrmse")]).all() for r in rows)
    assert np.median([r["rmse"] for r in rows]) < 2.0


def test_restart_scaling_efficiency_runs(world):
    _, get = world
    res = get("scaling")
    assert res["weak_scaling_efficiency_D1"] == 1.0
    assert 0.0 < res[f"weak_scaling_efficiency_D{WORLD}"] <= 1.5
    assert res["time_s_D1"] > 0


@pytest.mark.parametrize("name,bar", [("AR-n", 0.12), ("AR-rn", 0.12), ("NAR", 0.15),
                                      ("GAR", 0.6), ("CIGAR", 0.6)])
def test_trainers_with_n_mesh(world, name, bar):
    """Every stage n-sharded (``nshard_min_rows=1``) over 4 ranks, as
    `tests/test_trainer_nsharded.py` drives the JAX trainers: test RMSE
    (toy sin, 300/300/250 rows, so the padded path too) or relative error
    (Poisson fields) under its bars."""
    _, get = world
    out = get("trainers")[name]
    if name in ("GAR", "CIGAR"):
        rel, var = out
        assert rel < bar, (name, rel)
        assert np.all(np.isfinite(var)) and (name == "GAR" or np.all(var > 0))
    else:
        assert out < bar, (name, out)


def test_initialize_distributed_single_process():
    import torch.distributed as dist

    from fidelityfusion_tpu_torch.parallel.multihost import (
        initialize_distributed, is_main_process)

    assert not dist.is_initialized()
    try:
        info = initialize_distributed(device="cpu")
        assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                        "global_devices": 1}
        assert is_main_process() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_nccl_with_more_ranks_than_gpus_raises():
    """The backend rule never switches on its own: NCCL asked for more ranks
    than there are visible GPUs raises (here none is visible); gloo is
    chosen for the CPU or when named."""
    from fidelityfusion_tpu_torch.parallel.collectives import choose_backend

    with pytest.raises(RuntimeError, match="NCCL needs one GPU per rank"):
        choose_backend("cuda", "nccl", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        choose_backend("cpu", "nccl", 1)
    assert choose_backend("cpu", None, 4) == "gloo"
    assert choose_backend("cuda", "gloo", 4) == "gloo"


def test_example_05_runs_on_the_cpu():
    # the timeout is below the suite's per-test time limit (the root conftest.py)
    out = subprocess.run([sys.executable, "-m",
                          "fidelityfusion_tpu_torch.examples.ex05_large_n_scaling", "--cpu",
                          "--n", "128"], cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for part in range(1, 7):
        assert any(line.startswith(f"[{part}]") for line in lines), out.stdout
    assert "test RMSE" in out.stdout
