"""The CAR-large cell of the port's benchmark (`portbench/`, cell
`car.fit-joint-p4-5376`) on the CPU at small sizes: the port's joint GP
against the plain reference (`portbench/reference/car.py`) in float64 and
float32; the cell's comparison passing on a sound run and failing under
each planted fault (`portbench/car_faults.py`); the program's CAR-large
counters (`models/car.py:car_counts`); the counts; the reference's
Monte-Carlo draws; the fit cells' readers on the cell's records.

Tolerances, each with its reason:
- float64, port against reference: 1e-12 relative on the NLML, 1e-10 of
  the largest entry on each gradient, 1e-12 per stacked row on each loss
  of the trajectory, 1e-10 on the parameters and the posterior: two
  float64 routes through one matrix (a blocked Cholesky and LAPACK's), of
  condition near 1e4 here, so float64's 1.1e-16 times that and a few
  hundred-term sums (measured: 1e-15 and under);
- float32 through the public entry points: every loss within 1e-5 per
  stacked row and the posterior within 2e-5 of the top fidelity's y std
  (the variance of its square): float32's 6e-8 through the same
  condition, and the inputs normalized in float64 then rounded to float32
  (measured: 5.4e-7 per row, 7.0e-7 and 1.1e-7).
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fidelityfusion_tpu_torch.models import car
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.ops import cuda
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
from fidelityfusion_tpu_torch.train.fit import fit
from fidelityfusion_tpu_torch.utils.tree import tree_map
from portbench import car_faults, counts_car, harness
from portbench.data import zoo
from portbench.reference import car as ref
from portbench.reference import cigp

CELL = "car.fit-joint-p4-5376"
ROWS = (96, 48, 24)
F64 = torch.float64
# the port's parameter leaves and the reference's names for them
LEAVES = {("kernel", "base", "length_scales"): "ls",
          ("kernel", "base", "signal_variance"): "sv_x",
          ("kernel", "length_scale_z"): "lz", ("kernel", "signal_variance"): "sv",
          ("kernel", "b"): "b", ("noise_variance",): "nv"}


def _design(seed=0, n_test=10):
    rng = np.random.default_rng(seed)
    x = zoo.uniform(rng, ROWS[0])
    ys = zoo.p4(x)
    return ([x[:n] for n in ROWS], [y[:n] for y, n in zip(ys, ROWS)],
            zoo.uniform(rng, n_test).astype(np.float32))


def _model(seed=1):
    """A CAR-large model with seeded random parameters."""
    rng = np.random.default_rng(seed)
    model = car.ContinuousAutoRegressionLarge(3, ARDKernel(), input_dim=2, device="cpu")
    k = model.params["kernel"]
    k["base"]["length_scales"] = torch.tensor(rng.uniform(0.5, 2.0, 2), dtype=torch.float32)
    for key in ("length_scale_z", "signal_variance"):
        k[key] = torch.tensor([rng.uniform(0.5, 2.0)], dtype=torch.float32)
    k["base"]["signal_variance"] = torch.tensor([rng.uniform(0.7, 1.3)], dtype=torch.float32)
    k["b"] = torch.tensor(rng.uniform(0.5, 2.0), dtype=torch.float32)
    model.params["noise_variance"] = torch.tensor([rng.uniform(0.3, 1.0)], dtype=torch.float32)
    return model


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_params(port_params, requires_grad=False):
    p = {name: _get(port_params, path).detach().to(F64).reshape(-1 if name == "ls" else ())
         for path, name in LEAVES.items()}
    return {k: v.clone().requires_grad_(requires_grad) for k, v in p.items()}


def _draws():
    cfg = harness.config("car-large-ard")
    return ref.draws(cfg["mc_seed"], cfg["n_features"], cfg["n_mc"])


def _dm(xs, ys):
    return MultiFidelityDataManager([
        {"raw_fidelity_name": str(f), "fidelity_indicator": f, "X": x, "Y": y}
        for f, (x, y) in enumerate(zip(xs, ys))])


def test_port_nll_gradients_trajectory_and_posterior_equal_the_reference_in_float64():
    xs, ys, xt_raw = _design()
    data = ref.CARData(xs, ys)
    x, y = torch.tensor(data.x), torch.tensor(data.y)
    xt = torch.tensor(data.test_inputs(xt_raw.astype(np.float64)))
    model = _model()
    w, t = _draws()
    p64 = tree_map(lambda a: a.to(F64), model.params)
    leaves = {name: _get(p64, path).requires_grad_(True) for path, name in LEAVES.items()}
    got = model.gp.nll(p64, x, y)
    g_got = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    q = _ref_params(p64, requires_grad=True)
    want = ref.nll(q, x, y, w, t)
    g_want = dict(zip(q, torch.autograd.grad(want, list(q.values()))))
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-12)
    for name, g in g_got.items():
        wg = g_want[name].reshape(g.shape)
        torch.testing.assert_close(g, wg, rtol=0, atol=1e-10 * float(wg.abs().max()))

    p0 = tree_map(lambda a: a.detach().to(F64), model.params)
    res = fit(model.gp.nll, p0, steps=5, lr=5e-2, loss_args=(x, y))
    losses, trained = cigp.adam(lambda p: ref.nll(p, x, y, w, t), _ref_params(p0), 5, 5e-2)
    torch.testing.assert_close(res.losses, losses, rtol=0, atol=1e-12 * len(x))
    for name, v in _ref_params(res.params).items():
        torch.testing.assert_close(v, trained[name], rtol=0, atol=1e-10)

    with torch.no_grad():
        mean, cov = model.gp.predict(res.params, x, y, xt)
        m, v = ref.posterior(_ref_params(res.params), x, y, xt, w, t)
    torch.testing.assert_close(mean[:, 0], m, rtol=0, atol=1e-10)
    torch.testing.assert_close(cov.diagonal(), v, rtol=0, atol=1e-10)


def test_port_fit_and_forward_in_float32_follow_the_reference():
    """`train_CAR_large` and `forward`, the cell's path, against the
    reference in float64 from the same initial parameters and draws."""
    xs, ys, xt_raw = _design(seed=2)
    model = _model(seed=3)
    p0, (w, t) = _ref_params(model.params), _draws()
    dm = _dm(xs, ys)
    hist = car.train_CAR_large(model, dm, max_iter=5, lr_init=5e-2).numpy()
    with torch.no_grad():
        mean, cov = model.forward(dm, xt_raw)
    data = ref.CARData(xs, ys)
    x, y = torch.tensor(data.x), torch.tensor(data.y)
    n = len(data.x)
    x32, y32 = model.joint_train_data(dm)
    np.testing.assert_allclose(x32.numpy(), data.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(y32.numpy(), data.y, rtol=0, atol=1e-6)
    losses, _ = cigp.adam(lambda p: ref.nll(p, x, y, w, t), p0, 5, 5e-2)
    np.testing.assert_allclose(hist, losses.numpy(), rtol=0, atol=1e-5 * n)
    xt = torch.tensor(data.test_inputs(xt_raw.astype(np.float64)))
    with torch.no_grad():
        m, v = ref.posterior(_ref_params(model.params), x, y, xt, w, t)
    top = data.norms[-1]
    np.testing.assert_allclose(mean[:, 0].numpy(), m.numpy() * top.y_std + top.y_mean, rtol=0,
                               atol=2e-5 * top.y_std)
    np.testing.assert_allclose(cov.diagonal().numpy(), v.numpy() * top.y_std ** 2, rtol=0,
                               atol=2e-5 * top.y_std ** 2)


SMALL = {"rows": list(ROWS), "n_test": 8, "steps": 4, "checked": 1}


def _run_small(fault=None):
    if fault is None:
        return harness.execute(CELL, 12345678901, 0.01, False, time.time(), torch.device("cpu"),
                               SMALL)
    with car_faults.FAULTS[fault]():
        return harness.execute(CELL, 12345678901, 0.01, False, time.time(), torch.device("cpu"),
                               SMALL)


def test_sound_small_run_is_correct():
    out = _run_small()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"step0_gap", "traj_gap", "nll_gap", "mean_gap", "var_gap"}


@pytest.mark.parametrize("fault", sorted(car_faults.FAULTS))
def test_planted_fault_fails_the_check(fault):
    out = _run_small(fault)
    assert not out["correct"], out["checks"]


def test_car_counts_add_the_same_at_every_step_and_reset():
    xs, ys, xt = _design(seed=4, n_test=8)
    dm = _dm(xs, ys)
    n = sum(ROWS)
    launches = cuda.launch_counts()
    for steps in (1, 4):
        car.reset_car_counts()
        car.train_CAR_large(_model(), dm, max_iter=steps, lr_init=5e-2)
        assert car.car_counts() == {"features": {n: steps}, "gram": {(n, n): steps}}
    model = _model()
    car.reset_car_counts()
    with torch.no_grad():
        model.forward(dm, xt)
    # Sigma (phi once), the cross Gram (phi at both sides), the test Gram
    assert car.car_counts() == {"features": {n: 2, 8: 2},
                                "gram": {(n, n): 1, (n, 8): 1, (8, 8): 1}}
    assert cuda.launch_counts() == launches  # host counters only, no kernel on the CPU
    car.reset_car_counts()
    assert car.car_counts() == {"features": {}, "gram": {}}


def test_train_car_large_reports_its_stage_to_the_debugger():
    xs, ys, _ = _design(seed=5)
    seen = []
    debugger = SimpleNamespace(record_stage=lambda stage, losses: seen.append((stage, losses)))
    hist = car.train_CAR_large(_model(), _dm(xs, ys), max_iter=3, lr_init=5e-2,
                               debugger=debugger)
    assert len(seen) == 1 and seen[0][0] == 0 and seen[0][1] is hist


def test_car_counts_at_a_hand_worked_shape():
    # n = 4 rows, d = 2, one frequency and one draw
    feats = 9 * 4
    gram = 2 * 16 * 2 + 16 * 9 + 2 * 16  # phi phi^T, the SE Gram, the Hadamard form
    grads = feats + 2 * 16 * 2 + 16 * 9 + 3 * 16
    assert counts_car.car_step_flops(4, 2, 1, 1) == feats + gram + grads + 64 + 8 * 16
    fwd = counts_car.car_forward_flops(4, 2, 2, 1, 1)
    assert fwd == pytest.approx(feats + gram + 9 * 2 + (2 * 8 * 2 + 8 * 9 + 2 * 8)
                                + (2 * 4 * 2 + 4 * 9 + 2 * 4)
                                + 2 * 64 / 3 + 2 * 16 + 2 * 16 * 2 + 2 * 4 * 2 + 2 * 4 * 4)
    assert counts_car.car_fit_flops([2, 1, 1], 2, 1, 1, 10, 2) == pytest.approx(
        10 * counts_car.car_step_flops(4, 2, 1, 1) + fwd)


def test_reference_draws_equal_the_programs():
    w, t = _draws()
    k = _model().params["kernel"]
    assert len(w) == 64 and len(t) == 64
    assert torch.equal(k["_w"].to(F64), w) and torch.equal(k["_t"].to(F64), t)


def test_cell_reports_the_fit_cells_readers():
    e2e, layers = harness.cell_metrics(harness.manifest(), CELL, ())
    assert set(e2e) == {"setup_s", "fit_s"}
    assert set(layers) == {"fit.stage0_ms_per_step", "fit.mfu", "kern.chol_roofline",
                           "kern.tri_inv_roofline", "dev.idle_share.fit"}
    tr, cfg = harness.traffic("fit-joint-p4-5376"), harness.config("car-large-ard")
    run = SimpleNamespace(records=[{"stage_s": [1.2]}] * 3, traffic=tr, config=cfg, window_s=4.0)
    assert harness.metric_reader("fit.stage0_ms_per_step").read(run) == pytest.approx(12.0)
    mfu = harness.metric_reader("fit.mfu").read(run)
    assert mfu == pytest.approx(100 * 3 * counts_car.car_fit_flops(
        tr["rows"], 2, 64, 64, tr["steps"], tr["n_test"]) / 4.0 / 67e12)
