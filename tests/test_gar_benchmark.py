"""The GAR cell of the port's benchmark (`portbench/`, cell
`gar.fit-poisson-2048`) on the CPU at small sizes: its plain reference
(`portbench/reference/gar.py`) against the dense Kronecker Gaussian and
against the port's HOGP, GAR and trainer; its comparison failing under
each planted fault; the tracked spectrum's counters (`ops/spectral.py`);
`train_GAR` run twice on one data manager.

Tolerances, each with its reason:
- reference against the dense Gaussian, both float64: 1e-10 relative (two
  float64 factorizations of one matrix);
- port against reference: the port's Grams and eigenpairs are float64, the
  rest of its NLML float32 over N = n d_1 d_2 elements, so the NLML to 1e-6
  relative (float32's 1.2e-7 over a few hundred-term sums); gradients to
  2e-3 relative of the largest entry (float32 rotations of the Gram
  cotangents' two nearly cancelling terms); posteriors to 1e-5 of the
  field's scale (float32 mode products and the float32 normalization of
  the inputs).
"""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from fidelityfusion_tpu_torch.data.pde import poisson_fields
from fidelityfusion_tpu_torch.models.coupling import TensorLinear
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.models.gar import GAR, _Gar0LossTracked, _GarResLoss, train_GAR
from fidelityfusion_tpu_torch.models.hogp import HOGP
from fidelityfusion_tpu_torch.ops import cuda, spectral
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
from fidelityfusion_tpu_torch.train.fit import adam_scan_aux
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map
from portbench import counts_gar, harness, kron_faults
from portbench.data import poisson
from portbench.reference import gar as ref

F64 = torch.float64
CELL = "gar.fit-poisson-2048"


def _ref_params(ls, sv, nv, maps=()):
    p = {k: torch.tensor(v, dtype=F64) for k, v in (("ls", ls), ("sv", sv), ("nv", nv))}
    p.update({f"m{k}": torch.as_tensor(M, dtype=F64)[None] for k, M in enumerate(maps)})
    return p


def _port_params(ls, sv, nv):
    return {"kernel": {"length_scales": torch.tensor([ls]), "signal_variance": torch.tensor([sv])},
            "noise_variance": torch.tensor([nv])}


def _dense_nll(p, x, y, r):
    """Restart r's per-element NLML from the dense Kronecker covariance."""
    q = {k: v[r:r + 1] for k, v in p.items()}
    K0 = ref.ard_gram(q, x, x)[0] + ref.JITTER * torch.eye(len(x), dtype=F64)
    S = K0
    for g in ref.grids(y.shape[1:], x):
        S = torch.kron(S, ref.ard_gram(q, g, g)[0])
    S = S + torch.eye(S.shape[0], dtype=F64) / q["nv"][0]
    L = torch.linalg.cholesky(S)
    a = torch.linalg.solve_triangular(L, y.reshape(-1, 1), upper=False)
    N = y.numel()
    return 0.5 * (N * ref.LOG2PI + (a * a).sum() + 2 * torch.log(L.diagonal()).sum()) / N


def test_reference_nll_and_gradient_equal_the_dense_kronecker_gaussian():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((12, 4)), dtype=F64)
    y = torch.tensor(rng.standard_normal((12, 3, 4)), dtype=F64)
    base = {"ls": [0.8, 0.3], "sv": [1.3, 0.7], "nv": [4.0, 0.5]}
    p = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in base.items()}
    got = ref.hogp_nll(p, x, y[None])
    g_got = torch.autograd.grad(got.sum(), list(p.values()))
    q = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in base.items()}
    want = torch.stack([_dense_nll(q, x, y, r) for r in range(2)])
    g_want = torch.autograd.grad(want.sum(), list(q.values()))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12)


def _stage_case(seed=1, n=30, shape=(4, 4), lshape=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = rng.standard_normal((n,) + shape).astype(np.float32)
    yl = None if lshape is None else rng.standard_normal((n,) + lshape).astype(np.float32)
    return x, y, yl


@pytest.mark.parametrize("params", [(0.9, 1.2, 3.0), (0.3, 0.8, 20.0)])
def test_port_hogp_nll_and_tracked_step0_equal_the_reference(params):
    x, y, _ = _stage_case()
    hogp = HOGP(ARDKernel(), (4, 4))
    p = _port_params(*params)
    exact = float(hogp.nll(p, torch.tensor(x), torch.tensor(y)))
    tracked, _ = hogp.nll_tracked(p, hogp.tracking_aux0(len(x), "cpu"), 0, torch.tensor(x),
                                  torch.tensor(y))
    want = float(ref.hogp_nll(_ref_params([params[0]], [params[1]], [params[2]]),
                              torch.tensor(x, dtype=F64), torch.tensor(y, dtype=F64)[None])[0])
    assert exact == pytest.approx(want, rel=1e-6)
    assert float(tracked) == pytest.approx(want, rel=1e-6)


def test_port_residual_stage_gradient_equals_the_reference():
    x, yh, yl = _stage_case(seed=2, n=24, shape=(6, 6), lshape=(4, 4))
    hogp, tl = HOGP(ARDKernel(), (6, 6)), TensorLinear((4, 4), (6, 6))
    maps0 = tl.init_params("cpu")["maps"]
    shift, scale = 0.1, 1.7
    port = {"hogp": _port_params(0.7, 1.1, 5.0), "tl": {"maps": [m.clone() for m in maps0]}}
    leaves = [a.requires_grad_(True) for a in tree_leaves(port)]
    loss = _GarResLoss(hogp, tl)(port, torch.tensor(x), torch.tensor(yl), torch.tensor(yh), None,
                                 shift, scale)
    g_port = torch.autograd.grad(loss, leaves)
    q = _ref_params([0.7], [1.1], [5.0], [m.numpy() for m in maps0])
    for v in q.values():
        v.requires_grad_(True)
    want = ref.stage_loss(q, torch.tensor(x, dtype=F64), torch.tensor(yh, dtype=F64),
                          torch.tensor(yl, dtype=F64), shift, scale)
    assert float(loss.detach()) == pytest.approx(float(want[0].detach()), rel=1e-6)
    g_ref = dict(zip(q, torch.autograd.grad(want.sum(), list(q.values()))))
    # the port's leaves in tree order: length_scales, signal_variance, noise_variance, maps
    for got, key in zip(g_port, ["ls", "sv", "nv", "m0", "m1"]):
        w = g_ref[key].reshape(got.shape).to(torch.float32)
        torch.testing.assert_close(got, w, rtol=0, atol=2e-3 * float(w.abs().max()))


def _fields_design(rows=(40, 24, 12), res=(4, 6, 8), seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((rows[0], 4))
    xs = [x[:n] for n in rows]
    ys = [poisson.fields(xi, r) for xi, r in zip(xs, res)]
    return xs, ys, rng.random((6, 4)), [(r, r) for r in res]


def _dm(xs, ys):
    return MultiFidelityDataManager([
        {"raw_fidelity_name": str(f), "fidelity_indicator": f, "X": x, "Y": y}
        for f, (x, y) in enumerate(zip(xs, ys))])


def _trained_gar(dm, shapes, steps=5):
    model = GAR(3, [ARDKernel() for _ in range(3)], shapes, input_dim=4, device="cpu")
    train_GAR(model, dm, max_iter=steps, lr_init=5e-2, n_restarts=2)
    return model


def test_port_gar_forward_after_training_equals_the_reference():
    xs, ys, xt, shapes = _fields_design()
    dm = _dm(xs, ys)
    model = _trained_gar(dm, shapes)
    with torch.no_grad():
        mean, var = model.forward(dm, xt.astype(np.float32))
    params = []
    for s, hp in enumerate(model.params["hogp"]):
        p = {"ls": float(hp["kernel"]["length_scales"][0]),
             "sv": float(hp["kernel"]["signal_variance"][0]), "nv": float(hp["noise_variance"][0])}
        if s:
            p.update({f"m{k}": M.numpy().astype(np.float64)
                      for k, M in enumerate(model.params["tl"][s - 1]["maps"])})
        params.append(p)
    data = ref.GARData(xs, ys)
    m, v = ref.gar_posterior(data, params, xt, "cpu")
    y_std = data.norms[-1].y_std
    np.testing.assert_allclose(mean.numpy(), m.numpy(), rtol=0, atol=1e-5 * y_std)
    np.testing.assert_allclose(var.numpy(), v.numpy(), rtol=0, atol=1e-5 * y_std ** 2)


def test_poisson_copy_equals_the_program_generator():
    x = np.random.default_rng(4).random((5, 4))
    for r in (4, 8):
        np.testing.assert_allclose(poisson.fields(x, r), poisson_fields(x, (r,))[0], rtol=1e-6,
                                   atol=1e-7)


SMALL = {"rows": [128, 64, 32], "n_test": 8, "steps": 4, "checked": 1,
         "init": {"ls": [0.5, 2.0], "sv": [0.5, 2.0], "nv": [50.0, 100.0]}}
SMALL_FIELDS = {"fields": [[4, 4], [8, 8], [16, 16]]}


def _run_small(fault=None):
    ctx = kron_faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    with ctx:
        return harness.execute(CELL, 12345678901, 0.01, False, time.time(), torch.device("cpu"),
                               SMALL, SMALL_FIELDS)


def test_sound_small_run_is_correct():
    out = _run_small()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"step0_gap", "traj_s0_gap", "traj_s1_gap", "traj_s2_gap",
                                  "nll_gap", "mean_gap", "var_gap"}


@pytest.mark.parametrize("fault", sorted(kron_faults.FAULTS))
def test_planted_fault_fails_the_check(fault):
    out = _run_small(fault)
    assert not out["correct"], out["checks"]


def test_spectral_counters_count_a_tracked_stage():
    x, y, _ = _stage_case(seed=5, n=20, shape=(3, 3))
    hogp = HOGP(ARDKernel(), (3, 3))
    batch = tree_map(lambda a: torch.stack([a, 1.1 * a]), {"hogp": _port_params(0.8, 1.0, 4.0)})
    aux = tree_map(lambda a: a.expand((2,) + a.shape), hogp.tracking_aux0(20, "cpu"))
    launches = cuda.launch_counts()
    spectral.reset_spectral_counts()
    adam_scan_aux(_Gar0LossTracked(hogp), batch, aux, 5e-2, 100,
                  loss_args=(torch.tensor(x), torch.tensor(y)))
    # on the CPU every eigh_pairs call, the two refreshes and the two 3 x 3
    # mode Grams a step, takes torch.linalg.eigh
    assert spectral.spectral_counts() == {"refresh": {20: 2}, "jacobi": {20: 98},
                                          "small_eigh": {}, "library_eigh": {20: 2, 3: 200}}
    assert cuda.launch_counts() == launches
    spectral.reset_spectral_counts()
    assert spectral.spectral_counts() == {"refresh": {}, "jacobi": {}, "small_eigh": {},
                                          "library_eigh": {}}


def test_train_gar_twice_on_one_manager_keeps_the_residual_rows():
    xs, ys, xt, shapes = _fields_design(seed=6)
    dm = _dm(xs, ys)
    _trained_gar(dm, shapes)
    again = _trained_gar(dm, shapes)
    for i in (1, 2):
        x, y = dm.get_data_by_name(f"res-{i}")
        assert len(x) == len(y[0]) == len(xs[i])
    fresh_dm = _dm(xs, ys)
    fresh = _trained_gar(fresh_dm, shapes)
    with torch.no_grad():
        got, want = again.forward(dm, xt), fresh.forward(fresh_dm, xt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_gar_counts_at_a_hand_worked_shape():
    # n = 2 rows, one 2-point mode, d = 1: N = 4
    grams = 2 * 2 * 6 + 2 * 2 * 6  # gram_flops(2, 2, 1) for K_0 and the mode
    nll = grams + 9 * (8 + 8) + (2 * 4 * 2 + 2 * 4 * 2) + 3 * 4
    assert counts_gar.hogp_nll_flops(2, (2,), 1) == nll
    step = nll + grams + 3 * 4 + 2 * (2 * 4 * 2 + 4 * 8)
    assert counts_gar.hogp_step_flops(2, (2,), 1) == step
    assert counts_gar.lift_flops(3, (2, 2), (4, 5)) == 2 * 3 * 4 * 4 + 2 * 3 * 5 * 8
    cfg = json.loads((harness.HERE / "configs" / "gar-hogp-ard.json").read_text())
    assert counts_gar.gar_fit_flops(cfg["rows"]["fit"], cfg["fields"], 4, 4, 100, 128) > 5e13


def test_half_rows_fault_takes_the_tracked_nll_over_half_the_rows():
    x, y, _ = _stage_case(seed=7, n=20, shape=(3, 3))
    x, y = torch.tensor(x), torch.tensor(y)
    hogp, p = HOGP(ARDKernel(), (3, 3)), _port_params(0.8, 1.0, 4.0)
    want, (V_half, _) = hogp.nll_tracked(p, hogp.tracking_aux0(10, "cpu"), 0, x[:10], y[:10])
    with kron_faults.FAULTS["half_rows"]():
        got, (V, _) = hogp.nll_tracked(p, hogp.tracking_aux0(20, "cpu"), 0, x, y)
        exact = hogp.nll(p, x, y)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(exact) == pytest.approx(float(hogp.nll(p, x[:10], y[:10])), rel=1e-6)
    assert V.shape == (20, 20)  # the trainer's carry keeps its shape
    torch.testing.assert_close(V[:10, :10], V_half)


def test_exact_spectrum_probe_makes_a_tracked_step_exact():
    x, y, _ = _stage_case(seed=8, n=20, shape=(3, 3))
    x, y = torch.tensor(x), torch.tensor(y)
    hogp = HOGP(ARDKernel(), (3, 3))
    p0, p1 = _port_params(0.8, 1.0, 4.0), _port_params(0.5, 1.3, 4.0)
    _, aux = hogp.nll_tracked(p0, hogp.tracking_aux0(20, "cpu"), 0, x, y)
    exact = float(hogp.nll(p1, x, y))
    tracked, _ = hogp.nll_tracked(p1, aux, 1, x, y)
    with kron_faults.PROBES["exact_spectrum"]():
        probed, _ = hogp.nll_tracked(p1, aux, 1, x, y)
    assert float(probed) == pytest.approx(exact, rel=1e-6)
    assert abs(float(tracked) - exact) > 1e-6 * abs(exact)  # the tracked step is not exact


def _traced_run(op_seconds, busy_s, window_s, refreshes):
    from types import SimpleNamespace

    traced = SimpleNamespace(op_seconds=op_seconds, busy_s=busy_s, window_s=window_s)
    spectral_seen = None if refreshes is None else {"refresh": refreshes, "jacobi": {}}
    return SimpleNamespace(traced=traced, traced_fit={"spectral": spectral_seen})


def test_eigensolver_readers_of_the_traced_fit():
    def reduction(n):
        return f"void sytrd4_gpu<sytrd_params<double, 32, 8, {n}, 32, 16, 1, 2> >(int)"

    ops = {reduction(2048): 0.3, reduction(512): 0.1,
           "void sytrd4_cta<sytrd_params<double, 16, 32, 32, 32, 0, 1, 2>, 1>(int)": 0.05,
           "void laed2_par<stedc_params_<double2, double, 8, 1024, 128> >(int)": 0.02,
           "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16": 1.53}
    run = _traced_run(ops, busy_s=2.0, window_s=5.0, refreshes={2048: 3, 512: 3})
    refresh = harness.metric_reader("kron.refresh_ms").read(run)
    assert refresh == pytest.approx(1e3 * 0.4 / 6)  # the mode Grams' and laed's time left out
    share = harness.metric_reader("kron.eigh_share").read(run)
    assert share == pytest.approx(100 * 0.47 / 2.0)
    assert harness.metric_reader("dev.idle_share.gar").read(run) == pytest.approx(60.0)
    # a program without the counter: the refresh reader has nothing to read
    assert harness.metric_reader("kron.refresh_ms").read(_traced_run(ops, 2.0, 5.0, None)) is None
