"""The port's HOGP (`models/hogp.py`) and coupling (`models/coupling.py`)
against the JAX package on the CPU, the same parameters carried across
with `convert.params_from_numpy`; GAR and CIGAR end to end, subset and
non-subset (`tests/torch_field_checks.py` says what is checked and to
which tolerance); GAR's stage-0 tracking residual per restart.

Tolerances (float32, two ``eigh`` implementations): NLML values rtol 1e-5;
gradients rtol 1e-3 (JAX's own custom-VJP accuracy class on these
fixtures); posterior means and variances within 1e-4 of their scale;
the lifts and the interpolation matrix to 1e-6; a restart batch equal to
per-restart calls to 1e-5; the per-restart running-max tracking residual
within 1e-3 (absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models.coupling import TensorLinear as JTL
from fidelityfusion_tpu.models.coupling import interp_identity as j_interp
from fidelityfusion_tpu.models.hogp import HOGP as JHOGP
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu_torch.convert import params_from_numpy
from fidelityfusion_tpu_torch.models.coupling import TensorLinear, interp_identity
from fidelityfusion_tpu_torch.models.hogp import HOGP
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.train.fit import adam_scan, adam_scan_aux
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map
from tests import torch_field_checks as FC
from tests.torch_port_checks import leaves

KERNELS = {"ARD": (JK.ARDKernel, TK.ARDKernel), "SE": (JK.SquaredExponentialKernel,
                                                       TK.SquaredExponentialKernel)}


def _case(kernel, learnable=False, seed=5, n=12, shape=(4, 3), d=4):
    """Inputs (d = 4: the Poisson source parameters, a dim-1 length scale
    broadcast over them for ARD) and perturbed JAX parameters as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    y = rng.standard_normal((n,) + shape).astype(np.float32)
    yv = (0.1 * rng.random(n)).astype(np.float32)
    xt = rng.random((5, d)).astype(np.float32)
    jk, tk = KERNELS[kernel]
    flags = dict(learnable_grid=learnable, learnable_map=learnable)
    jh, th = JHOGP(jk(), shape, **flags), HOGP(tk(), shape, **flags)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jh.init_params(d))
    p["noise_variance"] = np.array([20.0], np.float32)
    return jh, th, p, x, y, yv, xt


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("kernel,learnable,with_yvar", [
    ("ARD", False, False), ("ARD", False, True), ("SE", False, True), ("ARD", True, False)])
def test_nll_value_and_gradients_match_jax(kernel, learnable, with_yvar):
    """`nll` (the custom backward) and `nll_with_state` against JAX's
    `nll`, value and every parameter's gradient, learnable grids and maps
    included."""
    jh, th, p, x, y, yv, _ = _case(kernel, learnable)
    yv = yv if with_yvar else None
    jv, jg = jax.jit(jax.value_and_grad(lambda q, x, y, yv: jh.nll(q, x, y, yv)))(
        jax.tree_util.tree_map(jnp.asarray, p), _j(x), _j(y), _j(yv))
    tp = tree_map(lambda a: a.requires_grad_(True), params_from_numpy(p, "cpu"))
    v = th.nll(tp, _t(x), _t(y), _t(yv))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(th.nll_with_state(params_from_numpy(p, "cpu"), _t(x), _t(y),
                                                 _t(yv))[0].item(), float(jv), rtol=1e-5)
    for a, t in zip(leaves(jg), leaves(tp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-3 * np.abs(np.asarray(a)).max() + 1e-6)


@pytest.mark.parametrize("kernel,with_yvar,dtype", [
    ("ARD", False, "float32"), ("ARD", True, "float32"), ("SE", False, "float64")])
def test_predict_matches_jax(kernel, with_yvar, dtype):
    """Posterior means and variances (float64 for the SE case: its Gram at
    these parameters is nearly rank one, and two float32 ``eigh``s give
    eigenvalue tensors that differ by ~1e-2 of the noise)."""
    jh, th, p, x, y, yv, xt = _case(kernel)
    yv = yv if with_yvar else None
    cast = lambda a: None if a is None else np.asarray(a, dtype)  # noqa: E731
    p, x, y, yv, xt = jax.tree_util.tree_map(cast, p), cast(x), cast(y), cast(yv), cast(xt)
    with jax.enable_x64(dtype == "float64"):
        jp = jax.tree_util.tree_map(jnp.asarray, p)

        def run(jp, x, y, yv, xt):
            _, jst = jh.nll_with_state(jp, x, y, yv)
            return jh.predict(jp, jst, x, xt)

        jm, jvar = (np.asarray(a) for a in jax.jit(run)(jp, _j(x), _j(y), _j(yv), _j(xt)))
    tp = tree_map(lambda a: torch.tensor(a), p)
    _, st = th.nll_with_state(tp, _t(x), _t(y), _t(yv))
    m, var = th.predict(tp, st, _t(x), _t(xt))
    tol = 1e-4 if dtype == "float32" else 1e-9
    np.testing.assert_allclose(m.numpy(), jm, atol=tol * np.abs(jm).max())
    np.testing.assert_allclose(var.numpy(), jvar, atol=tol * np.abs(jvar).max())
    assert (var.numpy() > 0).all()


def test_predict_matches_dense_posterior():
    """Mean and variance against the dense Kronecker GP posterior in
    float64 (the JAX package's `test_hogp_predict_matches_dense` bars)."""
    rng = np.random.default_rng(1)
    n, m, shape = 6, 3, (3, 2)
    x, xt = rng.random((n, 2)).astype(np.float32), rng.random((m, 2)).astype(np.float32)
    y = rng.standard_normal((n,) + shape).astype(np.float32)
    th = HOGP(TK.ARDKernel(), shape, jitter=0.0)
    p = th.init_params(2, device="cpu")
    _, st = th.nll_with_state(p, _t(x), _t(y))
    mean, var = th.predict(p, st, _t(x), _t(xt))
    kp = p["kernel"]
    K = lambda a, b: th.kernel.apply(kp, _t(a), _t(b)).double().numpy()  # noqa: E731
    g = [gr.numpy() for gr in th.grids(p)]
    Km = np.kron(K(g[0], g[0]), K(g[1], g[1]))
    noise = float(th.noise(p))
    Sigma = np.kron(K(x, x), Km) + noise * np.eye(n * 6)
    Ks, Kss = np.kron(K(xt, x), Km), np.kron(K(xt, xt), Km)
    mean_d = (Ks @ np.linalg.solve(Sigma, y.ravel().astype(np.float64))).reshape((m,) + shape)
    var_d = np.diagonal(Kss - Ks @ np.linalg.solve(Sigma, Ks.T)).reshape((m,) + shape) + noise
    np.testing.assert_allclose(mean.numpy(), mean_d, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), var_d, rtol=1e-2, atol=1e-3)


def test_tracked_nll_at_a_refresh_step_matches_jax():
    """`nll_tracked` at step 0 (a refresh) is the exact NLML, as JAX's, and
    its aux carries the eigenbasis and a zero residual; at a tracking step
    from that basis the value agrees with JAX's to rtol 1e-5."""
    jh, th, p, x, y, _, _ = _case("ARD", n=16)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")
    jtracked = jax.jit(lambda q, aux, step, x, y: jh.nll_tracked(q, aux, step, x, y))
    jl, jaux = jtracked(jp, jh.tracking_aux0(16), jnp.float32(0), _j(x), _j(y))
    tl, taux = th.nll_tracked(tp, th.tracking_aux0(16, device="cpu"), 0, _t(x), _t(y))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(taux[1]) == 0.0 and taux[0].shape == (16, 16)
    tp2 = tree_map(lambda a: a * 1.01, tp)
    jp2 = jax.tree_util.tree_map(lambda a: a * 1.01, jp)
    jl2, _ = jtracked(jp2, (jnp.asarray(taux[0].numpy()), jaux[1]), jnp.float32(1), _j(x),
                      _j(y))
    tl2, taux2 = th.nll_tracked(tp2, taux, 1, _t(x), _t(y))
    np.testing.assert_allclose(tl2.item(), float(jl2), rtol=1e-5)
    assert 0.0 < float(taux2[1]) < 0.15


def test_tracked_adaptive_gate():
    """`nll_tracked_adaptive` along 12 Adam steps: with a threshold too high
    to trip it is `nll_tracked` with refresh_every = max_gap, step for step
    (the JAX test's `test_adaptive_residual_gated_refresh` pin); with a
    zero threshold every step refreshes, so each value is the exact `nll`."""
    _, th, p, x, y, _, _ = _case("ARD", n=16)
    tp, x, y = params_from_numpy(p, "cpu"), _t(x), _t(y)
    static = lambda q, aux, s, x, y: th.nll_tracked(q, aux, s, x, y,  # noqa: E731
                                                    refresh_every=8)
    no_trip = lambda q, aux, s, x, y: th.nll_tracked_adaptive(  # noqa: E731
        q, aux, s, x, y, max_gap=8, res_threshold=1e9)
    always = lambda q, aux, s, x, y: th.nll_tracked_adaptive(  # noqa: E731
        q, aux, s, x, y, max_gap=8, res_threshold=-1.0)
    aux0, aux0a = th.tracking_aux0(16, device="cpu"), th.tracking_aux0_adaptive(16, device="cpu")
    _, _, l_static, _ = adam_scan_aux(static, tp, aux0, 5e-2, 12, loss_args=(x, y))
    _, _, l_no, aux_no = adam_scan_aux(no_trip, tp, aux0a, 5e-2, 12, loss_args=(x, y))
    _, _, l_all, aux_all = adam_scan_aux(always, tp, aux0a, 5e-2, 12, loss_args=(x, y))
    _, _, l_exact = adam_scan(th.nll, tp, 5e-2, 12, loss_args=(x, y))
    np.testing.assert_allclose(l_no.numpy(), l_static.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(l_all.numpy(), l_exact.numpy(), rtol=1e-6, atol=1e-7)
    assert float(aux_all[1]) == 0.0 and 0.0 < float(aux_no[1]) < 0.15


def test_restart_batch_equals_per_restart():
    """R = 3 parameter sets (and per-restart targets): `nll`'s values and
    gradients, `nll_with_state`'s values, equal to per-restart calls."""
    _, th, p, x, y, yv, _ = _case("ARD")
    rng = np.random.default_rng(9)
    ps = [tree_map(lambda a, s=s: a * (1 + 0.2 * s), params_from_numpy(p, "cpu")) for s in range(3)]
    batch = tree_map(lambda *a: torch.stack(a).requires_grad_(True), *ps)
    yb = torch.tensor(np.stack([y, y + 0.1 * rng.standard_normal(y.shape).astype(np.float32),
                                -y]))
    v = th.nll(batch, _t(x), yb, _t(yv))
    v.sum().backward()
    vs = th.nll_with_state(tree_map(lambda a: a.detach(), batch), _t(x), yb, _t(yv))[0]
    for r in range(3):
        q = tree_map(lambda a: a.requires_grad_(True), ps[r])
        v1 = th.nll(q, _t(x), yb[r], _t(yv))
        v1.backward()
        np.testing.assert_allclose(v[r].item(), v1.item(), rtol=1e-5)
        np.testing.assert_allclose(vs[r].item(), v1.item(), rtol=1e-5)
        for a, b in zip(tree_leaves(batch), tree_leaves(q)):
            np.testing.assert_allclose(a.grad[r].numpy(), b.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_dim1_length_scale_gradient_sums_over_inputs():
    """A dim-1 ARD length scale against d = 4 inputs: the Gram equals the
    one with the scale repeated, and its gradient is the sum of the
    repeated scale's four gradients."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.random((10, 4)), dtype=torch.float32)
    k = TK.ARDKernel()
    one = {"length_scales": torch.tensor([0.7], requires_grad=True),
           "signal_variance": torch.tensor([1.3])}
    four = {"length_scales": torch.full((4,), 0.7, requires_grad=True),
            "signal_variance": torch.tensor([1.3])}
    K1, K4 = k.apply(one, x, x, diag_add=torch.tensor(1e-2)), k.apply(four, x, x,
                                                                       diag_add=torch.tensor(1e-2))
    np.testing.assert_allclose(K1.detach().numpy(), K4.detach().numpy(), rtol=1e-6)
    w = torch.tensor(rng.standard_normal((10, 10)), dtype=torch.float32)
    (K1 * w).sum().backward()
    (K4 * w).sum().backward()
    np.testing.assert_allclose(one["length_scales"].grad.item(),
                               four["length_scales"].grad.sum().item(), rtol=1e-5)


@pytest.mark.parametrize("tracked", [False, True], ids=["nll", "nll_tracked"])
def test_float32_gradient_matches_float64(tracked):
    """The Kronecker backward forms each Gram's cotangent in the Grams'
    float64: at n = 64, output (8, 8, 8) (`scripts/hogp_grad_precision.py`'s
    CPU case) a float32 rotation out of the eigenbasis left the
    signal-variance gradient 4e-2 off float64.  Every leaf within 1e-5."""
    rng = np.random.default_rng(0)
    n, shape = 64, (8, 8, 8)
    x = rng.random((n, 4)).astype(np.float32)
    base = np.sin(2 * np.pi * x.sum(axis=1)).astype(np.float32)
    y = base.reshape((n, 1, 1, 1)) * rng.random(shape).astype(np.float32)
    hogp = HOGP(TK.SquaredExponentialKernel(), shape)
    p = hogp.init_params(4, device="cpu")

    def grads(dtype):
        q = tree_map(lambda a: a.to(dtype).requires_grad_(True), p)
        xx, yy = torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype)
        if tracked:
            aux = tree_map(lambda a: a.to(dtype), hogp.tracking_aux0(n, device="cpu"))
            loss = hogp.nll_tracked(q, aux, 0, xx, yy)[0]
        else:
            loss = hogp.nll(q, xx, yy)
        return torch.autograd.grad(loss, tree_leaves(q))

    for a, b in zip(grads(torch.float32), grads(torch.float64)):
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max()), (a, b)


@pytest.mark.parametrize("l_dim,h_dim", [(4, 7), (6, 10), (5, 5), (14, 6)])
def test_interp_identity_matches_jax(l_dim, h_dim):
    np.testing.assert_array_equal(interp_identity(l_dim, h_dim), j_interp(l_dim, h_dim))


def test_tensor_linear_matches_jax_and_accumulates_all_modes():
    rng = np.random.default_rng(3)
    jtl, ttl = JTL((3, 4), (5, 6)), TensorLinear((3, 4), (5, 6))
    maps = [rng.standard_normal(M.shape).astype(np.float32) for M in jtl.init_params()["maps"]]
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    want = np.asarray(jtl.apply({"maps": [jnp.asarray(M) for M in maps]}, jnp.asarray(x)))
    got = ttl.apply({"maps": [torch.tensor(M) for M in maps]}, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sq = TensorLinear((3, 4), (3, 4))
    out = sq.apply({"maps": [2.0 * torch.eye(3), 3.0 * torch.eye(4)]}, torch.ones((2, 3, 4)))
    np.testing.assert_allclose(out.numpy(), 6.0 * np.ones((2, 3, 4)))


def test_tensor_linear_restart_batch():
    """Maps with a restart axis over a shared (or per-restart) input equal
    per-restart lifts."""
    rng = np.random.default_rng(4)
    tl = TensorLinear((3, 4), (5, 6))
    maps = [torch.tensor(rng.standard_normal((2,) + M.shape), dtype=torch.float32)
            for M in tl.init_params(device="cpu")["maps"]]
    x = torch.tensor(rng.standard_normal((7, 3, 4)), dtype=torch.float32)
    got = tl.apply({"maps": maps}, x)
    got_b = tl.apply({"maps": maps}, torch.stack([x, x]))
    assert got.shape == (2, 7, 5, 6)
    for r in range(2):
        want = tl.apply({"maps": [M[r] for M in maps]}, x)
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_b[r].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- GAR and CIGAR end to end
# GAR subset: both stages through the tracked-spectrum NLML (the row
# threshold patched down to 8 in both packages, as `tests/test_spectral.py:310`
# does); GAR non-subset: training through the imputation path (the
# cascade's own `forward` fills the missing low-fidelity fields; their
# variance enters K_0's diagonal), exact ``eigh`` every step; CIGAR subset:
# each stage's restart batch of 40 and 24 rows through the fused NLML;
# CIGAR non-subset through the imputation path.  The JAX-trained
# parameters carried across with `convert.load_state` (GAR: its stage
# states rebuilt).


@pytest.fixture(scope="module")
def gar_ref():
    from fidelityfusion_tpu.models import gar as JG

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "_TRACK_N_THRESHOLD", 8)
        return FC.jax_run("GAR", False)


@pytest.fixture(scope="module")
def gar_nonsubset_ref():
    return FC.jax_run("GAR", True)


@pytest.fixture(scope="module")
def cigar_ref():
    return FC.jax_run("CIGAR", False)


@pytest.fixture(scope="module")
def cigar_nonsubset_ref():
    return FC.jax_run("CIGAR", True)


def test_gar_tracked_training_from_jax_init_matches_jax(gar_ref, monkeypatch):
    from fidelityfusion_tpu_torch.models import gar as TG

    monkeypatch.setattr(TG, "_TRACK_N_THRESHOLD", 8)
    FC.check_training(gar_ref, "GAR", False)


def test_gar_forward_with_carried_params_matches_jax(gar_ref):
    from fidelityfusion_tpu_torch.convert import load_state

    ref = gar_ref
    jm = ref["model"]
    model = FC.port_model("GAR", ref["shapes"])
    dm = FC.carried_data_manager(ref)
    load_state(model, jax.tree_util.tree_map(np.asarray, jm.params), jm.stage_norm,
               data_manager=dm)
    mean, var = model.forward(dm, ref["x_test"])
    FC.check_close(mean, ref["mean"])
    FC.check_close(var, ref["var"])
    low, low_var = model.forward(dm, ref["x_test"], to_fidelity=0)
    assert low.shape == (len(ref["x_test"]),) + ref["shapes"][0] and (low_var > 0).all()


def test_gar_nonsubset_training_from_jax_init_matches_jax(gar_nonsubset_ref):
    FC.check_training(gar_nonsubset_ref, "GAR", True)


def test_cigar_training_from_jax_init_matches_jax(cigar_ref):
    FC.check_training(cigar_ref, "CIGAR", False)


def test_cigar_forward_with_carried_params_matches_jax(cigar_ref):
    from fidelityfusion_tpu_torch.convert import load_state

    ref = cigar_ref
    jm = ref["model"]
    model = FC.port_model("CIGAR", ref["shapes"])
    dm = FC.carried_data_manager(ref)
    load_state(model, jax.tree_util.tree_map(np.asarray, jm.params), jm.stage_norm)
    mean, var = model.forward(dm, ref["x_test"])
    FC.check_close(mean, ref["mean"])
    FC.check_close(var, ref["var"])


def test_cigar_nonsubset_training_from_jax_init_matches_jax(cigar_nonsubset_ref):
    FC.check_training(cigar_nonsubset_ref, "CIGAR", True)


def test_gar_stage0_tracking_residual_per_restart_matches_jax():
    """chip_smoke's GAR stage-0 configuration cut to 256 rows: Poisson
    (8, 8) fields of seed 0, d_in = 4, ARD, the 4-rung restart ladder, 20
    steps of `adam_scan_aux` at lr 5e-2 over `_Gar0LossTracked` (a full
    ``eigh`` at step 0, Jacobi sweeps after).  Each restart's running-max
    tracking residual within 1e-3 of the JAX package's (JAX [0.1971,
    0.2052, 0.5652, 0.7639] against the port's [0.1973, 0.2051, 0.5652,
    0.7637] when measured); the final losses within 1e-3 of max(|loss|, 1)
    (restart 3 tracks with a residual of ~0.76, and its tracked losses part
    by ~2.4e-4)."""
    import importlib

    import optax

    from fidelityfusion_tpu.data.pde import generate_poisson_mf_dataset
    from fidelityfusion_tpu.models import gar as JG
    from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
    from fidelityfusion_tpu_torch.models import gar as TG
    from fidelityfusion_tpu_torch.train.fit import gp_restart_batch, stack_params

    # the module (the package's `train.fit` attribute is the function `fit`)
    JF = importlib.import_module("fidelityfusion_tpu.train.fit")
    # the first 256 of chip_smoke's 1152 samples (one seeded draw, row by row)
    x_all, ys = generate_poisson_mf_dataset(n_samples=256, d_in=4, seed=0)
    dm = JDM([{"raw_fidelity_name": "0", "fidelity_indicator": 0, "X": x_all, "Y": ys[0]}])
    x, y = (np.asarray(a, np.float32) for a in dm.get_data(0, normal=True))
    jh = JHOGP(JK.ARDKernel(), (8, 8))
    th = HOGP(TK.ARDKernel(), (8, 8))
    jinit = jh.init_params(4)
    jbatch = JF.stack_params(JF.gp_restart_batch(jh.kernel, jinit, jnp.asarray(x), 4,
                                                 jax.random.PRNGKey(0)))
    tinit = params_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    tbatch = stack_params(gp_restart_batch(th.kernel, tinit, torch.tensor(x), 4))
    for a, b in zip(leaves(jax.tree_util.tree_map(np.asarray, jbatch)), leaves(tbatch)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6)

    jloss = JG._Gar0LossTracked(jh)

    def jrun(p):
        _, _, losses, aux = JF.adam_scan_aux(jloss, {"hogp": p}, jh.tracking_aux0(256),
                                             optax.adam(5e-2), 20,
                                             loss_args=(jnp.asarray(x), jnp.asarray(y)))
        return losses, aux[1]

    jrun = jax.jit(jrun)
    runs = [jrun(jax.tree_util.tree_map(lambda a, r=r: a[r], jbatch)) for r in range(4)]
    jlosses, jres = (np.stack([np.asarray(run[k]) for run in runs]) for k in (0, 1))
    aux0 = tree_map(lambda a: a.expand((4,) + a.shape).clone(), th.tracking_aux0(256, "cpu"))
    _, _, losses, aux = adam_scan_aux(TG._Gar0LossTracked(th), {"hogp": tbatch}, aux0, 5e-2, 20,
                                      loss_args=(torch.tensor(x), torch.tensor(y)))
    res = aux[1].numpy()
    assert res.shape == (4,) and np.isfinite(res).all()
    np.testing.assert_allclose(res, jres, atol=1e-3)
    final, jfinal = losses[:, -1].numpy(), jlosses[:, -1]
    np.testing.assert_allclose(final, jfinal, atol=1e-3 * max(np.abs(jfinal).max(), 1.0))
