"""The port's spectral tracking (`ops/spectral.py`), the tracked Kronecker
NLML and the aux-carrying trainer (`train/fit.py:adam_scan_aux`,
`fit_restarts_tracked_adaptive`) against the JAX package on the CPU.

Tolerances: `jacobi_refine` and `_ns_orthonormalize` from the same V do
the same GEMMs as JAX's: float64 to 1e-10, float32 to 1e-5 (eigenvector
signs and degenerate bases of two ``eigh``s differ, so V itself is held
only where both start from the same V); the tracked-vs-exact trajectory
at the JAX test's bars (`tests/test_spectral.py:95`: running-max residual
< 0.15, value within 5e-3, relative gradient within 0.15); the
aux-carrying scan against JAX's on the same loss to 1e-6 relative; the
segmented adaptive trainer against one long run to 1e-5 (the JAX test's
bar) and its refresh segments equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fidelityfusion_tpu.models.gar import _Gar0LossTracked as JLoss
from fidelityfusion_tpu.models.hogp import HOGP as JHOGP
from fidelityfusion_tpu.ops import spectral as JS
from fidelityfusion_tpu.ops.kernels import ARDKernel as JARD
from fidelityfusion_tpu.train.fit import adam_scan_aux as j_adam_scan_aux
from fidelityfusion_tpu.train.fit import fit_restarts_tracked_adaptive as j_adaptive
from fidelityfusion_tpu_torch.convert import params_from_numpy
from fidelityfusion_tpu_torch.models.gar import _Gar0LossTracked
from fidelityfusion_tpu_torch.models.hogp import HOGP
from fidelityfusion_tpu_torch.ops import spectral as TS
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
from fidelityfusion_tpu_torch.train import fit as TF
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map

BIG = 1 << 20


def _se_gram(n, seed=0, ls=1.0, jitter=1e-3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 1)) * 10
    return np.exp(-0.5 * (x - x.T) ** 2 / ls ** 2) + jitter * np.eye(n)


def _warm_problem(n=64):
    """An SE Gram perturbed as one Adam step would, and the eigenbasis of
    the unperturbed one."""
    K = _se_gram(n)
    _, V = np.linalg.eigh(K)
    K2 = K + 1e-2 * _se_gram(n, seed=1, ls=2.0)
    return 0.5 * (K2 + K2.T), V


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ns_orthonormalize_matches_jax(dtype):
    rng = np.random.default_rng(1)
    S = rng.standard_normal((32, 32)) * 0.02
    Q = (np.eye(32) + S - S.T).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(JS._ns_orthonormalize(jnp.asarray(Q)))
    got = TS._ns_orthonormalize(torch.tensor(Q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-10 if dtype == "float64" else 1e-5)


@pytest.mark.parametrize("dtype,sweeps", [("float64", 1), ("float64", 2), ("float32", 1)])
def test_jacobi_refine_matches_jax_from_the_same_basis(dtype, sweeps):
    K, V = _warm_problem()
    K, V = K.astype(dtype), V.astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jw, jV, jres = (np.asarray(a) for a in JS.jacobi_refine(jnp.asarray(K), jnp.asarray(V),
                                                                 sweeps=sweeps))
    w, V1, res = (a.numpy() for a in TS.jacobi_refine(torch.tensor(K), torch.tensor(V),
                                                      sweeps=sweeps))
    tol = 1e-10 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(w, jw, atol=tol * np.abs(jw).max())
    np.testing.assert_allclose(V1, jV, atol=tol)
    np.testing.assert_allclose(res, jres, atol=tol)
    assert res < 2e-2 and np.abs(V1.T @ V1 - np.eye(len(K))).max() < 5e-5


def test_jacobi_refine_batched_equals_per_restart():
    K, V = _warm_problem(48)
    Kb = torch.tensor(np.stack([K, 2.0 * K, K + 0.1 * np.eye(48)]))
    Vb = torch.tensor(np.stack([V] * 3))
    w, Vn, res = TS.jacobi_refine(Kb, Vb)
    for r in range(3):
        w1, V1, res1 = TS.jacobi_refine(Kb[r], Vb[r])
        np.testing.assert_allclose(w[r].numpy(), w1.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(Vn[r].numpy(), V1.numpy(), atol=1e-12)
        np.testing.assert_allclose(res[r].item(), res1.item(), rtol=1e-10)


def test_tracked_eigh_refresh_schedule():
    """Steps that are multiples of ``refresh_every`` (0 included) pay the
    full eigh (the float32 Gram decomposed in float64) and ignore V_prev;
    others refine V_prev (exact warm start: residual ~0); the adaptive gate
    refreshes on a large last residual."""
    K = torch.tensor(_se_gram(48), dtype=torch.float32)
    garbage = torch.zeros((48, 48))
    w_ref, V_ref = (a.float() for a in torch.linalg.eigh(K.double()))
    for step in (0, 8):
        w, V, res = TS.tracked_eigh(K, garbage, step, refresh_every=4)
        np.testing.assert_allclose(w.numpy(), w_ref.numpy(), rtol=1e-6)
        assert float(res) == 0.0
    w2, V2, res2 = TS.tracked_eigh(K, V_ref, 1, refresh_every=4)
    assert float(res2) < 1e-5
    _, _, res3 = TS.tracked_eigh_adaptive(K, garbage, torch.tensor(0.5), 3, max_gap=64,
                                          res_threshold=0.05)
    _, _, res4 = TS.tracked_eigh_adaptive(K, V_ref, torch.tensor(0.01), 3, max_gap=64,
                                          res_threshold=0.05)
    assert float(res3) == 0.0 and 0.0 < float(res4) < 1e-5
    with pytest.raises(ValueError, match="unbatched"):
        TS.tracked_eigh_adaptive(K[None].expand(2, 48, 48), V_ref[None].expand(2, 48, 48),
                                 torch.zeros(2), 3)


def test_tracked_nlml_matches_exact_along_adam_trajectory():
    """24 Adam steps on the exact NLML; at each, the tracked NLML
    (refresh_every 8, carrying V) against the exact one, at the bars of
    `tests/test_spectral.py:95`."""
    rng = np.random.default_rng(0)
    n, shape = 48, (4, 5)
    x = torch.tensor(rng.random((n, 1)) * 10, dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((n,) + shape), dtype=torch.float32)
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    p = hogp.init_params(1, device="cpu")

    def val_grad(fn, p):
        q = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
        out = fn(q)
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        g = np.concatenate([a.grad.numpy().ravel() for a in tree_leaves(q)])
        return loss.item(), g, out[1] if isinstance(out, tuple) else None

    aux = hogp.tracking_aux0(n, device="cpu")
    max_res = max_dval = max_dgrad = 0.0
    opt = None
    for step in range(24):
        le, ge, _ = val_grad(lambda q: hogp.nll(q, x, y), p)
        lt, gt, aux = val_grad(lambda q: hogp.nll_tracked(q, aux, step, x, y, refresh_every=8),
                               p)
        aux = tuple(a.detach() for a in aux)
        max_res = max(max_res, float(aux[1]))
        max_dval = max(max_dval, abs(lt - le))
        max_dgrad = max(max_dgrad, np.linalg.norm(gt - ge) / (np.linalg.norm(ge) + 1e-12))
        p, opt = _adam_step(p, ge, opt, step)
    assert max_res < 0.15, max_res
    assert max_dval < 5e-3, max_dval
    assert max_dgrad < 0.15, max_dgrad


def _adam_step(p, g, opt, step, lr=5e-2):
    """One optax-equivalent Adam step on a flat gradient."""
    leaves = tree_leaves(p)
    flat = np.concatenate([a.numpy().ravel() for a in leaves])
    m, v = opt if opt is not None else (np.zeros_like(flat), np.zeros_like(flat))
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    upd = -lr * (m / (1 - 0.9 ** (step + 1))) / (np.sqrt(v / (1 - 0.999 ** (step + 1))) + 1e-8)
    out, i = [], 0
    for a in leaves:
        out.append(torch.tensor((flat[i:i + a.numel()] + upd[i:i + a.numel()]).reshape(a.shape),
                                dtype=torch.float32))
        i += a.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), p), (m, v)


def test_adam_scan_aux_rolls_back_params_opt_and_aux_as_jax():
    """A non-finite step keeps the last good params, optimizer state and
    aux: losses, params and aux against JAX's `adam_scan_aux` on the same
    loss (a quadratic, NaN at step 3 for the flagged restart; the aux counts
    the accepted steps), a batch of two restarts."""
    target = np.array([1.0, -2.0, 0.5], np.float32)
    w0 = np.array([[0.0, 0.0, 0.0], [0.3, 0.1, -0.2]], np.float32)

    def jloss(p, aux, step):
        nan = jnp.where((step == 3) & (p["flag"] > 0), jnp.nan, 0.0)
        return jnp.sum((p["w"] - target) ** 2) + nan, (aux[0] + 1.0,)

    def one(w, flag):
        return j_adam_scan_aux(jloss, {"w": w, "flag": flag}, (jnp.float32(0),),
                                optax.adam(0.1), 6, trainable={"w": True, "flag": False})

    jp, jgood, jl, jaux = jax.vmap(one)(jnp.asarray(w0), jnp.asarray([1.0, 0.0]))

    def tloss(p, aux, step):
        nan = torch.where((p["flag"] > 0) & (step == 3), float("nan"), 0.0)
        return ((p["w"] - torch.tensor(target)) ** 2).sum(-1) + nan, (aux[0] + 1.0,)

    tp = {"w": torch.tensor(w0), "flag": torch.tensor([1.0, 0.0])}
    p, good, losses, aux = TF.adam_scan_aux(tloss, tp, (torch.zeros(2),), 0.1, 6,
                                            trainable={"w": True, "flag": False})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(good["w"].numpy(), np.asarray(jgood["w"]), rtol=1e-6)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6)
    np.testing.assert_array_equal(aux[0].numpy(), np.asarray(jaux[0]))
    assert aux[0].tolist() == [5.0, 6.0] and np.isnan(losses[0, 3].item())


@pytest.fixture(scope="module")
def hogp_fixture():
    """The fixture of `tests/test_adaptive_batched.py` (ARD HOGP, n = 48,
    output (4, 4), 3 restarts), the restart batch made with numpy."""
    rng = np.random.default_rng(0)
    n, shape, R = 48, (4, 4), 3
    x = (rng.random((n, 2)) * 4).astype(np.float32)
    y = rng.standard_normal((n,) + shape).astype(np.float32)
    p0 = jax.tree_util.tree_map(np.asarray, {"hogp": JHOGP(JARD(), shape).init_params(2)})
    batch = jax.tree_util.tree_map(
        lambda a: np.stack([a] + [a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
                                  for _ in range(R - 1)]), p0)
    return shape, x, y, batch


def _port_adaptive(hogp_fixture, threshold, steps=24, seg=8, lr=1e-2):
    shape, x, y, batch = hogp_fixture
    hogp = HOGP(ARDKernel(), shape)
    aux0 = tuple(a.expand((3,) + a.shape) for a in hogp.tracking_aux0(len(x), device="cpu"))
    return TF.fit_restarts_tracked_adaptive(
        _Gar0LossTracked(hogp, refresh_every=BIG), params_from_numpy(batch, "cpu"), aux0,
        steps=steps, lr=lr, segment=seg, res_threshold=threshold,
        loss_args=(torch.tensor(x), torch.tensor(y)))


@pytest.mark.parametrize("threshold,refresh_every,segments",
                         [(-1.0, 8, [0, 1, 2]), (np.inf, BIG, [0])])
def test_adaptive_segments_equal_one_long_run(hogp_fixture, threshold, refresh_every,
                                              segments):
    """Gate forced on: the static refresh_every = segment schedule; gate
    forced off: pure tracking; both through the segmented trainer, so its
    resumption of params, Adam state and eigenbasis is exact."""
    shape, x, y, batch = hogp_fixture
    _, res_a, refreshed = _port_adaptive(hogp_fixture, threshold)
    assert refreshed == segments
    hogp = HOGP(ARDKernel(), shape)
    aux0 = tuple(a.expand((3,) + a.shape) for a in hogp.tracking_aux0(len(x), device="cpu"))
    _, res_s = TF.fit_restarts(_Gar0LossTracked(hogp, refresh_every=refresh_every),
                               params_from_numpy(batch, "cpu"), steps=24, lr=1e-2,
                               loss_args=(torch.tensor(x), torch.tensor(y)), aux0=aux0)
    np.testing.assert_allclose(res_a.losses.numpy(), res_s.losses.numpy(), rtol=1e-5, atol=1e-6)


def test_adaptive_gate_refreshes_as_jax(hogp_fixture):
    """A realistic threshold: the same refresh segments as the JAX trainer on
    the same batch, losses finite and falling, the winner verifying."""
    shape, x, y, batch = hogp_fixture
    hogp = JHOGP(JARD(), shape)
    jaux0 = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (3,) + a.shape),
                                   hogp.tracking_aux0(len(x)))
    _, jres, jrefreshed = j_adaptive(
        JLoss(hogp, refresh_every=BIG), jax.tree_util.tree_map(jnp.asarray, batch), jaux0,
        steps=32, lr=5e-2, segment=8, res_threshold=0.05, loss_args=(jnp.asarray(x),
                                                                      jnp.asarray(y)))
    best, res, refreshed = _port_adaptive(hogp_fixture, 0.05, steps=32, lr=5e-2)
    losses = res.losses.numpy()
    assert refreshed == jrefreshed and refreshed[0] == 0
    assert np.isfinite(losses).all() and losses[:, -1].min() < losses[:, 0].min()
    np.testing.assert_allclose(losses, np.asarray(jres.losses), rtol=1e-3, atol=1e-4)
    assert np.isfinite(best["hogp"]["noise_variance"].numpy()).all()
